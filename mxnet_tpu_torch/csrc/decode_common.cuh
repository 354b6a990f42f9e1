// Device code shared by the decode kernels: the fused decode layer group
// (fused_decode.cu, kernel #12), the tensor-parallel decode phases
// (decode_phase.cu, kernels #13 and #14) and paged attention
// (paged_attention.cu, #15).  Each is a cooperative persistent launch whose
// phases are separated by grid-wide barriers.
//
// - gemv: in (B, K) times N weight rows of K, for the whole decode batch,
//   each weight row streamed from device memory.  At B 16 a weight is used
//   2 B = 32 flops per 4 bytes it costs, far below the card's ~20 flops
//   per byte in fp32, so the bound is the weight bytes: one warp per output
//   column reads its row once with 16-byte loads, neighbouring lanes on
//   neighbouring addresses and several loads in flight per lane, and
//   applies it to all B rows at once from a shared-memory copy of the input
//   rows.  A GEMV with fewer output columns than the grid has warps splits
//   K across blocks (ksplit_for), so every warp streams weights; the caller
//   adds the partial sums in slice order, so results do not depend on
//   timing.  #13's q/k/v and out-projection.
// - ffn_gemv: the same products with the block's first unit "resident":
//   its weight rows bulk-copied (TMA, FfnCopies) into shared memory ahead
//   of the math, which waits on the copies' mbarrier only when it reaches
//   them and multiplies from shared memory on register tiles (ffn_tiles).
//   #14's FFN1 and FFN2 (copies issued at launch) and all four GEMVs of #12
//   (copies issued one GEMV ahead, each buffer's mbarrier reused).
// - split_attend and split_merge: paged attention with a row's keys split
//   over blocks (flash-decoding), for #12 and #13 over fp32 pages and for
//   #15 over fp32 or int8 pages: partials per chunk of SPLIT_KEYS keys,
//   then a merge in chunk order after a grid barrier.
// - coop_geometry: the grid of a cooperative launch, every block resident.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "sm90.cuh"

namespace mxt {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int GEMV_ROWS = 16;        // batch rows per register pass
constexpr int GEMV_LOADS = 4;        // weight float4 loads in flight per lane
constexpr int STAGE_FLOATS = 8192;   // staged input elements (32 KB)
constexpr int KSPLIT_MAX = 8;        // K slices of a split GEMV

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) & ~3; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the card's global nanosecond timer, for a kernel's phase stamps
__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// K slices for an N-column GEMV: enough to give every block a unit of
// work, the same value in every block
__device__ inline int ksplit_for(int N) {
  const int groups = (N + NWARPS - 1) / NWARPS;
  return max(1, min(KSPLIT_MAX, (int)gridDim.x / groups));
}

// stage rows [0, nb) x columns [k0, k0 + kc) of in (row stride K) into
// stage (row stride kc), several float4 loads in flight per thread
__device__ inline void stage_rows(float* stage, const float* in, int nb,
                                  int K, int k0, int kc) {
  const int kc4 = kc >> 2, n4 = nb * kc4;
  for (int e0 = threadIdx.x; e0 < n4; e0 += blockDim.x * 4) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < n4) {
        const int r = e / kc4;
        v[u] = __ldcg(reinterpret_cast<const float4*>(
            in + (size_t)r * K + k0 + (e - r * kc4) * 4));
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < n4) reinterpret_cast<float4*>(stage)[e] = v[u];
    }
  }
}

// epi(b, n, s, sum over K slice s of in[b, k] * W_n[k]) for b < B, n < N,
// s < ksplit.  A unit of work is NWARPS consecutive columns (one per warp)
// over one K slice; the slice's input rows are staged through shared
// memory in chunks so that every warp of the block reads them from there.
// K, the slices, the chunks and the staged offsets are multiples of 4.
template <class Row, class Epi>
__device__ void gemv(const float* in, int B, int K, int N, int ksplit,
                     Row row, Epi epi, float* stage) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = (N + NWARPS - 1) / NWARPS;
  const int slice = (int)round4((K + ksplit - 1) / ksplit);
  for (int unit = blockIdx.x; unit < groups * ksplit; unit += gridDim.x) {
    const int grp = unit / ksplit, s = unit - grp * ksplit;
    const int n = grp * NWARPS + warp;
    const bool has = n < N;
    const int k_lo = s * slice, k_hi = min(K, k_lo + slice);
    const float* w = has ? row(n) : nullptr;
    for (int b0 = 0; b0 < B; b0 += GEMV_ROWS) {
      const int nb = min(GEMV_ROWS, B - b0);
      const int kc_max = (STAGE_FLOATS / nb) & ~3;
      float acc[GEMV_ROWS];
#pragma unroll
      for (int r = 0; r < GEMV_ROWS; ++r) acc[r] = 0.f;
      for (int k0 = k_lo; k0 < k_hi; k0 += kc_max) {
        const int kc = min(kc_max, k_hi - k0);
        __syncthreads();
        stage_rows(stage, in + (size_t)b0 * K, nb, K, k0, kc);
        __syncthreads();
        if (!has) continue;
        int kk = lane * 4;
        for (; kk + 128 * (GEMV_LOADS - 1) < kc; kk += 128 * GEMV_LOADS) {
          float4 wv[GEMV_LOADS];
#pragma unroll
          for (int u = 0; u < GEMV_LOADS; ++u)
            wv[u] = __ldg(reinterpret_cast<const float4*>(w + k0 + kk + 128 * u));
#pragma unroll
          for (int u = 0; u < GEMV_LOADS; ++u) {
#pragma unroll
            for (int r = 0; r < GEMV_ROWS; ++r) {
              if (r < nb) {
                const float4 xv = *reinterpret_cast<const float4*>(
                    stage + r * kc + kk + 128 * u);
                acc[r] = fmaf(wv[u].x, xv.x, acc[r]);
                acc[r] = fmaf(wv[u].y, xv.y, acc[r]);
                acc[r] = fmaf(wv[u].z, xv.z, acc[r]);
                acc[r] = fmaf(wv[u].w, xv.w, acc[r]);
              }
            }
          }
        }
        for (; kk < kc; kk += 128) {
          const float4 wv = __ldg(reinterpret_cast<const float4*>(w + k0 + kk));
#pragma unroll
          for (int r = 0; r < GEMV_ROWS; ++r) {
            if (r < nb) {
              const float4 xv =
                  *reinterpret_cast<const float4*>(stage + r * kc + kk);
              acc[r] = fmaf(wv.x, xv.x, acc[r]);
              acc[r] = fmaf(wv.y, xv.y, acc[r]);
              acc[r] = fmaf(wv.z, xv.z, acc[r]);
              acc[r] = fmaf(wv.w, xv.w, acc[r]);
            }
          }
        }
      }
      if (has) {
#pragma unroll
        for (int r = 0; r < GEMV_ROWS; ++r) {
          if (r < nb) {
            const float v = warp_sum(acc[r]);
            if (lane == 0) epi(b0 + r, n, s, v);
          }
        }
      }
    }
  }
}

__device__ __forceinline__ float gelu_erf(float u) {
  return 0.5f * u * (1.f + erff(u * 0.70710678118654752f));
}

// Resident GEMVs (ffn_gemv).  A unit is NWARPS consecutive output columns
// over one K slice, as in gemv.  The block's first unit (unit blockIdx.x)
// is "resident" when its weight rows fit their buffer: its rows are
// bulk-copied into shared memory ahead of the math (FfnCopies), the math
// waits on the buffer's mbarrier only when it reaches them, and reads both
// operands from shared memory on register tiles (ffn_tiles).  A block's
// later units, and units too large, stream their weight rows from global
// memory one warp a column, as gemv does.
//
// Rows in shared memory have a pitch of round32(width) + 4 floats: the 8
// rows (or 4) that a tile step loads land 16 bytes apart in the banks.
__host__ __device__ __forceinline__ int ffn_pitch(int width) {
  return ((width + 31) & ~31) + 4;
}

struct FfnUnits {
  int groups, ks, slice;  // column groups, K slices, columns per slice
  __device__ FfnUnits(int N, int K, int ks_)
      : groups((N + NWARPS - 1) / NWARPS), ks(ks_),
        slice((int)round4((K + ks_ - 1) / ks_)) {}
  __device__ int count() const { return groups * ks; }
  // the block's first unit, if its rows fit `cap` floats
  __device__ bool resident(int cap) const {
    return (int)blockIdx.x < count() && NWARPS * ffn_pitch(slice) <= cap;
  }
};

// The bulk copies of the block's resident unit of an N-row weight (row(n):
// its K floats) into buf, and, when x is given (B <= GEMV_ROWS rows of
// K), of x's rows for that slice into xbuf, all completing on one
// mbarrier.  Every thread computes the same plan; copy c is issued by
// thread first + c, so the copies go out in parallel.
struct FfnCopies {
  const float* x;
  float* buf;
  float* xbuf;
  int K, n0, rows, k_lo, kc, xrows;
  __device__ FfnCopies(const FfnUnits& u, int N, int K_, float* buf_,
                       const float* x_, int B, float* xbuf_)
      : x(x_), buf(buf_), xbuf(xbuf_), K(K_) {
    const int grp = blockIdx.x / u.ks, s = blockIdx.x - grp * u.ks;
    n0 = grp * NWARPS;
    rows = min(NWARPS, N - n0);
    k_lo = s * u.slice;
    kc = max(0, min(K, k_lo + u.slice) - k_lo);
    xrows = x != nullptr && B <= GEMV_ROWS ? B : 0;
  }
  __device__ uint32_t bytes() const {
    return (uint32_t)(rows + xrows) * kc * 4;
  }
  template <class Row>
  __device__ void issue(int first, uint64_t* bar, Row row) const {
    const int c = (int)threadIdx.x - first, p = ffn_pitch(kc);
    if (kc == 0 || c < 0 || c >= rows + xrows) return;
    if (c < rows)
      bulk_load(smem_u32(buf + (size_t)c * p), row(n0 + c) + k_lo, kc * 4,
                smem_u32(bar));
    else
      bulk_load(smem_u32(xbuf + (size_t)(c - rows) * p),
                x + (size_t)(c - rows) * K + k_lo, kc * 4, smem_u32(bar));
  }
};

// Wait for the phase of `bar` whose parity is `parity` (each use of a
// buffer is one phase of its mbarrier: the caller flips its parity bit
// after every wait, and re-arms the barrier with mbar_expect_tx before the
// next copies).  A copy that never lands (a wrong byte count) would hang
// the grid at its next barrier: after 2^22 polls (seconds) the launch
// traps instead.
__device__ __forceinline__ void wait_copies(uint32_t bar, uint32_t parity) {
  for (int i = 0; i < (1 << 22); ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}

// rows [0, nb) x columns [k0, k0 + kc) of in (row stride K) into st (row
// pitch p), several float4 loads in flight per thread.  Ordinary loads
// through L2: activations written by other blocks before the grid barrier
// (a bulk copy reads through the async proxy, which grid.sync() does not
// order after other blocks' generic stores).
__device__ inline void ffn_stage(float* st, int p, const float* in, int nb,
                                 int K, int k0, int kc) {
  const int kc4 = kc >> 2, n4 = nb * kc4;
  for (int e0 = threadIdx.x; e0 < n4; e0 += blockDim.x * 4) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < n4) {
        const int r = e / kc4;
        v[u] = __ldcg(reinterpret_cast<const float4*>(
            in + (size_t)r * K + k0 + (e - r * kc4) * 4));
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < n4) {
        const int r = e / kc4;
        *reinterpret_cast<float4*>(st + r * p + (e - r * kc4) * 4) = v[u];
      }
    }
  }
}

// The resident unit's products, in two steps.  ffn_tiles adds this lane's
// share over columns [0, kc) of ws (weight rows, pitch pw) and xs (input
// rows, pitch px) to acc: lane l of warp w holds rows l / 4 and l / 4 + 8
// by weight rows l % 4 and l % 4 + 4 (acc x, y, z, w: row 0 by weight 0,
// row 0 by weight 1, row 1 by weight 0, row 1 by weight 1) over the float4
// columns w, w + 8, w + 16, ...: per step 4 float4 loads (two of them
// broadcast) for 16 FMAs.  Called once per staged chunk of a slice (each a
// multiple of 32 columns but the last), it sums the columns in the same
// order as one call over the whole slice.  ffn_tiles_out then adds the 8
// warps' partials in warp order through red (which may overlay xs) and
// calls epi(b, n, v) for b < nb, n < cols.
__device__ __forceinline__ void ffn_tiles(const float* ws, int pw,
                                          const float* xs, int px, int kc,
                                          float4& acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* x0 = xs + (lane >> 2) * px;
  const float* x1 = x0 + 8 * px;
  const float* w0 = ws + (lane & 3) * pw;
  const float* w1 = w0 + 4 * pw;
  float a00 = acc.x, a01 = acc.y, a10 = acc.z, a11 = acc.w;
  for (int f = warp * 4; f < kc; f += NWARPS * 4) {
    const float4 xa = *reinterpret_cast<const float4*>(x0 + f);
    const float4 xb = *reinterpret_cast<const float4*>(x1 + f);
    const float4 wa = *reinterpret_cast<const float4*>(w0 + f);
    const float4 wb = *reinterpret_cast<const float4*>(w1 + f);
    a00 = fmaf(xa.x, wa.x, a00); a00 = fmaf(xa.y, wa.y, a00);
    a00 = fmaf(xa.z, wa.z, a00); a00 = fmaf(xa.w, wa.w, a00);
    a01 = fmaf(xa.x, wb.x, a01); a01 = fmaf(xa.y, wb.y, a01);
    a01 = fmaf(xa.z, wb.z, a01); a01 = fmaf(xa.w, wb.w, a01);
    a10 = fmaf(xb.x, wa.x, a10); a10 = fmaf(xb.y, wa.y, a10);
    a10 = fmaf(xb.z, wa.z, a10); a10 = fmaf(xb.w, wa.w, a10);
    a11 = fmaf(xb.x, wb.x, a11); a11 = fmaf(xb.y, wb.y, a11);
    a11 = fmaf(xb.z, wb.z, a11); a11 = fmaf(xb.w, wb.w, a11);
  }
  acc = make_float4(a00, a01, a10, a11);
}

template <class Epi>
__device__ void ffn_tiles_out(float4 acc, int nb, int cols, float* red,
                              Epi epi) {
  __syncthreads();  // every warp is done with xs
  reinterpret_cast<float4*>(red)[threadIdx.x] = acc;
  __syncthreads();
  const int t = threadIdx.x;
  if (t < GEMV_ROWS * NWARPS) {
    const int b = t / NWARPS, n = t - b * NWARPS;
    const int tl = (b & 7) * 4 + (n & 3), e = (b >> 3) * 2 + (n >> 2);
    float v = 0.f;
    for (int w = 0; w < NWARPS; ++w) v += red[(w * 32 + tl) * 4 + e];
    if (b < nb && n < cols) epi(b, n, v);
  }
}

// acc[r] += sum over kk < kc of w(kk) * stage[r * p + kk], r < nb: this
// lane's columns lane * 4 + 128 j, GEMV_LOADS weight float4s in flight
__device__ __forceinline__ void ffn_dot(const float* wg, const float* stage,
                                        int p, int kc, int nb, int lane,
                                        float (&acc)[GEMV_ROWS]) {
  constexpr int L = GEMV_LOADS;
  int kk = lane * 4;
  for (; kk < kc; kk += 128 * L) {
    float4 wv[L];
#pragma unroll
    for (int u = 0; u < L; ++u)
      if (kk + 128 * u < kc)
        wv[u] = __ldg(reinterpret_cast<const float4*>(wg + kk + 128 * u));
#pragma unroll
    for (int u = 0; u < L; ++u) {
      if (kk + 128 * u < kc) {
#pragma unroll
        for (int r = 0; r < GEMV_ROWS; ++r) {
          if (r < nb) {
            const float4 xv = *reinterpret_cast<const float4*>(
                stage + r * p + kk + 128 * u);
            acc[r] = fmaf(wv[u].x, xv.x, acc[r]);
            acc[r] = fmaf(wv[u].y, xv.y, acc[r]);
            acc[r] = fmaf(wv[u].z, xv.z, acc[r]);
            acc[r] = fmaf(wv[u].w, xv.w, acc[r]);
          }
        }
      }
    }
  }
}

// epi(b, n, s, sum over K slice s of in[b, k] * W_n[k]) for b < B, n < N,
// s < u.ks.  stage_in(stage, p, b0, nb, k0, kc) writes rows b0.. b0 + nb -
// 1, columns k0.. k0 + kc - 1 of the input into stage (stage_floats
// floats) at pitch p.  The block's first unit reads its weight rows from
// w_res (null: not resident; pitch ffn_pitch(slice)) once the phase
// `parity` of bar completes, and, when x_res, its input from the stage,
// which the same copies filled; otherwise its input is staged in chunks
// of as many multiples of 32 columns as 16 rows of the stage hold.  With
// `landed`, each block raises it to the time its copies had landed.  Each
// output's FMA order is fixed.
template <class Row, class StageIn, class Epi>
__device__ void ffn_gemv(const FfnUnits& u, int B, int K, int N, Row row,
                         StageIn stage_in, Epi epi, float* stage,
                         int stage_floats, const float* w_res, bool x_res,
                         uint32_t bar, uint32_t parity,
                         unsigned long long* landed) {
  for (int unit = blockIdx.x; unit < u.count(); unit += gridDim.x) {
    const int grp = unit / u.ks, s = unit - grp * u.ks;
    const int n0 = grp * NWARPS;
    const int k_lo = s * u.slice, k_hi = min(K, k_lo + u.slice);
    if (w_res != nullptr && unit == (int)blockIdx.x) {
      const int kc = max(0, k_hi - k_lo), pw = ffn_pitch(kc);
      const int chunk = (stage_floats / GEMV_ROWS - 4) & ~31;
      for (int b0 = 0; b0 < B; b0 += GEMV_ROWS) {
        const int nb = min(GEMV_ROWS, B - b0);
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        int k0 = 0;
        do {
          const int kk = x_res ? kc : min(chunk, kc - k0);
          const int px = x_res ? pw : ffn_pitch(kk);
          if (!x_res) {
            __syncthreads();
            stage_in(stage, px, b0, nb, k_lo + k0, kk);
            __syncthreads();
          }
          if (k0 == 0) {
            wait_copies(bar, parity);
            if (landed != nullptr && threadIdx.x == 0)
              atomicMax(landed, (unsigned long long)globaltimer());
          }
          ffn_tiles(w_res + k0, pw, stage, px, kk, acc);
          k0 += kk;
        } while (k0 < kc);
        ffn_tiles_out(acc, nb, N - n0, stage, [&](int b, int c, float v) {
          epi(b0 + b, n0 + c, s, v);
        });
      }
      continue;
    }
    // not resident: one warp a column, its weight row streamed
    const int lane = threadIdx.x & 31, n = n0 + (int)(threadIdx.x >> 5);
    const bool has = n < N;
    const float* wg = has ? row(n) : nullptr;
    for (int b0 = 0; b0 < B; b0 += GEMV_ROWS) {
      const int nb = min(GEMV_ROWS, B - b0);
      const int kc_max = (stage_floats / nb - 36) & ~31;
      float acc[GEMV_ROWS];
#pragma unroll
      for (int r = 0; r < GEMV_ROWS; ++r) acc[r] = 0.f;
      for (int k0 = k_lo; k0 < k_hi; k0 += kc_max) {
        const int kc = min(kc_max, k_hi - k0), p = ffn_pitch(kc);
        __syncthreads();
        stage_in(stage, p, b0, nb, k0, kc);
        __syncthreads();
        if (has) ffn_dot(wg + k0, stage, p, kc, nb, lane, acc);
      }
      if (has) {
#pragma unroll
        for (int r = 0; r < GEMV_ROWS; ++r) {
          if (r < nb) {
            const float v = warp_sum(acc[r]);
            if (lane == 0) epi(b0 + r, n, s, v);
          }
        }
      }
    }
  }
  __syncthreads();  // the stage buffer is free for the next GEMV
}

// Split-key paged attention.  The unit of work is (row b, KV head, chunk
// of SPLIT_KEYS keys); a row of length n has ceil(n / SPLIT_KEYS) chunks
// per KV head and a row of length 0 none.  Every block enumerates the
// units alike, row-major, then KV head, then chunk, from `lengths`, and
// takes unit blockIdx.x, then every gridDim.x-th one, so a long row's keys
// spread over as many blocks as it has chunks and the batch's work over
// the grid.  Inside a unit each warp owns 8 consecutive keys, and each
// of its first D / E lanes E consecutive columns of every key, E =
// split_cols<DI> of the instance DI the kernel was built for (1, 2, 4 or
// 8, the fewest that fit DI in 32 lanes).  A head dim D (a multiple of 8
// in [8, 256]) runs on its class's instance (split_class: DI 32, 64, 128
// or 256, the next up), where D is a runtime value and D / E lanes are
// busy: every lane's load stays one aligned 4-, 8- or 16-byte vector (two
// at E 8) at the real row stride D, so pages, q and out keep their real
// D, with no padded copy.  The head dims of MXT_SPLIT_HEAD_DIMS also have
// an instance of their own, where D is a compile-time constant (a runtime
// D spilled the D 64 kernels of #12 and #15, PERF.md section 6, PR 23).
// A lane loads its
// columns of the 8 key rows and the 8 value rows at once (one round trip
// to memory), sums its part of each dot product with the query heads of
// the group, and 8 warp sums give every lane all 8 logits; the max, the
// exponentials, their sum and the lane's E columns of P V over the 8 keys
// then need no further exchange.  The block combines its 8 warps'
// (max, sum, output) in warp order at the largest max and writes the
// unit's, which split_merge combines in chunk order.  No atomics: results
// do not depend on timing.  A unit has two block barriers, and one more in
// the unit that owns a row's last chunk, which first runs append(b, kvh)
// (the step's key and value of that KV head into their page slot) so its
// own reads of that slot follow the write.

constexpr int SPLIT_KEYS = 64;       // keys per unit
constexpr int SPLIT_WARP_KEYS = 8;   // keys per warp of a unit

// The head dims with an instance of their own (D a compile-time
// constant): every multiple of 16 up to 128.  X(D) once for each.
#define MXT_SPLIT_HEAD_DIMS(X) \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)
// The instances of the classes (D a runtime value), one for each E.
#define MXT_SPLIT_CLASSES(X) X(32) X(64) X(128) X(256)

// columns a lane of split_attend's instance DI: 1, 2, 4 or 8, the fewest
// that fit DI in a warp's 32 lanes
template <int DI>
__host__ __device__ constexpr int split_cols() {
  static_assert((DI % 16 == 0 && DI >= 16 && DI <= 128) || DI == 256,
                "split attention: an instance of MXT_SPLIT_HEAD_DIMS or "
                "MXT_SPLIT_CLASSES");
  return DI <= 32 ? 1 : DI <= 64 ? 2 : DI <= 128 ? 4 : 8;
}

// The class instance that serves head dim D, or 0 for a D the kernels do
// not take: D a multiple of 8 in [8, 256] runs on the next of 32, 64, 128
// and 256.  The class's E divides every D it serves (24 / 1, 40 / 2, 72 /
// 4, 136 / 8), so the busy lanes D / E hold whole vectors.
__host__ __device__ constexpr int split_class(int D) {
  return (D < 8 || D > 256 || D % 8) ? 0
         : D <= 32                   ? 32
         : D <= 64                   ? 64
         : D <= 128                  ? 128
                                     : 256;
}

// blocks an SM the split kernels ask the compiler to fit: the instance of
// 256 keeps 16 columns of 8 keys' rows in registers and gets room for
// them
template <int DI>
__host__ __device__ constexpr int split_min_blocks(int below) {
  return DI > 128 ? 1 : below;
}

// chunks of a row of `length` keys (0 for an inactive row)
__device__ __forceinline__ int split_chunks(int length, int max_keys) {
  return (min(max(length, 0), max_keys) + SPLIT_KEYS - 1) / SPLIT_KEYS;
}

// units of the whole batch: KVH chunks per chunk of each row's keys
__device__ inline int split_units(const int* lengths, int B, int KVH,
                                  int max_keys) {
  int n = 0;
  for (int b = 0; b < B; ++b) n += split_chunks(__ldg(lengths + b), max_keys);
  return n * KVH;
}

// most units a launch can have, for sizing the partials' scratch
__host__ __device__ inline size_t split_units_max(int B, int KVH,
                                                  int max_keys) {
  return (size_t)B * KVH * ((max_keys + SPLIT_KEYS - 1) / SPLIT_KEYS);
}

// floats of shared memory split_attend uses: per warp its output rows
// (g D), maxima and sums (2 g)
__host__ __device__ inline int split_smem_floats(int g, int D) {
  return NWARPS * (g * D + 2 * g);
}

// E consecutive floats at p (8- or 16-byte aligned for E 2 and 4, and 16
// for E 8, two vectors)
template <int E>
struct Cols {
  float v[E];
  __device__ __forceinline__ void load(const float* p) {
    if constexpr (E == 8) {
      const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
      const float4 u = __ldcg(reinterpret_cast<const float4*>(p + 4));
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
      v[4] = u.x; v[5] = u.y; v[6] = u.z; v[7] = u.w;
    } else if constexpr (E == 4) {
      const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else if constexpr (E == 2) {
      const float2 t = __ldcg(reinterpret_cast<const float2*>(p));
      v[0] = t.x; v[1] = t.y;
    } else {
      v[0] = __ldcg(p);
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = 0.f;
  }
};

// The page types of split_attend.  fp32 pages load(off, kc, vc): a
// lane's E columns of the key row and of the value row at element offset
// off of the (KVH, P, S, D) slabs.  int8 pages (SCALED) load the lane's
// codes raw, and cvt turns them into values with the row's page scale
// once every load of the unit is in flight.

// fp32 pages
struct SplitF32 {
  static constexpr bool SCALED = false;
  const float* k;
  const float* v;
  template <int E>
  __device__ __forceinline__ void load(long long off, Cols<E>& kc,
                                       Cols<E>& vc) const {
    kc.load(k + off);
    vc.load(v + off);
  }
};

// the word a lane keeps its E raw int8 codes in until cvt
template <int E>
struct RawCodes {
  using type = unsigned;
};
template <>
struct RawCodes<8> {
  using type = unsigned long long;
};

// int8 pages: codes in the fp layout, one fp32 scale per (KV head, page)
// in (KVH, P); a value is its code times its page's scale, one multiply,
// as gather_pages_deq computes it.  E codes a lane: one 1-, 2-, 4- or
// 8-byte load per row, kept in the low bytes of a word until cvt.
struct SplitI8 {
  static constexpr bool SCALED = true;
  const signed char* k;
  const signed char* v;
  const float* ks;
  const float* vs;
  template <int E>
  __device__ __forceinline__ static typename RawCodes<E>::type raw(
      const signed char* p) {
    if constexpr (E == 8)
      return (unsigned long long)__ldcg(reinterpret_cast<const long long*>(p));
    else if constexpr (E == 4)
      return (unsigned)__ldcg(reinterpret_cast<const int*>(p));
    else if constexpr (E == 2)
      return (unsigned short)__ldcg(reinterpret_cast<const short*>(p));
    else
      return (unsigned char)__ldcg(p);
  }
  // code e of w (its signed byte e) times s
  template <int E>
  __device__ __forceinline__ static void cvt(typename RawCodes<E>::type w,
                                             float s, Cols<E>& c) {
    if constexpr (E == 8) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        c.v[e] = (float)(signed char)(unsigned char)(w >> (8 * e)) * s;
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        c.v[e] = (float)((int)(w << (24 - 8 * e)) >> 24) * s;
    }
  }
};

// q_at(b, c):    row b's query at column c = h D + d (h = kvh g + i),
//                before the scale
// append(b, kvh): run by the whole block in the unit of (b, kvh)'s last
//                chunk before it reads a key: writes the step's key and
//                value into their page slot
// pages:         SplitF32 or SplitI8 over the (KVH, P, S, D) slabs
// po/pm/pl:      per unit, (g D) unnormalised outputs, (g) maxima, (g) sums
// DI the instance of head dim D: D itself, or split_class(D).  Pages are
// read with L2-only loads: blocks write them in the same launch.
template <int DI, class QAt, class Append, class Pages>
__device__ void split_attend(QAt q_at, Append append, const Pages& pages,
                             const int* tables, const int* lengths, int B,
                             int KVH, int g, int D, int P, int S, int pps,
                             float scale, float* po, float* pm, float* pl,
                             float* smem) {
  constexpr int E = split_cols<DI>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // lanes past D / E hold no columns: they load nothing and add 0 to the
  // warp sums (every lane, known at compile time, where the caller's D is
  // the instance's own and DI / E is 32)
  const bool cols = (DI / E == 32 && D == DI) || lane * E < D;
  const int gD = g * D, max_keys = pps * S, wstride = gD + 2 * g;
  float* o_w = smem + warp * wstride;  // this warp's rows, then m, then l
  const int units = split_units(lengths, B, KVH, max_keys);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int r = u, b = 0, nch = 0;
    for (; b < B; ++b) {
      nch = split_chunks(__ldg(lengths + b), max_keys);
      if (r < nch * KVH) break;
      r -= nch * KVH;
    }
    const int kvh = r / nch, c = r - kvh * nch;
    const int length = min(__ldg(lengths + b), max_keys);
    const int k0 = c * SPLIT_KEYS + warp * SPLIT_WARP_KEYS;
    const int nk = min(SPLIT_WARP_KEYS, max(length - k0, 0));
    __syncthreads();  // the last unit's combine has read the warps' rows
    if (c == nch - 1) {
      append(b, kvh);
      __syncthreads();
    }
    // lane k < 8 finds key k's row (and its page's scales); every lane
    // loads its columns of all 8
    long long row = 0;
    float sk = 0.f, sv = 0.f;
    if (lane < nk) {
      const int t = k0 + lane;
      const int page = __ldg(tables + (size_t)b * pps + t / S);
      row = (((long long)kvh * P + page) * S + t % S) * D;
      if constexpr (Pages::SCALED) {
        sk = __ldcg(pages.ks + (size_t)kvh * P + page);
        sv = __ldcg(pages.vs + (size_t)kvh * P + page);
      }
    }
    Cols<E> kc[SPLIT_WARP_KEYS], vc[SPLIT_WARP_KEYS];
    if constexpr (Pages::SCALED) {
      // every code load first, then the scales (loaded beside the table
      // entries) shuffled and applied
      typename RawCodes<E>::type kr[SPLIT_WARP_KEYS], vr[SPLIT_WARP_KEYS];
#pragma unroll
      for (int k = 0; k < SPLIT_WARP_KEYS; ++k) {
        const long long rk = __shfl_sync(0xffffffffu, row, k) + lane * E;
        const bool ld = k < nk && cols;
        kr[k] = ld ? Pages::template raw<E>(pages.k + rk) : 0;
        vr[k] = ld ? Pages::template raw<E>(pages.v + rk) : 0;
      }
#pragma unroll
      for (int k = 0; k < SPLIT_WARP_KEYS; ++k) {
        Pages::template cvt<E>(kr[k], __shfl_sync(0xffffffffu, sk, k),
                               kc[k]);
        Pages::template cvt<E>(vr[k], __shfl_sync(0xffffffffu, sv, k),
                               vc[k]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < SPLIT_WARP_KEYS; ++k) {
        const long long rk = __shfl_sync(0xffffffffu, row, k) + lane * E;
        if (k < nk && cols) {
          pages.template load<E>(rk, kc[k], vc[k]);
        } else {
          kc[k].zero();
          vc[k].zero();
        }
      }
    }
    for (int i = 0; i < g; ++i) {
      const int col = (kvh * g + i) * D + lane * E;
      float qv[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        qv[e] = cols ? q_at(b, col + e) * scale : 0.f;
      float s[SPLIT_WARP_KEYS];
#pragma unroll
      for (int k = 0; k < SPLIT_WARP_KEYS; ++k) {
        float t = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) t = fmaf(qv[e], kc[k].v[e], t);
        s[k] = warp_sum(t);
      }
      float m = -INFINITY;
#pragma unroll
      for (int k = 0; k < SPLIT_WARP_KEYS; ++k)
        if (k < nk) m = fmaxf(m, s[k]);
      float l = 0.f, o[E];
#pragma unroll
      for (int e = 0; e < E; ++e) o[e] = 0.f;
#pragma unroll
      for (int k = 0; k < SPLIT_WARP_KEYS; ++k) {
        const float p = k < nk ? expf(s[k] - m) : 0.f;
        l += p;
#pragma unroll
        for (int e = 0; e < E; ++e) o[e] = fmaf(p, vc[k].v[e], o[e]);
      }
      if (cols) {
#pragma unroll
        for (int e = 0; e < E; ++e) o_w[i * D + lane * E + e] = o[e];
      }
      if (lane == 0) {
        o_w[gD + i] = m;  // -inf where the warp has no key
        o_w[gD + g + i] = l;
      }
    }
    __syncthreads();
    // the unit's partial: the warps' in warp order, at the largest max
    for (int e = tid; e < gD; e += blockDim.x) {
      const int i = e / D;
      float m = -INFINITY;
      for (int w = 0; w < NWARPS; ++w)
        m = fmaxf(m, smem[w * wstride + gD + i]);
      float o = 0.f, l = 0.f;
      for (int w = 0; w < NWARPS; ++w) {
        const float* ww = smem + w * wstride;
        const float a = expf(ww[gD + i] - m);
        o = fmaf(ww[e], a, o);
        l = fmaf(ww[gD + g + i], a, l);
      }
      po[(size_t)u * gD + e] = o;
      if (e == i * D) {
        pm[(size_t)u * g + i] = m;
        pl[(size_t)u * g + i] = l;
      }
    }
  }
}

// att[b, h D + d] = the merge of (row b, head h)'s chunk partials, in
// chunk order: sum_c o_c exp(m_c - m) / sum_c l_c exp(m_c - m), m the
// largest m_c; 0 for a row of length 0.  One element a thread.
__device__ inline void split_merge(const float* po, const float* pm,
                                   const float* pl, const int* lengths, int B,
                                   int KVH, int g, int D, int max_keys,
                                   float* att) {
  const int gD = g * D, Cq = KVH * gD;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < B * Cq;
       e += gridDim.x * blockDim.x) {
    const int b = e / Cq, hd = e - b * Cq;
    const int kvh = hd / gD, id = hd - kvh * gD, i = id / D;
    int u0 = 0;
    for (int bb = 0; bb < b; ++bb)
      u0 += split_chunks(__ldg(lengths + bb), max_keys) * KVH;
    const int nch = split_chunks(__ldg(lengths + b), max_keys);
    u0 += kvh * nch;
    float m = -INFINITY;
    for (int c = 0; c < nch; ++c)
      m = fmaxf(m, __ldcg(pm + (size_t)(u0 + c) * g + i));
    float o = 0.f, l = 0.f;
    for (int c = 0; c < nch; ++c) {
      const size_t u = (size_t)(u0 + c);
      const float a = expf(__ldcg(pm + u * g + i) - m);
      o = fmaf(__ldcg(po + u * gD + id), a, o);
      l = fmaf(__ldcg(pl + u * g + i), a, l);
    }
    att[e] = nch ? o / l : 0.f;
  }
}

// Grid (all blocks resident at once, from the occupancy calculator) and
// dynamic shared memory of a cooperative launch of `kernel` with
// NTHREADS threads and `smem_floats` floats of shared memory.
template <class Kernel>
cudaError_t coop_geometry(Kernel kernel, int smem_floats, int* grid,
                          size_t* smem) {
  *smem = (size_t)smem_floats * sizeof(float);
  cudaError_t e;
  if (*smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*smem);
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, NTHREADS, *smem)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = per_sm * sms;
  return cudaSuccess;
}

}  // namespace mxt
