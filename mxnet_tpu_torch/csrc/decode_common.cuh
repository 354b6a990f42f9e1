// Device code shared by the decode kernels: the fused decode layer group
// (fused_decode.cu, kernel #12), the tensor-parallel decode phases
// (decode_phase.cu, kernels #13 and #14) and paged attention
// (paged_attention.cu, #15).  Each is a cooperative persistent launch whose
// phases are separated by grid-wide barriers.
//
// - gemv: in (B, K) times N weight rows of K, for the whole decode batch.
//   At B 16 a weight is used 2 B = 32 flops per 4 bytes it costs, far
//   below the card's ~20 flops per byte in fp32, so the bound is the
//   weight bytes: one warp per output column reads its row once with
//   16-byte loads, neighbouring lanes on neighbouring addresses and several
//   loads in flight per lane, and applies it to all B rows at once from a
//   shared-memory copy of the input rows.  A GEMV with fewer output columns
//   than the grid has warps splits K across blocks (ksplit_for), so every
//   warp streams weights; the caller adds the partial sums in slice order,
//   so results do not depend on timing.
// - append_attend: the KV append at meta's (page, slot) and paged
//   attention (attend_group of paged_attention.cuh) per (sequence, KV
//   head), which reads only the pages the table names up to each row's
//   length.
// - split_attend and split_merge: paged attention with a row's keys split
//   over blocks (flash-decoding), for the tensor-parallel attention phase
//   (decode_phase.cu) over fp32 pages and for paged attention
//   (paged_attention.cu) over fp32 or int8 pages: partials per chunk of
//   SPLIT_KEYS keys, then a merge in chunk order after a grid barrier.
// - coop_geometry: the grid of a cooperative launch, every block resident.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "paged_attention.cuh"

namespace mxt {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int GEMV_ROWS = 16;        // batch rows per register pass
constexpr int GEMV_LOADS = 4;        // weight float4 loads in flight per lane
constexpr int STAGE_FLOATS = 8192;   // staged input elements (32 KB)
constexpr int KSPLIT_MAX = 8;        // K slices of a split GEMV

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) & ~3; }

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

// KV append, then attention, per (sequence, KV head) work item.
// qkv: (B, Cq + 2 KVH D) rows [q | k | v] of this launch; att: (B, Cq)
// with Cq = H D, head h reading KV head h / g; kp/vp: (KVH, P, S, D).
// Inactive rows all append to the scratch page 0, slot 0 (a benign race)
// and have length 0.  A row attends only over its own table's pages, so
// it reads its own freshly appended slot, written by this block, and no
// other block's append.
__device__ inline void append_attend(const float* qkv, int Cq, float* kp,
                                     float* vp, const int* meta,
                                     const int* tables, const int* lengths,
                                     int B, int KVH, int g, int P, int S,
                                     int D, int pps, float scale, float* att,
                                     float* smem) {
  const int KVC = KVH * D, N = Cq + 2 * KVC;
  for (int item = blockIdx.x; item < B * KVH; item += gridDim.x) {
    const int b = item / KVH, kvh = item - b * KVH;
    const float* src = qkv + (size_t)b * N + Cq + (size_t)kvh * D;
    const size_t dst =
        (((size_t)kvh * P + meta[b]) * S + meta[B + b]) * D;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      kp[dst + d] = __ldcg(src + d);
      vp[dst + d] = __ldcg(src + KVC + d);
    }
    __syncthreads();
    const size_t head0 = (size_t)kvh * g * D;
    const size_t pool0 = (size_t)kvh * P * S * D;
    attend_group(qkv + (size_t)b * N + head0, F32Pages{kp + pool0, vp + pool0},
                 tables + (size_t)b * pps, pps, lengths[b], S, D, g, scale,
                 att + (size_t)b * Cq + head0, smem);
  }
}

// Split-key paged attention.  The unit of work is (row b, KV head, chunk
// of SPLIT_KEYS keys); a row of length n has ceil(n / SPLIT_KEYS) chunks
// per KV head and a row of length 0 none.  Every block enumerates the
// units alike, row-major, then KV head, then chunk, from `lengths`, and
// takes unit blockIdx.x, then every gridDim.x-th one, so a long row's keys
// spread over as many blocks as it has chunks and the batch's work over
// the grid.  Inside a unit each warp owns 8 consecutive keys, and each
// lane E = D / 32 consecutive columns of every key: a lane loads its
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

// E consecutive floats at p (8- or 16-byte aligned for E 2 and 4)
template <int E>
struct Cols {
  float v[E];
  __device__ __forceinline__ void load(const float* p) {
    if constexpr (E == 4) {
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

// int8 pages: codes in the fp layout, one fp32 scale per (KV head, page)
// in (KVH, P); a value is its code times its page's scale, one multiply,
// as gather_pages_deq computes it.  E codes a lane: one 1-, 2- or 4-byte
// load per row, kept in the low bytes of a word until cvt.
struct SplitI8 {
  static constexpr bool SCALED = true;
  const signed char* k;
  const signed char* v;
  const float* ks;
  const float* vs;
  template <int E>
  __device__ __forceinline__ static unsigned raw(const signed char* p) {
    if constexpr (E == 4)
      return (unsigned)__ldcg(reinterpret_cast<const int*>(p));
    else if constexpr (E == 2)
      return (unsigned short)__ldcg(reinterpret_cast<const short*>(p));
    else
      return (unsigned char)__ldcg(p);
  }
  // code e of w (its signed byte e) times s
  template <int E>
  __device__ __forceinline__ static void cvt(unsigned w, float s,
                                             Cols<E>& c) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      c.v[e] = (float)((int)(w << (24 - 8 * e)) >> 24) * s;
  }
};

// q_at(b, c):    row b's query at column c = h D + d (h = kvh g + i),
//                before the scale
// append(b, kvh): run by the whole block in the unit of (b, kvh)'s last
//                chunk before it reads a key: writes the step's key and
//                value into their page slot
// pages:         SplitF32 or SplitI8 over the (KVH, P, S, D) slabs
// po/pm/pl:      per unit, (g D) unnormalised outputs, (g) maxima, (g) sums
// D = 32 E.  Pages are read with L2-only loads: blocks write them in the
// same launch.
template <int E, class QAt, class Append, class Pages>
__device__ void split_attend(QAt q_at, Append append, const Pages& pages,
                             const int* tables, const int* lengths, int B,
                             int KVH, int g, int P, int S, int pps,
                             float scale, float* po, float* pm, float* pl,
                             float* smem) {
  constexpr int D = 32 * E;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
      unsigned kr[SPLIT_WARP_KEYS], vr[SPLIT_WARP_KEYS];
#pragma unroll
      for (int k = 0; k < SPLIT_WARP_KEYS; ++k) {
        const long long rk = __shfl_sync(0xffffffffu, row, k) + lane * E;
        kr[k] = k < nk ? Pages::template raw<E>(pages.k + rk) : 0u;
        vr[k] = k < nk ? Pages::template raw<E>(pages.v + rk) : 0u;
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
        if (k < nk) {
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
      for (int e = 0; e < E; ++e) qv[e] = q_at(b, col + e) * scale;
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
#pragma unroll
      for (int e = 0; e < E; ++e) o_w[i * D + lane * E + e] = o[e];
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
