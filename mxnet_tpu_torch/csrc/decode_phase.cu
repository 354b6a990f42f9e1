// Tensor-parallel decode phases: one shard of one decoder layer, for the
// whole decode batch, in two cooperative persistent launches.  Wrapped by
// mxnet_tpu_torch/ops/kernels/fused_cell.py:decode_attn_phase and
// :decode_ffn_phase.
//
// Replaces the TPU kernels _decode_attn_phase_kernel (kernel #13,
// mxnet_tpu/ops/pallas/fused_cell.py:509, launched by decode_attn_phase at
// :572) and _decode_ffn_phase_kernel (#14, :617, launched at :626).  A
// Pallas body cannot carry a cross-chip collective, so under tensor
// parallelism the layer-group fusion of _decode_group_kernel splits at the
// two all-reduces of a Megatron layer; the caller sums the shards' partial
// products between the launches (models/decoder.py:_all_reduce) and adds
// the replicated bias and the residual LayerNorm.  The contracts are the
// TPU kernels': one launch per layer per shard for each phase, the KV
// pages updated in place, partial products in fp32 with no bias.
//
// #13, attention phase (grid-wide barriers between the phases):
//   1. q/k/v GEMVs over the shard's heads (B rows x (Cl + 2 KVCl) outputs
//      from the full-width x, Cl = H_local D), as partial sums over slices
//      of K: 144 column groups at tp 2 would leave most of the ~400 blocks
//      idle
//   2. split-key paged attention (decode_common.cuh:split_attend): one
//      unit per (sequence, KV head, chunk of 64 keys), each writing its
//      chunk's running max, sum and unnormalised output; a unit sums its
//      query rows' slices (in slice order) + bias as it reads them, and
//      the unit of a row's last chunk first sums the step's k and v the
//      same way and writes them into the page slot meta names (the KV
//      append), then reads them back through the table like every key
//   3. the chunks of each (sequence, head) merged in chunk order
//      (split_merge) into the attention output (B, Cl)
//   4. out-projection over the shard's Cl inputs (wo's row shard, (C, Cl)),
//      as partial sums over slices of K
//   5. the slices summed in slice order into o_part (B, C)
// Why split the keys: a unit of a whole (sequence, KV head) left one block
// walking the longest row's 512 keys while most of the ~400 resident
// blocks waited at the barrier (96 units at tp 2, 48 at tp 4); with
// 64-key chunks the serving batch's lengths give about as many units as
// blocks, and a unit's work is bounded by 64 keys.  Inactive rows have
// no unit and append nothing (the plain version writes their k and v to
// the scratch page 0, which no row reads).  A merge of its own,
// rather than inside the out-projection's staging, because every column
// group of that GEMV stages the same rows and would merge them again:
// folded there (each block merging the K slice it stages), the serial
// L2 reads sat on the GEMV's path, and the phase read 0.0505 ms against
// this design's 0.0431 (H100 80GB HBM3, 700 W; tp 2, B 16, mixed
// lengths; chip_flash_ab.py --phases tp), more than the merge pass and
// its grid barrier (~4 us) cost.
// #14, FFN phase:
//   0. at launch, each block's weight rows on their way into shared
//      memory: one 1-D bulk copy (TMA) per row of its FFN1 unit (8 rows of
//      w1's column shard (Fl, C) over a K slice) and of its FFN2 unit (of
//      w2's row shard (C, Fl)), and per row of x over the FFN1 unit's
//      slice, each set completing on an mbarrier that the math waits on
//      only when it reaches the unit
//   1. FFN1 as partial sums over slices of K (2 at tp 2, 4 at tp 4: every
//      block holds a share of the weights)
//   2. h = erf GELU(the slices' sum in slice order + b1), once per element
//   3. FFN2 over the shard's Fl inputs, as partial sums over slices of K
//   4. the slices summed in slice order into f_part (B, C)
// Each resident unit multiplies from shared memory on register tiles (two
// rows by two weight rows a lane, the K columns spread over the warps,
// their partials added in warp order: ffn_tiles), a quarter of the
// shared-memory reads of one warp a column.  Why: one warp a column
// streaming its row from memory (mxt::gemv) left FFN1 at 192 column groups
// for ~400 blocks, staged x in two serial chunks, issued FFN2's 384-column
// slices one load at a time and started w2's stream only after the grid
// barrier; stamped, the parent design took ffn1 18.4 us, ffn2 12.2 and
// the slice sum 2.1 of 0.0371 ms (H100 80GB HBM3, 700 W; tp 2, B 16;
// chip_flash_ab.py --phases tp).  b1 and the GELU folded into FFN2's
// staging had each of FFN2's 96 column groups re-add the slices and
// re-take the GELU of the same elements, and FFN2 unsplit (96 busy
// blocks, two an SM) left most of the grid idle: both read slower than
// this design in the same call (PERF.md, section 6).
//
// Bound on the card: bytes.  A shard's layer reads C (2 Cl + 2 KVCl) fp32
// weights in the attention phase and 2 C Fl in the FFN phase (4.7 MB and
// 9.4 MB at tp 2, full width), plus the KV its rows' lengths name; each
// weight is used by the B = 16 rows (32 flops per 4 bytes).  The GEMVs
// therefore stream each weight row once, as the fused decode kernel does
// (decode_common.cuh); the TPU kernel reads the whole page slab behind a
// mask (fused_cell.py:543-552) where this one reads only the pages on each
// row's table up to its length, which computes the same thing under the
// allocator's invariants (page 0 is scratch, no page twice in one table).
// The partial sums of a split GEMV are added in slice order, with no
// atomics, so results do not depend on timing.
#include "decode_common.cuh"
#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using mxt::KSPLIT_MAX;
using mxt::NTHREADS;
using mxt::round4;

struct AttnArgs {
  const float* x;        // (B, C) activations entering the layer
  float* kp;             // (KVH, P, S, D) the shard's key page slab
  float* vp;             // (KVH, P, S, D) the shard's value page slab
  const float* wq;       // (Cl, C), bq (Cl,)
  const float* bq;
  const float* wk;       // (KVC, C), bk (KVC,)
  const float* bk;
  const float* wv;       // (KVC, C), bv (KVC,)
  const float* bv;
  const float* wo;       // (C, Cl): wo's row shard, contiguous
  const int* meta;       // (2, B): write page, write slot
  const int* tables;     // (B, pps) page tables
  const int* lengths;    // (B,) valid keys after this step's append
  float* scratch;        // attn_scratch_floats(...) floats
  float* out;            // (B, C) o_part
  long long* timing;     // null, or ATTN_PHASES + 1 phase-end timestamps
  int B, C, H, KVH, D, P, S, pps;
  float scale;
};

struct FfnArgs {
  const float* x;        // (B, C)
  const float* w1;       // (Fl, C): w1's column shard, b1 (Fl,)
  const float* b1;
  const float* w2;       // (C, Fl): w2's row shard, contiguous
  float* scratch;        // ffn_scratch_floats(B, C, Fl) floats
  float* out;            // (B, C) f_part
  long long* timing;     // null, or FFN_PHASES + 1 phase-end timestamps
  int B, C, Fl;
};

// scratch: qkv parts (KSPLIT_MAX, B, Cl + 2 KVC) | att (B, Cl) | parts
// (KSPLIT_MAX, B, C) | the split attention's per-unit partials: outputs
// (U, g D), maxima (U, g), sums (U, g), U = split_units_max
__host__ __device__ inline size_t attn_scratch_floats(int B, int C, int Cl,
                                                      int KVC, int D,
                                                      int max_keys) {
  const int KVH = KVC / D, g = Cl / KVC;
  const size_t U = mxt::split_units_max(B, KVH, max_keys);
  return (size_t)KSPLIT_MAX * B * (Cl + 2 * KVC) + round4((size_t)B * Cl) +
         (size_t)KSPLIT_MAX * B * C + round4(U * g * D) + 2 * round4(U * g);
}

// scratch: FFN1 parts (KSPLIT_MAX, B, Fl) | h (B, Fl) | FFN2 parts
// (KSPLIT_MAX, B, C)
__host__ __device__ inline size_t ffn_scratch_floats(int B, int C, int Fl) {
  return (size_t)KSPLIT_MAX * B * (Fl + C) + (size_t)B * Fl;
}

// #14's shared memory: two mbarriers, a block's resident w1 rows and w2
// rows (at tp 2, full width: 8 rows of 384 columns each), then the stage
// (16 rows of 384 columns), rows padded (ffn_pitch): 48.5 KB a block,
// three blocks an SM
constexpr int FFN_BAR_FLOATS = 4;
constexpr int FFN_W1_FLOATS = 8 * 388;
constexpr int FFN_W2_FLOATS = 8 * 388;
constexpr int FFN_STAGE_FLOATS = 16 * 388;
constexpr int FFN_SMEM_FLOATS =
    FFN_BAR_FLOATS + FFN_W1_FLOATS + FFN_W2_FLOATS + FFN_STAGE_FLOATS;

// the attention and the FFN phase's phases, each closed by a grid barrier
constexpr int ATTN_PHASES = 5;
constexpr int FFN_PHASES = 5;

using mxt::globaltimer;

// out[b, c] = sum over s < ks of parts[s, b, c], in slice order
__device__ void sum_slices(float* out, const float* parts, int ks, int n) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < ks; ++s) acc += __ldcg(parts + (size_t)s * n + e);
    out[e] = acc;
  }
}

// one kernel per head dim, D = 32 E, so each carries one attention path
// under the register budget of three blocks an SM
template <int E>
__global__ void __launch_bounds__(NTHREADS, 3) attn_phase_kernel(AttnArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  // with a timing buffer, block 0 stamps the start and the end of every
  // phase (right after the grid barrier that closes it; the last phase
  // gets a barrier of its own only then)
  const bool stamp = a.timing != nullptr && blockIdx.x == 0 &&
                     threadIdx.x == 0;
  int n_stamp = 0;
  if (stamp) a.timing[n_stamp++] = globaltimer();
  auto sync = [&]() {
    grid.sync();
    if (stamp) a.timing[n_stamp++] = globaltimer();
  };
  const int B = a.B, C = a.C, D = a.D, S = a.S, P = a.P;
  const int Cl = a.H * D, KVC = a.KVH * D, N = Cl + 2 * KVC;
  const int g = a.H / a.KVH, max_keys = a.pps * S;
  const size_t U = mxt::split_units_max(B, a.KVH, max_keys);
  float* qkv = a.scratch;
  float* att = qkv + (size_t)KSPLIT_MAX * B * N;
  float* parts = att + round4((size_t)B * Cl);
  float* po = parts + (size_t)KSPLIT_MAX * B * C;
  float* pm = po + round4(U * g * D);
  float* pl = pm + round4(U * g);
  const float *wq = a.wq, *wk = a.wk, *wv = a.wv, *wo = a.wo;
  const float *bq = a.bq, *bk = a.bk, *bv = a.bv;
  float *kp = a.kp, *vp = a.vp;
  const int* meta = a.meta;

  // 1. q/k/v over the shard's heads, partial sums over K slices
  const int kq = mxt::ksplit_for(N);
  mxt::gemv(a.x, B, C, N, kq,
            [=](int n) {
              return n < Cl ? wq + (size_t)n * C
                   : n < Cl + KVC ? wk + (size_t)(n - Cl) * C
                                  : wv + (size_t)(n - Cl - KVC) * C;
            },
            [=](int b, int n, int s, float v) {
              qkv[((size_t)s * B + b) * N + n] = v;
            },
            smem);
  sync();

  // 2. split-key attention: each unit's chunk partials.  q, k and v are
  // the slices' sums in slice order + bias; the unit of a row's last chunk
  // appends the row's k and v at meta's (page, slot)
  auto qkv_at = [=](int b, int n) {
    float v = 0.f;
    for (int s = 0; s < kq; ++s)
      v += __ldcg(qkv + ((size_t)s * B + b) * N + n);
    return v;
  };
  auto q_at = [=](int b, int n) { return qkv_at(b, n) + bq[n]; };
  auto append = [=](int b, int kvh) {
    const size_t dst = (((size_t)kvh * P + meta[b]) * S + meta[B + b]) * D;
    for (int e = threadIdx.x; e < 2 * D; e += blockDim.x) {
      const int d = e < D ? e : e - D, c = kvh * D + d;
      if (e < D)
        kp[dst + d] = qkv_at(b, Cl + c) + bk[c];
      else
        vp[dst + d] = qkv_at(b, Cl + KVC + c) + bv[c];
    }
  };
  mxt::split_attend<E>(q_at, append, mxt::SplitF32{kp, vp}, a.tables,
                       a.lengths, B, a.KVH, g, P, S, a.pps, a.scale, po, pm,
                       pl, smem);
  sync();

  // 3. the chunks merged in chunk order
  mxt::split_merge(po, pm, pl, a.lengths, B, a.KVH, g, D, max_keys, att);
  sync();

  // 4. out-projection partial over the shard's Cl inputs, K split
  const int ks = mxt::ksplit_for(C);
  mxt::gemv(att, B, Cl, C, ks, [=](int n) { return wo + (size_t)n * Cl; },
            [=](int b, int n, int s, float v) {
              parts[((size_t)s * B + b) * C + n] = v;
            },
            smem);
  sync();

  // 5. o_part = the slices' sum, in order
  sum_slices(a.out, parts, ks, B * C);
  if (a.timing) sync();
}

// #14's GEMVs.  A unit is NWARPS consecutive output columns over one K
// slice, as in mxt::gemv.  The block's first unit (unit blockIdx.x) is
// "resident" when its weight rows fit their buffer and its input rows the
// stage: its rows are bulk-copied into shared memory at launch
// (FfnCopies), the math waits on the unit's mbarrier only when it reaches
// them, and reads both operands from shared memory on register tiles
// (ffn_tiles).  A block's later units, and units too large, stream their
// weight rows from global memory one warp a column, as mxt::gemv does.
//
// Rows in shared memory have a pitch of round32(width) + 4 floats: the 8
// rows (or 4) that a tile step loads land 16 bytes apart in the banks.
__device__ __forceinline__ int ffn_pitch(int width) {
  return ((width + 31) & ~31) + 4;
}

struct FfnUnits {
  int groups, ks, slice;  // column groups, K slices, columns per slice
  __device__ FfnUnits(int N, int K, int ks_)
      : groups((N + mxt::NWARPS - 1) / mxt::NWARPS), ks(ks_),
        slice((int)round4((K + ks_ - 1) / ks_)) {}
  __device__ int count() const { return groups * ks; }
  // the block's first unit, if its rows fit `cap` floats and its input
  // rows (at most GEMV_ROWS) the stage
  __device__ bool resident(int cap) const {
    const int p = ffn_pitch(slice);
    return (int)blockIdx.x < count() && mxt::NWARPS * p <= cap &&
           mxt::GEMV_ROWS * p <= FFN_STAGE_FLOATS;
  }
};

// The bulk copies of the block's resident unit of w (N rows of K) into
// buf, and, when x is given (B <= GEMV_ROWS rows of K), of x's rows for
// that slice into xbuf, all completing on one mbarrier.  Every thread
// computes the same plan; copy c is issued by thread first + c, so the
// copies go out in parallel.
struct FfnCopies {
  const float* w;
  const float* x;
  float* buf;
  float* xbuf;
  int K, n0, rows, k_lo, kc, xrows;
  __device__ FfnCopies(const FfnUnits& u, const float* w_, int N, int K_,
                       float* buf_, const float* x_, int B, float* xbuf_)
      : w(w_), x(x_), buf(buf_), xbuf(xbuf_), K(K_) {
    const int grp = blockIdx.x / u.ks, s = blockIdx.x - grp * u.ks;
    n0 = grp * mxt::NWARPS;
    rows = min(mxt::NWARPS, N - n0);
    k_lo = s * u.slice;
    kc = max(0, min(K, k_lo + u.slice) - k_lo);
    xrows = x != nullptr && B <= mxt::GEMV_ROWS ? B : 0;
  }
  __device__ uint32_t bytes() const {
    return (uint32_t)(rows + xrows) * kc * 4;
  }
  __device__ void issue(int first, uint64_t* bar) const {
    const int c = (int)threadIdx.x - first, p = ffn_pitch(kc);
    if (kc == 0 || c < 0 || c >= rows + xrows) return;
    if (c < rows)
      bulk_load(smem_u32(buf + (size_t)c * p),
                w + (size_t)(n0 + c) * K + k_lo, kc * 4, smem_u32(bar));
    else
      bulk_load(smem_u32(xbuf + (size_t)(c - rows) * p),
                x + (size_t)(c - rows) * K + k_lo, kc * 4, smem_u32(bar));
  }
};

// wait for the first phase of `bar` (the launch's bulk copies).  A copy
// that never lands (a wrong byte count) would hang the grid at its next
// barrier: after 2^22 polls (seconds) the launch traps instead.
__device__ __forceinline__ void wait_copies(uint32_t bar) {
  for (int i = 0; i < (1 << 22); ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
    if (done) return;
  }
  __trap();
}

// rows [0, nb) x columns [k0, k0 + kc) of in (row stride K) into st (row
// pitch p), several float4 loads in flight per thread
__device__ void ffn_stage(float* st, int p, const float* in, int nb, int K,
                          int k0, int kc) {
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

// The resident unit's products: epi(b, n, sum over k < kc of xs[b, k] *
// ws[n, k]) for b < nb, n < cols, xs and ws in shared memory at pitch p.
// Lane l of warp w holds rows l / 4 and l / 4 + 8 by weight rows l % 4 and
// l % 4 + 4 over the float4 columns w, w + 8, w + 16, ...: per step 4
// float4 loads (two of them broadcast) for 16 FMAs.  Then the 8 warps'
// partials, in warp order, through red (which may overlay xs).
template <class Epi>
__device__ void ffn_tiles(const float* ws, const float* xs, int p, int kc,
                          int nb, int cols, float* red, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* x0 = xs + (lane >> 2) * p;
  const float* x1 = x0 + 8 * p;
  const float* w0 = ws + (lane & 3) * p;
  const float* w1 = w0 + 4 * p;
  float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
  for (int f = warp * 4; f < kc; f += mxt::NWARPS * 4) {
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
  __syncthreads();  // every warp is done with xs
  reinterpret_cast<float4*>(red)[threadIdx.x] =
      make_float4(a00, a01, a10, a11);
  __syncthreads();
  const int t = threadIdx.x;
  if (t < mxt::GEMV_ROWS * mxt::NWARPS) {
    const int b = t / mxt::NWARPS, n = t - b * mxt::NWARPS;
    const int tl = (b & 7) * 4 + (n & 3), e = (b >> 3) * 2 + (n >> 2);
    float v = 0.f;
    for (int w = 0; w < mxt::NWARPS; ++w) v += red[(w * 32 + tl) * 4 + e];
    if (b < nb && n < cols) epi(b, n, v);
  }
}

// acc[r] += sum over kk < kc of w(kk) * stage[r * p + kk], r < nb: this
// lane's columns lane * 4 + 128 j, GEMV_LOADS weight float4s in flight
__device__ __forceinline__ void ffn_dot(const float* wg, const float* stage,
                                        int p, int kc, int nb, int lane,
                                        float (&acc)[mxt::GEMV_ROWS]) {
  constexpr int L = mxt::GEMV_LOADS;
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
        for (int r = 0; r < mxt::GEMV_ROWS; ++r) {
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
// 1, columns k0.. k0 + kc - 1 of the input into stage at pitch p.  The
// block's first unit reads its weight rows from w_res (null: not
// resident) once bar completes, and, when x_res, its input from the
// stage, which the same copies filled.  With `landed`, each block raises
// it to the time its copies landed.  Each output's FMA order is fixed.
template <class Row, class StageIn, class Epi>
__device__ void ffn_gemv(const FfnUnits& u, int B, int K, int N, Row row,
                         StageIn stage_in, Epi epi, float* stage,
                         const float* w_res, bool x_res, uint64_t* bar,
                         unsigned long long* landed) {
  for (int unit = blockIdx.x; unit < u.count(); unit += gridDim.x) {
    const int grp = unit / u.ks, s = unit - grp * u.ks;
    const int n0 = grp * mxt::NWARPS;
    const int k_lo = s * u.slice, k_hi = min(K, k_lo + u.slice);
    if (w_res != nullptr && unit == (int)blockIdx.x) {
      const int kc = max(0, k_hi - k_lo), p = ffn_pitch(kc);
      for (int b0 = 0; b0 < B; b0 += mxt::GEMV_ROWS) {
        const int nb = min(mxt::GEMV_ROWS, B - b0);
        if (!x_res) {
          __syncthreads();
          stage_in(stage, p, b0, nb, k_lo, kc);
          __syncthreads();
        }
        wait_copies(smem_u32(bar));
        if (landed != nullptr && threadIdx.x == 0)
          atomicMax(landed, (unsigned long long)globaltimer());
        ffn_tiles(w_res, stage, p, kc, nb, N - n0, stage,
                  [&](int b, int c, float v) { epi(b0 + b, n0 + c, s, v); });
      }
      continue;
    }
    // not resident: one warp a column, its weight row streamed
    const int lane = threadIdx.x & 31, n = n0 + (int)(threadIdx.x >> 5);
    const bool has = n < N;
    const float* wg = has ? row(n) : nullptr;
    for (int b0 = 0; b0 < B; b0 += mxt::GEMV_ROWS) {
      const int nb = min(mxt::GEMV_ROWS, B - b0);
      const int kc_max = (FFN_STAGE_FLOATS / nb - 36) & ~31;
      float acc[mxt::GEMV_ROWS];
#pragma unroll
      for (int r = 0; r < mxt::GEMV_ROWS; ++r) acc[r] = 0.f;
      for (int k0 = k_lo; k0 < k_hi; k0 += kc_max) {
        const int kc = min(kc_max, k_hi - k0), p = ffn_pitch(kc);
        __syncthreads();
        stage_in(stage, p, b0, nb, k0, kc);
        __syncthreads();
        if (has) ffn_dot(wg + k0, stage, p, kc, nb, lane, acc);
      }
      if (has) {
#pragma unroll
        for (int r = 0; r < mxt::GEMV_ROWS; ++r) {
          if (r < nb) {
            const float v = mxt::warp_sum(acc[r]);
            if (lane == 0) epi(b0 + r, n, s, v);
          }
        }
      }
    }
  }
  __syncthreads();  // the stage buffer is free for the next GEMV
}

__global__ void __launch_bounds__(NTHREADS, 3) ffn_phase_kernel(FfnArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  // stamps as in attn_phase_kernel, but for the first phase: "copies"
  // ends when the last block's FFN1 rows have landed (each block raises
  // timing[1] to its landing time), and FFN1 follows it
  const bool stamp = a.timing != nullptr && blockIdx.x == 0 &&
                     threadIdx.x == 0;
  int n_stamp = 2;
  if (stamp) {
    a.timing[0] = globaltimer();
    atomicMax(reinterpret_cast<unsigned long long*>(a.timing + 1),
              (unsigned long long)a.timing[0]);
  }
  auto sync = [&]() {
    grid.sync();
    if (stamp) a.timing[n_stamp++] = globaltimer();
  };
  const int B = a.B, C = a.C, Fl = a.Fl;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* w1s = smem + FFN_BAR_FLOATS;
  float* w2s = w1s + FFN_W1_FLOATS;
  float* stage = w2s + FFN_W2_FLOATS;
  float* hparts = a.scratch;
  float* hbuf = hparts + (size_t)KSPLIT_MAX * B * Fl;
  float* parts = hbuf + (size_t)B * Fl;
  const float *x = a.x, *w1 = a.w1, *b1 = a.b1, *w2 = a.w2;
  const FfnUnits u1(Fl, C, mxt::ksplit_for(Fl));
  const FfnUnits u2(C, Fl, mxt::ksplit_for(C));
  const bool r1 = u1.resident(FFN_W1_FLOATS);
  const bool r2 = u2.resident(FFN_W2_FLOATS);

  // 0. the block's resident weight rows (and FFN1's input rows) on their
  // way into shared memory before any math: thread 0 sets up the barriers
  // and the bytes each expects, then the copies go out from as many
  // threads
  const FfnCopies c1(u1, w1, Fl, C, w1s, x, B, stage);
  const FfnCopies c2(u2, w2, C, Fl, w2s, nullptr, 0, nullptr);
  if (threadIdx.x == 0) {
    mbar_init(smem_u32(bars), 1);
    mbar_init(smem_u32(bars + 1), 1);
    mbar_fence_init();
    if (r1) mbar_expect_tx(smem_u32(bars), c1.bytes());
    if (r2) mbar_expect_tx(smem_u32(bars + 1), c2.bytes());
  }
  __syncthreads();
  if (r1) c1.issue(0, bars);
  if (r2) c2.issue(NTHREADS / 2, bars + 1);
  const bool x_res = r1 && c1.xrows > 0;

  // 1. FFN1 partials over K slices: hparts[s, b, n]
  ffn_gemv(u1, B, C, Fl, [=](int n) { return w1 + (size_t)n * C; },
           [=](float* st, int p, int b0, int nb, int k0, int kc) {
             ffn_stage(st, p, x + (size_t)b0 * C, nb, C, k0, kc);
           },
           [=](int b, int n, int s, float v) {
             hparts[((size_t)s * B + b) * Fl + n] = v;
           },
           stage, r1 ? w1s : nullptr, x_res, bars,
           a.timing ? reinterpret_cast<unsigned long long*>(a.timing + 1)
                    : nullptr);
  sync();

  // 2. h = gelu_erf(the FFN1 slices' sum in slice order + b1), once per
  // element
  const int ks1 = u1.ks;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < B * Fl / 4;
       e += gridDim.x * blockDim.x) {
    const int k = (e * 4) % Fl;
    const float* p = hparts + (size_t)e * 4;
    const float4 bv = __ldg(reinterpret_cast<const float4*>(b1 + k));
    // the slices in groups of 4 loads in flight, added in slice order
    float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < ks1; s0 += 4) {
      float4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (s0 + j < ks1)
          v[j] = __ldcg(reinterpret_cast<const float4*>(
              p + (size_t)(s0 + j) * B * Fl));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (s0 + j < ks1) {
          h.x += v[j].x;
          h.y += v[j].y;
          h.z += v[j].z;
          h.w += v[j].w;
        }
      }
    }
    reinterpret_cast<float4*>(hbuf)[e] =
        make_float4(mxt::gelu_erf(h.x + bv.x), mxt::gelu_erf(h.y + bv.y),
                    mxt::gelu_erf(h.z + bv.z), mxt::gelu_erf(h.w + bv.w));
  }
  sync();

  // 3. FFN2 over the shard's Fl inputs
  ffn_gemv(u2, B, Fl, C, [=](int n) { return w2 + (size_t)n * Fl; },
           [=](float* st, int p, int b0, int nb, int k0, int kc) {
             ffn_stage(st, p, hbuf + (size_t)b0 * Fl, nb, Fl, k0, kc);
           },
           [=](int b, int n, int s, float v) {
             parts[((size_t)s * B + b) * C + n] = v;
           },
           stage, r2 ? w2s : nullptr, false, bars + 1, nullptr);
  sync();

  // 4. f_part = the slices' sum, in order
  sum_slices(a.out, parts, u2.ks, B * C);
  if (a.timing) sync();
}

using AttnKernel = void (*)(AttnArgs);

// the attention phase kernel of head dim D (32, 64 or 128)
AttnKernel attn_kernel(int D) {
  return D == 32 ? attn_phase_kernel<1>
       : D == 64 ? attn_phase_kernel<2> : attn_phase_kernel<4>;
}

cudaError_t attn_geometry(int g, int D, int* grid, size_t* smem) {
  return mxt::coop_geometry(
      attn_kernel(D),
      std::max(mxt::STAGE_FLOATS, mxt::split_smem_floats(g, D)), grid, smem);
}

cudaError_t ffn_geometry(int* grid, size_t* smem) {
  return mxt::coop_geometry(ffn_phase_kernel, FFN_SMEM_FLOATS, grid, smem);
}

cudaError_t launch(const void* kernel, int grid, size_t smem, void* args,
                   void* stream) {
  void* params[] = {args};
  cudaError_t e = cudaLaunchCooperativeKernel(kernel, grid, NTHREADS, params,
                                              smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* mxt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Phases of the attention and the FFN phase kernel that timing stamps.
extern "C" int mxt_decode_attn_phases() { return ATTN_PHASES; }
extern "C" int mxt_decode_ffn_phases() { return FFN_PHASES; }

// Blocks each phase kernel launches with (for the caller's records).
extern "C" int mxt_decode_phase_grid(int g, int D, int* attn_grid,
                                     int* ffn_grid) {
  size_t smem = 0;
  cudaError_t e = attn_geometry(g, D, attn_grid, &smem);
  if (e != cudaSuccess) return (int)e;
  return (int)ffn_geometry(ffn_grid, &smem);
}

// Floats of device scratch one launch needs: the attention phase with
// Cl = H D query columns, KVC = KVH D key columns and rows of at most
// max_keys = pps S keys (ffn: Cl = Fl, the rest ignored).
extern "C" long long mxt_decode_phase_scratch(int ffn, int B, int C, int Cl,
                                              int KVC, int D, int max_keys) {
  return (long long)(ffn ? ffn_scratch_floats(B, C, Cl)
                         : attn_scratch_floats(B, C, Cl, KVC, D, max_keys));
}

// x (B, C); kp/vp (KVH, P, S, D); wq (H D, C), wk/wv (KVH D, C), biases;
// wo (C, H D); meta (2, B), tables (B, pps), lengths (B,) int32; scratch of
// mxt_decode_phase_scratch floats; out (B, C); timing null, or
// mxt_decode_attn_phases() + 1 int64 that block 0 fills with %globaltimer
// stamps (the start, then the end of each phase).  C must be a multiple of
// 4 and D 32, 64 or 128.
extern "C" int mxt_decode_attn_phase(const void* x, void* kp, void* vp,
                                     const void* wq, const void* bq,
                                     const void* wk, const void* bk,
                                     const void* wv, const void* bv,
                                     const void* wo, const void* meta,
                                     const void* tables, const void* lengths,
                                     void* scratch, void* out, void* timing,
                                     int B, int C, int H, int KVH, int D,
                                     int P, int S, int pps, float scale,
                                     void* stream) {
  if (D != 32 && D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  int grid = 0;
  size_t smem = 0;
  cudaError_t e = attn_geometry(H / KVH, D, &grid, &smem);
  if (e != cudaSuccess) return (int)e;
  AttnArgs a;
  a.x = (const float*)x;
  a.kp = (float*)kp;
  a.vp = (float*)vp;
  a.wq = (const float*)wq;
  a.bq = (const float*)bq;
  a.wk = (const float*)wk;
  a.bk = (const float*)bk;
  a.wv = (const float*)wv;
  a.bv = (const float*)bv;
  a.wo = (const float*)wo;
  a.meta = (const int*)meta;
  a.tables = (const int*)tables;
  a.lengths = (const int*)lengths;
  a.scratch = (float*)scratch;
  a.out = (float*)out;
  a.timing = (long long*)timing;
  a.B = B; a.C = C; a.H = H; a.KVH = KVH; a.D = D;
  a.P = P; a.S = S; a.pps = pps;
  a.scale = scale;
  return (int)launch((const void*)attn_kernel(D), grid, smem, &a, stream);
}

// x (B, C); w1 (Fl, C), b1 (Fl,); w2 (C, Fl); scratch of
// mxt_decode_phase_scratch floats; out (B, C); timing null, or
// mxt_decode_ffn_phases() + 1 int64 stamps as mxt_decode_attn_phase's.  C
// and Fl must be multiples of 4.
extern "C" int mxt_decode_ffn_phase(const void* x, const void* w1,
                                    const void* b1, const void* w2,
                                    void* scratch, void* out, void* timing,
                                    int B, int C, int Fl, void* stream) {
  int grid = 0;
  size_t smem = 0;
  cudaError_t e = ffn_geometry(&grid, &smem);
  if (e != cudaSuccess) return (int)e;
  FfnArgs a;
  a.x = (const float*)x;
  a.w1 = (const float*)w1;
  a.b1 = (const float*)b1;
  a.w2 = (const float*)w2;
  a.scratch = (float*)scratch;
  a.out = (float*)out;
  a.timing = (long long*)timing;
  a.B = B; a.C = C; a.Fl = Fl;
  return (int)launch((const void*)ffn_phase_kernel, grid, smem, &a, stream);
}
