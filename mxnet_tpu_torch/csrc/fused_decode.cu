// Fused decode layer group: every decoder layer of one group, for the
// whole decode batch, in ONE cooperative persistent kernel launch.
// Wrapped by mxnet_tpu_torch/ops/kernels/fused_cell.py:decode_layer_group.
//
// Replaces the TPU kernel _decode_group_kernel
// (mxnet_tpu/ops/pallas/fused_cell.py:341, launched by decode_layer_group
// at :438).  It keeps that kernel's contract: one launch per layer group,
// KV pages updated in place, and activations that never go back to the
// host between layers.
//
// The TPU kernel runs one grid step per layer in order on one core and
// carries the activations in VMEM.  Here the grid is one persistent set
// of blocks, all resident at once (cooperative launch, sized from the
// occupancy calculator), which loops over the group's layers; the phases
// of a layer are separated by grid-wide barriers
// (cooperative_groups::this_grid().sync()):
//   1. qkv projections (B rows x (C + 2 KVC) outputs) + bias
//   2. split-key paged attention (decode_common.cuh:split_attend): one
//      unit per (sequence, KV head, chunk of 64 keys), each writing its
//      chunk's running max, sum and unnormalised output; the unit of a
//      row's last chunk first writes the row's k and v into the page slot
//      meta names (the KV append), then reads them back through the table
//      like every key.  Rows of length 0 have no unit and append nothing
//   3. the chunks of each (sequence, head) merged in chunk order
//      (split_merge) into the attention output
//   4. out-projection, as partial sums over slices of K
//   5. residual + bias + the partial sums, LayerNorm per row
//   6. FFN1 + bias + erf GELU
//   7. FFN2, as partial sums over slices of K
//   8. residual + bias + the partial sums, LayerNorm per row
// The (B, C) and (B, F) activations live in one small device scratch
// buffer that stays in the 50 MB L2 between phases, in place of the
// TPU's VMEM carry (fused_cell.py:358-366).  One kernel per head dim
// that is a multiple of 16 up to 128 (MXT_SPLIT_HEAD_DIMS, FULL: D a
// compile-time constant; a runtime D cost D 64 ~15% in the A/B of
// PERF.md section 6, PR 23), and one per class of the other multiples of
// 8 up to 256 (MXT_SPLIT_CLASSES, D a runtime value, split_class), so
// each carries one attention path under the register budget of three
// blocks an SM (one at 256).
//
// Bound on the card: bytes.  At full width (C 768, F 3072, B 16) a layer
// reads 4 C^2 + 2 C F fp32 weights = 28.3 MB and does 2 B flops per
// weight (8 flops per 4 bytes, against ~20 flops per byte the card can
// sustain in fp32 outside the tensor cores), plus the KV pages its rows'
// lengths name, so the 12-layer step is bounded by 340 MB of weights over
// the card's 3.35 TB/s.  No weight depends on the activations, so the
// weight stream need not wait for the grid barriers: each GEMV's unit of
// work (8 output columns over one K slice, one a block) has its weight
// rows bulk-copied (TMA, one 1-D copy a row: decode_common.cuh:FfnCopies)
// into one of two shared-memory buffers as soon as that buffer is free,
// and the math waits on the buffer's mbarrier only when it starts.  The
// four GEMVs alternate between the buffers (qkv and FFN1 in the first,
// the out-projection and FFN2 in the second), so each copy is issued when
// the GEMV two before it has finished with the buffer and streams under
// the phases between: the out-projection's rows under LN2, qkv and
// attention; FFN1's under attention, the out-projection and LN1; FFN2's
// under LN1 and FFN1; layer l + 1's qkv rows under layer l's FFN2 and
// LN2; layer 0's qkv and out-projection rows from the launch on.  Each
// buffer's mbarrier is reused, one phase per copy: every thread tracks
// its parity and thread 0 re-arms it (expect_tx) before each copy, after
// a block barrier and an async-proxy fence that order the threads' reads
// of the buffer before the copy's writes.  The math runs from shared
// memory on register tiles (ffn_tiles: 2 rows by 2 weight rows a lane,
// the K columns over the warps).  The activations (x, att, h), written by
// other blocks in the same launch, are staged with ordinary loads after
// the barrier, never by bulk copy (the async proxy is not ordered after
// other blocks' stores by grid.sync()).
//
// Shared memory, at full width: two weight buffers of 8 rows of up to 768
// columns (24.7 KB each) and a stage of 16 rows of 384 columns (24.8 KB),
// 72.5 KB a block, three blocks an SM (396 blocks on 132 SMs).  Every
// GEMV's units then number at most the blocks (qkv 288 column groups of
// K 768; the out-projection 96 groups over 4 K slices of 192; FFN1 384
// groups of K 768; FFN2 96 groups over 4 slices of 768), so every unit is
// resident.  Two 24.7 KB buffers and a 49 KB stage for a whole K row of
// 768 would not fit three blocks an SM, and two blocks an SM (264 blocks)
// would leave units without a block; so the input rows are staged in
// chunks of 384 columns, two chunks for a K of 768, the register tiles
// adding up across them in the order of one pass.  qkv and FFN1 stay
// unsplit over K (so q, k, v and h are written whole, with their bias, by
// the unit that computes them) and the out-projection and FFN2 are split
// over K as ksplit_for chooses, summed in slice order by the LayerNorm
// phase that follows.  A unit whose rows do not fit a buffer (K slices
// over 768 columns: wider models) and a block's second unit (a grid
// smaller than a GEMV's units) stream their weight rows from device
// memory one warp a column, as the tensor-parallel phases' GEMVs do.  The
// attention units and the LayerNorm use the stage (its size covers
// split_smem_floats(g, D) and a row of C), never a weight buffer, which
// may be receiving rows.
//
// Why: the parent design streamed each GEMV's weights one warp a column
// only after the barrier that opened the phase, and gave each (row, KV
// head) to one block, which walked the whole row: the longest row set the
// attention phase's pace.  What the stamps of this design show (PERF.md,
// section 6): a bulk copy's issue returns only once its bytes have been
// requested, so the phase that issues a GEMV's 9.4 MB carries ~3 us of
// it, and the weights share the L2-to-SM path with the staging of the
// inputs, which every block of a GEMV reads whole (8 columns a unit: 16
// input rows per 8 weight rows).  Measured slower or no faster, so not
// kept: the copies issued by a producer warp outside a grid barrier of
// the compute threads (the phases the copies overlap slow down as much as
// the issuing phases speed up, and 72 registers spill more); issued in
// the merge and LayerNorm phases, where most blocks idle (those phases
// grow by the same ~3 us); one packed copy a unit over unpadded rows; the
// next attention unit's key and value lines prefetched into L2; and one
// weight buffer at four blocks an SM.  All sums run in a fixed order and
// no atomic decides a result: the output does not depend on timing.
#include "decode_common.cuh"

namespace cg = cooperative_groups;

namespace {

using mxt::FfnCopies;
using mxt::FfnUnits;
using mxt::KSPLIT_MAX;
using mxt::NTHREADS;
using mxt::NWARPS;
using mxt::round4;
constexpr int NW = 16;               // weight pointers per layer
// the phases of a layer, each closed by a grid barrier, and its GEMVs
constexpr int PHASES = 8;
constexpr int GEMVS = 4;
// shared memory: two mbarriers, two weight buffers of 8 rows of up to 768
// columns, then the stage (at least 16 rows of 384 columns)
constexpr int BAR_FLOATS = 4;
constexpr int W_FLOATS = NWARPS * (768 + 4);
constexpr int STAGE_MIN = mxt::GEMV_ROWS * (384 + 4);

struct Args {
  float* x;              // (B, C) activations, updated in place
  float* kp;             // (Lg, KVH, P, S, D) this group's key pages
  float* vp;             // (Lg, KVH, P, S, D) this group's value pages
  const float* const* w; // (Lg, NW) weight pointers: wq bq wk bk wv bv wo
                         // bo w1 b1 w2 b2 ln1g ln1b ln2g ln2b
  const int* meta;       // (2, B): write page, write slot
  const int* tables;     // (B, pps) page tables
  const int* lengths;    // (B,) valid keys after this step's append
  float* scratch;        // scratch_floats(...) floats
  long long* timing;     // null, or 1 + 2 Lg (PHASES + GEMVS) slots
  int B, C, F, H, KVH, D, P, S, pps, Lg, stage_floats;
  float scale;
};

// scratch layout: qkv (B, C + 2 KVC) | att (B, C) | h (B, F) | parts
// (KSPLIT_MAX, B, C) | the split attention's per-unit partials: outputs
// (U, g D), maxima (U, g), sums (U, g), U = split_units_max; every piece
// starts 16-byte aligned
__host__ __device__ inline size_t scratch_floats(int B, int C, int F, int H,
                                                 int KVH, int D,
                                                 int max_keys) {
  const int KVC = KVH * D, g = H / KVH;
  const size_t U = mxt::split_units_max(B, KVH, max_keys);
  return round4((size_t)B * (C + 2 * KVC)) + round4((size_t)B * C) +
         round4((size_t)B * F) + (size_t)KSPLIT_MAX * B * C +
         round4(U * g * D) + 2 * round4(U * g);
}

__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = mxt::warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < NWARPS ? red[lane] : 0.f;
    t = mxt::warp_sum(t);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

// x[b] = LN(x[b] + (sum_s parts[s, b] + bias)) * gamma + beta, eps 1e-5,
// one block per row; the partial sums are added in slice order.  The row
// is read once into shared memory (C + 64 floats of smem).
__device__ void residual_layer_norm(float* x, const float* parts, int ks,
                                    const float* bias, const float* gamma,
                                    const float* beta, int B, int C,
                                    float* smem) {
  float* red = smem;
  float* yrow = smem + 64;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    float* xr = x + (size_t)b * C;
    float sum = 0.f;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float p = 0.f;
      for (int s = 0; s < ks; ++s)
        p += __ldcg(parts + ((size_t)s * B + b) * C + c);
      yrow[c] = __ldcg(xr + c) + (p + bias[c]);
      sum += yrow[c];
    }
    const float mu = block_sum(sum, red) / C;
    float var = 0.f;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const float d = yrow[c] - mu;
      var += d * d;
    }
    const float inv = rsqrtf(block_sum(var, red) / C + 1e-5f);
    for (int c = threadIdx.x; c < C; c += blockDim.x)
      xr[c] = (yrow[c] - mu) * inv * gamma[c] + beta[c];
  }
}

using mxt::globaltimer;

template <int DI, bool FULL>
__global__ void __launch_bounds__(NTHREADS, mxt::split_min_blocks<DI>(3))
    fused_decode_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int B = a.B, C = a.C, F = a.F, S = a.S, P = a.P, Lg = a.Lg;
  const int D = FULL ? DI : a.D;
  // with a timing buffer: block 0 stamps the start and the end of every
  // phase (right after the grid barrier that closes it); every block
  // raises a slot per phase to the time it reached that barrier (the
  // last block's arrival: the barrier's own cost is the end less it);
  // per layer and GEMV each block with a resident unit raises a slot to
  // the time its copies had landed, and each block adds the units it
  // streamed to another
  long long* const timing = a.timing;
  const bool stamp = timing != nullptr && blockIdx.x == 0 &&
                     threadIdx.x == 0;
  int phase = 0;
  if (stamp) timing[0] = globaltimer();
  auto sync = [&]() {
    if (timing != nullptr) {
      __syncthreads();
      if (threadIdx.x == 0)
        atomicMax(reinterpret_cast<unsigned long long*>(
                      timing + 1 + Lg * PHASES + phase),
                  (unsigned long long)globaltimer());
    }
    grid.sync();
    ++phase;
    if (stamp) timing[phase] = globaltimer();
  };
  const int KVH = a.KVH, KVC = KVH * D, N = C + 2 * KVC, g = a.H / KVH;
  const int max_keys = a.pps * S;
  const size_t layer_pages = (size_t)KVH * P * S * D;
  const size_t U = mxt::split_units_max(B, KVH, max_keys);
  float* x = a.x;
  float* qkv = a.scratch;
  float* att = qkv + round4((size_t)B * N);
  float* hbuf = att + round4((size_t)B * C);
  float* parts = hbuf + round4((size_t)B * F);
  float* po = parts + (size_t)KSPLIT_MAX * B * C;
  float* pm = po + round4(U * g * D);
  float* pl = pm + round4(U * g);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* wbuf = smem + BAR_FLOATS;       // buffer b at wbuf + b * W_FLOATS
  float* stage = wbuf + 2 * W_FLOATS;
  const int ks = mxt::ksplit_for(C);

  // GEMV j of a layer: 0 qkv, 1 out-projection, 2 FFN1, 3 FFN2, copied
  // into buffer j % 2; its outputs, inputs, K slices and weight row n
  auto gemv_n = [=](int j) { return j == 0 ? N : j == 2 ? F : C; };
  auto gemv_k = [=](int j) { return j == 3 ? F : C; };
  auto units = [=](int j) {
    return FfnUnits(gemv_n(j), gemv_k(j), (j & 1) ? ks : 1);
  };
  const float* const* wt = a.w;
  auto wrow = [=](int l, int j, int n) -> const float* {
    const float* const* w = wt + (size_t)l * NW;
    switch (j) {
      case 0:
        return n < C         ? w[0] + (size_t)n * C
               : n < C + KVC ? w[2] + (size_t)(n - C) * C
                             : w[4] + (size_t)(n - C - KVC) * C;
      case 1: return w[6] + (size_t)n * C;
      case 2: return w[8] + (size_t)n * C;
      default: return w[10] + (size_t)n * F;
    }
  };
  // bit b: the parity of the phase of buffer b's mbarrier to wait for
  uint32_t parity = 0;

  // the block's resident rows of GEMV j of layer l on their way into
  // buffer j % 2, which every thread has finished reading
  auto issue = [&](int l, int j) {
    const FfnUnits u = units(j);
    if (l >= Lg || !u.resident(W_FLOATS)) return;
    uint64_t* bar = bars + (j & 1);
    const FfnCopies c(u, gemv_n(j), gemv_k(j), wbuf + (j & 1) * W_FLOATS,
                      nullptr, 0, nullptr);
    fence_async_shared();  // this thread's reads before the copies' writes
    __syncthreads();
    if (threadIdx.x == 0) mbar_expect_tx(smem_u32(bar), c.bytes());
    __syncthreads();
    c.issue(0, bar, [=](int n) { return wrow(l, j, n); });
  };
  // GEMV j of layer l on in (B, K): epi(b, n, s, the sum over slice s)
  auto gemv = [&](int l, int j, const float* in, auto epi) {
    const FfnUnits u = units(j);
    const int K = gemv_k(j), b = j & 1;
    const bool res = u.resident(W_FLOATS);
    if (timing != nullptr && threadIdx.x == 0) {
      const int taken = u.count() > (int)blockIdx.x
                            ? (u.count() - 1 - (int)blockIdx.x) /
                                      (int)gridDim.x + 1
                            : 0;
      if (taken > (int)res)
        atomicAdd(reinterpret_cast<unsigned long long*>(
                      timing + 1 + Lg * (2 * PHASES + GEMVS) + l * GEMVS + j),
                  (unsigned long long)(taken - (int)res));
    }
    mxt::ffn_gemv(
        u, B, K, gemv_n(j), [=](int n) { return wrow(l, j, n); },
        [=](float* st, int p, int b0, int nb, int k0, int kc) {
          mxt::ffn_stage(st, p, in + (size_t)b0 * K, nb, K, k0, kc);
        },
        epi, stage, a.stage_floats, res ? wbuf + b * W_FLOATS : nullptr,
        false, smem_u32(bars + b), (parity >> b) & 1u,
        timing ? reinterpret_cast<unsigned long long*>(
                     timing + 1 + 2 * Lg * PHASES + l * GEMVS + j)
               : nullptr);
    if (res) parity ^= 1u << b;
  };
  auto part = [=](int b, int n, int s, float v) {
    parts[((size_t)s * B + b) * C + n] = v;
  };

  // layer 0's qkv and out-projection rows on their way at launch
  if (threadIdx.x == 0) {
    mbar_init(smem_u32(bars), 1);
    mbar_init(smem_u32(bars + 1), 1);
    mbar_fence_init();
  }
  __syncthreads();
  issue(0, 0);
  issue(0, 1);

  for (int l = 0; l < Lg; ++l) {
    const float* const* w = wt + (size_t)l * NW;
    const float *bq = w[1], *bk = w[3], *bv = w[5], *b1 = w[9];
    float* kp = a.kp + (size_t)l * layer_pages;
    float* vp = a.vp + (size_t)l * layer_pages;

    // 1. qkv + bias; then FFN1's rows into the freed buffer
    gemv(l, 0, x, [=](int b, int n, int, float v) {
      const float bias = n < C         ? bq[n]
                         : n < C + KVC ? bk[n - C]
                                       : bv[n - C - KVC];
      qkv[(size_t)b * N + n] = v + bias;
    });
    issue(l, 2);
    sync();

    // 2. split-key attention units; the unit of a row's last chunk
    // appends the row's k and v at meta's (page, slot)
    const int* meta = a.meta;
    auto q_at = [=](int b, int c) {
      return __ldcg(qkv + (size_t)b * N + c);
    };
    auto append = [=](int b, int kvh) {
      const size_t dst =
          (((size_t)kvh * P + __ldg(meta + b)) * S + __ldg(meta + B + b)) * D;
      const float* src = qkv + (size_t)b * N + C + (size_t)kvh * D;
      for (int e = threadIdx.x; e < 2 * D; e += blockDim.x) {
        if (e < D)
          kp[dst + e] = __ldcg(src + e);
        else
          vp[dst + e - D] = __ldcg(src + KVC + e - D);
      }
    };
    mxt::split_attend<DI>(q_at, append, mxt::SplitF32{kp, vp}, a.tables,
                          a.lengths, B, KVH, g, D, P, S, a.pps, a.scale, po,
                          pm, pl, stage);
    sync();

    // 3. the chunks merged in chunk order
    mxt::split_merge(po, pm, pl, a.lengths, B, KVH, g, D, max_keys, att);
    sync();

    // 4. out-projection, partial sums over K slices; then FFN2's rows
    gemv(l, 1, att, part);
    issue(l, 3);
    sync();

    // 5. residual + bias, LayerNorm
    residual_layer_norm(x, parts, ks, w[7], w[12], w[13], B, C, stage);
    sync();

    // 6. FFN1 + bias + erf GELU; then the next layer's qkv rows
    gemv(l, 2, x, [=](int b, int n, int, float v) {
      hbuf[(size_t)b * F + n] = mxt::gelu_erf(v + b1[n]);
    });
    issue(l + 1, 0);
    sync();

    // 7. FFN2, partial sums over K slices; then the next layer's
    // out-projection rows
    gemv(l, 3, hbuf, part);
    issue(l + 1, 1);
    sync();

    // 8. residual + bias, LayerNorm: the next layer's input
    residual_layer_norm(x, parts, ks, w[11], w[14], w[15], B, C, stage);
    if (l + 1 < Lg || timing != nullptr) sync();
  }
}

using Kernel = void (*)(Args);

// the kernel of head dim D (a multiple of 8 in [8, 256]: its own, or its
// class's), or null
Kernel kernel_for(int D) {
  switch (D) {
#define MXT_KERNEL(d) \
  case d:             \
    return fused_decode_kernel<d, true>;
    MXT_SPLIT_HEAD_DIMS(MXT_KERNEL)
#undef MXT_KERNEL
  }
  switch (mxt::split_class(D)) {
#define MXT_KERNEL(d) \
  case d:             \
    return fused_decode_kernel<d, false>;
    MXT_SPLIT_CLASSES(MXT_KERNEL)
#undef MXT_KERNEL
  }
  return nullptr;
}

// floats of the stage: 16 rows of 384 columns, the split attention's
// per-warp rows, a LayerNorm row (C + 64) and the tiles' warp partials
int stage_floats(int C, int g, int D) {
  return std::max({STAGE_MIN, mxt::split_smem_floats(g, D), C + 64,
                   4 * NTHREADS});
}

// Launch geometry: fills the grid size (all blocks resident at once) and
// the dynamic shared memory in bytes.  The carveout asks for the most
// shared memory an SM has, which three blocks of 72.5 KB need.
cudaError_t geometry(int C, int g, int D, int* grid, size_t* smem) {
  const Kernel k = kernel_for(D);
  if (k == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  return mxt::coop_geometry(
      k, BAR_FLOATS + 2 * W_FLOATS + stage_floats(C, g, D), grid, smem);
}

}  // namespace

extern "C" const char* mxt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Phases of a layer that timing stamps, and GEMVs whose landings it
// stamps.
extern "C" int mxt_decode_layer_group_phases() { return PHASES; }
extern "C" int mxt_decode_layer_group_gemvs() { return GEMVS; }

// Blocks the fused kernel launches with (for the caller's records).
extern "C" int mxt_decode_layer_group_grid(int C, int H, int KVH, int D,
                                           int* grid) {
  size_t smem = 0;
  return (int)geometry(C, H / KVH, D, grid, &smem);
}

// Floats of device scratch one launch needs, for rows of at most max_keys
// = pps S keys.
extern "C" long long mxt_decode_layer_group_scratch(int B, int C, int F,
                                                    int H, int KVH, int D,
                                                    int max_keys) {
  return (long long)scratch_floats(B, C, F, H, KVH, D, max_keys);
}

// x (B, C); kp/vp (Lg, KVH, P, S, D); w (Lg, 16) device pointers to
// 16-byte aligned weights; meta (2, B), tables (B, pps), lengths (B,)
// int32; scratch of mxt_decode_layer_group_scratch floats; timing null
// or 1 + 2 Lg (phases + gemvs) int64, zeroed, which the launch fills:
// %globaltimer stamps of the start and the end of each phase (block 0),
// when the last block reached each phase's closing barrier, then per
// layer and GEMV when the last block's weight rows had landed (0: no
// block had its rows copied), then per layer and GEMV the units whose
// weight rows were streamed from device memory.  C and F must be
// multiples of 4, D a multiple of 8 in [8, 256] and B at least 1.
extern "C" int mxt_decode_layer_group(void* x, void* kp, void* vp,
                                      const void* w, const void* meta,
                                      const void* tables, const void* lengths,
                                      void* scratch, void* timing, int B,
                                      int C, int F, int H, int KVH, int D,
                                      int P, int S, int pps, int Lg,
                                      float scale, void* stream) {
  if (kernel_for(D) == nullptr || B < 1) return (int)cudaErrorInvalidValue;
  int grid = 0;
  size_t smem = 0;
  cudaError_t e = geometry(C, H / KVH, D, &grid, &smem);
  if (e != cudaSuccess) return (int)e;
  Args a;
  a.x = (float*)x;
  a.kp = (float*)kp;
  a.vp = (float*)vp;
  a.w = (const float* const*)w;
  a.meta = (const int*)meta;
  a.tables = (const int*)tables;
  a.lengths = (const int*)lengths;
  a.scratch = (float*)scratch;
  a.timing = (long long*)timing;
  a.B = B; a.C = C; a.F = F; a.H = H; a.KVH = KVH; a.D = D;
  a.P = P; a.S = S; a.pps = pps; a.Lg = Lg;
  a.stage_floats = stage_floats(C, H / KVH, D);
  a.scale = scale;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)kernel_for(D), grid, NTHREADS,
                                  params, smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
