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
//   2. KV append at meta's (page, slot), then paged attention per
//      (sequence, KV head) through attend_group of paged_attention.cuh
//   3. out-projection, as partial sums over slices of K
//   4. residual + bias + the partial sums, LayerNorm per row
//   5. FFN1 + bias + erf GELU
//   6. FFN2, as partial sums over slices of K
//   7. residual + bias + the partial sums, LayerNorm per row
// The (B, C) and (B, F) activations live in one small device scratch
// buffer that stays in the 50 MB L2 between phases, in place of the
// TPU's VMEM carry (fused_cell.py:358-366).
//
// Bound on the card: bytes.  At full width (C 768, F 3072, B 16) a layer
// reads 4 C^2 + 2 C F fp32 weights = 28.3 MB and does 2 B flops per
// weight (8 flops per 4 bytes, against ~20 flops per byte the card can
// sustain in fp32 outside the tensor cores), so the 12-layer step is
// bounded by 340 MB of weights plus the KV pages it reads, over the
// card's 3.35 TB/s.  The GEMV phases therefore read each weight row once
// (one warp per output column, 16-byte loads, neighbouring lanes on
// neighbouring addresses, several loads in flight per lane) and apply it
// to all B rows at once from a shared-memory copy of the input rows.  A
// GEMV with fewer output columns than the grid has warps (the two C-wide
// ones) splits K across blocks, so every warp streams weights; the
// following LayerNorm phase adds the partial sums in a fixed order, so
// results do not depend on timing.  The attention phase reads only the
// pages the table names up to each row's length.  The GEMV and the
// append + attention phases are shared with the tensor-parallel phase
// kernels (decode_phase.cu) through decode_common.cuh.
#include "decode_common.cuh"

namespace cg = cooperative_groups;

namespace {

using mxt::KSPLIT_MAX;
using mxt::NTHREADS;
using mxt::NWARPS;
using mxt::round4;
constexpr int NW = 16;               // weight pointers per layer

struct Args {
  float* x;              // (B, C) activations, updated in place
  float* kp;             // (Lg, KVH, P, S, D) this group's key pages
  float* vp;             // (Lg, KVH, P, S, D) this group's value pages
  const float* const* w; // (Lg, NW) weight pointers: wq bq wk bk wv bv wo
                         // bo w1 b1 w2 b2 ln1g ln1b ln2g ln2b
  const int* meta;       // (2, B): write page, write slot
  const int* tables;     // (B, pps) page tables
  const int* lengths;    // (B,) valid keys after this step's append
  float* scratch;        // scratch_floats(B, C, F, KVC) floats
  long long* timing;     // null, or (Lg * 7 + 1) phase-end timestamps
  int B, C, F, H, KVH, D, P, S, pps, Lg;
  float scale;
};

// scratch layout: qkv (B, C + 2 KVC) | att (B, C) | h (B, F) |
// parts (KSPLIT_MAX, B, C); every piece starts 16-byte aligned
__host__ __device__ inline size_t scratch_floats(int B, int C, int F,
                                                 int KVC) {
  return round4((size_t)B * (C + 2 * KVC)) + round4((size_t)B * C) +
         round4((size_t)B * F) + (size_t)KSPLIT_MAX * B * C;
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
// is read once into shared memory (C + 64 <= STAGE_FLOATS).
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

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// three blocks per SM: the wide GEMVs need the warps more than the code
// needs registers
__global__ void __launch_bounds__(NTHREADS, 3) fused_decode_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  // with a timing buffer, block 0 stamps the start and the end of every
  // phase (right after the grid barrier that closes it)
  const bool stamp = a.timing != nullptr && blockIdx.x == 0 &&
                     threadIdx.x == 0;
  int n_stamp = 0;
  if (stamp) a.timing[n_stamp++] = globaltimer();
  auto sync = [&]() {
    grid.sync();
    if (stamp) a.timing[n_stamp++] = globaltimer();
  };
  const int B = a.B, C = a.C, F = a.F, D = a.D;
  const int KVC = a.KVH * D, N = C + 2 * KVC, g = a.H / a.KVH;
  const size_t layer_pages = (size_t)a.KVH * a.P * a.S * D;
  float* x = a.x;
  float* qkv = a.scratch;
  float* att = qkv + round4((size_t)B * N);
  float* hbuf = att + round4((size_t)B * C);
  float* parts = hbuf + round4((size_t)B * F);
  const int ks = mxt::ksplit_for(C);
  auto part = [=](int b, int n, int s, float v) {
    parts[((size_t)s * B + b) * C + n] = v;
  };
  for (int l = 0; l < a.Lg; ++l) {
    const float* const* w = a.w + (size_t)l * NW;
    const float *wq = w[0], *bq = w[1], *wk = w[2], *bk = w[3];
    const float *wv = w[4], *bv = w[5], *wo = w[6];
    const float *w1 = w[8], *b1 = w[9], *w2 = w[10];
    float* kp = a.kp + (size_t)l * layer_pages;
    float* vp = a.vp + (size_t)l * layer_pages;

    // 1. qkv + bias
    mxt::gemv(x, B, C, N, 1,
              [=](int n) {
                return n < C ? wq + (size_t)n * C
                     : n < C + KVC ? wk + (size_t)(n - C) * C
                                   : wv + (size_t)(n - C - KVC) * C;
              },
              [=](int b, int n, int, float v) {
                const float bias = n < C         ? bq[n]
                                   : n < C + KVC ? bk[n - C]
                                                 : bv[n - C - KVC];
                qkv[(size_t)b * N + n] = v + bias;
              },
              smem);
    sync();

    // 2. KV append, then attention, per (sequence, KV head)
    mxt::append_attend(qkv, C, kp, vp, a.meta, a.tables, a.lengths, B, a.KVH,
                       g, a.P, a.S, D, a.pps, a.scale, att, smem);
    sync();

    // 3. out-projection, partial sums over K slices
    mxt::gemv(att, B, C, C, ks, [=](int n) { return wo + (size_t)n * C; },
              part, smem);
    sync();

    // 4. residual + bias, LayerNorm
    residual_layer_norm(x, parts, ks, w[7], w[12], w[13], B, C, smem);
    sync();

    // 5. FFN1 + bias + erf GELU
    mxt::gemv(x, B, C, F, 1, [=](int n) { return w1 + (size_t)n * C; },
              [=](int b, int n, int, float v) {
                hbuf[(size_t)b * F + n] = mxt::gelu_erf(v + b1[n]);
              },
              smem);
    sync();

    // 6. FFN2, partial sums over K slices
    mxt::gemv(hbuf, B, F, C, ks, [=](int n) { return w2 + (size_t)n * F; },
              part, smem);
    sync();

    // 7. residual + bias, LayerNorm: the next layer's input
    residual_layer_norm(x, parts, ks, w[11], w[14], w[15], B, C, smem);
    if (l + 1 < a.Lg || a.timing) sync();
  }
}

}  // namespace

extern "C" const char* mxt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Launch geometry for the given head grouping: fills the grid size (all
// blocks resident at once) and the dynamic shared memory in bytes.
static cudaError_t geometry(int g, int D, int* grid, size_t* smem) {
  return mxt::coop_geometry(
      fused_decode_kernel,
      std::max({mxt::STAGE_FLOATS, mxt::attend_smem_floats(g, D), 33}), grid,
      smem);
}

// Blocks the fused kernel launches with (for the caller's records).
extern "C" int mxt_decode_layer_group_grid(int H, int KVH, int D, int* grid) {
  size_t smem = 0;
  return (int)geometry(H / KVH, D, grid, &smem);
}

// Floats of device scratch one launch needs.
extern "C" long long mxt_decode_layer_group_scratch(int B, int C, int F,
                                                    int KVH, int D) {
  return (long long)scratch_floats(B, C, F, KVH * D);
}

// x (B, C); kp/vp (Lg, KVH, P, S, D); w (Lg, 16) device pointers; meta
// (2, B), tables (B, pps), lengths (B,) int32; scratch of
// mxt_decode_layer_group_scratch floats; timing null or (Lg * 7 + 1)
// int64.  C, F and D must be multiples of 4, and C at most 8128.
extern "C" int mxt_decode_layer_group(void* x, void* kp, void* vp,
                                      const void* w, const void* meta,
                                      const void* tables, const void* lengths,
                                      void* scratch, void* timing, int B,
                                      int C, int F, int H, int KVH, int D,
                                      int P, int S, int pps, int Lg,
                                      float scale, void* stream) {
  int grid = 0;
  size_t smem = 0;
  cudaError_t e = geometry(H / KVH, D, &grid, &smem);
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
  a.scale = scale;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)fused_decode_kernel, grid,
                                  NTHREADS, params, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
