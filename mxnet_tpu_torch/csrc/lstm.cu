// Persistent LSTM time loop, forward and backward: ONE cooperative kernel
// launch per layer and direction covers all T steps.
// Wrapped by mxnet_tpu_torch/ops/kernels/fused_cell.py:lstm_sequence.
//
// Replaces the TPU kernels _lstm_fwd_kernel and _lstm_bwd_kernel
// (mxnet_tpu/ops/pallas/fused_cell.py:142, 195, launched at :177, :251).
//
//   forward   g = gx[t] + h W + b;  i, f, u, o = sigmoid, sigmoid, tanh,
//             sigmoid of g's four blocks of H (MXNet order i, f, c, o);
//             c' = f c + i u;  h' = o tanh(c');  out[t] = h', cseq[t] = c'
//   backward  the same loop time-reversed: the gates recomputed from the
//             saved h_prev[t], c_prev[t]; dgx[t] = dg; the carries
//             dh = dg W^T and dc = dc f; dh0, dc0 after the last step
//
// gx (T, B, 4H), out (T, B, H), h_prev (T, B, H), dout (T, B, H), dgx
// (T, B, 4H), h0/c0/dh0/dc0 (B, H) are of the layer's type (float32 or
// bfloat16); cseq, c_prev and dcseq are float32; W (H, 4H) and b (4H,)
// are float32 or bfloat16, W with any strides.  Every product and both
// carries are float32, as the JAX kernel casts W and h to float32.
//
// The TPU runs the time loop as a sequential grid on one core, with W
// latched in VMEM and the carries in VMEM scratch.  Here the grid is one
// persistent set of blocks, all resident at once (cooperative launch,
// sized from the occupancy calculator), and the steps are separated by
// grid-wide barriers (cooperative_groups::this_grid().sync()).  Each block
// owns U consecutive hidden units j and loads, once, their four gate
// columns W[:, gH + j] (and, in the backward, their rows W[j, :]) into
// shared memory: the SM's counterpart of the latched W.  Each step a block
//   1. stages the previous h (float32, kept transposed as (H, B) so that
//      32 batch rows of one unit are one run) from the L2 into shared
//      memory with 16-byte loads, 32 batch rows at a time;
//   2. computes its (B x 4U) gate pre-activations with float32 FMAs: the
//      8 warps split H, lane = batch row, and the partial sums are added
//      in warp order (a fixed order: two runs agree bit for bit);
//   3. applies the nonlinearities and updates c, which never leaves the
//      block;
//   4. writes out[t], cseq[t] and its slice of the next h;
//   5. waits at one grid barrier (the h buffer is double-buffered, so one
//      barrier per step suffices).
// The backward block stages h_prev[t] (transposed by the caller) the same
// way, writes its slice of dg (float32, to a double-buffered (4H, B)
// scratch) and of dgx[t], passes one grid barrier, then reads the whole dg
// of step t back from the L2 to form dh_prev[:, j] = sum_g dg[:, g] W[j,
// g] for its own units; dc stays in the block.  No atomics.
//
// Bound on the card: operations.  Per layer at the word LM's shape (T 35,
// B 32, H 650) the forward does 2 T B H 4H = 3.79 GFLOP of recurrent
// products (0.057 ms at 67 TFLOP/s in float32) and moves ~24 MB (0.007 ms
// at 3.35 TB/s); the backward twice the products.  The 35 serial grid
// barriers set a latency floor of their own.  chip_smoke.py measured ~9.3
// us per forward step and ~22 us per backward step at that shape (H100
// SXM, 700 W).  Every backward block reads all of dg (B 4H floats, 333
// KB) each step, so that phase is bound by the L2's rate into each SM.
// This first version reads h and dg from the L2 every step and runs its
// products on the CUDA cores; wgmma, TMA, an exchange of dh partial sums
// in place of dg, and a split of the serial chain are later work.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int ROWS = 32;             // batch rows per pass: one per lane
constexpr int LOADS = 8;             // 16-byte loads in flight per thread
constexpr int UMAX = 8;              // hidden units per block, at most

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <class T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// per-step data: float32 goes through the L2 only (written by other blocks
// during the launch, so a stale L1 line must not be read)
__device__ __forceinline__ float ld_step(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_step(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// 16 bytes: 4 floats or 8 bfloat16, as float
__device__ __forceinline__ void ld16(const float* p, float* v) {
  const float4 x = __ldcg(reinterpret_cast<const float4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void ld16(const __nv_bfloat16* p, float* v) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

struct Weights {
  const void* w;          // W[k][g] at w + k * sk + g * sg
  long long sk, sg;
  int w_bf16;
  const void* b;          // (4H,)
  int b_bf16;
};

__device__ __forceinline__ float ldw(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// shared-memory layout, in floats; every piece starts 16-byte aligned
__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

struct Layout {
  int wc, bias, wr, hs, pre, own1, own2, total;
  __host__ __device__ Layout(int H, int B, int U, bool backward) {
    const int NG = 4 * U;
    int o = 0;
    wc = o;   o += round4(H * NG);            // gate columns [k][4U]
    bias = o; o += round4(NG);
    wr = o;   o += backward ? round4(4 * H * U) : 0;   // rows [g][U]
    hs = o;   // staged h [k][32]; the warps' partial sums alias it
    const int red_n = NWARPS * NG * ROWS;
    o += round4(H * ROWS > red_n ? H * ROWS : red_n);
    pre = o;  o += NG * ROWS;                 // summed pre-activations
    own1 = o; o += round4(B * U);             // c (fwd) / dc (bwd)
    own2 = o; o += backward ? round4(B * U) : 0;       // dh (bwd)
    total = o;
  }
};

// W's gate columns of units j0..j0+U-1 as wc[k][gate * U + u], their bias
// as bias[gate * U + u]; units past H read 0
template <int U>
__device__ void load_columns(float* wc, float* bias, const Weights& wt,
                             int H, int j0) {
  constexpr int NG = 4 * U;
  for (int e = threadIdx.x; e < H * NG; e += blockDim.x) {
    const int k = e / NG, c = e - k * NG;
    const int gate = c / U, j = j0 + c - gate * U;
    wc[e] = j < H ? ldw(wt.w, k * wt.sk + (long long)(gate * H + j) * wt.sg,
                        wt.w_bf16)
                  : 0.f;
  }
  for (int c = threadIdx.x; c < NG; c += blockDim.x) {
    const int gate = c / U, j = j0 + c - gate * U;
    bias[c] = j < H ? ldw(wt.b, gate * H + j, wt.b_bf16) : 0.f;
  }
}

// rows b0..b0+31 of a transposed (K, B) matrix, element (k, b) at
// src[k * B + b], into hs[k][r] (row stride 32).  When B is a multiple of
// 32, each k's 32 rows are one run of 16-byte loads, LOADS in flight per
// thread; otherwise single elements, 0 past row B.
template <class S>
__device__ void stage(float* hs, const S* src, int K, int B, int b0) {
  const int nt = blockDim.x;
  if (B % ROWS == 0) {
    constexpr int V = 16 / sizeof(S), PER_K = ROWS / V;
    const int n = K * PER_K;
    for (int e0 = threadIdx.x; e0 < n; e0 += nt * LOADS) {
      float v[LOADS][V];
#pragma unroll
      for (int q = 0; q < LOADS; ++q) {
        const int e = e0 + q * nt, k = e / PER_K;
        if (e < n) ld16(src + (size_t)k * B + b0 + (e - k * PER_K) * V, v[q]);
      }
#pragma unroll
      for (int q = 0; q < LOADS; ++q) {
        const int e = e0 + q * nt;
        if (e < n) {
          float4* d = reinterpret_cast<float4*>(hs + e * V);
#pragma unroll
          for (int i = 0; i < V / 4; ++i)
            d[i] = make_float4(v[q][4 * i], v[q][4 * i + 1], v[q][4 * i + 2],
                               v[q][4 * i + 3]);
        }
      }
    }
    return;
  }
  const int n = K * ROWS;
  for (int e0 = threadIdx.x; e0 < n; e0 += nt * LOADS) {
    float v[LOADS];
#pragma unroll
    for (int q = 0; q < LOADS; ++q) {
      const int e = e0 + q * nt, b = b0 + (e & (ROWS - 1));
      v[q] = e < n && b < B ? ld_step(src + (size_t)(e / ROWS) * B + b) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < LOADS; ++q) {
      const int e = e0 + q * nt;
      if (e < n) hs[e] = v[q];
    }
  }
}

// pre[c][r] = sum_k hs[k][r] * wc[k][c] for the 32 staged rows and the
// block's 4U gate columns.  Warps split k; lane = row; the warps' partial
// sums are added in warp order.  Ends with the block synchronised.
template <int U>
__device__ void gate_products(float* hs, const float* wc, float* pre,
                              int H) {
  constexpr int NG = 4 * U;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int span = (H + NWARPS - 1) / NWARPS;
  const int lo = warp * span, hi = min(H, lo + span);
  float acc[NG];
#pragma unroll
  for (int c = 0; c < NG; ++c) acc[c] = 0.f;
  for (int k = lo; k < hi; ++k) {
    const float hv = hs[k * ROWS + lane];
    const float4* w4 = reinterpret_cast<const float4*>(wc + k * NG);
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const float4 w = w4[q];
      acc[4 * q] = fmaf(hv, w.x, acc[4 * q]);
      acc[4 * q + 1] = fmaf(hv, w.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(hv, w.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(hv, w.w, acc[4 * q + 3]);
    }
  }
  __syncthreads();            // every warp is done with hs
  float* red = hs;
#pragma unroll
  for (int c = 0; c < NG; ++c) red[(warp * NG + c) * ROWS + lane] = acc[c];
  __syncthreads();
  for (int e = threadIdx.x; e < NG * ROWS; e += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < NWARPS; ++w) s += red[w * NG * ROWS + e];
    pre[e] = s;
  }
  __syncthreads();
}

struct FwdArgs {
  const void* gx;   // (T, B, 4H)
  const void* c0;   // (B, H)
  Weights wt;
  void* out;        // (T, B, H)
  float* cseq;      // (T, B, H)
  float* hbuf;      // (2, H, B) float32 scratch: h of the last two steps,
                    // transposed; the caller puts h0 in hbuf[1]
  int T, B, H;
};

template <class T, int U>
__global__ void __launch_bounds__(NTHREADS, 1) lstm_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int H = a.H, B = a.B, G = 4 * H;
  const int j0 = blockIdx.x * U;
  const Layout L(H, B, U, false);
  float *wc = smem + L.wc, *bias = smem + L.bias, *hs = smem + L.hs;
  float *pre = smem + L.pre, *c_own = smem + L.own1;
  load_columns<U>(wc, bias, a.wt, H, j0);
  const T* c0 = static_cast<const T*>(a.c0);
  for (int e = threadIdx.x; e < B * U; e += blockDim.x) {
    const int b = e / U, j = j0 + e - b * U;
    c_own[e] = j < H ? to_f32(c0[(size_t)b * H + j]) : 0.f;
  }
  const T* gx = static_cast<const T*>(a.gx);
  T* out = static_cast<T*>(a.out);
  for (int t = 0; t < a.T; ++t) {
    float* h_next = a.hbuf + (size_t)(t & 1) * H * B;
    const float* h_prev = a.hbuf + (size_t)((t + 1) & 1) * H * B;
    for (int b0 = 0; b0 < B; b0 += ROWS) {
      __syncthreads();        // hs and pre are free again
      stage(hs, h_prev, H, B, b0);
      __syncthreads();
      gate_products<U>(hs, wc, pre, H);
      const int rows = min(ROWS, B - b0);
      for (int e = threadIdx.x; e < rows * U; e += blockDim.x) {
        const int r = e / U, u = e - r * U, j = j0 + u, b = b0 + r;
        if (j >= H) continue;
        const size_t row = (size_t)t * B + b;
        const T* g = gx + row * G;
        const float gi = to_f32(g[j]) + pre[u * ROWS + r] + bias[u];
        const float gf = to_f32(g[H + j]) + pre[(U + u) * ROWS + r] +
                         bias[U + u];
        const float gu = to_f32(g[2 * H + j]) +
                         pre[(2 * U + u) * ROWS + r] + bias[2 * U + u];
        const float go = to_f32(g[3 * H + j]) +
                         pre[(3 * U + u) * ROWS + r] + bias[3 * U + u];
        const float i = sigmoid(gi), f = sigmoid(gf), uu = tanhf(gu),
                    o = sigmoid(go);
        const float c = f * c_own[b * U + u] + i * uu;
        const float h = o * tanhf(c);
        c_own[b * U + u] = c;
        out[row * H + j] = from_f32<T>(h);
        a.cseq[row * H + j] = c;
        h_next[(size_t)j * B + b] = h;
      }
    }
    if (t + 1 < a.T) grid.sync();
  }
}

struct BwdArgs {
  const void* gx;      // (T, B, 4H)
  const void* hp;      // (T, H, B) h_prev transposed, the layer's type
  const float* cp;     // (T, B, H) c_prev
  const float* cseq;   // (T, B, H)
  const void* dout;    // (T, B, H)
  const float* dcseq;  // (T, B, H)
  Weights wt;
  void* dgx;           // (T, B, 4H)
  void* dh0;           // (B, H)
  void* dc0;           // (B, H)
  float* dgbuf;        // (2, 4H, BP) float32 scratch, BP = B rounded up to 32
  int T, B, H, BP;
};

// dh_own[b][u] = sum_g dg[g][b] * W[j0 + u][g] for rows b0..b0+31: warps
// split g, lane = row, 16 loads from the L2 in flight per lane (the dg of
// a step is read by every block: this phase is bound by the L2's rate into
// the SM); the warps' partial sums (in red, which aliases hs) are added
// in warp order
template <int U>
__device__ void dh_products(const float* dg, const float* wr, float* hs,
                            float* dh_own, int B, int BP, int G, int b0) {
  constexpr int D = 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int span = (G + NWARPS - 1) / NWARPS;
  const int lo = warp * span, hi = min(G, lo + span);
  float acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = 0.f;
  const float* col = dg + b0 + lane;
  int g = lo;
  for (; g + D <= hi; g += D) {
    float v[D];
#pragma unroll
    for (int q = 0; q < D; ++q) v[q] = __ldcg(col + (size_t)(g + q) * BP);
#pragma unroll
    for (int q = 0; q < D; ++q)
#pragma unroll
      for (int u = 0; u < U; ++u)
        acc[u] = fmaf(v[q], wr[(g + q) * U + u], acc[u]);
  }
  for (; g < hi; ++g) {
    const float v = __ldcg(col + (size_t)g * BP);
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = fmaf(v, wr[g * U + u], acc[u]);
  }
  __syncthreads();            // every warp is done with hs
  float* red = hs;
#pragma unroll
  for (int u = 0; u < U; ++u) red[(warp * U + u) * ROWS + lane] = acc[u];
  __syncthreads();
  for (int e = threadIdx.x; e < U * ROWS; e += blockDim.x) {
    const int u = e / ROWS, r = e - u * ROWS, b = b0 + r;
    float s = 0.f;
    for (int w = 0; w < NWARPS; ++w) s += red[w * U * ROWS + e];
    if (b < B) dh_own[b * U + u] = s;
  }
  __syncthreads();
}

template <class T, int U>
__global__ void __launch_bounds__(NTHREADS, 1) lstm_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int H = a.H, B = a.B, G = 4 * H, BP = a.BP;
  const int j0 = blockIdx.x * U;
  const Layout L(H, B, U, true);
  float *wc = smem + L.wc, *bias = smem + L.bias, *wr = smem + L.wr;
  float *hs = smem + L.hs, *pre = smem + L.pre;
  float *dc_own = smem + L.own1, *dh_own = smem + L.own2;
  load_columns<U>(wc, bias, a.wt, H, j0);
  // the block's rows of W as wr[g][u]
  for (int e = threadIdx.x; e < G * U; e += blockDim.x) {
    const int u = e / G, g = e - u * G, j = j0 + u;
    wr[g * U + u] = j < H ? ldw(a.wt.w, j * a.wt.sk + (long long)g * a.wt.sg,
                                a.wt.w_bf16)
                          : 0.f;
  }
  for (int e = threadIdx.x; e < B * U; e += blockDim.x) {
    dc_own[e] = 0.f;
    dh_own[e] = 0.f;
  }
  const T* gx = static_cast<const T*>(a.gx);
  const T* hp = static_cast<const T*>(a.hp);
  const T* dout = static_cast<const T*>(a.dout);
  T* dgx = static_cast<T*>(a.dgx);
  for (int s = 0; s < a.T; ++s) {
    const int t = a.T - 1 - s;
    float* dg = a.dgbuf + (size_t)(s & 1) * G * BP;
    for (int b0 = 0; b0 < B; b0 += ROWS) {
      __syncthreads();
      stage(hs, hp + (size_t)t * H * B, H, B, b0);
      __syncthreads();
      gate_products<U>(hs, wc, pre, H);
      const int rows = min(ROWS, B - b0);
      for (int e = threadIdx.x; e < rows * U; e += blockDim.x) {
        const int r = e / U, u = e - r * U, j = j0 + u, b = b0 + r;
        if (j >= H) continue;
        const size_t row = (size_t)t * B + b;
        const T* g = gx + row * G;
        const float i = sigmoid(to_f32(g[j]) + pre[u * ROWS + r] + bias[u]);
        const float f = sigmoid(to_f32(g[H + j]) +
                                pre[(U + u) * ROWS + r] + bias[U + u]);
        const float uu = tanhf(to_f32(g[2 * H + j]) +
                               pre[(2 * U + u) * ROWS + r] + bias[2 * U + u]);
        const float o = sigmoid(to_f32(g[3 * H + j]) +
                                pre[(3 * U + u) * ROWS + r] + bias[3 * U + u]);
        const size_t x = row * H + j;
        const float tc = tanhf(a.cseq[x]);
        const float dh = dh_own[b * U + u] + to_f32(dout[x]);
        const float d_o = dh * tc;
        const float dc = dc_own[b * U + u] + a.dcseq[x] +
                         dh * o * (1.f - tc * tc);
        const float dgi = (dc * uu) * i * (1.f - i);
        const float dgf = (dc * a.cp[x]) * f * (1.f - f);
        const float dgu = (dc * i) * (1.f - uu * uu);
        const float dgo = d_o * o * (1.f - o);
        T* dgr = dgx + row * G;
        dgr[j] = from_f32<T>(dgi);
        dgr[H + j] = from_f32<T>(dgf);
        dgr[2 * H + j] = from_f32<T>(dgu);
        dgr[3 * H + j] = from_f32<T>(dgo);
        dg[(size_t)j * BP + b] = dgi;
        dg[(size_t)(H + j) * BP + b] = dgf;
        dg[(size_t)(2 * H + j) * BP + b] = dgu;
        dg[(size_t)(3 * H + j) * BP + b] = dgo;
        dc_own[b * U + u] = dc * f;
      }
    }
    grid.sync();              // dg of step t is complete in the L2
    for (int b0 = 0; b0 < B; b0 += ROWS)
      dh_products<U>(dg, wr, hs, dh_own, B, BP, G, b0);
  }
  T* dh0 = static_cast<T*>(a.dh0);
  T* dc0 = static_cast<T*>(a.dc0);
  for (int e = threadIdx.x; e < B * U; e += blockDim.x) {
    const int b = e / U, j = j0 + e - b * U;
    if (j < H) {
      dh0[(size_t)b * H + j] = from_f32<T>(dh_own[e]);
      dc0[(size_t)b * H + j] = from_f32<T>(dc_own[e]);
    }
  }
}

template <class T>
const void* kernel_for(bool backward, int U) {
#define MXT_LSTM_CASE(N)                                      \
  case N:                                                     \
    return backward ? (const void*)lstm_bwd_kernel<T, N>      \
                    : (const void*)lstm_fwd_kernel<T, N>;
  switch (U) {
    MXT_LSTM_CASE(1)
    MXT_LSTM_CASE(2)
    MXT_LSTM_CASE(3)
    MXT_LSTM_CASE(4)
    MXT_LSTM_CASE(5)
    MXT_LSTM_CASE(6)
    MXT_LSTM_CASE(7)
    MXT_LSTM_CASE(8)
  }
#undef MXT_LSTM_CASE
  return nullptr;
}

const void* kernel_for(bool backward, int bf16, int U) {
  return bf16 ? kernel_for<__nv_bfloat16>(backward, U)
              : kernel_for<float>(backward, U);
}

// The fewest units per block whose grid, ceil(H / U) blocks, is all
// resident at once.  units = 0 when none up to UMAX fits.
cudaError_t plan(bool backward, int bf16, int H, int B, int* units,
                 int* grid, size_t* smem) {
  *units = *grid = 0;
  *smem = 0;
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaDeviceGetAttribute(&smem_max,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  dev)) != cudaSuccess)
    return e;
  for (int U = std::max(1, (H + sms - 1) / sms); U <= UMAX; ++U) {
    const size_t bytes = (size_t)Layout(H, B, U, backward).total * 4;
    if (bytes > (size_t)smem_max) break;     // grows with U
    const void* fn = kernel_for(backward, bf16, U);
    if ((e = cudaFuncSetAttribute(fn,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bytes)) != cudaSuccess)
      return e;
    int per_sm = 0;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, fn, NTHREADS, bytes)) != cudaSuccess)
      return e;
    const int blocks = (H + U - 1) / U;
    if (blocks <= per_sm * sms) {
      *units = U;
      *grid = blocks;
      *smem = bytes;
      return cudaSuccess;
    }
  }
  return cudaSuccess;
}

Weights weights(const void* w, long long sk, long long sg, int w_bf16,
                const void* b, int b_bf16) {
  Weights wt;
  wt.w = w;
  wt.sk = sk;
  wt.sg = sg;
  wt.w_bf16 = w_bf16;
  wt.b = b;
  wt.b_bf16 = b_bf16;
  return wt;
}

}  // namespace

extern "C" const char* mxt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// The launch geometry of the forward (backward = 0) or backward kernel for
// the layer's type (bf16 = 1 for bfloat16), H and B: units per block,
// blocks and dynamic shared memory in bytes; units = 0 when the grid
// cannot be resident at once.
extern "C" int mxt_lstm_plan(int backward, int bf16, int H, int B,
                             int* units, int* grid, long long* smem) {
  size_t bytes = 0;
  const cudaError_t e = plan(backward != 0, bf16, H, B, units, grid, &bytes);
  *smem = (long long)bytes;
  return (int)e;
}

// One launch of the forward time loop; hbuf holds 2 H B floats, h0
// transposed to (H, B) in float32 in its second half.
extern "C" int mxt_lstm_fwd(const void* gx, const void* c0,
                            const void* w, long long sk, long long sg,
                            int w_bf16, const void* b, int b_bf16, void* out,
                            void* cseq, void* hbuf, int T, int B, int H,
                            int bf16, void* stream) {
  int U = 0, grid = 0;
  size_t smem = 0;
  cudaError_t e = plan(false, bf16, H, B, &U, &grid, &smem);
  if (e != cudaSuccess) return (int)e;
  if (U == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  FwdArgs a;
  a.gx = gx;
  a.c0 = c0;
  a.wt = weights(w, sk, sg, w_bf16, b, b_bf16);
  a.out = out;
  a.cseq = (float*)cseq;
  a.hbuf = (float*)hbuf;
  a.T = T;
  a.B = B;
  a.H = H;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel_for(false, bf16, U), grid, NTHREADS,
                                  params, smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// One launch of the backward time loop; dgbuf holds 2 * 4H * BP floats,
// BP = B rounded up to a multiple of 32.
extern "C" int mxt_lstm_bwd(const void* gx, const void* hp, const void* cp,
                            const void* cseq, const void* dout,
                            const void* dcseq, const void* w, long long sk,
                            long long sg, int w_bf16, const void* b,
                            int b_bf16, void* dgx, void* dh0, void* dc0,
                            void* dgbuf, int T, int B, int H, int BP,
                            int bf16, void* stream) {
  int U = 0, grid = 0;
  size_t smem = 0;
  cudaError_t e = plan(true, bf16, H, B, &U, &grid, &smem);
  if (e != cudaSuccess) return (int)e;
  if (U == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  BwdArgs a;
  a.gx = gx;
  a.hp = hp;
  a.cp = (const float*)cp;
  a.cseq = (const float*)cseq;
  a.dout = dout;
  a.dcseq = (const float*)dcseq;
  a.wt = weights(w, sk, sg, w_bf16, b, b_bf16);
  a.dgx = dgx;
  a.dh0 = dh0;
  a.dc0 = dc0;
  a.dgbuf = (float*)dgbuf;
  a.T = T;
  a.B = B;
  a.H = H;
  a.BP = BP;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel_for(true, bf16, U), grid, NTHREADS,
                                  params, smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
