// Fused transformer epilogues: bias + exact-erf GELU (forward), and bias +
// dropout + residual, forward and backward.
//
// bias_gelu_fwd_kernel, the port of _bg_fwd_kernel
// (mxnet_tpu/ops/pallas/epilogue.py:135):
//
//   out = gelu(x + b) = 0.5 u (1 + erf(u / sqrt 2)),  u = x + b
//
// x, out (R, C) and b (C,) of one type (float32, bfloat16 or float16),
// computed in fp32 (erff) and stored in the tensors' type.  Bound on the
// card: bytes (each element read and written once, ~20 flops of erf
// between).  At the serving path's shapes, (16 | 64, 3072), 0.4-1.6 MB
// move (fp32): the time is a launch and one cold HBM round trip, so the
// design is about latency.  Each thread owns one fixed column vector
// (16 bytes, 4 floats or 8 bf16/fp16, at the serving shapes at most 4
// elements; one element for a ragged C such as 770) and walks rows, so
// its slice of the bias is loaded once into registers and no element
// needs a modulo.  It issues the loads of all its rows of a pass (K of
// them) before the bias's and before it computes, so all of a block's
// loads are in flight at once.  The launch plan
// (mxnet_tpu_torch/ops/kernels/epilogue.py: bias_gelu_plan) halves the
// block, down to 32 threads, until there is at least one block an SM at
// small R, and at large R gives each thread one pass of 4 rows (fp32:
// 2); the kernel grid-strides only past the grid's 65535 row groups,
// where the next pass's loads are issued before the current one
// computes.
//
// bias_dropout_residual, the port of _bdr_fwd_kernel and _bdr_bwd_kernel
// (mxnet_tpu/ops/pallas/epilogue.py:213, 221).
//
//   forward   out = r + keep(row, col) * (x + b)     x, r, out: (R, C); b: (C,)
//   backward  dx  = keep(row, col) * g
//
// keep is 0 where the dropout hash of the element's global (row, col) in
// the flattened (R, C) view falls below the rate's uint32 threshold, and
// 1/(1-rate) (rounded to float32) where it does not.  The hash is
// hash_keep_bits of mxnet_tpu/ops/pallas/flash_attention.py:125 with
// batch-head 0 (dropout_hash.cuh): uint32 arithmetic wraps by definition
// in C++, so the mask equals the JAX package's and the port's plain
// version bit for bit.  The backward regenerates it from the seed, so no
// mask is ever stored.
//
// Bound on the card: bytes.  Each element is read and written once, with
// ~15 integer operations of hash between; nothing is reused except the
// (C,) bias row, which stays in L1/L2.  Each thread moves 16 bytes per
// load (4 floats or 8 bfloat16) when C and the pointers allow it, else one
// element; math is fp32 with explicit round-to-nearest adds and multiplies,
// so no FMA contraction departs from the plain version:
//   u = x + b;  u = u * keep;  out = r + u.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dropout_hash.cuh"

namespace {

// the hash of dropout_hash.cuh with batch-head 0
__device__ __forceinline__ uint32_t keep_hash(uint32_t seed, uint32_t gi,
                                              uint32_t gj) {
  return mxt_keep_hash(seed, 0u, gi, gj);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
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
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// V consecutive elements of one row, moved by one load or store
template <class T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// nv vectors of V elements a row; thread (blockIdx.x, threadIdx.x) owns
// vector column col of every row blockIdx.y K + gridDim.y K i + k, k < K.
// The bias is of x's type (TB = T: one vector load) or float32 (V scalar
// loads).  The thread issues its loads of x before those of the bias, so
// that both round trips overlap.
template <class T, class TB, int V, int K>
__global__ void __launch_bounds__(256)
bias_gelu_fwd_kernel(const T* __restrict__ x, const TB* __restrict__ b,
                     T* __restrict__ out, int R, int nv) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= nv) return;
  const Vec<T, V>* xv = reinterpret_cast<const Vec<T, V>*>(x) + col;
  Vec<T, V>* ov = reinterpret_cast<Vec<T, V>*>(out) + col;
  const int step = gridDim.y * K;
  int r0 = blockIdx.y * K;
  Vec<T, V> v[K];
  auto load = [&](Vec<T, V>(&dst)[K], int r) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (r + k < R) dst[k] = xv[(size_t)(r + k) * nv];
  };
  load(v, r0);
  float bias[V];
  if constexpr (std::is_same<T, TB>::value) {
    const Vec<T, V> bv = reinterpret_cast<const Vec<T, V>*>(b)[col];
#pragma unroll
    for (int e = 0; e < V; ++e) bias[e] = to_f32(bv.v[e]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) bias[e] = b[col * V + e];
  }
  auto gelu_store = [&](const Vec<T, V>(&src)[K], int r) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (r + k >= R) continue;
      Vec<T, V> o;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float u = __fadd_rn(to_f32(src[k].v[e]), bias[e]);
        o.v[e] = from_f32<T>(0.5f * u * (1.f + erff(u * 0.70710678118654752f)));
      }
      ov[(size_t)(r + k) * nv] = o;
    }
  };
  if (step >= R) {              // one pass a thread: the plan's usual case
    gelu_store(v, r0);
    return;
  }
  while (r0 < R) {
    // the next pass's loads are issued before this pass computes, so the
    // grid-strided loop keeps loads in flight while it computes
    Vec<T, V> nxt[K];
    if (r0 + step < R) load(nxt, r0 + step);
    gelu_store(v, r0);
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = nxt[k];
    r0 += step;
  }
}

template <class T, int V, bool MASK>
__global__ void __launch_bounds__(256)
bdr_fwd_kernel(const T* __restrict__ x, const T* __restrict__ b,
               const T* __restrict__ r, const long long* __restrict__ seed,
               T* __restrict__ out, int n, int C, uint32_t thr, float ks) {
  const uint32_t s = MASK ? (uint32_t)seed[0] : 0u;
  const int nv = n / V;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nv;
       i += gridDim.x * blockDim.x) {
    const int e0 = i * V;
    const int row = e0 / C, col0 = e0 - row * C;
    const Vec<T, V> xv = reinterpret_cast<const Vec<T, V>*>(x)[i];
    const Vec<T, V> rv = reinterpret_cast<const Vec<T, V>*>(r)[i];
    const Vec<T, V> bv = *reinterpret_cast<const Vec<T, V>*>(b + col0);
    Vec<T, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float u = __fadd_rn(to_f32(xv.v[k]), to_f32(bv.v[k]));
      if (MASK) {
        const float m =
            keep_hash(s, (uint32_t)row, (uint32_t)(col0 + k)) >= thr ? ks
                                                                       : 0.f;
        u = __fmul_rn(u, m);
      }
      o.v[k] = from_f32<T>(__fadd_rn(to_f32(rv.v[k]), u));
    }
    reinterpret_cast<Vec<T, V>*>(out)[i] = o;
  }
}

template <class T, int V>
__global__ void __launch_bounds__(256)
bdr_bwd_kernel(const T* __restrict__ g, const long long* __restrict__ seed,
               T* __restrict__ dx, int n, int C, uint32_t thr, float ks) {
  const uint32_t s = (uint32_t)seed[0];
  const int nv = n / V;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nv;
       i += gridDim.x * blockDim.x) {
    const int e0 = i * V;
    const int row = e0 / C, col0 = e0 - row * C;
    const Vec<T, V> gv = reinterpret_cast<const Vec<T, V>*>(g)[i];
    Vec<T, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float m =
          keep_hash(s, (uint32_t)row, (uint32_t)(col0 + k)) >= thr ? ks : 0.f;
      o.v[k] = from_f32<T>(__fmul_rn(to_f32(gv.v[k]), m));
    }
    reinterpret_cast<Vec<T, V>*>(dx)[i] = o;
  }
}

constexpr int kThreads = 256;

int blocks_for(int n, int V) {
  const int nv = n / V;
  return nv > 0 ? (nv + kThreads - 1) / kThreads : 1;
}

template <class T, int V>
int fwd(const void* x, const void* b, const void* r, const void* seed,
        void* out, int n, int C, int mask, uint32_t thr, float ks,
        cudaStream_t st) {
  if (mask)
    bdr_fwd_kernel<T, V, true><<<blocks_for(n, V), kThreads, 0, st>>>(
        (const T*)x, (const T*)b, (const T*)r, (const long long*)seed,
        (T*)out, n, C, thr, ks);
  else
    bdr_fwd_kernel<T, V, false><<<blocks_for(n, V), kThreads, 0, st>>>(
        (const T*)x, (const T*)b, (const T*)r, nullptr, (T*)out, n, C, thr,
        ks);
  return (int)cudaGetLastError();
}

template <class T, int V>
int bwd(const void* g, const void* seed, void* dx, int n, int C,
        uint32_t thr, float ks, cudaStream_t st) {
  bdr_bwd_kernel<T, V><<<blocks_for(n, V), kThreads, 0, st>>>(
      (const T*)g, (const long long*)seed, (T*)dx, n, C, thr, ks);
  return (int)cudaGetLastError();
}

template <class T, class TB, int V>
int bias_gelu(const void* x, const void* b, void* out, int R, int C,
              int threads, int rows, int gx, int gy, cudaStream_t st) {
  const dim3 grid(gx, gy);
  const int nv = C / V;
  if (rows == 4)
    bias_gelu_fwd_kernel<T, TB, V, 4><<<grid, threads, 0, st>>>(
        (const T*)x, (const TB*)b, (T*)out, R, nv);
  else if (rows == 2)
    bias_gelu_fwd_kernel<T, TB, V, 2><<<grid, threads, 0, st>>>(
        (const T*)x, (const TB*)b, (T*)out, R, nv);
  else
    bias_gelu_fwd_kernel<T, TB, V, 1><<<grid, threads, 0, st>>>(
        (const T*)x, (const TB*)b, (T*)out, R, nv);
  return (int)cudaGetLastError();
}

template <class T, class TB>
int bias_gelu(const void* x, const void* b, void* out, int R, int C,
              int vec, int threads, int rows, int gx, int gy,
              cudaStream_t st) {
  constexpr int V16 = 16 / sizeof(T);
  if (vec == V16)
    return bias_gelu<T, TB, V16>(x, b, out, R, C, threads, rows, gx, gy, st);
  if (vec == V16 / 2)
    return bias_gelu<T, TB, V16 / 2>(x, b, out, R, C, threads, rows, gx, gy,
                                     st);
  return bias_gelu<T, TB, 1>(x, b, out, R, C, threads, rows, gx, gy, st);
}

template <class T>
int bias_gelu(const void* x, const void* b, int b_f32, void* out, int R,
              int C, int vec, int threads, int rows, int gx, int gy,
              cudaStream_t st) {
  return b_f32 ? bias_gelu<T, float>(x, b, out, R, C, vec, threads, rows, gx,
                                     gy, st)
               : bias_gelu<T, T>(x, b, out, R, C, vec, threads, rows, gx, gy,
                                 st);
}

}  // namespace

extern "C" const char* mxt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// out = gelu(x + b): x, out (R, C) contiguous, of one dtype (0 float32,
// 1 bfloat16, 2 float16), and b (C,) contiguous, of x's dtype or (b_f32)
// float32.  vec: elements a thread moves at once, 1 or 8 or 16 bytes of
// them, which needs C divisible by vec and x, out (and a b of x's dtype)
// aligned to vec elements.  The launch: blocks of `threads` (<= 256),
// grid (gx, gy), gx threads covering a row's C / vec vectors, `rows` (1,
// 2 or 4) rows a pass; R * C < 2**31.
extern "C" int mxt_bias_gelu_fwd(const void* x, const void* b, void* out,
                                 int R, int C, int dtype, int b_f32, int vec,
                                 int threads, int rows, int gx, int gy,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return bias_gelu<float, float>(x, b, out, R, C, vec, threads, rows, gx,
                                   gy, st);
  if (dtype == 1)
    return bias_gelu<__nv_bfloat16>(x, b, b_f32, out, R, C, vec, threads,
                                    rows, gx, gy, st);
  return bias_gelu<__half>(x, b, b_f32, out, R, C, vec, threads, rows, gx,
                           gy, st);
}

// x, r, out (R, C) and b (C,), contiguous, of one dtype: 0 float32,
// 1 bfloat16.  n = R * C < 2**31.  vec: 1 for one element per thread, or
// 16 bytes per thread (4 floats / 8 bfloat16), which needs C divisible by
// that count and 16-byte aligned pointers.  seed: one int64 on the card
// holding the uint32 seed; read only when mask != 0.  thr: the uint32 keep
// threshold; ks: the keep scale.
extern "C" int mxt_bias_dropout_residual_fwd(const void* x, const void* b,
                                             const void* r, const void* seed,
                                             void* out, int n, int C,
                                             int dtype, int vec, int mask,
                                             unsigned thr, float ks,
                                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return vec > 1 ? fwd<float, 4>(x, b, r, seed, out, n, C, mask, thr, ks, st)
                   : fwd<float, 1>(x, b, r, seed, out, n, C, mask, thr, ks,
                                   st);
  return vec > 1
             ? fwd<__nv_bfloat16, 8>(x, b, r, seed, out, n, C, mask, thr, ks,
                                     st)
             : fwd<__nv_bfloat16, 1>(x, b, r, seed, out, n, C, mask, thr, ks,
                                     st);
}

// g, dx (R, C) of one dtype, as above; always masks (the caller launches
// nothing at rate 0).
extern "C" int mxt_bias_dropout_residual_bwd(const void* g, const void* seed,
                                             void* dx, int n, int C,
                                             int dtype, int vec,
                                             unsigned thr, float ks,
                                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return vec > 1 ? bwd<float, 4>(g, seed, dx, n, C, thr, ks, st)
                   : bwd<float, 1>(g, seed, dx, n, C, thr, ks, st);
  return vec > 1 ? bwd<__nv_bfloat16, 8>(g, seed, dx, n, C, thr, ks, st)
                 : bwd<__nv_bfloat16, 1>(g, seed, dx, n, C, thr, ks, st);
}
