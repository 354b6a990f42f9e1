// Fused bias + dropout + residual epilogue, forward and backward: the
// port of _bdr_fwd_kernel and _bdr_bwd_kernel
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
#include <cuda_runtime.h>
#include <stdint.h>

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

// V consecutive elements of one row, moved by one load or store
template <class T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

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

}  // namespace

extern "C" const char* mxt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
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
