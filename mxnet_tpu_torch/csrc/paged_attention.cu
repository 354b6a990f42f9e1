// Paged decode attention: one query token per sequence, GQA, keys and
// values read through the page table up to each sequence's length.
// Wrapped by mxnet_tpu_torch/ops/kernels/paged_attention.py:paged_attention.
// Replaces the TPU's upstream Pallas paged-attention kernel called at
// mxnet_tpu/ops/pallas/paged_attention.py:251; the math, bound and design
// are in paged_attention.cuh.
//
// Grid: one block per (sequence, KV head), 128 threads.
#include "paged_attention.cuh"

namespace {

__global__ void __launch_bounds__(128)
paged_attention_kernel(const float* q, const float* kp, const float* vp,
                       const int* lengths, const int* tables, float* out,
                       int H, int KVH, int P, int S, int D, int pps,
                       float scale) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x / KVH, kvh = blockIdx.x - b * KVH;
  const int g = H / KVH;
  const size_t row = ((size_t)b * H + (size_t)kvh * g) * D;
  mxt::attend_group(q + row, kp, vp, tables + (size_t)b * pps, pps,
                    lengths[b], kvh, P, S, D, g, scale, out + row, smem);
}

}  // namespace

extern "C" const char* mxt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// q (B, H, D), kp/vp (KVH, P, S, D), lengths (B,), tables (B, pps) int32,
// out (B, H, D); all fp32 except the int32 lengths and tables.
extern "C" int mxt_paged_attention(const void* q, const void* kp,
                                   const void* vp, const void* lengths,
                                   const void* tables, void* out, int B,
                                   int H, int KVH, int P, int S, int D,
                                   int pps, float scale, void* stream) {
  const size_t smem = (size_t)mxt::attend_smem_floats(H / KVH, D) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_attention_kernel<<<B * KVH, 128, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)kp, (const float*)vp,
      (const int*)lengths, (const int*)tables, (float*)out, H, KVH, P, S, D,
      pps, scale);
  return (int)cudaGetLastError();
}
