// Paged decode attention: one query token per sequence, GQA, keys and
// values read through the page table up to each sequence's length, from
// fp32 pages or from int8 pages with one scale per (KV head, page).
// Wrapped by mxnet_tpu_torch/ops/kernels/paged_attention.py:paged_attention.
// Replaces the TPU's upstream Pallas paged-attention kernel called at
// mxnet_tpu/ops/pallas/paged_attention.py:251 (fp pages) and the XLA
// dequant-gather path of int8 pages at :237-247; the math, bound and design
// are in paged_attention.cuh.
//
// Grid: one block per (sequence, KV head), 128 threads.
#include "paged_attention.cuh"

namespace {

template <class Pages>
__device__ __forceinline__ void attend_block(const float* q,
                                             const Pages& kv,
                                             const int* lengths,
                                             const int* tables, float* out,
                                             int H, int KVH, int D, int S,
                                             int pps, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x / KVH, kvh = blockIdx.x - b * KVH;
  const int g = H / KVH;
  const size_t row = ((size_t)b * H + (size_t)kvh * g) * D;
  mxt::attend_group(q + row, kv, tables + (size_t)b * pps, pps, lengths[b],
                    S, D, g, scale, out + row, smem);
}

__global__ void __launch_bounds__(128)
paged_attention_kernel(const float* q, const float* kp, const float* vp,
                       const int* lengths, const int* tables, float* out,
                       int H, int KVH, int P, int S, int D, int pps,
                       float scale) {
  const int kvh = blockIdx.x % KVH;
  const size_t pool0 = (size_t)kvh * P * S * D;
  attend_block(q, mxt::F32Pages{kp + pool0, vp + pool0}, lengths, tables,
               out, H, KVH, D, S, pps, scale);
}

__global__ void __launch_bounds__(128)
paged_attention_i8_kernel(const float* q, const signed char* kq,
                          const signed char* vq, const float* ks,
                          const float* vs, const int* lengths,
                          const int* tables, float* out, int H, int KVH,
                          int P, int S, int D, int pps, float scale) {
  const int kvh = blockIdx.x % KVH;
  const size_t pool0 = (size_t)kvh * P * S * D;
  const size_t scale0 = (size_t)kvh * P;
  attend_block(q,
               mxt::I8Pages{kq + pool0, vq + pool0, ks + scale0,
                            vs + scale0},
               lengths, tables, out, H, KVH, D, S, pps, scale);
}

template <class Kernel>
int smem_for(Kernel kernel, int H, int KVH, int D, size_t* smem) {
  *smem = (size_t)mxt::attend_smem_floats(H / KVH, D) * sizeof(float);
  if (*smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return 0;
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
  size_t smem;
  int e = smem_for(paged_attention_kernel, H, KVH, D, &smem);
  if (e) return e;
  paged_attention_kernel<<<B * KVH, 128, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)kp, (const float*)vp,
      (const int*)lengths, (const int*)tables, (float*)out, H, KVH, P, S, D,
      pps, scale);
  return (int)cudaGetLastError();
}

// As mxt_paged_attention, over int8 pages: kq/vq (KVH, P, S, D) int8 codes,
// ks/vs (KVH, P) fp32 scales.
extern "C" int mxt_paged_attention_i8(const void* q, const void* kq,
                                      const void* vq, const void* ks,
                                      const void* vs, const void* lengths,
                                      const void* tables, void* out, int B,
                                      int H, int KVH, int P, int S, int D,
                                      int pps, float scale, void* stream) {
  size_t smem;
  int e = smem_for(paged_attention_i8_kernel, H, KVH, D, &smem);
  if (e) return e;
  paged_attention_i8_kernel<<<B * KVH, 128, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const signed char*)kq, (const signed char*)vq,
      (const float*)ks, (const float*)vs, (const int*)lengths,
      (const int*)tables, (float*)out, H, KVH, P, S, D, pps, scale);
  return (int)cudaGetLastError();
}
