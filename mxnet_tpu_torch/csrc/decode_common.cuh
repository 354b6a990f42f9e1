// Device code shared by the decode kernels: the fused decode layer group
// (fused_decode.cu, kernel #12) and the tensor-parallel decode phases
// (decode_phase.cu, kernels #13 and #14).  Each is a cooperative
// persistent launch whose phases are separated by grid-wide barriers.
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
