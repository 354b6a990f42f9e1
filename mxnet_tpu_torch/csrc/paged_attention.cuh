// Paged decode attention for one (sequence, KV head) work item, run by a
// whole thread block: the attention of the fused decode-layer-group
// kernel (fused_decode.cu, #12, through decode_common.cuh:append_attend).
// The standalone paged attention (paged_attention.cu, #15) and the TP
// attention phase (decode_phase.cu, #13) split each row's keys over blocks
// instead (decode_common.cuh:split_attend).
//
// Replaces the masked whole-pool read inside _decode_group_kernel
// (mxnet_tpu/ops/pallas/fused_cell.py:386-414).
//
// Bound on the card: bytes.  Each key and value row is read once from
// device memory and used by the g = H / KVH query heads of its group
// (g * D * 2 flops per 4 * D bytes), far below the H100's ~20 flops per
// byte in fp32.  The design therefore reads only the pages the table
// names up to `length` (the TPU kernel reads the whole pool behind a
// mask), loads each key/value row once with neighbouring threads on
// neighbouring 16-byte words and several loads in flight per thread (the
// tile loop is latency-bound otherwise), and keeps the g query rows, one
// tile of keys and values, the logits and the running output in shared
// memory.  The softmax is the online (running max / running sum) form in
// fp32.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace mxt {

// fp32 pages of one KV head: (P, S, D) for keys and for values
struct F32Pages {
  const float* k;
  const float* v;
  __device__ __forceinline__ void load4(size_t off, float4& kr,
                                        float4& vr) const {
    kr = __ldcg(reinterpret_cast<const float4*>(k + off));
    vr = __ldcg(reinterpret_cast<const float4*>(v + off));
  }
};

constexpr int ATTN_TILE = 64;   // keys per tile
constexpr int STAGE_LOADS = 4;  // 16-byte loads in flight per staging thread

// floats of shared memory one attend_group call uses
__host__ __device__ inline int attend_smem_floats(int g, int D) {
  return g * D                  // scaled query rows
         + ATTN_TILE * (D + 1)  // key tile, rows padded against bank conflicts
         + ATTN_TILE * D        // value tile
         + g * ATTN_TILE        // logits, then probabilities
         + g * D                // running output
         + 3 * g;               // running max, running sum, rescale factor
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// q:      the group's g query rows, row i at q + i * D (heads kvh*g .. +g-1)
// kv:     the KV head's pages, offset to that head
// table:  the sequence's page-table row (pps entries)
// out:    the group's g output rows, row i at out + i * D
// D is a multiple of 4 and the pools are 16-byte aligned.
// A length of 0 (an inactive batch row) writes zeros.
// Page pools, q and out are read with L2-only loads: inside the fused
// kernel other blocks write them earlier in the same launch.
__device__ inline void attend_group(const float* q, const F32Pages& kv,
                             const int* table, int pps, int length, int S,
                             int D, int g, float scale, float* out,
                             float* smem) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nth >> 5;
  const int gD = g * D;
  if (length <= 0) {
    for (int e = tid; e < gD; e += nth) out[e] = 0.f;
    return;
  }
  float* q_s = smem;
  float* k_s = q_s + gD;
  float* v_s = k_s + ATTN_TILE * (D + 1);
  float* p_s = v_s + ATTN_TILE * D;
  float* acc = p_s + g * ATTN_TILE;
  float* m_s = acc + gD;
  float* l_s = m_s + g;
  float* a_s = l_s + g;

  __syncthreads();  // the caller may have used shared memory just before
  for (int e = tid; e < gD; e += nth) {
    q_s[e] = __ldcg(q + e) * scale;
    acc[e] = 0.f;
  }
  for (int i = tid; i < g; i += nth) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  const size_t page_stride = (size_t)S * D;

  const int D4 = D >> 2;  // float4s a row
  for (int t0 = 0; t0 < length; t0 += ATTN_TILE) {
    const int nt = min(ATTN_TILE, length - t0);
    __syncthreads();
    // stage the tile's key and value rows: STAGE_LOADS independent
    // 16-byte loads in flight per thread before any is stored
    const int n4 = nt * D4;
    for (int e0 = tid; e0 < n4; e0 += nth * STAGE_LOADS) {
      float4 kr[STAGE_LOADS], vr[STAGE_LOADS];
#pragma unroll
      for (int u = 0; u < STAGE_LOADS; ++u) {
        const int e = e0 + u * nth;
        if (e < n4) {
          const int j = e / D4, t = t0 + j;
          const int page = table[min(t / S, pps - 1)];
          const size_t off = (size_t)page * page_stride +
                             (size_t)(t % S) * D + (size_t)(e - j * D4) * 4;
          kv.load4(off, kr[u], vr[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < STAGE_LOADS; ++u) {
        const int e = e0 + u * nth;
        if (e < n4) {
          const int j = e / D4, d = (e - j * D4) * 4;
          float* kd = k_s + j * (D + 1) + d;  // padded row: scalar stores
          kd[0] = kr[u].x;
          kd[1] = kr[u].y;
          kd[2] = kr[u].z;
          kd[3] = kr[u].w;
          *reinterpret_cast<float4*>(v_s + j * D + d) = vr[u];
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < g * ATTN_TILE; e += nth) {
      const int i = e / ATTN_TILE, j = e - i * ATTN_TILE;
      float s = -INFINITY;
      if (j < nt) {
        const float* qi = q_s + i * D;
        const float* kj = k_s + j * (D + 1);
        s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(qi[d], kj[d], s);
      }
      p_s[e] = s;
    }
    __syncthreads();
    for (int i = warp; i < g; i += nwarps) {
      float* pi = p_s + i * ATTN_TILE;
      float mx = -INFINITY;
      for (int j = lane; j < ATTN_TILE; j += 32) mx = fmaxf(mx, pi[j]);
      mx = warp_max(mx);
      const float m_old = m_s[i];
      const float m_new = fmaxf(m_old, mx);  // finite: the tile has a key
      float sum = 0.f;
      for (int j = lane; j < ATTN_TILE; j += 32) {
        const float p = expf(pi[j] - m_new);  // masked keys: exp(-inf) = 0
        pi[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        a_s[i] = alpha;
        l_s[i] = l_s[i] * alpha + sum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < gD; e += nth) {
      const int i = e / D, d = e - i * D;
      const float* pi = p_s + i * ATTN_TILE;
      float s = acc[e] * a_s[i];
      for (int j = 0; j < nt; ++j) s = fmaf(pi[j], v_s[j * D + d], s);
      acc[e] = s;
    }
  }
  __syncthreads();
  for (int e = tid; e < gD; e += nth) out[e] = acc[e] / l_s[e / D];
  __syncthreads();  // shared memory is free for the caller again
}

}  // namespace mxt
