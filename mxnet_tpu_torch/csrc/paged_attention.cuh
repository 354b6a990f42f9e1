// Paged decode attention for one (sequence, KV head) work item, run by a
// whole thread block.  Shared by the standalone paged-attention kernel
// (paged_attention.cu) and the fused decode-layer-group kernel
// (fused_decode.cu), so both compute attention with the same code.
//
// Replaces the TPU's upstream jax.experimental.pallas.ops.tpu
// .paged_attention (called at mxnet_tpu/ops/pallas/paged_attention.py:251)
// and the masked whole-pool read inside _decode_group_kernel
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
//
// The page type is a template parameter (F32Pages or I8Pages below).  int8
// pages (the JAX package's QPages, attended there in XLA through
// gather_pages_deq + attend_ctx, mxnet_tpu/ops/pallas/paged_attention.py:
// 237-247) are dequantized as they are staged: each code times its page's
// latched per-head scale, one fp32 multiply, as the plain version does.
// They move a quarter of the bytes of fp pages, 16 codes per 16-byte load
// (fp pages: 4 values per 16-byte load), so a tile takes a quarter of the
// load instructions.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace mxt {

// A page type gives VEC, the values of a key or value row that one
// 16-byte load brings.

// fp32 pages of one KV head: (P, S, D) for keys and for values
struct F32Pages {
  static constexpr int VEC = 4;
  const float* k;
  const float* v;
  __device__ __forceinline__ void load4(size_t off, int /*page*/, float4& kr,
                                        float4& vr) const {
    kr = __ldcg(reinterpret_cast<const float4*>(k + off));
    vr = __ldcg(reinterpret_cast<const float4*>(v + off));
  }
};

// int8 pages of one KV head: codes (P, S, D) and per-page scales (P,).
// load() brings 16 codes of a key row and of a value row and their page's
// scales into registers; stage() writes them, dequantized, into a padded
// key row of shared memory (scalar stores) and a value row (float4).
struct I8Pages {
  static constexpr int VEC = 16;
  struct Raw {
    uint4 k, v;     // 16 codes each
    float sk, sv;   // their page's scales
  };
  const signed char* k;
  const signed char* v;
  const float* ks;
  const float* vs;
  __device__ __forceinline__ Raw load(size_t off, int page) const {
    return {__ldcg(reinterpret_cast<const uint4*>(k + off)),
            __ldcg(reinterpret_cast<const uint4*>(v + off)),
            __ldcg(ks + page), __ldcg(vs + page)};
  }
  // signed byte b of a 4-byte word
  __device__ __forceinline__ static float code(unsigned w, int b) {
    return (float)((int)(w << (24 - 8 * b)) >> 24);
  }
  __device__ __forceinline__ static void stage(const Raw& r, float* kd,
                                               float* vd) {
    const unsigned kw[4] = {r.k.x, r.k.y, r.k.z, r.k.w};
    const unsigned vw[4] = {r.v.x, r.v.y, r.v.z, r.v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int b = 0; b < 4; ++b) kd[4 * i + b] = code(kw[i], b) * r.sk;
      *reinterpret_cast<float4*>(vd + 4 * i) =
          make_float4(code(vw[i], 0) * r.sv, code(vw[i], 1) * r.sv,
                      code(vw[i], 2) * r.sv, code(vw[i], 3) * r.sv);
    }
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
// kv:     the KV head's pages (F32Pages or I8Pages), offset to that head
// table:  the sequence's page-table row (pps entries)
// out:    the group's g output rows, row i at out + i * D
// D is a multiple of Pages::VEC and the pools are 16-byte aligned.
// A length of 0 (an inactive batch row) writes zeros.
// Page pools, q and out are read with L2-only loads: inside the fused
// kernel other blocks write them earlier in the same launch.
template <class Pages>
__device__ void attend_group(const float* q, const Pages& kv,
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

  constexpr int V = Pages::VEC;
  const int D4 = D >> 2, DV = D / V;  // float4s, loads per row
  for (int t0 = 0; t0 < length; t0 += ATTN_TILE) {
    const int nt = min(ATTN_TILE, length - t0);
    __syncthreads();
    // stage the tile's key and value rows: STAGE_LOADS independent
    // 16-byte loads in flight per thread before any is stored (one loop
    // per page type: fp32 keeps its loads in float4 registers)
    if constexpr (V == 4) {
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
            kv.load4(off, page, kr[u], vr[u]);
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
    } else {
      const int nv = nt * DV;
      for (int e0 = tid; e0 < nv; e0 += nth * STAGE_LOADS) {
        typename Pages::Raw r[STAGE_LOADS];
#pragma unroll
        for (int u = 0; u < STAGE_LOADS; ++u) {
          const int e = e0 + u * nth;
          if (e < nv) {
            const int j = e / DV, t = t0 + j;
            const int page = table[min(t / S, pps - 1)];
            const size_t off = (size_t)page * page_stride +
                               (size_t)(t % S) * D + (size_t)(e - j * DV) * V;
            r[u] = kv.load(off, page);
          }
        }
#pragma unroll
        for (int u = 0; u < STAGE_LOADS; ++u) {
          const int e = e0 + u * nth;
          if (e < nv) {
            const int j = e / DV, d = (e - j * DV) * V;
            Pages::stage(r[u], k_s + j * (D + 1) + d, v_s + j * D + d);
          }
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
