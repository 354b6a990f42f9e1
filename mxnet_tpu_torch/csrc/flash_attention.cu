// Flash attention, forward and backward: the port of _fwd_kernel,
// _bwd_dq_kernel and _bwd_dkv_kernel (mxnet_tpu/ops/pallas/
// flash_attention.py:158, 262, 314).
//
//   forward   S = Q K^T * scale, masked;  P = softmax(S) over the valid keys;
//             O = (P * keep) V;  lse = m + log(l)  (per row, fp32)
//   dq        P = exp(S - lse);  dP = (dO V^T) * keep;  dS = P (dP - delta);
//             dQ = dS K * scale
//   dk, dv    dV = (P * keep)^T dO;  dK = dS^T Q * scale
//
// q, k, v, out, dO, dq, dk, dv: (BH, L, D), contiguous, float32 or
// bfloat16, D in {32, 64, 128}; lse and delta = sum_d dO * O: (BH, L)
// float32.  The mask is the JAX kernel's (_block_mask, :49): key j of row i
// is valid when j < min(kv_length[bh / H], L), and j <= i when causal, and
// |i - j| <= window when banded.  keep is the dropout multiplier of the
// hash in dropout_hash.cuh over (seed, bh, global i, global j): 0, or
// 1/(1-rate) rounded to float32, so every kernel and any tiling draws the
// same mask.  The normalizer l sums the undropped P (:193).
//
// A row with no valid key gives out = 0 and lse = -inf, as the reference
// attention does.  Masked elements get P = 0 explicitly; the JAX kernel's
// -1e30 sentinel alone would give such a row exp(0) = 1 on every masked
// key of a visited tile, so its output would depend on the tiling.
//
// Design for the SM (not the TPU's grid): a block of 256 threads owns one
// 64-row tile of one (batch, head) and loops over the 64-wide tiles of
// the other side, skipping tiles the mask rules out (_block_needed, :69)
// and the per-element mask on interior tiles (_block_boundary, :86).  The
// tiles sit in shared memory as float32 (a bf16 input is widened on load),
// rows padded by 4 floats so the 16-byte loads below hit distinct banks.
// Thread (ty, tx) = (tid / 16, tid % 16) owns score rows 4 ty .. 4 ty + 3
// and columns tx + 16 c (c < 4) of a 64 x 64 tile; the row reductions of
// the online softmax are shuffles across the 16 lanes of a row group.  The
// products are fp32 FMAs (a bf16 x bf16 product is exact in fp32, as on the
// tensor cores); in bfloat16, P is rounded to bf16 before P V and dS before
// dS K and dS^T Q, as the JAX kernel casts (:200, :300, :355, :361).
//
// Bound on the card.  At BERT-base training shapes (L 128, D 64) the
// kernels do 4, 6 and 8 BH L^2 D flops over 4, 5 and 6 BH L D elements
// read or written: L / 4 = 32 flops per fp32 byte, above the 20 where the
// fp32 peak (67 TFLOP/s) and not memory (3.35 TB/s) bounds, and L / 2 = 64
// per bf16 byte, below the 295 of the bf16 tensor cores.  This first
// version runs its products as fp32 FMAs on the CUDA cores, 16 FMAs for
// every 8 16-byte shared-memory loads; the tensor cores (wgmma) and TMA
// are later work.  The dk/dv kernel owns its key rows, so it needs no
// atomics and its result does not depend on the order blocks run in.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int kTile = 64;      // rows of a q tile and of a k tile
constexpr int kThreads = 256;  // 16 row groups x 16 lanes
constexpr int kSP = kTile + 4; // padded row of a score tile in shared memory
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

template <class T>
__device__ __forceinline__ T cvt(float v);
template <>
__device__ __forceinline__ float cvt<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the value a cast to the input dtype and back gives (bf16: round to
// nearest even; float32: unchanged)
template <class T>
__device__ __forceinline__ float round_as(float v);
template <>
__device__ __forceinline__ float round_as<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// rows [row0, row0 + 64) of a (L, D) matrix into shared memory as float32,
// row stride D + 4; rows at or past L read as 0
template <class T, int D>
__device__ __forceinline__ void load_tile(float* sm, const T* g, int row0,
                                          int L) {
  constexpr int C4 = D / 4, SD = D + 4;
  for (int idx = threadIdx.x; idx < kTile * C4; idx += kThreads) {
    const int r = idx / C4, c = (idx - r * C4) * 4;
    const int gr = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < L) v = load4(g + (size_t)gr * D + c);
    store4(sm + r * SD + c, v);
  }
}

// The output columns a thread owns in a (64, D) accumulator: D / 16 of
// them, as float4 groups 64 apart (or a float2 at D 32), so a row's 16
// lanes read 16 consecutive 16-byte words.
template <int D>
struct Cols {
  static constexpr int N = D / 16;
  __device__ static __forceinline__ int col(int tx, int e) {
    if (D == 32) return tx * 2 + e;
    return (e / 4) * 64 + tx * 4 + (e % 4);
  }
  __device__ static __forceinline__ void load(const float* row, int tx,
                                              float (&o)[N]) {
    if constexpr (D == 32) {
      const float2 t = *reinterpret_cast<const float2*>(row + tx * 2);
      o[0] = t.x;
      o[1] = t.y;
    } else {
#pragma unroll
      for (int g = 0; g < N / 4; ++g) {
        const float4 t = load4(row + g * 64 + tx * 4);
        o[g * 4] = t.x;
        o[g * 4 + 1] = t.y;
        o[g * 4 + 2] = t.z;
        o[g * 4 + 3] = t.w;
      }
    }
  }
};

// acc[i][:] += sum_j P[4 ty + i][j] * X[j][cols]: P (64, 64) at stride kSP,
// X (64, D) at stride D + 4
template <int D>
__device__ __forceinline__ void acc_pv(float (&acc)[4][D / 16],
                                       const float* sp, const float* sx,
                                       int ty, int tx) {
  constexpr int SD = D + 4, N = D / 16;
#pragma unroll 2
  for (int j = 0; j < kTile; j += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = load4(sp + (ty * 4 + i) * kSP + j);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x[N];
      Cols<D>::load(sx + (j + e) * SD, tx, x);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pe = e == 0 ? p[i].x : e == 1 ? p[i].y
                       : e == 2 ? p[i].z : p[i].w;
#pragma unroll
        for (int n = 0; n < N; ++n) acc[i][n] = fmaf(pe, x[n], acc[i][n]);
      }
    }
  }
}

// s[i][c] = A[4 ty + i] . B[tx + 16 c] over D: A, B (64, D) at stride D + 4
template <int D>
__device__ __forceinline__ void dot_tile(float (&s)[4][4], const float* sa,
                                         const float* sb, int ty, int tx) {
  constexpr int SD = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = load4(sa + (ty * 4 + i) * SD + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = load4(sb + (tx + 16 * c) * SD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float t = s[i][c];
        t = fmaf(a[i].x, b[c].x, t);
        t = fmaf(a[i].y, b[c].y, t);
        t = fmaf(a[i].z, b[c].z, t);
        t = fmaf(a[i].w, b[c].w, t);
        s[i][c] = t;
      }
  }
}

// max / sum across the 16 lanes of a row group
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The mask of one (batch, head): rows and keys at or past L, keys at or
// past kvlen, the causal and the band conditions.
struct Mask {
  int L, klim, causal, window;  // window < 0: no band
  __device__ bool valid(int i, int j) const {
    return i < L && j < klim && (!causal || j <= i) &&
           (window < 0 || abs(i - j) <= window);
  }
  // some element of the tile rows [q0, q0+64) x keys [k0, k0+64) is valid
  __device__ bool needed(int q0, int k0) const {
    const int q1 = q0 + kTile - 1, k1 = k0 + kTile - 1;
    return q0 < L && k0 < klim && (!causal || k0 <= q1) &&
           (window < 0 || (k0 <= q1 + window && k1 >= q0 - window));
  }
  // every element of the tile is valid: no per-element mask
  __device__ bool interior(int q0, int k0) const {
    const int q1 = q0 + kTile - 1, k1 = k0 + kTile - 1;
    return q1 < L && k1 < klim && (!causal || k1 <= q0) &&
           (window < 0 || (q1 - k0 <= window && k1 - q0 <= window));
  }
};

struct Args {
  const void *q, *k, *v, *dout, *lse_in, *delta;
  const long long* seed;  // one int64 holding the uint32 seed, or null
  const int* kvlen;       // (B,) int32, or null
  void *out, *lse_out, *dq, *dk, *dv;
  int H, L;
  float scale;
  int causal, window;
  uint32_t thr;
  float ks;
};

__device__ __forceinline__ Mask mask_of(const Args& a, int bh) {
  Mask m;
  m.L = a.L;
  m.klim = a.L;
  if (a.kvlen) m.klim = min(max(a.kvlen[bh / a.H], 0), a.L);
  m.causal = a.causal;
  m.window = a.window;
  return m;
}

__device__ __forceinline__ float keep_of(const Args& a, uint32_t s, int bh,
                                         int i, int j) {
  return mxt_keep_hash(s, (uint32_t)bh, (uint32_t)i, (uint32_t)j) >= a.thr
             ? a.ks
             : 0.f;
}

// the k tiles [lo, hi] that rows [q0, q0 + 64) can see
__device__ __forceinline__ void k_range(const Mask& m, int q0, int& lo,
                                        int& hi) {
  const int q1 = q0 + kTile - 1;
  lo = 0;
  hi = (m.klim + kTile - 1) / kTile - 1;
  if (m.causal) hi = min(hi, q1 / kTile);
  if (m.window >= 0) {
    hi = min(hi, (q1 + m.window) / kTile);
    lo = max(0, q0 - m.window) / kTile;
  }
}

// ---------------------------------------------------------------------------
// #5 forward: grid (q tiles, BH)
// ---------------------------------------------------------------------------
template <class T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Args a) {
  constexpr int SD = D + 4, N = D / 16;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sk = sq + kTile * SD;
  float* sv = sk + kTile * SD;
  float* sp = sv + kTile * SD;
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t base = (size_t)bh * a.L * D;
  const Mask m = mask_of(a, bh);
  const uint32_t seed = a.seed ? (uint32_t)a.seed[0] : 0u;
  load_tile<T, D>(sq, static_cast<const T*>(a.q) + base, q0, a.L);

  float mx[4], l[4], acc[4][N];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mx[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) acc[i][n] = 0.f;
  }
  int lo, hi;
  k_range(m, q0, lo, hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * kTile;
    if (!m.needed(q0, k0)) continue;
    __syncthreads();  // the last tile's reads of sk, sv, sp are done
    load_tile<T, D>(sk, static_cast<const T*>(a.k) + base, k0, a.L);
    load_tile<T, D>(sv, static_cast<const T*>(a.v) + base, k0, a.L);
    __syncthreads();
    float s[4][4];
    dot_tile<D>(s, sq, sk, ty, tx);
    const bool edge = !m.interior(q0, k0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gi = q0 + ty * 4 + i;
      bool ok[4];
      float cur = kMasked;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ok[c] = !edge || m.valid(gi, k0 + tx + 16 * c);
        s[i][c] = ok[c] ? s[i][c] * a.scale : kMasked;
        cur = fmaxf(cur, s[i][c]);
      }
      const float mnew = fmaxf(mx[i], row_max(cur));
      const float alpha = expf(mx[i] - mnew);
      float p[4], sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = ok[c] ? expf(s[i][c] - mnew) : 0.f;
        sum += p[c];
      }
      l[i] = l[i] * alpha + row_sum(sum);
      mx[i] = mnew;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float pd = p[c];
        if (a.seed) pd *= keep_of(a, seed, bh, gi, k0 + tx + 16 * c);
        sp[(ty * 4 + i) * kSP + tx + 16 * c] = round_as<T>(pd);
      }
#pragma unroll
      for (int n = 0; n < N; ++n) acc[i][n] *= alpha;
    }
    __syncthreads();
    acc_pv<D>(acc, sp, sv, ty, tx);
  }
  T* out = static_cast<T*>(a.out) + base;
  float* lse = static_cast<float*>(a.lse_out) + (size_t)bh * a.L;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = q0 + ty * 4 + i;
    if (gi >= a.L) continue;
    const bool empty = l[i] == 0.f;
    const float den = empty ? 1.f : l[i];
    float o[N];
#pragma unroll
    for (int n = 0; n < N; ++n) o[n] = acc[i][n] / den;
    if constexpr (D == 32) {
      out[(size_t)gi * D + tx * 2] = cvt<T>(o[0]);
      out[(size_t)gi * D + tx * 2 + 1] = cvt<T>(o[1]);
    } else {
#pragma unroll
      for (int g = 0; g < N / 4; ++g)
        store4(out + (size_t)gi * D + g * 64 + tx * 4,
               make_float4(o[g * 4], o[g * 4 + 1], o[g * 4 + 2],
                           o[g * 4 + 3]));
    }
    if (tx == 0) lse[gi] = empty ? -INFINITY : mx[i] + logf(den);
  }
}

// ---------------------------------------------------------------------------
// #6 backward dq: grid (q tiles, BH), streams k tiles
// ---------------------------------------------------------------------------
template <class T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(Args a) {
  constexpr int SD = D + 4, N = D / 16;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sdo = sq + kTile * SD;
  float* sk = sdo + kTile * SD;
  float* sv = sk + kTile * SD;
  float* sp = sv + kTile * SD;
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t base = (size_t)bh * a.L * D;
  const Mask m = mask_of(a, bh);
  const uint32_t seed = a.seed ? (uint32_t)a.seed[0] : 0u;
  load_tile<T, D>(sq, static_cast<const T*>(a.q) + base, q0, a.L);
  load_tile<T, D>(sdo, static_cast<const T*>(a.dout) + base, q0, a.L);
  const float* lse_g = static_cast<const float*>(a.lse_in) + (size_t)bh * a.L;
  const float* dl_g = static_cast<const float*>(a.delta) + (size_t)bh * a.L;
  float lse[4], delta[4], acc[4][N];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = q0 + ty * 4 + i;
    lse[i] = gi < a.L ? lse_g[gi] : -INFINITY;
    delta[i] = gi < a.L ? dl_g[gi] : 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) acc[i][n] = 0.f;
  }
  int lo, hi;
  k_range(m, q0, lo, hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * kTile;
    if (!m.needed(q0, k0)) continue;
    __syncthreads();
    load_tile<T, D>(sk, static_cast<const T*>(a.k) + base, k0, a.L);
    load_tile<T, D>(sv, static_cast<const T*>(a.v) + base, k0, a.L);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<D>(s, sq, sk, ty, tx);
    dot_tile<D>(dp, sdo, sv, ty, tx);
    const bool edge = !m.interior(q0, k0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gi = q0 + ty * 4 + i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int gj = k0 + tx + 16 * c;
        const bool ok = (!edge || m.valid(gi, gj)) && lse[i] != -INFINITY;
        const float p = ok ? expf(s[i][c] * a.scale - lse[i]) : 0.f;
        float d = dp[i][c];
        if (a.seed) d *= keep_of(a, seed, bh, gi, gj);
        sp[(ty * 4 + i) * kSP + tx + 16 * c] =
            round_as<T>(p * (d - delta[i]));
      }
    }
    __syncthreads();
    acc_pv<D>(acc, sp, sk, ty, tx);
  }
  T* dq = static_cast<T*>(a.dq) + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = q0 + ty * 4 + i;
    if (gi >= a.L) continue;
#pragma unroll
    for (int n = 0; n < N; ++n)
      dq[(size_t)gi * D + Cols<D>::col(tx, n)] = cvt<T>(acc[i][n] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// #7 backward dk, dv: grid (k tiles, BH), streams q tiles; the block owns
// its 64 key rows, so no atomics
// ---------------------------------------------------------------------------
template <class T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(Args a) {
  constexpr int SD = D + 4, N = D / 16;
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);
  float* sv = sk + kTile * SD;
  float* sq = sv + kTile * SD;
  float* sdo = sq + kTile * SD;
  float* sp = sdo + kTile * SD;
  float* slse = sp + kTile * kSP;
  float* sdl = slse + kTile;
  const int bh = blockIdx.y, k0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t base = (size_t)bh * a.L * D;
  const Mask m = mask_of(a, bh);
  const uint32_t seed = a.seed ? (uint32_t)a.seed[0] : 0u;
  load_tile<T, D>(sk, static_cast<const T*>(a.k) + base, k0, a.L);
  load_tile<T, D>(sv, static_cast<const T*>(a.v) + base, k0, a.L);
  const float* lse_g = static_cast<const float*>(a.lse_in) + (size_t)bh * a.L;
  const float* dl_g = static_cast<const float*>(a.delta) + (size_t)bh * a.L;
  float dk[4][N], dv[4][N];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < N; ++n) dk[i][n] = dv[i][n] = 0.f;
  // the q tiles that can see keys [k0, k0 + 64)
  const int k1 = k0 + kTile - 1;
  int lo = 0, hi = (a.L + kTile - 1) / kTile - 1;
  if (m.causal) lo = k0 / kTile;
  if (m.window >= 0) {
    lo = max(lo, max(0, k0 - m.window) / kTile);
    hi = min(hi, (k1 + m.window) / kTile);
  }
  if (k0 >= m.klim) hi = lo - 1;
  for (int qt = lo; qt <= hi; ++qt) {
    const int q0 = qt * kTile;
    if (!m.needed(q0, k0)) continue;
    __syncthreads();
    load_tile<T, D>(sq, static_cast<const T*>(a.q) + base, q0, a.L);
    load_tile<T, D>(sdo, static_cast<const T*>(a.dout) + base, q0, a.L);
    if (threadIdx.x < kTile) {
      const int gi = q0 + threadIdx.x;
      slse[threadIdx.x] = gi < a.L ? lse_g[gi] : -INFINITY;
      sdl[threadIdx.x] = gi < a.L ? dl_g[gi] : 0.f;
    }
    __syncthreads();
    // transposed tiles: row = key 4 ty + i, column = query tx + 16 c
    float st[4][4], dpt[4][4];
    dot_tile<D>(st, sk, sq, ty, tx);
    dot_tile<D>(dpt, sv, sdo, ty, tx);
    const bool edge = !m.interior(q0, k0);
    float ds[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gj = k0 + ty * 4 + i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qc = tx + 16 * c, gi = q0 + qc;
        const float lse = slse[qc];
        const bool ok = (!edge || m.valid(gi, gj)) && lse != -INFINITY;
        const float p = ok ? expf(st[i][c] * a.scale - lse) : 0.f;
        const float keep = a.seed ? keep_of(a, seed, bh, gi, gj) : 1.f;
        sp[(ty * 4 + i) * kSP + qc] = round_as<T>(p * keep);
        ds[i][c] = round_as<T>(p * (dpt[i][c] * keep - sdl[qc]));
      }
    }
    __syncthreads();
    acc_pv<D>(dv, sp, sdo, ty, tx);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        sp[(ty * 4 + i) * kSP + tx + 16 * c] = ds[i][c];
    __syncthreads();
    acc_pv<D>(dk, sp, sq, ty, tx);
  }
  T* dkp = static_cast<T*>(a.dk) + base;
  T* dvp = static_cast<T*>(a.dv) + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gj = k0 + ty * 4 + i;
    if (gj >= a.L) continue;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const size_t o = (size_t)gj * D + Cols<D>::col(tx, n);
      dkp[o] = cvt<T>(dk[i][n] * a.scale);
      dvp[o] = cvt<T>(dv[i][n]);
    }
  }
}

// shared memory of each kernel, in bytes
template <int D>
constexpr int smem_fwd() {
  return (3 * kTile * (D + 4) + kTile * kSP) * 4;
}
template <int D>
constexpr int smem_dq() {
  return (4 * kTile * (D + 4) + kTile * kSP) * 4;
}
template <int D>
constexpr int smem_dkv() {
  return (4 * kTile * (D + 4) + kTile * kSP + 2 * kTile) * 4;
}

enum Which { kFwd, kDq, kDkv };

template <class T, int D, Which W>
int launch(const Args& a, int BH, cudaStream_t st) {
  auto kernel = W == kFwd  ? flash_fwd_kernel<T, D>
                : W == kDq ? flash_bwd_dq_kernel<T, D>
                           : flash_bwd_dkv_kernel<T, D>;
  constexpr int smem = W == kFwd  ? smem_fwd<D>()
                       : W == kDq ? smem_dq<D>()
                                  : smem_dkv<D>();
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((a.L + kTile - 1) / kTile, BH);
  kernel<<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <Which W>
int dispatch(const Args& a, int BH, int D, int dtype, cudaStream_t st) {
  if (dtype == 0) {
    if (D == 32) return launch<float, 32, W>(a, BH, st);
    if (D == 64) return launch<float, 64, W>(a, BH, st);
    if (D == 128) return launch<float, 128, W>(a, BH, st);
  } else {
    if (D == 32) return launch<__nv_bfloat16, 32, W>(a, BH, st);
    if (D == 64) return launch<__nv_bfloat16, 64, W>(a, BH, st);
    if (D == 128) return launch<__nv_bfloat16, 128, W>(a, BH, st);
  }
  return (int)cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, const void* seed,
               const void* kvlen, int H, int L, float scale, int causal,
               int window, unsigned thr, float ks) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.seed = static_cast<const long long*>(seed);
  a.kvlen = static_cast<const int*>(kvlen);
  a.H = H;
  a.L = L;
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  a.thr = thr;
  a.ks = ks;
  return a;
}

}  // namespace

extern "C" const char* mxt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Common arguments: q, k, v (BH, L, D) contiguous, 16-byte aligned, of
// dtype 0 float32 or 1 bfloat16; D in {32, 64, 128}; BH <= 65535.  seed:
// one int64 on the card (its low 32 bits the seed), or null for no
// dropout; kvlen: (BH / H,) int32 on the card, or null for no padding
// mask; window < 0 for no band; thr and ks: the rate's uint32 keep
// threshold and keep scale.  Each returns cudaGetLastError() after its
// launch.

// out (BH, L, D) in the input dtype; lse (BH, L) float32
extern "C" int mxt_flash_fwd(const void* q, const void* k, const void* v,
                             const void* seed, const void* kvlen, void* out,
                             void* lse, int BH, int H, int L, int D,
                             int dtype, float scale, int causal, int window,
                             unsigned thr, float ks, void* stream) {
  Args a = make_args(q, k, v, seed, kvlen, H, L, scale, causal, window, thr,
                     ks);
  a.out = out;
  a.lse_out = lse;
  return dispatch<kFwd>(a, BH, D, dtype, (cudaStream_t)stream);
}

// dout, dq (BH, L, D) in the input dtype; lse, delta (BH, L) float32
extern "C" int mxt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* seed,
                                const void* kvlen, void* dq, int BH, int H,
                                int L, int D, int dtype, float scale,
                                int causal, int window, unsigned thr,
                                float ks, void* stream) {
  Args a = make_args(q, k, v, seed, kvlen, H, L, scale, causal, window, thr,
                     ks);
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.dq = dq;
  return dispatch<kDq>(a, BH, D, dtype, (cudaStream_t)stream);
}

// dk, dv (BH, L, D) in the input dtype
extern "C" int mxt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* seed,
                                 const void* kvlen, void* dk, void* dv,
                                 int BH, int H, int L, int D, int dtype,
                                 float scale, int causal, int window,
                                 unsigned thr, float ks, void* stream) {
  Args a = make_args(q, k, v, seed, kvlen, H, L, scale, causal, window, thr,
                     ks);
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  return dispatch<kDkv>(a, BH, D, dtype, (cudaStream_t)stream);
}
