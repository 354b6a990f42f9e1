// Weight-only quantized matmul: y = x @ dequant(W).T in fp32, with the
// integer weight dequantized inside the kernel, never written out at full
// width.  Wrapped by mxnet_tpu_torch/ops/kernels/quant_matmul.py, whose
// qmm_plan picks the K split, the tiles and the variant below.
//
// Replaces the TPU kernels _qmm8_kernel (int8 codes, one scale per output
// channel; mxnet_tpu/ops/pallas/quant_matmul.py:179) and _qmm4_kernel (int4
// codes packed two per byte, low nibble = even input index, one scale per
// group of `group` inputs; :185).
//
// x (M, I) fp32, q (O, I) int8 or (O, I/2) uint8, s (O,) or (O, I/group)
// fp32 -> y (M, O) fp32, for any I (even for int4).  On the serving path M
// is a decode batch (<= 16) or a prefill chunk (64), and (O, I) is
// (768, 768), (3072, 768) or (768, 3072); a tensor-parallel shard has
// I 384, 192 or 1536.
//
// Bound on the card: at M <= 16 the code bytes (int8 O*I, int4 O*I/2),
// since each code serves only M rows; at M 64 the products, two tf32
// tensor-core products per fp32 product (the codes are exact in tf32, x is
// split in two).  Either is under 1.3 us at the path's shapes, so a launch
// is its fixed costs: the card's SMs all reading at once, and few phases.
// - K is split across the blocks of a thread-block cluster (<= 8): rank r
//   owns the r-th K slice, whole 128-input stages, the last ending at I.
//   A block owns 16 channels and 8 rows (M <= 8), 32 channels and 16 rows
//   (M <= 16), or 64 channels and 32 rows (M > 16), so a layer's GEMMs
//   launch 144 to 576 blocks, not the 24 to 96 of a whole-K design.
// - A block stages only its own K slice: each stage of codes, of x and,
//   for grouped int4, of the group scales lands in shared memory by
//   cp.async (16 bytes, or 4 and 1 where a row is not 16-byte aligned:
//   x I % 4, codes int8 I % 16, int4 I % 32), zero-filled past I, in a
//   ring deep enough for the whole slice where it fits: all of a slice's
//   bytes are in flight at once.  (Bulk copies of whole rows onto an
//   mbarrier were slower at every decode shape: chip_flash_ab.py's qmm
//   phase.)
// - Up to 16 rows, products on mma.sync m16n8k8 tf32, channels on the 16
//   rows (y^T = W x^T) and rows of x on the 8 columns.  A warp owns 16
//   channels and 32-input chunks of each stage (the block's warps split a
//   stage's 4 chunks 4 or 2 ways); lane (g, t) reads inputs 8t..8t+7 of a
//   chunk at once (its codes as one 8- or 4-byte word per channel row, x
//   as two float4), and k-step j takes inputs 8t + 2j and 8t + 2j + 1 as
//   the MMA's k columns t and t + 4.  A code is exact in tf32: one piece.
//   x is split as hi = tf32(x), lo = tf32(x - hi), both rounded as
//   cvt.rna.tf32.f32 rounds (an integer add and mask); each k-step issues
//   A*hi, then A*lo.
// - Above 16 rows, products on wgmma m64n32k8 tf32 (mma.sync's tf32 rate
//   bound the prefill chunk): the block's 4 warps are one warpgroup over
//   its 64 channels.  x lands as 128-byte swizzled boxes of 32 rows x 32
//   inputs; the block writes each box's residual x - tf32(x) beside it,
//   and a stage's products go as one group: A = the codes from registers
//   (inputs 8j + t, 8j + t + 4 of k-step j), B = the box (the tensor core
//   reads tf32(x), truncated), then its residual box.
// - int8 sums the products of its codes and multiplies the sum by s[o]
//   once, after the slices are summed.  int4 with a group that is a
//   multiple of 32 sums each chunk's products apart and adds s[o, group]
//   times them into the running sum (a chunk lies in one group).  Any
//   other group (a small or odd one, as w4_group gives for an input dim
//   that 128 does not divide) folds the scale into the weight: code * s
//   in fp32, split like x, and three products (hi hi, hi lo, lo hi).
// - The slices are summed in a fixed order in the same launch: each rank
//   stages its warps' partial tiles in shared memory, sends each float4 of
//   them to the rank that sums it (distributed shared memory), and after
//   the cluster's barrier each rank sums its share of the tile over the
//   slots in order (ranks, then each rank's stage parts), scales it (int8)
//   and writes y.  No atomics: the same inputs give the same bits at
//   every launch.
// So the kernel differs from the plain version's x @ (q * s).T in the
// order of its fp32 sums, in x's split (x - hi - lo is within 2^-21 of x),
// and for int8 and the grouped int4 in where the scale is rounded in: they
// agree to fp32 rounding, not bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int KSTAGE = 128;   // inputs per pipeline stage
constexpr int KCHUNK = 32;    // inputs per warp chunk: 4 k-steps of 8
constexpr int CHUNKS = KSTAGE / KCHUNK;
constexpr int XP = KSTAGE * 4 + 16;  // bytes per row of x in a stage
constexpr int SMEM_BUDGET = 200 * 1024;  // the deepest ring
// %globaltimer stamps a block: start, the ring's first loads issued, the
// products done, the partials sent, the cluster's barrier passed, its
// share of y written
constexpr int STAMPS = 6;

// A block's tiles and shared memory.  Row pitches are padded so that a
// warp's reads of its fragments are free of bank conflicts: x float4s at
// rows g, columns 8t (pitch 16 mod 128 bytes), int8 code words of 8 bytes
// (pitch 32 mod 128), int4 words of 4 bytes (16 mod 128).
template <int FMT, int WCH, int NT, bool FOLD, bool WG>
struct Cfg {
  static constexpr int BO = 16 * WCH;       // output channels a block
  static constexpr int KW = WARPS / WCH;    // warps splitting a stage
  static constexpr int MT = 8 * NT;         // rows of x a block
  static constexpr int CP = FMT == 8 ? KSTAGE + 32 : KSTAGE / 2 + 16;
  static constexpr int CODES = BO * CP;
  static constexpr int SCALES = FMT == 4 && !FOLD ? BO * CHUNKS * 4 : 0;
  // wgmma reads x as 128-byte swizzled boxes of MT rows x 32 inputs, one
  // a chunk, each on a 1024-byte boundary
  static constexpr int PRE =
      WG ? (CODES + SCALES + 1023) / 1024 * 1024 : CODES + SCALES;
  static constexpr int BOX = MT * 128;
  static constexpr int STAGE = PRE + (WG ? CHUNKS * BOX : MT * XP);
  static constexpr int ALIGN = WG ? 1024 : 0;  // to align the ring's base
  static constexpr int LO = WG ? CHUNKS * BOX : 0;  // x's residuals
  static_assert(!WG || (WCH == 4 && NT == 4), "wgmma: 64 channels, N 32");
  // the deepest ring the budget holds, 2 to 8 stages
  static constexpr int NBUF = SMEM_BUDGET / STAGE > 8
                                  ? 8
                                  : (SMEM_BUDGET / STAGE < 2
                                         ? 2
                                         : SMEM_BUDGET / STAGE);
  static constexpr int S8 = FMT == 8 ? (BO * 4 + 15) / 16 * 16 : 0;  // s[o]
  static constexpr int E4 = MT * BO / 4;    // float4s of an output tile
  static constexpr int RP = BO + 4;         // floats a row of a partial
  static_assert(KW * MT * RP * 4 <= STAGE, "the partials fit a stage");
  static_assert(CODES % 16 == 0 && SCALES % 16 == 0 && STAGE % 16 == 0,
                "16-byte aligned stage parts");
  // ring depth for a slice of `slice` inputs: all its stages in flight
  // when they fit (one stage more than the slice, which is never filled)
  __host__ __device__ static int depth(int slice) {
    return min(NBUF, slice / KSTAGE + 1);
  }
  __host__ __device__ static int ring(int slice) {
    return min(depth(slice), slice / KSTAGE) * STAGE;
  }
  // per rank: the float4s of the tile it sums (of E4 or fewer rows)
  __host__ __device__ static int share(int e4, int ks) {
    return (e4 + ks - 1) / ks;
  }
  // the ring, (wgmma) a residual box, the int8 scales, then the partials
  // the cluster sends this block: KW * ks slots of its share
  __host__ __device__ static int smem(int slice, int ks) {
    return ALIGN + ring(slice) + LO + S8 + KW * ks * share(E4, ks) * 16;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most n (runtime, <= 7) groups are pending
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// every thread of the cluster has arrived; shared-memory writes before
// the barrier are visible to the cluster's reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// the generic address of `p`'s place in block `rank`'s shared memory
__device__ __forceinline__ float* cluster_ptr(float* p, int rank) {
  uint64_t r;
  asm("mapa.u64 %0, %1, %2;" : "=l"(r) : "l"(p), "r"(rank));
  return reinterpret_cast<float*>(r);
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// x rounded to tf32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero, on the magnitude's bits), for finite x
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// code as the tf32 operand (exact: |code| <= 127)
__device__ __forceinline__ uint32_t code_bits(int c) {
  return __float_as_uint((float)c);
}

__device__ __forceinline__ int byte_s8(uint2 w, int i) {  // i < 8
  const unsigned v = i < 4 ? w.x : w.y;
  return (int)(v << (24 - 8 * (i & 3))) >> 24;
}

__device__ __forceinline__ int nib_s4(unsigned w, int i) {  // i < 8
  return (int)(w << (28 - 4 * i)) >> 28;
}

// One stage on mma.sync: warp (sub, kp) takes the stage's chunks kp,
// kp + KW, ... for its 16 channels r0, r0 + 8 (see the note at the top).
template <int FMT, int WCH, int NT, bool FOLD>
__device__ __forceinline__ void mma_stage(
    const unsigned char* cs, const float* ss, const unsigned char* xs,
    float (&acc)[NT][4], const float* __restrict__ s, int O, int I, int G,
    int group, int o0, int kst, int hi, int r0, int g, int t, int kp,
    int mv) {
  constexpr int KW = WARPS / WCH;
  constexpr int CP = FMT == 8 ? KSTAGE + 32 : KSTAGE / 2 + 16;
#pragma unroll
  for (int c = kp; c < CHUNKS; c += KW) {
    const int kc = kst + c * KCHUNK;
    if (kc >= hi) break;  // the same for the whole warp
    // A fragments of the chunk's 4 k-steps: a[j] = rows (g, g+8) x
    // inputs (8t + 2j, 8t + 2j + 1); FOLD: hi and lo of code * scale
    uint32_t a[4][4], al[4][4];
    if constexpr (FMT == 8) {
      const uint2 w0 =
          *reinterpret_cast<const uint2*>(cs + r0 * CP + c * 32 + 8 * t);
      const uint2 w1 = *reinterpret_cast<const uint2*>(
          cs + (r0 + 8) * CP + c * 32 + 8 * t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[j][0] = code_bits(byte_s8(w0, 2 * j));
        a[j][1] = code_bits(byte_s8(w1, 2 * j));
        a[j][2] = code_bits(byte_s8(w0, 2 * j + 1));
        a[j][3] = code_bits(byte_s8(w1, 2 * j + 1));
      }
    } else {
      const unsigned w0 =
          *reinterpret_cast<const unsigned*>(cs + r0 * CP + c * 16 + 4 * t);
      const unsigned w1 = *reinterpret_cast<const unsigned*>(
          cs + (r0 + 8) * CP + c * 16 + 4 * t);
      if constexpr (FOLD) {
        const float* sa = s + (size_t)min(o0 + r0, O - 1) * G;
        const float* sb = s + (size_t)min(o0 + r0 + 8, O - 1) * G;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = min(kc + 8 * t + 2 * j + h, I - 1) / group;
            split((float)nib_s4(w0, 2 * j + h) * __ldg(sa + k),
                  a[j][2 * h], al[j][2 * h]);
            split((float)nib_s4(w1, 2 * j + h) * __ldg(sb + k),
                  a[j][2 * h + 1], al[j][2 * h + 1]);
          }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[j][0] = code_bits(nib_s4(w0, 2 * j));
          a[j][1] = code_bits(nib_s4(w1, 2 * j));
          a[j][2] = code_bits(nib_s4(w0, 2 * j + 1));
          a[j][3] = code_bits(nib_s4(w1, 2 * j + 1));
        }
      }
    }
    constexpr bool GROUPED = FMT == 4 && !FOLD;
    float part[NT][4];  // GROUPED: this chunk's products, unscaled
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float(&d)[4] = GROUPED ? part[n] : acc[n];
      if constexpr (GROUPED) {
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e] = 0.f;
      }
      if (8 * n >= mv) continue;  // no row of this tile: the same warp-wide
      const float* xr = reinterpret_cast<const float*>(
                            xs + (8 * n + g) * XP) +
                        c * KCHUNK + 8 * t;
      const bool row = 8 * n + g < mv;  // rows past M take zeros
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 v0 = row ? *reinterpret_cast<const float4*>(xr) : zero;
      const float4 v1 =
          row ? *reinterpret_cast<const float4*>(xr + 4) : zero;
      const float xv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
      uint32_t bh[8], bl[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) split(xv[i], bh[i], bl[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_tf32(d, a[j], bh[2 * j], bh[2 * j + 1]);
        mma_tf32(d, a[j], bl[2 * j], bl[2 * j + 1]);
        if constexpr (FOLD) mma_tf32(d, al[j], bh[2 * j], bh[2 * j + 1]);
      }
    }
    if constexpr (GROUPED) {
      const float s0 = ss[r0 * CHUNKS + c], s1 = ss[(r0 + 8) * CHUNKS + c];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] += s0 * part[n][0];
        acc[n][1] += s0 * part[n][1];
        acc[n][2] += s1 * part[n][2];
        acc[n][3] += s1 * part[n][3];
      }
    }
  }
}

// One stage of a 64-channel, 32-row block on wgmma (M > 16): the block
// writes the residuals x - tf32(x) of the stage's x boxes into lo (same
// layout), then issues one warpgroup product per chunk, k-step and piece
// as one group: A = the codes (or, with FOLD, code * scale as hi and lo)
// from registers, channels on its 64 rows; B = the box (the tensor core
// reads tf32(x), truncated) and its residual box.  Lane (g, t) of warp w
// holds channels 16w + g (+8) and inputs 8j + t (+4) of k-step j, as the
// tf32 A fragment lays them out.  int4 with groups keeps each chunk's
// products apart and scales them once the stage's products are done.
template <int FMT, bool FOLD>
__device__ __forceinline__ void wg_stage(
    const unsigned char* cs, const float* ss, const unsigned char* xs,
    float* lo, float (&acc)[4][4], const float* __restrict__ s, int O, int I,
    int G, int group, int o0, int kst, int hi, int r0, int t, int tid) {
  constexpr int NT = 4, MT = 8 * NT, BOX = MT * 128;
  constexpr int CP = FMT == 8 ? KSTAGE + 32 : KSTAGE / 2 + 16;
  constexpr bool GROUPED = FMT == 4 && !FOLD;
  const int nch = min(CHUNKS, (hi - kst + KCHUNK - 1) / KCHUNK);
  const float4* box = reinterpret_cast<const float4*>(xs);
  for (int i = tid; i < nch * BOX / 16; i += THREADS) {
    float4 v = box[i];
    v.x = tf32_residual(v.x);
    v.y = tf32_residual(v.y);
    v.z = tf32_residual(v.z);
    v.w = tf32_residual(v.w);
    reinterpret_cast<float4*>(lo)[i] = v;
  }
  fence_async_shared();
  __syncthreads();
  uint32_t a[CHUNKS][4][4], al[CHUNKS][4][4];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    if (c >= nch) break;
    const int kc = kst + c * KCHUNK;
    if constexpr (FMT == 8) {
      const uint4* p0 = reinterpret_cast<const uint4*>(cs + r0 * CP + c * 32);
      const uint4* p1 =
          reinterpret_cast<const uint4*>(cs + (r0 + 8) * CP + c * 32);
      const uint4 u0 = p0[0], u1 = p0[1], v0 = p1[0], v1 = p1[1];
      const unsigned w0[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
      const unsigned w1[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // inputs 8j + t: word 2j, byte t
        a[c][j][0] = code_bits((int)(w0[2 * j] << (24 - 8 * t)) >> 24);
        a[c][j][1] = code_bits((int)(w1[2 * j] << (24 - 8 * t)) >> 24);
        a[c][j][2] = code_bits((int)(w0[2 * j + 1] << (24 - 8 * t)) >> 24);
        a[c][j][3] = code_bits((int)(w1[2 * j + 1] << (24 - 8 * t)) >> 24);
      }
    } else {
      const uint4 u0 =
          *reinterpret_cast<const uint4*>(cs + r0 * CP + c * 16);
      const uint4 u1 =
          *reinterpret_cast<const uint4*>(cs + (r0 + 8) * CP + c * 16);
      const unsigned w0[4] = {u0.x, u0.y, u0.z, u0.w};
      const unsigned w1[4] = {u1.x, u1.y, u1.z, u1.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // inputs 8j + t: word j, nibble t
        const int n0 = nib_s4(w0[j], t), n1 = nib_s4(w1[j], t);
        const int n2 = nib_s4(w0[j], t + 4), n3 = nib_s4(w1[j], t + 4);
        if constexpr (FOLD) {
          const float* sa = s + (size_t)min(o0 + r0, O - 1) * G;
          const float* sb = s + (size_t)min(o0 + r0 + 8, O - 1) * G;
          const int k0 = min(kc + 8 * j + t, I - 1) / group;
          const int k1 = min(kc + 8 * j + t + 4, I - 1) / group;
          split((float)n0 * __ldg(sa + k0), a[c][j][0], al[c][j][0]);
          split((float)n1 * __ldg(sb + k0), a[c][j][1], al[c][j][1]);
          split((float)n2 * __ldg(sa + k1), a[c][j][2], al[c][j][2]);
          split((float)n3 * __ldg(sb + k1), a[c][j][3], al[c][j][3]);
        } else {
          a[c][j][0] = code_bits(n0);
          a[c][j][1] = code_bits(n1);
          a[c][j][2] = code_bits(n2);
          a[c][j][3] = code_bits(n3);
        }
      }
    }
  }
  float part[GROUPED ? CHUNKS : 1][NT][4];
  if constexpr (GROUPED) {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[c][n][e] = 0.f;
  }
  const uint32_t hb = smem_u32(xs), lb = smem_u32(lo);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    if (c >= nch) break;
    float(&d)[MT / 2] = reinterpret_cast<float(&)[MT / 2]>(
        GROUPED ? part[GROUPED ? c : 0] : acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int off = c * BOX + 32 * j;
      wgmma_tf32_rs<MT>(d, a[c][j], gmma_desc(hb + off, 1, 1024));
      wgmma_tf32_rs<MT>(d, a[c][j], gmma_desc(lb + off, 1, 1024));
      if constexpr (FOLD)
        wgmma_tf32_rs<MT>(d, al[c][j], gmma_desc(hb + off, 1, 1024));
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(reinterpret_cast<float(&)[MT / 2]>(acc));
  if constexpr (GROUPED) {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      if (c >= nch) break;
      fence_regs(reinterpret_cast<float(&)[MT / 2]>(part[c]));
      const float s0 = ss[r0 * CHUNKS + c], s1 = ss[(r0 + 8) * CHUNKS + c];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] += s0 * part[c][n][0];
        acc[n][1] += s0 * part[c][n][1];
        acc[n][2] += s1 * part[c][n][2];
        acc[n][3] += s1 * part[c][n][3];
      }
    }
  }
}

template <int FMT, int WCH, int NT, bool FOLD, bool WG>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const float* __restrict__ x, const uint8_t* __restrict__ q,
           const float* __restrict__ s, float* __restrict__ y, int M, int O,
           int I, int G, int group, int slice, int xvec, int qvec,
           unsigned long long* __restrict__ stamps) {
  using C = Cfg<FMT, WCH, NT, FOLD, WG>;
  constexpr int BO = C::BO, KW = C::KW, MT = C::MT, CP = C::CP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =  // wgmma: the ring from a 1024-byte boundary
      WG ? smem_raw + ((0u - smem_u32(smem_raw)) & 1023u) : smem_raw;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int sub = warp % WCH, kp = warp / WCH;  // channel tile, stage part
  const int rank = blockIdx.x, ks = gridDim.x;  // K slice = cluster rank
  const int o0 = blockIdx.y * BO, m0 = blockIdx.z * MT;
  const int lo = rank * slice, hi = min(I, lo + slice);
  const int nst = (hi - lo + KSTAGE - 1) / KSTAGE;
  const size_t row_bytes = FMT == 8 ? (size_t)I : (size_t)I / 2;
  // phase stamps (STAMPS a block; qmm_phase_times), thread 0 only
  unsigned long long* stamp =
      stamps && tid == 0
          ? stamps + STAMPS * (blockIdx.x +
                               gridDim.x * (blockIdx.y +
                                            gridDim.y * (size_t)blockIdx.z))
          : nullptr;
  if (stamp) stamp[0] = globaltimer();
  // the cluster's blocks have all started before one writes another's
  // shared memory: arrive now, wait before the first such write
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int mv = min(MT, M - m0);  // rows of x this block has
  const int depth = C::depth(slice);

  const int ring = C::ring(slice);
  float* lo_box = reinterpret_cast<float*>(smem + ring);  // wgmma: x - hi
  float* s8 = reinterpret_cast<float*>(smem + ring + C::LO);  // int8: s[o]
  float* recv = reinterpret_cast<float*>(smem + ring + C::LO + C::S8);

  auto load_stage = [&](int st, int buf) {
    unsigned char* cs = smem + buf * C::STAGE;
    float* ss = reinterpret_cast<float*>(cs + C::CODES);
    unsigned char* xs = cs + C::PRE;
    const int kst = lo + st * KSTAGE, kend = min(kst + KSTAGE, hi);
    // codes: BO rows of 16-byte chunks (16 int8 or 32 int4 inputs each)
    constexpr int CK = FMT == 8 ? 16 : 32;
    constexpr int CPR = KSTAGE / CK;
    for (int e = tid; e < BO * CPR; e += THREADS) {
      const int r = e / CPR, c = e - r * CPR, o = o0 + r;
      const int k = kst + c * CK;
      int nb = min(max(kend - k, 0), CK) / (FMT == 8 ? 1 : 2);
      if (o >= O) nb = 0;
      const uint8_t* src = q + (size_t)min(o, O - 1) * row_bytes +
                           (nb ? (FMT == 8 ? k : k / 2) : 0);
      unsigned char* dst = cs + r * CP + c * 16;
      if (qvec) {
        cp_async16(dst, src, nb);
      } else {
        uint4 v = make_uint4(0, 0, 0, 0);
        unsigned char* vb = reinterpret_cast<unsigned char*>(&v);
        for (int b = 0; b < nb; ++b) vb[b] = __ldg(src + b);
        *reinterpret_cast<uint4*>(dst) = v;
      }
    }
    // int4 group scales, one per (channel, chunk): a chunk lies in a group
    if constexpr (C::SCALES > 0) {
      for (int e = tid; e < BO * CHUNKS; e += THREADS) {
        const int r = e / CHUNKS, c = e - r * CHUNKS, o = o0 + r;
        const int k = min(kst + c * KCHUNK, I - 1);
        cp_async4(ss + e, s + (size_t)min(o, O - 1) * G + k / group,
                  o < O ? 4 : 0);
      }
    }
    // x: rows of 32 chunks of 4 floats; inputs past the slice are zeros;
    // rows past M are not read (wgmma: zeros)
    for (int e = tid; e < (WG ? MT : mv) * (KSTAGE / 4); e += THREADS) {
      const int r = e / (KSTAGE / 4), c = e - r * (KSTAGE / 4);
      const int k = kst + c * 4;
      const int nf = r < mv ? min(max(kend - k, 0), 4) : 0;
      const float* src = x + (nf ? (size_t)(m0 + r) * I + k : 0);
      unsigned char* dst =
          WG ? xs + (c >> 3) * C::BOX + r * 128 + (((c & 7) ^ (r & 7)) << 4)
             : xs + r * XP + c * 16;
      if (xvec) {
        cp_async16(dst, src, nf * 4);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cp_async4(dst + 4 * i, i < nf ? src + i : x, i < nf ? 4 : 0);
      }
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int r0 = sub * 16 + g;  // this lane's channel rows r0, r0 + 8

  if constexpr (FMT == 8) {
    for (int e = tid; e < BO; e += THREADS)
      cp_async4(s8 + e, s + min(o0 + e, O - 1), 4);
  }
  for (int st = 0; st < depth - 1; ++st) {
    if (st < nst) load_stage(st, st);
    cp_async_commit();
  }
  if (stamp) stamp[1] = globaltimer();
  for (int st = 0; st < nst; ++st) {
    cp_async_wait_n(depth - 2);  // stage st has landed
    __syncthreads();             // ... for every thread; st - 1 is done
    if (st + depth - 1 < nst)
      load_stage(st + depth - 1, (st + depth - 1) % depth);
    cp_async_commit();
    const unsigned char* cs = smem + (st % depth) * C::STAGE;
    const float* ss = reinterpret_cast<const float*>(cs + C::CODES);
    const unsigned char* xs = cs + C::PRE;
    const int kst = lo + st * KSTAGE;
    if constexpr (WG)
      wg_stage<FMT, FOLD>(cs, ss, xs, lo_box, acc, s, O, I, G, group, o0,
                          kst, hi, r0, t, tid);
    else
      mma_stage<FMT, WCH, NT, FOLD>(cs, ss, xs, acc, s, O, I, G, group, o0,
                                    kst, hi, r0, g, t, kp, mv);
  }

  // the warps' partial tiles, red[kp][row][channel], over the ring
  cp_async_wait<0>();
  __syncthreads();
  if (stamp) stamp[2] = globaltimer();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 8 * n + 2 * t + (e & 1), ch = r0 + (e >> 1) * 8;
      red[(kp * MT + row) * C::RP + ch] = acc[n][e];
    }
  __syncthreads();
  // send each float4 of them to the rank that sums it, into slot (this
  // rank, stage part) there
  const int e4v = mv * (BO / 4);
  const int per = C::share(e4v, ks);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int f = tid; f < KW * e4v; f += THREADS) {
    const int p = f / e4v, e4 = f - p * e4v, owner = e4 / per;
    const int row = e4 / (BO / 4), ch = (e4 - row * (BO / 4)) * 4;
    float* dst = recv + ((rank * KW + p) * per + e4 - owner * per) * 4;
    *reinterpret_cast<float4*>(cluster_ptr(dst, owner)) =
        *reinterpret_cast<const float4*>(red + (p * MT + row) * C::RP + ch);
  }
  if (stamp) stamp[3] = globaltimer();
  cluster_sync();
  if (stamp) stamp[4] = globaltimer();
  // this rank's share: the slots summed in order (ranks, each rank's
  // stage parts), scaled (int8) and written
  const float4* in = reinterpret_cast<const float4*>(recv);
  for (int e4 = rank * per + tid; e4 < min(e4v, (rank + 1) * per);
       e4 += THREADS) {
    const int li = e4 - rank * per;
    float4 v = in[li];
    for (int sl = 1; sl < ks * KW; ++sl) {
      const float4 u = in[sl * per + li];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const int row = e4 / (BO / 4), ch = (e4 - row * (BO / 4)) * 4;
    const float vv[4] = {v.x, v.y, v.z, v.w};
    const int m = m0 + row;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = o0 + ch + i;
      if (o < O)
        y[(size_t)m * O + o] = FMT == 8 ? vv[i] * s8[ch + i] : vv[i];
    }
  }
  if (stamp) stamp[5] = globaltimer();
}

template <int FMT, int WCH, int NT, bool FOLD, bool WG>
int launch(const float* x, const uint8_t* q, const float* s, float* y, int M,
           int O, int I, int G, int group, int ks, int slice, int xvec,
           int qvec, unsigned long long* stamps, cudaStream_t stream) {
  using C = Cfg<FMT, WCH, NT, FOLD, WG>;
  auto kernel = qmm_kernel<FMT, WCH, NT, FOLD, WG>;
  static int sized = 0;  // the dynamic shared memory the kernel may take
  const int smem = C::smem(slice, ks);
  if (smem > sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ks, (O + C::BO - 1) / C::BO, (M + C::MT - 1) / C::MT);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, x, q, s, y, M, O, I,
                                           G, group, slice, xvec, qvec,
                                           stamps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the plan's variant: wch 16-channel tiles and nt 8-row tiles a block (1
// or 2 each) on mma.sync, or (wg) 64 channels and 32 rows on wgmma
struct Args {
  const float* x;
  const uint8_t* q;
  const float* s;
  float* y;
  int M, O, I, G, group, ks, slice, xvec, qvec;
  unsigned long long* stamps;
  cudaStream_t st;
};

template <int FMT, int WCH, int NT, bool FOLD, bool WG>
int go(const Args& a) {
  return launch<FMT, WCH, NT, FOLD, WG>(a.x, a.q, a.s, a.y, a.M, a.O, a.I,
                                        a.G, a.group, a.ks, a.slice, a.xvec,
                                        a.qvec, a.stamps, a.st);
}

template <int FMT, int WCH, bool FOLD>
int by_rows(int nt, const Args& a) {
  if (nt == 1) return go<FMT, WCH, 1, FOLD, false>(a);
  if (nt == 2) return go<FMT, WCH, 2, FOLD, false>(a);
  return (int)cudaErrorInvalidValue;
}

template <int FMT, bool FOLD>
int by_tile(int wch, int nt, int wg, const Args& a) {
  if (wg)
    return wch == 4 && nt == 4 ? go<FMT, 4, 4, FOLD, true>(a)
                               : (int)cudaErrorInvalidValue;
  if (wch == 1) return by_rows<FMT, 1, FOLD>(nt, a);
  if (wch == 2) return by_rows<FMT, 2, FOLD>(nt, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* mxt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// fmt 8: q (O, I) int8, s (O,); fmt 4: q (O, I/2) uint8, s (O, I/group).
// x (M, I) and y (M, O) fp32, contiguous.  The plan (qmm_plan): ks K
// slices of `slice` inputs (a multiple of 128; ks <= 8, the last slice
// ending at I), wch 16-channel tiles and nt 8-row tiles a block, fold
// (int4: the scale folded into the weight), wg (wgmma: wch 4, nt 4);
// xvec / qvec: x's / q's rows are 16-byte aligned; stamps: null, or
// STAMPS %globaltimer values a block (qmm_phase_times).
extern "C" int mxt_quant_matmul(const void* x, const void* q, const void* s,
                                void* y, int M, int O, int I, int fmt,
                                int group, int ks, int slice, int wch, int nt,
                                int fold, int wg, int xvec, int qvec,
                                void* stamps, void* stream) {
  if (ks < 1 || ks > 8 || slice % KSTAGE || (long long)ks * slice < I ||
      (long long)(ks - 1) * slice >= I)
    return (int)cudaErrorInvalidValue;
  const Args a = {(const float*)x, (const uint8_t*)q, (const float*)s,
                  (float*)y, M, O, I, fmt == 8 ? 1 : I / group, group, ks,
                  slice, xvec, qvec, (unsigned long long*)stamps,
                  (cudaStream_t)stream};
  if (fmt == 8) return by_tile<8, false>(wch, nt, wg, a);
  if (fold) return by_tile<4, true>(wch, nt, wg, a);
  return by_tile<4, false>(wch, nt, wg, a);
}
