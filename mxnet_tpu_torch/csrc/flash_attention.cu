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
// q, k, v, out, dO, dq, dk, dv: (B, H, L, D) views at any strides TMA
// admits (unit stride along D), float32 or bfloat16, D in {32, 64, 128};
// lse and delta = sum_d dO * O: (B, H, L) float32 at any B and H strides.
// A (batch, head) is numbered bh = b * H + h.  The mask is the JAX
// kernel's (_block_mask, :49): key j of row i
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
// Two designs, one per dtype, on one skeleton (TMA rings, one producer
// warpgroup, the element pass on the accumulators, a persistent grid at
// L <= 256): bf16 products on wgmma (below), and the float32 kernels (#5
// forward, #6 dq, #7 dk and dv) on the tensor cores in 3xTF32.  Each fp32
// operand x is split into hi = tf32(x) and lo = tf32(x - hi); hi hi + hi
// lo + lo hi is summed in fp32 and lo lo left out, about 2^-20 of each
// product against a single TF32 product's 2^-11, so the kernels stay
// fp32-accurate (the port runs fp32 with TF32 off).  That is 3 tf32
// products for each fp32 one: 495 / 3 = 165 TFLOP/s, above the 67 of fp32
// FMAs.  Where the float32 design met trouble:
// 1. wgmma reads tf32 from shared memory K-major only (no transpose bit).
//    The first products (S = Q K^T, and #6's dP = dO V^T; in #7 S^T =
//    K Q^T and dP^T = V dO^T) read both tiles K-major as TMA lands them.
//    The second (O = (P keep) V, dQ = dS K, dV = (P keep)^T dO, dK = dS^T
//    Q) would read their B tile MN-major; they run on mma.sync m16n8k8
//    instead, each lane loading its B fragment from the row-major tile
//    (mma_product), with no transposed copy in shared memory.
// 2. The fp32 accumulator is not tf32's A fragment (sm90.cuh): lane t
//    holds columns 2t, 2t + 1 of each 8-group where the fragment takes t,
//    t + 4.  mma_product permutes K within each 8-group to match (k t is
//    column 2t, k t + 4 column 2t + 1) and reads B's rows in that order;
//    the sum over K does not change.
// 3. The tensor core reads an fp32 word's top 19 bits.  So the first
//    products read A and B as TMA lands them, as their hi halves; warps
//    1-3 of the producer warpgroup write the residual tiles x - trunc(x)
//    of each stage's first-product operands beside them (the B lo of hi
//    lo: K in #5, K and V in #6, Q and dO in #7), and the consumers load
//    the own side's residuals into registers as A fragments (the A lo of
//    lo hi; residual_frags).  mma_product splits both operands in
//    registers, so #5's V needs no residual tile: a quarter less shared
//    memory a stage, half the transform warps' work.  Every masked P is 0
//    before mma_product, so no -1e30 sentinel reaches a product.
// 4. Shared memory and registers: fp32 tiles are twice bf16's and the
//    residual tiles double the streamed side, so the backward's streamed
//    tiles hold 32 rows; its own side is double-buffered at D 32 and 64
//    (113 and 193 KB), single at D 128 with one consumer warpgroup (192
//    KB).  The consumers fit the 168 registers a thread ptxas allots at
//    384 threads (#7 with dropout spills 8 bytes at D 64).  At D 128 (255
//    registers; #7's dK and dV take 128) the lo products go 4 k8 steps a
//    group, so the residual fragments take 32 registers, not 128; still
//    #6 spills ~0.2 KB and #7 ~0.7 KB.  The forward holds no dO, dP or
//    delta: 64 streamed rows a stage at D 32 and 64 (104 and 208 KB), 32
//    at D 128, where its o (64 fp32) lets two consumer warpgroups fit (224
//    KB; CfgF<kFwd, D>).  Its threads fit the 168 registers at every D,
//    with no spill but 4 bytes at D 64 without dropout.
// 5. A 128-byte swizzled TMA box row holds 32 fp32: D / 32 boxes side by
//    side (TileF), and a tf32 descriptor steps 32 bytes a k8.
// 6. The tensor core's adds into its accumulator do not round to nearest
//    (they drift as truncation would): a chain of 3xTF32's products
//    drifted to 3e-5 of the largest gradient at L 2048.  The lo products
//    go first and the hi ones last, and mma_product sums each tile apart
//    and adds it with a rounded add: 5.3e-6 at most on the card.
// Outputs leave through the own tile and a TMA store (16-byte stores from
// registers were slower for #7 and no faster for #6); #5's lse by plain
// stores.  At the training shape (B 32, H 12, L 128, D 64, the batch's
// kv_length) #5 reads and writes 50.5 MB, #6 63.3 MB and #7 75.9 MB,
// 0.0151, 0.0189 and 0.0227 ms at 3.35 TB/s, over 1.2, 1.85 and 2.47
// GFLOP, 0.007, 0.0112 and 0.0149 ms in 3xTF32 at 495 TFLOP/s: bytes
// bound.

// The bfloat16 kernels (#5 forward, #6 dq, #7 dk and dv) are built for
// Hopper's tensor cores (sm90.cuh has the building blocks):
// - Products on wgmma, m64n64k16: S (S^T in #7) and dP (dP^T) with K (the
//   q side in #7) read K-major from shared memory, and the other operand
//   K-major from shared memory too (#6, #7) or, in #5, the warpgroup's Q
//   rows held in registers as A fragments for the whole item; O (#5), dV,
//   dK and dQ with A from registers (the fp32 accumulator of P keep or dS,
//   rounded to bf16, is already the A fragment of four k16 steps) and B
//   the V (#5), q-side (#7) or K (#6) tile read MN-major, the transpose
//   bit set.  P keep is rounded to bf16 before O and dV, and dS before dK
//   and dQ, as the JAX kernel casts (:200, :300, :355, :361).
// - Tiles by TMA in 64-row boxes, 128-byte swizzled (64-byte at D 32; at
//   D 128 two 64-column boxes, since a swizzled box row is at most 128
//   bytes); rows past L read as 0 within their (batch, head).  Every map
//   is (D, L, H, B) at its tensor's own strides, so a head slice, BERT's
//   permuted (B, L, 3, H, D) projection or the transposed gradient of its
//   output is read, and each output (out, dq, dk, dv) written, where it
//   lies; lse and delta are read at their own strides too.  The float32
//   kernels' maps are the same, in boxes of 32 columns.  One lane of a
//   producer warpgroup loads the block's own
//   side once a work item (double-buffered across items) and rings the
//   other side through 3 stages (2 in #6 and #7 at D 128) on mbarriers;
//   #7's lse and delta come into each stage by the producer warp's lanes
//   (a TMA box of float32 rows may not start where L * 4 is not a multiple
//   of 16 bytes), #6's sit in registers.  The producer warpgroup hands its
//   registers to two consumer warpgroups (setmaxnreg, 24 and 240).
// - Two consumer warpgroups own 64 rows each (#7 at D 128: one, as its dK
//   and dV take 128 fp32 a thread); each skips the tiles the mask rules
//   out for its rows and applies the per-element mask on edge tiles only.
//   Each block owns its rows, so there are no atomics and the result does
//   not depend on the order blocks run in.
// - #5's online softmax runs on the S accumulator in registers: each
//   thread holds 16 scores of each of two rows, reduced over the four
//   lanes that share a row by two shuffles; the running max is kept in
//   base 2 (S |scale| log2 e, S negated for a negative scale), the
//   exponent is one FMA and the SFU's ex2, and O is rescaled only where
//   some row of the warp moved its max.  The masked-row sentinel -1e30
//   keeps a row with no valid key yet from making its rescale NaN, and
//   the normalizer sums the undropped P (:193).
// - Outputs leave through shared memory (the warpgroup's rows of the tile
//   it has finished with, in the swizzled layout) and a TMA store; #5's
//   lse (natural log) by plain stores.
// - The grid is persistent (a block per SM walking items) where rows are
//   short (L <= 256), so one item's prologue overlaps another's products;
//   at longer L a block per item, which the hardware balances.
//
// Bound on the card, bf16.  At the training shape (B 32, H 12, L 128, D
// 64, the batch's kv_length) #5 reads and writes 25.4 MB, 0.0076 ms at
// 3.35 TB/s, #6 31.9 MB and #7 38.1 MB, over 1.2 to 2.5 GFLOP (at most
// 0.0025 ms at 989 TFLOP/s): bytes bound.  There a launch's fixed part
// (prologue, first loads from a cold L2, the TMA stores: chip_smoke.py
// times the backward with every kv_length 0) takes most of the time.  At
// the long shape (B 4, L 2048) #5, #6 and #7 need 40.4, 60.6 and 80.8
// GFLOP, 0.041, 0.061 and 0.082 ms: operations bound.  There the element
// pass sets the pace, not the tensor cores.  #5 spends about 17
// instructions an element at dropout 0.1: the max, 2 for the exponent, the
// sum, half a bf16 pack, 12 for the hash and its keep multiplier (9 of
// them integer, at half the FP32 rate), ~0.2 SM-cycles an element at 128
// lanes a cycle, against 0.06 SM-cycles of wgmma (4 D flops an element at
// 989 TFLOP/s over 132 SMs); #7 about 20 and #6 18 against 0.12 and 0.09.
// At dropout 0 the ex2, 16 a cycle on an SM, is about the wgmma's time.
// The designs hoist the hash's per-row and per-column products out of the
// element loop, skip the hash at dropout 0, and run the exponent on the
// SFU; two consumer warpgroups per SM overlap one's element pass with the
// other's wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "sm90.cuh"

namespace {

constexpr int kTile = 64;  // rows of a q tile and of a k tile
constexpr float kMasked = -1e30f;

// The mask of one (batch, head): rows and keys at or past L, keys at or
// past kvlen, the causal and the band conditions.
struct Mask {
  int L, klim, causal, window;  // window < 0: no band
  __device__ bool valid(int i, int j) const {
    return i < L && j < klim && (!causal || j <= i) &&
           (window < 0 || abs(i - j) <= window);
  }
  // some element of the tile rows [q0, q0 + NQ) x keys [k0, k0 + NK) is
  // valid
  template <int NQ = kTile, int NK = kTile>
  __device__ bool needed(int q0, int k0) const {
    const int q1 = q0 + NQ - 1, k1 = k0 + NK - 1;
    return q0 < L && k0 < klim && (!causal || k0 <= q1) &&
           (window < 0 || (k0 <= q1 + window && k1 >= q0 - window));
  }
  // every element of the tile is valid: no per-element mask
  template <int NQ = kTile, int NK = kTile>
  __device__ bool interior(int q0, int k0) const {
    const int q1 = q0 + NQ - 1, k1 = k0 + NK - 1;
    return q1 < L && k1 < klim && (!causal || k1 <= q0) &&
           (window < 0 || (q1 - k0 <= window && k1 - q0 <= window));
  }
};

// A (batch, head): work item bh is batch bh / H, head bh % H (masks and
// the dropout hash keep bh itself), its place in a (D, L, H, B) map
struct HB {
  int h, b;
  __device__ HB(int bh, int H) : h(bh % H), b(bh / H) {}
};

// where the rows of (batch b, head h) of a (B, H, L, D) tensor lie, in
// elements: row i of (b, h) starts at b * sb + h * sh + i * sl
struct Strides {
  long long sb, sh, sl;
  __device__ long long at(HB w) const {
    return (long long)w.b * sb + (long long)w.h * sh;
  }
  __device__ long long at(int bh, int H) const { return at(HB(bh, H)); }
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
  // where each tensor's rows lie, as a (B, H, L, D) view (lse and delta
  // as (B, H, L), sl unused: 1): the forward's q, k, v, out and lse, the
  // backward's q, k, v, dout, lse, delta and dq, dk, dv
  Strides sq, sk, sv, so, slse, sdo, sdl, sdq, sdk, sdv;
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

// the k tiles of RK keys [lo, hi] that rows [q0, q0 + 64) can see
template <int RK = kTile>
__device__ __forceinline__ void k_range(const Mask& m, int q0, int& lo,
                                        int& hi) {
  const int q1 = q0 + kTile - 1;
  lo = 0;
  hi = (m.klim + RK - 1) / RK - 1;
  if (m.causal) hi = min(hi, q1 / RK);
  if (m.window >= 0) {
    hi = min(hi, (q1 + m.window) / RK);
    lo = max(0, q0 - m.window) / RK;
  }
}

// the q tiles of RQ rows [lo, hi] that keys [k0, k0 + 64) can be seen
// from (none: hi < lo)
template <int RQ = kTile>
__device__ __forceinline__ void q_range(const Mask& m, int k0, int& lo,
                                        int& hi) {
  const int k1 = k0 + kTile - 1;
  lo = 0;
  hi = (m.L + RQ - 1) / RQ - 1;
  if (m.causal) lo = k0 / RQ;
  if (m.window >= 0) {
    lo = max(lo, max(0, k0 - m.window) / RQ);
    hi = min(hi, (k1 + m.window) / RQ);
  }
  if (k0 >= m.klim) hi = lo - 1;
}

// ---------------------------------------------------------------------------
// #6 and #7 in bfloat16: wgmma products on TMA-fed tile rings (sm_90a)
// ---------------------------------------------------------------------------
constexpr float kLog2e = 1.4426950408889634f;

// A (rows, D) bf16 tile as TMA writes it: D / kCols boxes of kCols
// columns side by side, each rows x kRowBytes with the matching swizzle.
template <int D>
struct Tile {
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kBoxes = D / kCols;
  static constexpr int kRowBytes = kCols * 2;
  static constexpr int kLayout = kRowBytes == 128 ? 1 : 2;
  static constexpr uint32_t kSbo = 8 * kRowBytes;
  // K-major operand over D: rows [row0, row0 + 64) of a tile of R rows at
  // k16 step kk
  template <int R>
  __device__ static uint64_t kmajor(uint32_t tile, int row0, int kk) {
    const int col = kk * 16;
    return gmma_desc(tile + (col / kCols) * R * kRowBytes +
                         row0 * kRowBytes + (col % kCols) * 2,
                     kLayout, kSbo);
  }
  // MN-major operand: rows [16 kk, 16 kk + 16) of a tile of R rows as K,
  // the columns of box b as N
  template <int R>
  __device__ static uint64_t mnmajor(uint32_t tile, int kk, int b) {
    return gmma_desc(tile + b * R * kRowBytes + kk * 16 * kRowBytes, kLayout,
                     kSbo);
  }
};

// s (64 x 64) = A B^T over D: A the rows [a0, a0 + 64) of a tile of RA
// rows, B the 64 rows of a tile of 64
template <int D, int RA>
__device__ __forceinline__ void ss_product(float (&s)[32], uint32_t ta,
                                           int a0, uint32_t tb) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(s, Tile<D>::template kmajor<RA>(ta, a0, kk),
                 Tile<D>::template kmajor<64>(tb, 0, kk), kk > 0);
}

// acc (64 x D) += A B: A (64 x 64) the bf16 fragments a (k16 step kk in
// a[4 kk .. 4 kk + 3]), B a tile of 64 rows (K) by D
template <int D>
__device__ __forceinline__ void rs_product(float (&acc)[D / 2],
                                           const uint32_t (&a)[16],
                                           uint32_t tb) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int b = 0; b < Tile<D>::kBoxes; ++b) {
      const uint64_t db = Tile<D>::template mnmajor<64>(tb, kk, b);
      if constexpr (D == 32)
        wgmma_rs_n32(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                     a[4 * kk + 3], db);
      else
        wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(acc + 32 * b),
                     a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                     db);
    }
}

// the kernels' tensor maps, in boxes of 64 rows: the inputs, and the
// outputs (#5: out; #6: dq in out; #7: dk in out, dv in out2), each 4-D
// over (D, L, H, B) at its tensor's own strides.
struct Maps {
  CUtensorMap q, k, v, dout, out, out2;
};
struct Sm90Args {
  Maps maps;
  Args a;
  int BH;
};

__device__ __forceinline__ void prefetch_maps(const Maps& m, bool dout) {
  tma_prefetch(&m.q);
  tma_prefetch(&m.k);
  tma_prefetch(&m.v);
  if (dout) tma_prefetch(&m.dout);
}

__device__ __forceinline__ void tma_load_rows(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int c0, int c1,
                                              HB w) {
  tma_load_4d(dst, map, bar, c0, c1, w.h, w.b);
}
__device__ __forceinline__ void tma_store_rows(const CUtensorMap* map,
                                               uint32_t src, int c0, int c1,
                                               HB w) {
  tma_store_4d(map, src, c0, c1, w.h, w.b);
}

// the thread's place in its warpgroup's fragments: rows fr + {0, 8},
// columns fc + 8 j + {0, 1}
struct Frag {
  int fr, fc;
  __device__ explicit Frag(int t) : fr(16 * (t >> 5) + ((t & 31) >> 2)),
                                    fc(2 * (t & 3)) {}
};

// A warpgroup's (64, D) fp32 accumulator times `scale`, rounded to bf16,
// into rows [row0, row0 + 64) of a tile of R rows in the swizzled layout
// TMA reads (16-byte chunk c of row r at c ^ (r % 8) at 128-byte rows,
// c ^ (r % 8) / 2 at 64).  Conflict-free: a store's 8 rows land in 8
// distinct chunks.
template <int D, int R>
__device__ __forceinline__ void frag_to_tile(uint8_t* tile, int row0,
                                             const float (&acc)[D / 2],
                                             float scale, const Frag& f) {
  using T = Tile<D>;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + f.fr + 8 * h;
    const int x = T::kLayout == 1 ? (r & 7) : ((r & 7) >> 1);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int b = 8 * j / T::kCols, c = j % (T::kCols / 8);
      *reinterpret_cast<uint32_t*>(tile + (b * R + r) * T::kRowBytes +
                                   (c ^ x) * 16 + f.fc * 2) =
          pack_bf16(acc[4 * j + 2 * h] * scale,
                    acc[4 * j + 2 * h + 1] * scale);
    }
  }
}

// Rows [row0, row0 + 64) of a tile of R rows at shared `tile`, written by
// one warpgroup (frag_to_tile), to rows [grow, grow + 64) of (batch,
// head) `where` through `map`; thread t of the warpgroup issues the store
// and returns once TMA has read the tile.  Rows past L are not written.
template <int D, int R>
__device__ __forceinline__ void store_rows(const CUtensorMap* map,
                                           uint32_t tile, int row0, int grow,
                                           HB where, int t) {
  if (t != 0) return;
#pragma unroll
  for (int b = 0; b < Tile<D>::kBoxes; ++b)
    tma_store_rows(map, tile + (b * R + row0) * Tile<D>::kRowBytes,
                   b * Tile<D>::kCols, grow, where);
  tma_store_commit_wait_read();
}

// 2^x on the special-function unit (subnormal results flush to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the dropout multiplier of the element whose pre-mixed hash is h
__device__ __forceinline__ float keep_of_mix(uint32_t h, uint32_t thr,
                                             float ks) {
  return mxt_keep_mix(h) >= thr ? ks : 0.f;
}

// -lse log2(e), the exponent offset of a row's probabilities in base 2
// (-inf for a row with no valid key, whose probabilities are then 0)
__device__ __forceinline__ float neg_lse2(float lse) {
  return lse == -INFINITY ? -INFINITY : -lse * kLog2e;
}

// Rows [row0, row0 + 64 NWG) of a tensor map into a tile of 64 NWG rows,
// 64 rows a box, skipping the 64-row groups that start at or past L (no
// warpgroup reads them); load_bytes is what that asks for.
template <int D, int NWG>
__device__ __forceinline__ uint32_t load_bytes(int row0, int L) {
  uint32_t bytes = 0;
#pragma unroll
  for (int w = 0; w < NWG; ++w)
    if (row0 + 64 * w < L) bytes += 64 * D * 2;
  return bytes;
}
template <int D, int NWG>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const CUtensorMap* map,
                                          uint32_t bar, int row0, HB where,
                                          int L) {
#pragma unroll
  for (int w = 0; w < NWG; ++w) {
    if (row0 + 64 * w >= L) break;
#pragma unroll
    for (int b = 0; b < Tile<D>::kBoxes; ++b)
      tma_load_rows(dst + (b * NWG + w) * 64 * Tile<D>::kRowBytes, map, bar,
                    b * Tile<D>::kCols, row0 + 64 * w, where);
  }
}

// Row 0 of (batch, head) w of a (B, H, L) float32 tensor (lse, delta)
// at strides s
__device__ __forceinline__ const float* stat_rows(const void* p,
                                                  const Strides& s, HB w) {
  return static_cast<const float*>(p) + s.at(w);
}

// A q tile's R rows of lse and delta of (batch, head) w, R / 32 per lane of
// the producer warp: fetched before the warp waits for the stage, stored
// after (lse as neg_lse2; rows at or past L as 0).  The rows' addresses
// are formed here from w, which the warp holds for its TMA loads anyway:
// the producer's 24 registers hold no more across the ring.
template <int R = 64>
struct Stats {
  static constexpr int N = R / 32;
  float l[N], d[N];
  __device__ void fetch(const Args& a, HB w, int row0) {
    const float* lg = stat_rows(a.lse_in, a.slse, w);
    const float* dg = stat_rows(a.delta, a.sdl, w);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int r = row0 + (threadIdx.x & 31) + 32 * k;
      l[k] = r < a.L ? neg_lse2(lg[r]) : 0.f;
      d[k] = r < a.L ? dg[r] : 0.f;
    }
  }
  __device__ void store(float* nl, float* dl) const {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      nl[(threadIdx.x & 31) + 32 * k] = l[k];
      dl[(threadIdx.x & 31) + 32 * k] = d[k];
    }
  }
};

// registers a thread of a consumer warpgroup takes when two consumer
// warpgroups and the producer warpgroup (down to 24) share the SM's 64 K
constexpr int kConsumerRegs = 240, kProducerRegs = 24;

// ---------------------------------------------------------------------------
// #7 dk, dv.  A work item is 64 NWG key rows of one (batch, head), items
// numbered key block fastest, so that the blocks resident at once share
// their heads' q tiles in L2.  Each block walks items gridDim.x apart
// (see launch_sm90 for the grid).  NWG
// consumer warpgroups own 64 key rows each; warp 0 of the producer
// warpgroup loads each item's K and V once (TMA, double-buffered so the
// next item's arrive while this one computes) and rings the q tiles
// through S stages: Q and dO by TMA, lse and delta by its lanes.
// ---------------------------------------------------------------------------
template <int D, int NWG, int S>
struct DkvSmem {
  static constexpr int kKV = NWG * 64 * D * 2;  // a K (or V) tile
  static constexpr int kT = 64 * D * 2;         // a Q (or dO) stage
  // K and V of items n even, then odd: K0 V0 K1 V1
  static constexpr int kKV0 = 0, kQ = 4 * kKV, kDo = kQ + S * kT;
  static constexpr int kLse = kDo + S * kT, kDl = kLse + S * 256;
  // kv_full[2], kv_empty[2], full[S], empty[S]
  static constexpr int kBar = kDl + S * 256;
  static constexpr int kBytes = kBar + (4 + 2 * S) * 8;
};

// whether any warpgroup of a block with keys [kb, kb + 64 NWG) needs the
// q tile of RQ rows at q0
template <int NWG, int RQ = 64>
__device__ __forceinline__ bool any_keys_need(const Mask& m, int q0,
                                              int kb) {
  bool need = false;
#pragma unroll
  for (int w = 0; w < NWG; ++w) need |= m.needed<RQ, 64>(q0, kb + 64 * w);
  return need;
}

template <int NWG, int RQ = 64>
__device__ __forceinline__ void block_q_range(const Mask& m, int kb, int& lo,
                                              int& hi) {
  lo = 1 << 30;
  hi = -1;
#pragma unroll
  for (int w = 0; w < NWG; ++w) {
    int l, h;
    q_range<RQ>(m, kb + 64 * w, l, h);
    if (l <= h) {
      lo = min(lo, l);
      hi = max(hi, h);
    }
  }
  if (hi < 0) lo = 0;
}

// The element pass of #7 on S^T and dP^T over 8 NJ queries (rows keys
// k0 + fr + 8 h, columns queries q0 + fc + 8 j + e): P^T = exp(S^T scale -
// lse) (0 where masked), keep from the hash; st becomes P^T keep and dpt
// dS^T = P^T (dP^T keep - delta).  nl and dl: the q tile's neg_lse2 and
// delta.  About 19 instructions an element with dropout: 2 for the
// exponent, 12 for the hash and its keep multiplier (9 of them integer, at
// half the FP32 issue rate), 5 for P keep and dS.
template <int NJ, bool EDGE, bool DROP>
__device__ __forceinline__ void dkv_elems(float (&st)[4 * NJ],
                                          float (&dpt)[4 * NJ], const Mask& m,
                                          const Frag& f, int q0, int k0,
                                          const float* nl, const float* dl,
                                          float sl2,
                                          const uint32_t (&kmix)[2],
                                          uint32_t thr, float ks) {
  const uint32_t qa0 = (uint32_t)(q0 + f.fc) * 0x9E3779B1u;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float2 n2 = *reinterpret_cast<const float2*>(nl + 8 * j + f.fc);
    const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + f.fc);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t qa = qa0 + (uint32_t)(8 * j + e) * 0x9E3779B1u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = 4 * j + 2 * h + e;
        float p = fast_exp2(fmaf(st[idx], sl2, e ? n2.y : n2.x));
        if (EDGE && !m.valid(q0 + f.fc + 8 * j + e, k0 + f.fr + 8 * h))
          p = 0.f;
        float dp = dpt[idx];
        if (DROP) {
          const float km = keep_of_mix(qa ^ kmix[h], thr, ks);
          st[idx] = p * km;
          dp *= km;
        } else {
          st[idx] = p;
        }
        dpt[idx] = p * (dp - (e ? d2.y : d2.x));
      }
    }
  }
}

// #7's element pass on a 64-query tile, then as bf16 A fragments pa =
// bf16(P^T keep) and da = bf16(dS^T) (1 instruction an element more)
template <bool EDGE, bool DROP>
__device__ __forceinline__ void dkv_grads(float (&st)[32], float (&dpt)[32],
                                          uint32_t (&pa)[16],
                                          uint32_t (&da)[16], const Mask& m,
                                          const Frag& f, int q0, int k0,
                                          const float* nl, const float* dl,
                                          float sl2,
                                          const uint32_t (&kmix)[2],
                                          uint32_t thr, float ks) {
  dkv_elems<8, EDGE, DROP>(st, dpt, m, f, q0, k0, nl, dl, sl2, kmix, thr, ks);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    pa[i] = pack_bf16(st[2 * i], st[2 * i + 1]);
    da[i] = pack_bf16(dpt[2 * i], dpt[2 * i + 1]);
  }
}

template <int D, int NWG, int S, bool DROP>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_bwd_dkv_sm90(const __grid_constant__ Sm90Args p) {
  using L_ = DkvSmem<D, NWG, S>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const Args& a = p.a;
  const int n_kb = (a.L + 64 * NWG - 1) / (64 * NWG);
  const int items = n_kb * p.BH;
  const uint32_t bar_kv = base + L_::kBar, bar_kv_empty = bar_kv + 16,
                 bar_full = bar_kv + 32, bar_empty = bar_full + 8 * S;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  if (tid == NWG * 128) prefetch_maps(p.maps, true);
  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(bar_kv + 8 * b, 1);
      mbar_init(bar_kv_empty + 8 * b, NWG);  // thread 0 of each consumer
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(bar_full + 8 * s, 32);        // the producer warp's lanes
      mbar_init(bar_empty + 8 * s, 4 * NWG);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {  // the producer warpgroup: warp 0 loads, lane 0 TMAs
    if constexpr (NWG == 2) reg_dealloc<kProducerRegs>();
    if (tid >= NWG * 128 + 32) return;
    const bool lead = tid == NWG * 128;
    int it = 0, n = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const int bh = item / n_kb, kb = item % n_kb * 64 * NWG;
      const HB hb(bh, a.H);
      const Mask m = mask_of(a, bh);
      int lo, hi;
      block_q_range<NWG>(m, kb, lo, hi);
      if (lead) {  // this item's K and V, once the item two back is done
        const uint32_t kv = bar_kv + 8 * (n & 1);
        mbar_wait(bar_kv_empty + 8 * (n & 1), ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(kv, 2 * load_bytes<D, NWG>(kb, a.L));
        load_rows<D, NWG>(base + L_::kKV0 + (n & 1) * 2 * L_::kKV,
                          &p.maps.k, kv, kb, hb, a.L);
        load_rows<D, NWG>(base + L_::kKV0 + ((n & 1) * 2 + 1) * L_::kKV,
                          &p.maps.v, kv, kb, hb, a.L);
      }
      for (int qt = lo; qt <= hi; ++qt) {
        if (!any_keys_need<NWG>(m, qt * 64, kb)) continue;
        Stats<> st;
        st.fetch(a, hb, qt * 64);
        const int s = it % S;
        mbar_wait(bar_empty + 8 * s, ((it / S) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * s;
        if (lead) {
          mbar_expect(full, 2 * L_::kT);
          load_rows<D, 1>(base + L_::kQ + s * L_::kT, &p.maps.q, full,
                          qt * 64, hb, a.L);
          load_rows<D, 1>(base + L_::kDo + s * L_::kT, &p.maps.dout, full,
                          qt * 64, hb, a.L);
        }
        st.store(reinterpret_cast<float*>(smem + L_::kLse) + s * 64,
                 reinterpret_cast<float*>(smem + L_::kDl) + s * 64);
        mbar_arrive(full);
        ++it;
      }
    }
    return;
  }
  if constexpr (NWG == 2) reg_alloc<kConsumerRegs>();

  // a consumer warpgroup: keys [k0, k0 + 64) of each work item
  const Frag f(tid & 127);
  const float sl2 = a.scale * kLog2e;
  int it = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int bh = item / n_kb, kb = item % n_kb * 64 * NWG;
    const Mask m = mask_of(a, bh);
    int lo, hi;
    block_q_range<NWG>(m, kb, lo, hi);
    const int k0 = kb + 64 * wg;
    uint32_t kmix[2] = {0u, 0u};
    if (DROP) {
      const uint32_t sb = (uint32_t)a.seed[0] + (uint32_t)bh * 0xC2B2AE3Du;
      for (int h = 0; h < 2; ++h)
        kmix[h] = (uint32_t)(k0 + f.fr + 8 * h) * 0x85EBCA77u ^ sb;
    }
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    const uint32_t sk = base + L_::kKV0 + (n & 1) * 2 * L_::kKV,
                   sv = sk + L_::kKV;
    mbar_wait(bar_kv + 8 * (n & 1), (n >> 1) & 1);
    for (int qt = lo; qt <= hi; ++qt) {
      const int q0 = qt * 64;
      if (!any_keys_need<NWG>(m, q0, kb)) continue;
      const int s = it % S;
      mbar_wait(bar_full + 8 * s, (it / S) & 1);
      ++it;
      if (m.needed(q0, k0)) {
        const uint32_t sq = base + L_::kQ + s * L_::kT;
        const uint32_t sdo = base + L_::kDo + s * L_::kT;
        const float* nl = reinterpret_cast<const float*>(smem + L_::kLse) +
                          s * 64;
        const float* dl = reinterpret_cast<const float*>(smem + L_::kDl) +
                          s * 64;
        float st[32], dpt[32];
        uint32_t pa[16], da[16];
        wgmma_fence();
        ss_product<D, NWG * 64>(st, sk, 64 * wg, sq);
        ss_product<D, NWG * 64>(dpt, sv, 64 * wg, sdo);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        if (m.interior(q0, k0))
          dkv_grads<false, DROP>(st, dpt, pa, da, m, f, q0, k0, nl, dl, sl2,
                                 kmix, a.thr, a.ks);
        else
          dkv_grads<true, DROP>(st, dpt, pa, da, m, f, q0, k0, nl, dl, sl2,
                                kmix, a.thr, a.ks);
        fence_regs(dv);
        fence_regs(dk);
        wgmma_fence();
        rs_product<D>(dv, pa, sdo);  // dV += bf16(P^T keep) dO
        rs_product<D>(dk, da, sq);   // dK += bf16(dS^T) Q
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
      }
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(bar_empty + 8 * s);
    }
    // dK scale and dV through this warpgroup's rows of the item's K and V
    // tiles (its products are done with them), then TMA; the tiles are
    // then free for the item after next
    uint8_t* kt = smem + L_::kKV0 + (n & 1) * 2 * L_::kKV;
    frag_to_tile<D, NWG * 64>(kt, 64 * wg, dk, a.scale, f);
    frag_to_tile<D, NWG * 64>(kt + L_::kKV, 64 * wg, dv, 1.f, f);
    fence_async_shared();
    named_sync(1 + wg, 128);
    if (k0 < a.L) {
      const HB w(bh, a.H);
      store_rows<D, NWG * 64>(&p.maps.out, sk, 64 * wg, k0, w, tid & 127);
      store_rows<D, NWG * 64>(&p.maps.out2, sv, 64 * wg, k0, w, tid & 127);
    }
    if ((tid & 127) == 0) mbar_arrive(bar_kv_empty + 8 * (n & 1));
  }
}

// ---------------------------------------------------------------------------
// #6 dq.  A work item is 64 NWG query rows of one (batch, head), numbered
// and walked as #7's.  NWG consumer warpgroups own 64 query rows each
// (their lse and delta in registers); one lane of the producer warpgroup
// loads each item's Q and dO once (double-buffered) and rings the k tiles
// (K, V) through S stages, all by TMA.
// ---------------------------------------------------------------------------
template <int D, int NWG, int S>
struct DqSmem {
  static constexpr int kQT = NWG * 64 * D * 2;  // a Q (or dO) tile
  static constexpr int kT = 64 * D * 2;         // a K (or V) stage
  // Q and dO of items n even, then odd: Q0 dO0 Q1 dO1
  static constexpr int kQ0 = 0, kK = 4 * kQT, kV = kK + S * kT;
  // q_full[2], q_empty[2], full[S], empty[S]
  static constexpr int kBar = kV + S * kT;
  static constexpr int kBytes = kBar + (4 + 2 * S) * 8;
};

// whether any warpgroup of a block with rows [qb, qb + 64 NWG) needs the
// k tile of RK keys at k0
template <int NWG, int RK = 64>
__device__ __forceinline__ bool any_rows_need(const Mask& m, int qb,
                                              int k0) {
  bool need = false;
#pragma unroll
  for (int w = 0; w < NWG; ++w) need |= m.needed<64, RK>(qb + 64 * w, k0);
  return need;
}

template <int NWG, int RK = 64>
__device__ __forceinline__ void block_k_range(const Mask& m, int qb, int& lo,
                                              int& hi) {
  lo = 1 << 30;
  hi = -1;
#pragma unroll
  for (int w = 0; w < NWG; ++w) {
    int l, h;
    k_range<RK>(m, qb + 64 * w, l, h);
    if (l <= h) {
      lo = min(lo, l);
      hi = max(hi, h);
    }
  }
  if (hi < 0) lo = 0;
}

// The element pass of #6 on S and dP over 8 NJ keys (rows queries q0 + fr
// + 8 h, columns keys k0 + fc + 8 j + e): P = exp(S scale - lse) (0 where
// masked), keep from the hash; dp becomes dS = P (dP keep - delta).  The
// rows' neg_lse2, delta and pre-mixed hash in nl, dlt and qmix.  About 17
// instructions an element with dropout (as #7's, less P keep).
template <int NJ, bool EDGE, bool DROP>
__device__ __forceinline__ void dq_elems(const float (&s)[4 * NJ],
                                         float (&dp)[4 * NJ], const Mask& m,
                                         const Frag& f, int q0, int k0,
                                         const float (&nl)[2],
                                         const float (&dlt)[2], float sl2,
                                         const uint32_t (&qmix)[2],
                                         uint32_t thr, float ks) {
  const uint32_t kb0 = (uint32_t)(k0 + f.fc) * 0x85EBCA77u;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t kbe = kb0 + (uint32_t)(8 * j + e) * 0x85EBCA77u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = 4 * j + 2 * h + e;
        float p = fast_exp2(fmaf(s[idx], sl2, nl[h]));
        if (EDGE && !m.valid(q0 + f.fr + 8 * h, k0 + f.fc + 8 * j + e))
          p = 0.f;
        float d = dp[idx];
        if (DROP) d *= keep_of_mix(qmix[h] ^ kbe, thr, ks);
        dp[idx] = p * (d - dlt[h]);
      }
    }
}

// #6's element pass on a 64-key tile, then da = bf16(dS) as A fragments
template <bool EDGE, bool DROP>
__device__ __forceinline__ void dq_grads(const float (&s)[32], float (&dp)[32],
                                         uint32_t (&da)[16], const Mask& m,
                                         const Frag& f, int q0, int k0,
                                         const float (&nl)[2],
                                         const float (&dlt)[2], float sl2,
                                         const uint32_t (&qmix)[2],
                                         uint32_t thr, float ks) {
  dq_elems<8, EDGE, DROP>(s, dp, m, f, q0, k0, nl, dlt, sl2, qmix, thr, ks);
#pragma unroll
  for (int i = 0; i < 16; ++i) da[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
}

template <int D, int NWG, int S, bool DROP>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_bwd_dq_sm90(const __grid_constant__ Sm90Args p) {
  using L_ = DqSmem<D, NWG, S>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const Args& a = p.a;
  const int n_qb = (a.L + 64 * NWG - 1) / (64 * NWG);
  const int items = n_qb * p.BH;
  const uint32_t bar_q = base + L_::kBar, bar_q_empty = bar_q + 16,
                 bar_full = bar_q + 32, bar_empty = bar_full + 8 * S;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  if (tid == NWG * 128) prefetch_maps(p.maps, true);
  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(bar_q + 8 * b, 1);
      mbar_init(bar_q_empty + 8 * b, NWG);  // thread 0 of each consumer
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * NWG);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {  // the producer warpgroup: one lane issues every load
    if constexpr (NWG == 2) reg_dealloc<kProducerRegs>();
    if (tid != NWG * 128) return;
    int it = 0, n = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const int bh = item / n_qb, qb = item % n_qb * 64 * NWG;
      const HB hb(bh, a.H);
      const Mask m = mask_of(a, bh);
      int lo, hi;
      block_k_range<NWG>(m, qb, lo, hi);
      // this item's Q and dO, once the item two back is done with them
      const uint32_t q = bar_q + 8 * (n & 1);
      mbar_wait(bar_q_empty + 8 * (n & 1), ((n >> 1) & 1) ^ 1);
      mbar_expect_tx(q, 2 * load_bytes<D, NWG>(qb, a.L));
      load_rows<D, NWG>(base + L_::kQ0 + (n & 1) * 2 * L_::kQT, &p.maps.q,
                        q, qb, hb, a.L);
      load_rows<D, NWG>(base + L_::kQ0 + ((n & 1) * 2 + 1) * L_::kQT,
                        &p.maps.dout, q, qb, hb, a.L);
      for (int kt = lo; kt <= hi; ++kt) {
        if (!any_rows_need<NWG>(m, qb, kt * 64)) continue;
        const int s = it % S;
        mbar_wait(bar_empty + 8 * s, ((it / S) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * L_::kT);
        load_rows<D, 1>(base + L_::kK + s * L_::kT, &p.maps.k, full,
                        kt * 64, hb, a.L);
        load_rows<D, 1>(base + L_::kV + s * L_::kT, &p.maps.v, full,
                        kt * 64, hb, a.L);
        ++it;
      }
    }
    return;
  }
  if constexpr (NWG == 2) reg_alloc<kConsumerRegs>();

  // a consumer warpgroup: query rows [q0, q0 + 64) of each work item,
  // their lse and delta in registers
  const Frag f(tid & 127);
  const float sl2 = a.scale * kLog2e;
  int it = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int bh = item / n_qb, qb = item % n_qb * 64 * NWG;
    const Mask m = mask_of(a, bh);
    int lo, hi;
    block_k_range<NWG>(m, qb, lo, hi);
    const int q0 = qb + 64 * wg;
    float nl[2], dlt[2];
    uint32_t qmix[2] = {0u, 0u};
    const uint32_t sb =
        DROP ? (uint32_t)a.seed[0] + (uint32_t)bh * 0xC2B2AE3Du : 0u;
    const float* lg = stat_rows(a.lse_in, a.slse, HB(bh, a.H));
    const float* dg = stat_rows(a.delta, a.sdl, HB(bh, a.H));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi = q0 + f.fr + 8 * h;
      nl[h] = gi < a.L ? neg_lse2(lg[gi]) : -INFINITY;
      dlt[h] = gi < a.L ? dg[gi] : 0.f;
      if (DROP) qmix[h] = (uint32_t)gi * 0x9E3779B1u ^ sb;
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    const uint32_t sq = base + L_::kQ0 + (n & 1) * 2 * L_::kQT,
                   sdo = sq + L_::kQT;
    mbar_wait(bar_q + 8 * (n & 1), (n >> 1) & 1);
    for (int kt = lo; kt <= hi; ++kt) {
      const int k0 = kt * 64;
      if (!any_rows_need<NWG>(m, qb, k0)) continue;
      const int s = it % S;
      mbar_wait(bar_full + 8 * s, (it / S) & 1);
      ++it;
      if (m.needed(q0, k0)) {
        const uint32_t sk = base + L_::kK + s * L_::kT;
        const uint32_t sv = base + L_::kV + s * L_::kT;
        float sc[32], dp[32];
        uint32_t da[16];
        wgmma_fence();
        ss_product<D, NWG * 64>(sc, sq, 64 * wg, sk);
        ss_product<D, NWG * 64>(dp, sdo, 64 * wg, sv);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        if (m.interior(q0, k0))
          dq_grads<false, DROP>(sc, dp, da, m, f, q0, k0, nl, dlt, sl2, qmix,
                                a.thr, a.ks);
        else
          dq_grads<true, DROP>(sc, dp, da, m, f, q0, k0, nl, dlt, sl2, qmix,
                               a.thr, a.ks);
        fence_regs(dq);
        wgmma_fence();
        rs_product<D>(dq, da, sk);  // dQ += bf16(dS) K
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
      }
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(bar_empty + 8 * s);
    }
    // dQ scale through this warpgroup's rows of the item's Q tile, then
    // TMA; Q and dO are then free for the item after next
    frag_to_tile<D, NWG * 64>(smem + L_::kQ0 + (n & 1) * 2 * L_::kQT,
                              64 * wg, dq, a.scale, f);
    fence_async_shared();
    named_sync(1 + wg, 128);
    if (q0 < a.L)
      store_rows<D, NWG * 64>(&p.maps.out, sq, 64 * wg, q0, HB(bh, a.H),
                              tid & 127);
    if ((tid & 127) == 0) mbar_arrive(bar_q_empty + 8 * (n & 1));
  }
}

// ---------------------------------------------------------------------------
// #5 forward in bfloat16.  Work items as #6's: 64 NWG query rows of one
// (batch, head); NWG consumer warpgroups own 64 rows each, their Q rows
// (as A fragments), running max, sum and output in registers; one lane
// of the producer warpgroup loads each item's Q once (double-buffered)
// and rings the k tiles (K, V) through S stages, all by TMA over 4-D maps
// at the caller's strides.  Each consumer's tile is S = Q K^T, wait, the
// element pass, O += P V, wait: the other consumer's products overlap
// its element pass.
// ---------------------------------------------------------------------------
template <int D, int NWG, int S>
struct FwdSmem {
  static constexpr int kQT = NWG * 64 * D * 2;  // a Q tile
  static constexpr int kT = 64 * D * 2;         // a K (or V) stage
  // Q of items n even, then odd
  static constexpr int kQ0 = 0, kK = 2 * kQT, kV = kK + S * kT;
  // q_full[2], q_empty[2], full[S], empty[S]
  static constexpr int kBar = kV + S * kT;
  static constexpr int kBytes = kBar + (4 + 2 * S) * 8;
};

constexpr float kLn2 = 0.6931471805599453f;

// The element pass of #5 on S over 8 NJ keys (rows queries q0 + fr + 8 h,
// columns keys k0 + fc + 8 j + e), sl2 = |scale| log2(e) (S negated where
// the scale is negative).  Each row's running max mx (of S sl2) and this
// thread's part of its sum l move on by the tile, o is rescaled where a
// row's max moved (in base 2, alpha = exp2(mx_old - mx)), and s becomes
// P keep, P = exp2(S sl2 - mx), 0 where masked; l sums the undropped P.
// About 4 instructions an element at dropout 0 (the max, the exponent's
// FMA and SFU op, the sum), 12 more for the hash and its keep multiplier.
template <int D, int NJ, bool EDGE, bool DROP>
__device__ __forceinline__ void fwd_elems(float (&s)[4 * NJ],
                                          float (&o)[D / 2], float (&mx)[2],
                                          float (&l)[2], const Mask& m,
                                          const Frag& f, int q0, int k0,
                                          float sl2,
                                          const uint32_t (&qmix)[2],
                                          uint32_t thr, float ks) {
  uint32_t ok = 0xffffffffu;  // bit idx: element idx is valid
  if (EDGE) {
    ok = 0u;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * h + e;
          if (m.valid(q0 + f.fr + 8 * h, k0 + f.fc + 8 * j + e))
            ok |= 1u << idx;
          else
            s[idx] = kMasked;
        }
  }
  float mnew[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float c = kMasked;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      c = fmaxf(c, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
    c = fmaxf(c, __shfl_xor_sync(0xffffffffu, c, 1));
    c = fmaxf(c, __shfl_xor_sync(0xffffffffu, c, 2));
    mnew[h] = fmaxf(mx[h], c * sl2);
  }
  if (__any_sync(0xffffffffu, mnew[0] != mx[0] || mnew[1] != mx[1])) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float alpha = fast_exp2(mx[h] - mnew[h]);
      l[h] *= alpha;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * h] *= alpha;
        o[4 * j + 2 * h + 1] *= alpha;
      }
    }
  }
  const uint32_t kb0 = (uint32_t)(k0 + f.fc) * 0x85EBCA77u;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t kbe = kb0 + (uint32_t)(8 * j + e) * 0x85EBCA77u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = 4 * j + 2 * h + e;
        float p = fast_exp2(fmaf(s[idx], sl2, -mnew[h]));
        if (EDGE && !((ok >> idx) & 1u)) p = 0.f;
        l[h] += p;
        if (DROP) p *= keep_of_mix(qmix[h] ^ kbe, thr, ks);
        s[idx] = p;
      }
    }
  mx[0] = mnew[0];
  mx[1] = mnew[1];
}

// #5's element pass on a 64-key tile in bf16, then as A fragments pa =
// bf16(P keep) (half an instruction an element more)
template <int D, bool EDGE, bool DROP>
__device__ __forceinline__ void fwd_probs(float (&s)[32], float (&o)[D / 2],
                                          uint32_t (&pa)[16], float (&mx)[2],
                                          float (&l)[2], const Mask& m,
                                          const Frag& f, int q0, int k0,
                                          float sl2,
                                          const uint32_t (&qmix)[2],
                                          uint32_t thr, float ks) {
  fwd_elems<D, 8, EDGE, DROP>(s, o, mx, l, m, f, q0, k0, sl2, qmix, thr, ks);
#pragma unroll
  for (int i = 0; i < 16; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// Rows [row0, row0 + 64) of a bf16 tile of R rows in TMA's swizzled
// layout (see frag_to_tile) as a warpgroup's wgmma A fragments over D:
// k16 step kk in a[4 kk .. 4 kk + 3]
template <int D, int R>
__device__ __forceinline__ void tile_to_frag(uint32_t (&a)[D / 4],
                                             const uint8_t* tile, int row0,
                                             const Frag& f) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + f.fr + 8 * (i & 1);
      const int c = 16 * kk + 8 * (i >> 1) + f.fc;
      const int x = T::kLayout == 1 ? (r & 7) : ((r & 7) >> 1);
      const int ch = (c % T::kCols) / 8;
      a[4 * kk + i] = *reinterpret_cast<const uint32_t*>(
          tile + ((c / T::kCols) * R + r) * T::kRowBytes + (ch ^ x) * 16 +
          (c % 8) * 2);
    }
}

// s (64 x 64) = Q K^T over D: Q the A fragments qa, K a tile of 64 rows
// read K-major
template <int D>
__device__ __forceinline__ void rs_scores(float (&s)[32],
                                          const uint32_t (&qa)[D / 4],
                                          uint32_t tk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_rs_n64<0>(s, qa[4 * kk], qa[4 * kk + 1], qa[4 * kk + 2],
                    qa[4 * kk + 3], Tile<D>::template kmajor<64>(tk, 0, kk),
                    kk > 0);
}

template <int D, int NWG, int S, bool DROP>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_fwd_sm90(const __grid_constant__ Sm90Args p) {
  using L_ = FwdSmem<D, NWG, S>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const Args& a = p.a;
  const int n_qb = (a.L + 64 * NWG - 1) / (64 * NWG);
  const int items = n_qb * p.BH;
  const uint32_t bar_q = base + L_::kBar, bar_q_empty = bar_q + 16,
                 bar_full = bar_q + 32, bar_empty = bar_full + 8 * S;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  if (tid == NWG * 128) prefetch_maps(p.maps, false);
  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(bar_q + 8 * b, 1);
      mbar_init(bar_q_empty + 8 * b, NWG);  // thread 0 of each consumer
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * NWG);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {  // the producer warpgroup: one lane issues every load
    if constexpr (NWG == 2) reg_dealloc<kProducerRegs>();
    if (tid != NWG * 128) return;
    int it = 0, n = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const int bh = item / n_qb, qb = item % n_qb * 64 * NWG;
      const HB hb(bh, a.H);
      const Mask m = mask_of(a, bh);
      int lo, hi;
      block_k_range<NWG>(m, qb, lo, hi);
      // this item's Q, once the item two back is done with its buffer
      const uint32_t q = bar_q + 8 * (n & 1);
      mbar_wait(bar_q_empty + 8 * (n & 1), ((n >> 1) & 1) ^ 1);
      mbar_expect_tx(q, load_bytes<D, NWG>(qb, a.L));
      load_rows<D, NWG>(base + L_::kQ0 + (n & 1) * L_::kQT, &p.maps.q, q,
                        qb, hb, a.L);
      for (int kt = lo; kt <= hi; ++kt) {
        if (!any_rows_need<NWG>(m, qb, kt * 64)) continue;
        const int s = it % S;
        mbar_wait(bar_empty + 8 * s, ((it / S) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * L_::kT);
        load_rows<D, 1>(base + L_::kK + s * L_::kT, &p.maps.k, full,
                        kt * 64, hb, a.L);
        load_rows<D, 1>(base + L_::kV + s * L_::kT, &p.maps.v, full,
                        kt * 64, hb, a.L);
        ++it;
      }
    }
    return;
  }
  if constexpr (NWG == 2) reg_alloc<kConsumerRegs>();

  // a consumer warpgroup: query rows [q0, q0 + 64) of each work item
  const Frag f(tid & 127);
  const bool neg = a.scale < 0.f;
  const float sl2 = fabsf(a.scale) * kLog2e;
  int it = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int bh = item / n_qb, qb = item % n_qb * 64 * NWG;
    const HB hb(bh, a.H);
    const Mask m = mask_of(a, bh);
    int lo, hi;
    block_k_range<NWG>(m, qb, lo, hi);
    const int q0 = qb + 64 * wg;
    uint32_t qmix[2] = {0u, 0u};
    if (DROP) {
      const uint32_t sb = (uint32_t)a.seed[0] + (uint32_t)bh * 0xC2B2AE3Du;
      for (int h = 0; h < 2; ++h)
        qmix[h] = (uint32_t)(q0 + f.fr + 8 * h) * 0x9E3779B1u ^ sb;
    }
    float o[D / 2], mx[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    const uint32_t sq = base + L_::kQ0 + (n & 1) * L_::kQT;
    mbar_wait(bar_q + 8 * (n & 1), (n >> 1) & 1);
    // this warpgroup's Q rows into registers: S reads only K from shared
    // memory
    uint32_t qa[D / 4];
    tile_to_frag<D, NWG * 64>(qa, smem + L_::kQ0 + (n & 1) * L_::kQT, 64 * wg,
                              f);
    for (int kt = lo; kt <= hi; ++kt) {
      const int k0 = kt * 64;
      if (!any_rows_need<NWG>(m, qb, k0)) continue;
      const int s = it % S;
      mbar_wait(bar_full + 8 * s, (it / S) & 1);
      ++it;
      if (m.needed(q0, k0)) {
        const uint32_t sk = base + L_::kK + s * L_::kT;
        const uint32_t sv = base + L_::kV + s * L_::kT;
        float sc[32];
        uint32_t pa[16];
        wgmma_fence();
        rs_scores<D>(sc, qa, sk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        if (neg) {
#pragma unroll
          for (int i = 0; i < 32; ++i) sc[i] = -sc[i];
        }
        if (m.interior(q0, k0))
          fwd_probs<D, false, DROP>(sc, o, pa, mx, l, m, f, q0, k0, sl2, qmix,
                                    a.thr, a.ks);
        else
          fwd_probs<D, true, DROP>(sc, o, pa, mx, l, m, f, q0, k0, sl2, qmix,
                                   a.thr, a.ks);
        fence_regs(o);
        wgmma_fence();
        rs_product<D>(o, pa, sv);  // O += bf16(P keep) V
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
      }
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(bar_empty + 8 * s);
    }
    // O / l through this warpgroup's rows of the item's Q tile, then TMA;
    // lse by plain stores, one lane of the four that share a row.  A row
    // with no valid key has l = 0 and o = 0: out 0, lse -inf.
    float lsum[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t = l[h];
      t += __shfl_xor_sync(0xffffffffu, t, 1);
      t += __shfl_xor_sync(0xffffffffu, t, 2);
      lsum[h] = t;
      const float inv = t == 0.f ? 0.f : 1.f / t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * h] *= inv;
        o[4 * j + 2 * h + 1] *= inv;
      }
    }
    frag_to_tile<D, NWG * 64>(smem + L_::kQ0 + (n & 1) * L_::kQT, 64 * wg, o,
                              1.f, f);
    fence_async_shared();
    named_sync(1 + wg, 128);
    if (q0 < a.L)
      store_rows<D, NWG * 64>(&p.maps.out, sq, 64 * wg, q0, hb, tid & 127);
    if ((tid & 3) == 0) {
      float* lse = static_cast<float*>(a.lse_out) + a.slse.at(bh, a.H);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gi = q0 + f.fr + 8 * h;
        if (gi < a.L)
          lse[gi] = lsum[h] == 0.f ? -INFINITY
                                   : (mx[h] + log2f(lsum[h])) * kLn2;
      }
    }
    if ((tid & 127) == 0) mbar_arrive(bar_q_empty + 8 * (n & 1));
  }
}

// ---------------------------------------------------------------------------
// #6 and #7 in float32: 3xTF32 products on the tensor cores (sm_90a)
// ---------------------------------------------------------------------------
// An (R, D) fp32 tile as TMA writes it: D / 32 boxes of 32 columns side by
// side, each R rows of 128 bytes, 128-byte swizzled (16-byte chunk c of
// row r at c ^ (r % 8)).
template <int D, int R>
struct TileF {
  static constexpr int kBytes = R * D * 4;
  // byte offset of element (r, c)
  __device__ static int at(int r, int c) {
    return ((c >> 5) * R + r) * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) +
           (c & 3) * 4;
  }
  // K-major wgmma operand over D: rows from row0 (a multiple of 8) at k8
  // step kk, 32 bytes a step within a box
  __device__ static uint64_t kmajor(uint32_t tile, int row0, int kk) {
    return gmma_desc(tile + ((kk >> 2) * R + row0) * 128 + (kk & 3) * 32, 1,
                     1024);
  }
};

// Rows [row0, row0 + NR ROWS) of a float32 map into a tile of NR ROWS rows,
// boxes of ROWS rows by 32 columns, skipping the ROWS-row groups that start
// at or past L; f32_load_bytes is what that asks for.
template <int D, int NR, int ROWS>
__device__ __forceinline__ uint32_t f32_load_bytes(int row0, int L) {
  uint32_t bytes = 0;
#pragma unroll
  for (int w = 0; w < NR; ++w)
    if (row0 + ROWS * w < L) bytes += ROWS * D * 4;
  return bytes;
}
template <int D, int NR, int ROWS>
__device__ __forceinline__ void f32_load_rows(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int row0,
                                              HB where, int L) {
#pragma unroll
  for (int w = 0; w < NR; ++w) {
    if (row0 + ROWS * w >= L) break;
#pragma unroll
    for (int b = 0; b < D / 32; ++b)
      tma_load_rows(dst + (b * NR + w) * ROWS * 128, map, bar, b * 32,
                    row0 + ROWS * w, where);
  }
}

// What the tensor core drops of rows [row0, row0 + 64) of an fp32 tile
// (TileF<D, R>), k8 steps [kk0, kk0 + CH), rounded to tf32, as a
// warpgroup's tf32 A fragments: step kk0 + c in a[4 c .. 4 c + 3], rows
// fr, fr + 8 and columns 8 kk + t, 8 kk + t + 4 (t = fc / 2).
// Conflict-free: a load's 8 rows land in 8 distinct chunks.
template <int D, int R, int CH>
__device__ __forceinline__ void residual_frags(uint32_t (&a)[4 * CH],
                                               const uint8_t* tile, int row0,
                                               int kk0, const Frag& f) {
  const int t = f.fc >> 1;
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + f.fr + 8 * (i & 1);
      const int col = 8 * (kk0 + c) + t + 4 * (i >> 1);
      a[4 * c + i] = tf32_round(tf32_residual(
          *reinterpret_cast<const float*>(tile + TileF<D, R>::at(r, col))));
    }
}

// The tensor core's adds into its fp32 accumulator do not round to
// nearest, up to 2^-23 of the running sum each time: a chain into one
// large accumulator drifts (3xTF32's three products a k8 step, over a
// whole tile, read up to 3e-5 of the largest gradient on the card).  So
// the small products come first and the hi hi products, one a k8 step,
// last.
//
// c (64 x N) (+)= A B_lo + A_lo B over k8 steps [kk0, kk0 + CH) of D: A
// the rows [a0, a0 + 64) of an fp32 tile of RA rows at ta, its residuals
// in alo (residual_frags); B the N-row fp32 tile tb, its residual tile at
// tb + 2 TileF<D, N>::kBytes (a stage's layout).  The tensor core reads A
// and B as their tf32 truncations, so with hi_products these leave out
// only A_lo B_lo and the truncation of the residuals, about 2^-20 of each
// product.  c starts from 0 when `first`.
template <int D, int RA, int N, int CH>
__device__ __forceinline__ void lo_products(float (&c)[N / 2], uint32_t ta,
                                            int a0,
                                            const uint32_t (&alo)[4 * CH],
                                            uint32_t tb, int kk0,
                                            bool first) {
  using TB = TileF<D, N>;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int kk = kk0 + i;
    wgmma_tf32_ss<N>(c, TileF<D, RA>::kmajor(ta, a0, kk),
                     TB::kmajor(tb + 2 * TB::kBytes, 0, kk),
                     !(first && i == 0));
    wgmma_tf32_rs<N>(c, alo + 4 * i, TB::kmajor(tb, 0, kk));
  }
}
// s (64 x N) (+)= A B over all of D as tf32 (see lo_products); s starts
// from 0 when `first`
template <int D, int RA, int N>
__device__ __forceinline__ void hi_products(float (&s)[N / 2], uint32_t ta,
                                            int a0, uint32_t tb,
                                            bool first) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    wgmma_tf32_ss<N>(s, TileF<D, RA>::kmajor(ta, a0, kk),
                     TileF<D, N>::kmajor(tb, 0, kk), !(first && kk == 0));
}

// A tile's first products for one warpgroup, s = A1 B1^T and, when NP is
// 2, d = A2 B2^T, in 3xTF32 (A1, A2 the rows [a0, a0 + 64) of tiles of RA
// rows; B1, B2 stage tiles of N rows), CH k8 steps of the lo products a
// group (so the residual fragments take 4 NP CH registers), the hi
// products with the last group; returns with them done.
template <int D, int RA, int N, int CH, int NP = 2>
__device__ __forceinline__ void first_products(float (&s)[N / 2],
                                               float (&d)[N / 2],
                                               const uint8_t* smem,
                                               uint32_t base, uint32_t a1,
                                               uint32_t a2, int a0,
                                               uint32_t b1, uint32_t b2,
                                               const Frag& f) {
#pragma unroll
  for (int kk0 = 0; kk0 < D / 8; kk0 += CH) {
    uint32_t r1[4 * CH], r2[4 * CH];
    residual_frags<D, RA, CH>(r1, smem + (a1 - base), a0, kk0, f);
    if constexpr (NP == 2)
      residual_frags<D, RA, CH>(r2, smem + (a2 - base), a0, kk0, f);
    wgmma_fence();
    lo_products<D, RA, N, CH>(s, a1, a0, r1, b1, kk0, kk0 == 0);
    if constexpr (NP == 2)
      lo_products<D, RA, N, CH>(d, a2, a0, r2, b2, kk0, kk0 == 0);
    if (kk0 + CH == D / 8) {
      hi_products<D, RA, N>(s, a1, a0, b1, false);
      if constexpr (NP == 2) hi_products<D, RA, N>(d, a2, a0, b2, false);
    }
    wgmma_commit();
    wgmma_wait<0>();
  }
  fence_regs(s);
  if constexpr (NP == 2) fence_regs(d);
}

// The forward's one first product, s = A B^T in 3xTF32, as above.
template <int D, int RA, int N, int CH>
__device__ __forceinline__ void first_products(float (&s)[N / 2],
                                               const uint8_t* smem,
                                               uint32_t base, uint32_t a,
                                               int a0, uint32_t b,
                                               const Frag& f) {
  first_products<D, RA, N, CH, 1>(s, s, smem, base, a, a, a0, b, b, f);
}

// acc (the warp's 16 rows by D, in the accumulator's layout) += A B in
// 3xTF32 on mma.sync m16n8k8: A the warp's rows of an m64nR fp32
// accumulator a (its R columns the K dimension), B an fp32 tile (TileF<D,
// R>) of R rows by D, read row-major as TMA wrote it.  The accumulator
// gives lane (g, t) columns 2t and 2t + 1 of each 8-group where mma's A
// fragment takes t and t + 4, so K runs permuted within each 8-group (mma's
// k t is column 2t, k t + 4 column 2t + 1) and each lane reads B's rows 2t
// and 2t + 1 to match: the sum over K is the same.  A and B split into
// tf32 hi + lo in registers; lo lo is left out.  Each 8-column block of
// the tile's sum starts from 0, takes the lo products, then the hi ones
// (the drift, above), and is added to acc by a rounded fp32 add.
// Conflict-free: a load's lanes read 8 columns of 4 rows of one parity, 8
// distinct chunks.
template <int D, int R>
__device__ __forceinline__ void mma_product(float (&acc)[D / 2],
                                            const float (&a)[R / 2],
                                            const uint8_t* tb) {
  constexpr int NJ = R / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ah[R / 2], al[R / 2];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    tf32_split(a[4 * j], ah[4 * j], al[4 * j]);              // row g, col 2t
    tf32_split(a[4 * j + 2], ah[4 * j + 1], al[4 * j + 1]);  // g + 8, 2t
    tf32_split(a[4 * j + 1], ah[4 * j + 2], al[4 * j + 2]);  // g, 2t + 1
    tf32_split(a[4 * j + 3], ah[4 * j + 3], al[4 * j + 3]);  // g + 8, 2t + 1
  }
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int c = 8 * nb + g;
    float cc[4] = {0.f, 0.f, 0.f, 0.f};
    uint32_t bh[2 * NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int k = 8 * j + 2 * t;
      uint32_t bl0, bl1;
      tf32_split(*reinterpret_cast<const float*>(tb + TileF<D, R>::at(k, c)),
                 bh[2 * j], bl0);
      tf32_split(
          *reinterpret_cast<const float*>(tb + TileF<D, R>::at(k + 1, c)),
          bh[2 * j + 1], bl1);
      mma_tf32(cc, al + 4 * j, bh[2 * j], bh[2 * j + 1]);
      mma_tf32(cc, ah + 4 * j, bl0, bl1);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      mma_tf32(cc, ah + 4 * j, bh[2 * j], bh[2 * j + 1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[4 * nb + i] += cc[i];
  }
}

// A warpgroup's (64, D) fp32 accumulator times scale into rows [row0, row0
// + 64) of an fp32 tile (TileF<D, R>) in the layout TMA reads.  A store's
// 32 lanes write 8 rows x 2 chunks, two wavefronts.
template <int D, int R>
__device__ __forceinline__ void frag_to_tile_f32(uint8_t* tile, int row0,
                                                 const float (&acc)[D / 2],
                                                 float scale, const Frag& f) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + f.fr + 8 * h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(tile + TileF<D, R>::at(r, 8 * j + f.fc)) =
          make_float2(acc[4 * j + 2 * h] * scale,
                      acc[4 * j + 2 * h + 1] * scale);
  }
}

// Rows [row0, row0 + 64) of an fp32 tile of R rows at shared `tile`,
// written by one warpgroup, to rows [grow, grow + 64) of (batch, head)
// `where` through `map`; thread t of the warpgroup issues the store and
// returns once TMA has read the tile.  Rows past L are not written.
template <int D, int R>
__device__ __forceinline__ void store_rows_f32(const CUtensorMap* map,
                                               uint32_t tile, int row0,
                                               int grow, HB where, int t) {
  if (t != 0) return;
#pragma unroll
  for (int b = 0; b < D / 32; ++b)
    tma_store_rows(map, tile + (b * R + row0) * 128, b * 32, grow, where);
  tma_store_commit_wait_read();
}

// The transform warps' share of a stage (warps 1-3 of the producer
// warpgroup, thread i0 of 96): the residual tiles x - tf32(x) of its first
// NR streamed tiles (the backward's two, the forward's K), elementwise in
// the same swizzled layout, from the stage's third tile on, then a fence
// so that wgmma (the async proxy) sees them.
template <int D, int R, int NR = 2>
__device__ __forceinline__ void write_residuals(uint8_t* stage, int i0) {
  constexpr int n = NR * R * D / 4;  // float4s of the tiles
  const float4* src = reinterpret_cast<const float4*>(stage);
  float4* dst = reinterpret_cast<float4*>(stage + 2 * R * D * 4);
#pragma unroll 4
  for (int i = i0; i < n; i += 96) {
    const float4 v = src[i];
    dst[i] = make_float4(tf32_residual(v.x), tf32_residual(v.y),
                         tf32_residual(v.z), tf32_residual(v.w));
  }
  fence_async_shared();
}

// The float32 kernels' shared memory: the block's own side, NO tiles of
// NWG groups of 64 rows (#5: Q; #6: Q and dO; #7: K and V) in OB buffers,
// S stages of the streamed side of R rows each, NT tiles a stage (#5: K, V
// and K's residual tile; #6: K, V and their residual tiles; #7: Q, dO and
// theirs), ST bytes of #7's lse (as neg_lse2) and delta for the stages,
// barriers.
template <int D, int NWG, int R, int S, int OB, int NO = 2, int NT = 4,
          int ST = 8 * S * R>
struct SmemF {
  static constexpr int kOwn = NWG * 64 * D * 4;  // an own tile
  static constexpr int kT = R * D * 4;           // a streamed tile
  static constexpr int kStage = NO * OB * kOwn;  // stage s at kStage + NT s kT
  static constexpr int kStats = kStage + NT * S * kT;  // stage s: + 8 s R
  // own_full[OB], own_empty[OB], full[S], ready[S], empty[S]
  static constexpr int kBar = kStats + ST;
  static constexpr int kBytes = kBar + (2 * OB + 3 * S) * 8;
};

// The flash kernels: #5 forward, #6 dq, #7 dk and dv.
enum Which { kFwd, kDq, kDkv };

// The float32 kernels' shape per kernel and head dim; here the backward's
// (#6 and #7): consumer warpgroups of 64 own rows (one at D 128, where
// #7's dK and dV take 128 fp32 a thread), streamed rows per stage,
// stages, own-side buffers, and the k8 steps of the first products' lo
// products per group (all of D in one group but at D 128).  32 streamed
// rows keep the consumers near the 168 registers a thread that ptxas
// allots at 384 threads (see the note at the top), and leave room for the
// own side's second buffer at D 64 (the next item's loads overlap this
// one's tiles).  Shared memory: 113 KB at D 32, 193 KB at D 64 and 192 KB
// at D 128.
template <Which W, int D>
struct CfgF {
  static constexpr int kWG = D == 128 ? 1 : 2;
  static constexpr int kR = 32;
  static constexpr int kStages = D == 32 ? 3 : 2;
  static constexpr int kOwnBufs = D == 128 ? 1 : 2;
  static constexpr int kChunk = D == 128 ? 4 : D / 8;
  using Smem = SmemF<D, kWG, kR, kStages, kOwnBufs>;
  static_assert(Smem::kBytes + 1024 <= 232448, "float32 flash: smem");
};

// The float32 forward's shape per head dim.  It holds no dO, dP or delta:
// one own tile (Q) a buffer, three tiles a stage (K, V, K's residual: V is
// mma_product's B and splits in registers), and o takes D / 2 fp32 a
// thread, so two consumer warpgroups fit at every D.  64 streamed rows a
// stage (half #6's barrier round trips a key) in 3 stages at D 32 and 64;
// at D 128 two Q buffers of 128 rows leave room for 2 stages of 32 rows.
// Shared memory: 104 KB at D 32, 208 KB at D 64, 224 KB at D 128.
template <int D>
struct CfgF<kFwd, D> {
  static constexpr int kWG = 2;
  static constexpr int kR = D == 128 ? 32 : 64;
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kOwnBufs = 2;
  static constexpr int kChunk = CfgF<kDq, D>::kChunk;
  using Smem = SmemF<D, kWG, kR, kStages, kOwnBufs, 1, 3, 0>;
  static_assert(Smem::kBytes + 1024 <= 232448, "float32 flash fwd: smem");
};

// registers of the float32 kernels' warpgroups at NWG 2: the producer's
// transform warps need more than the bf16 kernels' 24
constexpr int kConsumerRegsF = 232, kProducerRegsF = 40;

// The float32 kernels' barriers, in shared memory from `bar` on.
struct BarsF {
  uint32_t own, own_empty, full, ready, empty;
  template <int OB, int S>
  __device__ static BarsF at(uint32_t bar) {
    BarsF b;
    b.own = bar;
    b.own_empty = bar + 8 * OB;
    b.full = bar + 16 * OB;
    b.ready = b.full + 8 * S;
    b.empty = b.ready + 8 * S;
    return b;
  }
  // full's arrivals: 1 (#5's and #6's loading lane) or 32 (#7's loader
  // warp)
  template <int OB, int S, int NWG>
  __device__ void init(int full_count) const {
    for (int b = 0; b < OB; ++b) {
      mbar_init(own + 8 * b, 1);
      mbar_init(own_empty + 8 * b, NWG);  // thread 0 of each consumer
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, full_count);
      mbar_init(ready + 8 * s, 96);       // the transform warps' threads
      mbar_init(empty + 8 * s, 4 * NWG);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
};

// ---------------------------------------------------------------------------
// #5 forward in float32.  Work items and rings as #6's: 64 NWG query rows
// of one (batch, head); one lane of the producer warpgroup loads each
// item's Q (OB buffers) and rings the k tiles (K, V) of R keys through S
// stages, all by TMA; warps 1-3 of the producer warpgroup write each
// stage's K residual tile; NWG consumer warpgroups own 64 query rows each,
// their running max, sum and output in registers.  Per tile: S = Q K^T on
// wgmma in 3xTF32, the online softmax on the accumulator (fwd_elems), O +=
// (P keep) V on mma.sync in 3xTF32 reading V as TMA wrote it.
// ---------------------------------------------------------------------------
template <int D, int NWG, int R, int S, int OB, bool DROP>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_fwd_tf32(const __grid_constant__ Sm90Args p) {
  using L_ = SmemF<D, NWG, R, S, OB, 1, 3, 0>;
  constexpr int CH = CfgF<kFwd, D>::kChunk;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const Args& a = p.a;
  const int n_qb = (a.L + 64 * NWG - 1) / (64 * NWG);
  const int items = n_qb * p.BH;
  const BarsF bars = BarsF::at<OB, S>(base + L_::kBar);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  if (tid == NWG * 128) prefetch_maps(p.maps, false);
  if (tid == 0) bars.init<OB, S, NWG>(1);
  __syncthreads();

  if (wg == NWG) {  // the producer warpgroup
    if constexpr (NWG == 2) reg_dealloc<kProducerRegsF>();
    const bool loader = tid < NWG * 128 + 32;
    if (loader && tid != NWG * 128) return;
    int it = 0, n = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const int bh = item / n_qb, qb = item % n_qb * 64 * NWG;
      const HB hb(bh, a.H);
      const Mask m = mask_of(a, bh);
      int lo, hi;
      block_k_range<NWG, R>(m, qb, lo, hi);
      const int b = n % OB;
      if (loader) {  // this item's Q, once its buffer is free
        const uint32_t own = bars.own + 8 * b;
        mbar_wait(bars.own_empty + 8 * b, ((n / OB) & 1) ^ 1);
        mbar_expect_tx(own, f32_load_bytes<D, NWG, 64>(qb, a.L));
        f32_load_rows<D, NWG, 64>(base + b * L_::kOwn, &p.maps.q, own, qb,
                                  hb, a.L);
      }
      for (int kt = lo; kt <= hi; ++kt) {
        if (!any_rows_need<NWG, R>(m, qb, kt * R)) continue;
        const int s = it % S, ph = (it / S) & 1;
        const uint32_t stage = base + L_::kStage + 3 * s * L_::kT;
        ++it;
        if (loader) {
          mbar_wait(bars.empty + 8 * s, ph ^ 1);
          const uint32_t full = bars.full + 8 * s;
          mbar_expect_tx(full, 2 * L_::kT);
          f32_load_rows<D, 1, R>(stage, &p.maps.k, full, kt * R, hb, a.L);
          f32_load_rows<D, 1, R>(stage + L_::kT, &p.maps.v, full, kt * R, hb,
                                 a.L);
        } else {
          mbar_wait(bars.full + 8 * s, ph);
          write_residuals<D, R, 1>(smem + (stage - base),
                                   tid - NWG * 128 - 32);
          mbar_arrive(bars.ready + 8 * s);
        }
      }
    }
    return;
  }
  if constexpr (NWG == 2) reg_alloc<kConsumerRegsF>();

  // a consumer warpgroup: query rows [q0, q0 + 64) of each work item
  const Frag f(tid & 127);
  const bool neg = a.scale < 0.f;
  const float sl2 = fabsf(a.scale) * kLog2e;
  int it = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int bh = item / n_qb, qb = item % n_qb * 64 * NWG;
    const HB hb(bh, a.H);
    const Mask m = mask_of(a, bh);
    int lo, hi;
    block_k_range<NWG, R>(m, qb, lo, hi);
    const int q0 = qb + 64 * wg, b = n % OB;
    uint32_t qmix[2] = {0u, 0u};
    if (DROP) {
      const uint32_t sb = (uint32_t)a.seed[0] + (uint32_t)bh * 0xC2B2AE3Du;
      for (int h = 0; h < 2; ++h)
        qmix[h] = (uint32_t)(q0 + f.fr + 8 * h) * 0x9E3779B1u ^ sb;
    }
    float o[D / 2], mx[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    const uint32_t sq = base + b * L_::kOwn;
    mbar_wait(bars.own + 8 * b, (n / OB) & 1);
    for (int kt = lo; kt <= hi; ++kt) {
      const int k0 = kt * R;
      if (!any_rows_need<NWG, R>(m, qb, k0)) continue;
      const int s = it % S, ph = (it / S) & 1;
      mbar_wait(bars.full + 8 * s, ph);
      mbar_wait(bars.ready + 8 * s, ph);
      ++it;
      if (m.needed<64, R>(q0, k0)) {
        const uint32_t sk = base + L_::kStage + 3 * s * L_::kT;
        float sc[R / 2];
        // S = Q K^T
        first_products<D, NWG * 64, R, CH>(sc, smem, base, sq, 64 * wg, sk,
                                           f);
        if (neg) {
#pragma unroll
          for (int i = 0; i < R / 2; ++i) sc[i] = -sc[i];
        }
        // every masked P is 0 here, so no masked score reaches the product
        if (m.interior<64, R>(q0, k0))
          fwd_elems<D, R / 8, false, DROP>(sc, o, mx, l, m, f, q0, k0, sl2,
                                           qmix, a.thr, a.ks);
        else
          fwd_elems<D, R / 8, true, DROP>(sc, o, mx, l, m, f, q0, k0, sl2,
                                          qmix, a.thr, a.ks);
        // O += (P keep) V
        mma_product<D, R>(o, sc, smem + (sk + L_::kT - base));
      }
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(bars.empty + 8 * s);
    }
    // O / l through this warpgroup's rows of the item's Q tile, then TMA;
    // lse by plain stores, one lane of the four that share a row.  A row
    // with no valid key has l = 0 and o = 0: out 0, lse -inf.  Q is then
    // free for the item OB on.
    float lsum[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t = l[h];
      t += __shfl_xor_sync(0xffffffffu, t, 1);
      t += __shfl_xor_sync(0xffffffffu, t, 2);
      lsum[h] = t;
      const float inv = t == 0.f ? 0.f : 1.f / t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * h] *= inv;
        o[4 * j + 2 * h + 1] *= inv;
      }
    }
    frag_to_tile_f32<D, NWG * 64>(smem + (sq - base), 64 * wg, o, 1.f, f);
    fence_async_shared();
    named_sync(1 + wg, 128);
    if (q0 < a.L)
      store_rows_f32<D, NWG * 64>(&p.maps.out, sq, 64 * wg, q0, hb,
                                  tid & 127);
    if ((tid & 3) == 0) {
      float* lse = static_cast<float*>(a.lse_out) + a.slse.at(hb);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gi = q0 + f.fr + 8 * h;
        if (gi < a.L)
          lse[gi] = lsum[h] == 0.f ? -INFINITY
                                   : (mx[h] + log2f(lsum[h])) * kLn2;
      }
    }
    if ((tid & 127) == 0) mbar_arrive(bars.own_empty + 8 * b);
  }
}

// ---------------------------------------------------------------------------
// #6 dq in float32.  Work items and rings as the bf16 kernel's: 64 NWG
// query rows of one (batch, head); one lane of the producer warpgroup
// loads each item's Q and dO (OB buffers) and rings the k tiles (K, V) of
// R keys through S stages, all by TMA; warps 1-3 of the producer
// warpgroup write each stage's residual tiles; NWG consumer warpgroups own
// 64 query rows each.  Per tile: S = Q K^T and dP = dO V^T on wgmma in
// 3xTF32, the element pass on the accumulators, dQ += dS K on mma.sync in
// 3xTF32 reading K as TMA wrote it.
// ---------------------------------------------------------------------------
template <int D, int NWG, int R, int S, int OB, bool DROP>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_bwd_dq_tf32(const __grid_constant__ Sm90Args p) {
  using L_ = SmemF<D, NWG, R, S, OB>;
  constexpr int CH = CfgF<kDq, D>::kChunk;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const Args& a = p.a;
  const int n_qb = (a.L + 64 * NWG - 1) / (64 * NWG);
  const int items = n_qb * p.BH;
  const BarsF bars = BarsF::at<OB, S>(base + L_::kBar);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  if (tid == NWG * 128) prefetch_maps(p.maps, true);
  if (tid == 0) bars.init<OB, S, NWG>(1);
  __syncthreads();

  if (wg == NWG) {  // the producer warpgroup
    if constexpr (NWG == 2) reg_dealloc<kProducerRegsF>();
    const bool loader = tid < NWG * 128 + 32;
    if (loader && tid != NWG * 128) return;
    int it = 0, n = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const int bh = item / n_qb, qb = item % n_qb * 64 * NWG;
      const HB hb(bh, a.H);
      const Mask m = mask_of(a, bh);
      int lo, hi;
      block_k_range<NWG, R>(m, qb, lo, hi);
      const int b = n % OB;
      if (loader) {  // this item's Q and dO, once their buffer is free
        const uint32_t own = bars.own + 8 * b;
        mbar_wait(bars.own_empty + 8 * b, ((n / OB) & 1) ^ 1);
        mbar_expect_tx(own, 2 * f32_load_bytes<D, NWG, 64>(qb, a.L));
        f32_load_rows<D, NWG, 64>(base + 2 * b * L_::kOwn, &p.maps.q, own, qb,
                                  hb, a.L);
        f32_load_rows<D, NWG, 64>(base + (2 * b + 1) * L_::kOwn,
                                  &p.maps.dout, own, qb, hb, a.L);
      }
      for (int kt = lo; kt <= hi; ++kt) {
        if (!any_rows_need<NWG, R>(m, qb, kt * R)) continue;
        const int s = it % S, ph = (it / S) & 1;
        const uint32_t stage = base + L_::kStage + 4 * s * L_::kT;
        ++it;
        if (loader) {
          mbar_wait(bars.empty + 8 * s, ph ^ 1);
          const uint32_t full = bars.full + 8 * s;
          mbar_expect_tx(full, 2 * L_::kT);
          f32_load_rows<D, 1, R>(stage, &p.maps.k, full, kt * R, hb, a.L);
          f32_load_rows<D, 1, R>(stage + L_::kT, &p.maps.v, full, kt * R, hb,
                                 a.L);
        } else {
          mbar_wait(bars.full + 8 * s, ph);
          write_residuals<D, R>(smem + (stage - base), tid - NWG * 128 - 32);
          mbar_arrive(bars.ready + 8 * s);
        }
      }
    }
    return;
  }
  if constexpr (NWG == 2) reg_alloc<kConsumerRegsF>();

  // a consumer warpgroup: query rows [q0, q0 + 64) of each work item,
  // their lse and delta in registers
  const Frag f(tid & 127);
  const float sl2 = a.scale * kLog2e;
  int it = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int bh = item / n_qb, qb = item % n_qb * 64 * NWG;
    const Mask m = mask_of(a, bh);
    int lo, hi;
    block_k_range<NWG, R>(m, qb, lo, hi);
    const int q0 = qb + 64 * wg, b = n % OB;
    float nl[2], dlt[2];
    uint32_t qmix[2] = {0u, 0u};
    const uint32_t sb =
        DROP ? (uint32_t)a.seed[0] + (uint32_t)bh * 0xC2B2AE3Du : 0u;
    const float* lg = stat_rows(a.lse_in, a.slse, HB(bh, a.H));
    const float* dg = stat_rows(a.delta, a.sdl, HB(bh, a.H));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi = q0 + f.fr + 8 * h;
      nl[h] = gi < a.L ? neg_lse2(lg[gi]) : -INFINITY;
      dlt[h] = gi < a.L ? dg[gi] : 0.f;
      if (DROP) qmix[h] = (uint32_t)gi * 0x9E3779B1u ^ sb;
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    const uint32_t sq = base + 2 * b * L_::kOwn, sdo = sq + L_::kOwn;
    mbar_wait(bars.own + 8 * b, (n / OB) & 1);
    for (int kt = lo; kt <= hi; ++kt) {
      const int k0 = kt * R;
      if (!any_rows_need<NWG, R>(m, qb, k0)) continue;
      const int s = it % S, ph = (it / S) & 1;
      mbar_wait(bars.full + 8 * s, ph);
      mbar_wait(bars.ready + 8 * s, ph);
      ++it;
      if (m.needed<64, R>(q0, k0)) {
        const uint32_t sk = base + L_::kStage + 4 * s * L_::kT;
        float sc[R / 2], dp[R / 2];
        first_products<D, NWG * 64, R, CH>(sc, dp, smem, base, sq, sdo,
                                           64 * wg, sk, sk + L_::kT, f);
        if (m.interior<64, R>(q0, k0))
          dq_elems<R / 8, false, DROP>(sc, dp, m, f, q0, k0, nl, dlt, sl2,
                                       qmix, a.thr, a.ks);
        else
          dq_elems<R / 8, true, DROP>(sc, dp, m, f, q0, k0, nl, dlt, sl2,
                                      qmix, a.thr, a.ks);
        mma_product<D, R>(dq, dp, smem + (sk - base));  // dQ += dS K
      }
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(bars.empty + 8 * s);
    }
    // dQ scale through this warpgroup's rows of the item's Q tile, then
    // TMA; Q and dO are then free for the item OB on
    frag_to_tile_f32<D, NWG * 64>(smem + (sq - base), 64 * wg, dq, a.scale,
                                  f);
    fence_async_shared();
    named_sync(1 + wg, 128);
    if (q0 < a.L)
      store_rows_f32<D, NWG * 64>(&p.maps.out, sq, 64 * wg, q0, HB(bh, a.H),
                                  tid & 127);
    if ((tid & 127) == 0) mbar_arrive(bars.own_empty + 8 * b);
  }
}

// ---------------------------------------------------------------------------
// #7 dk, dv in float32.  Work items as the bf16 kernel's: 64 NWG key rows
// of one (batch, head); warp 0 of the producer warpgroup loads each item's
// K and V (OB buffers) and rings the q tiles of R rows through S stages (Q
// and dO by TMA, lse and delta by its lanes); warps 1-3 write each stage's
// residual tiles.  Per tile: S^T = K Q^T and dP^T = V dO^T on wgmma in
// 3xTF32, the element pass, dV += (P^T keep) dO and dK += dS^T Q on
// mma.sync in 3xTF32 reading dO and Q as TMA wrote them.
// ---------------------------------------------------------------------------
template <int D, int NWG, int R, int S, int OB, bool DROP>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_bwd_dkv_tf32(const __grid_constant__ Sm90Args p) {
  using L_ = SmemF<D, NWG, R, S, OB>;
  constexpr int CH = CfgF<kDkv, D>::kChunk;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const Args& a = p.a;
  const int n_kb = (a.L + 64 * NWG - 1) / (64 * NWG);
  const int items = n_kb * p.BH;
  const BarsF bars = BarsF::at<OB, S>(base + L_::kBar);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  if (tid == NWG * 128) prefetch_maps(p.maps, true);
  if (tid == 0) bars.init<OB, S, NWG>(32);
  __syncthreads();

  if (wg == NWG) {  // the producer warpgroup
    if constexpr (NWG == 2) reg_dealloc<kProducerRegsF>();
    const bool loader = tid < NWG * 128 + 32;
    const bool lead = tid == NWG * 128;
    int it = 0, n = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const int bh = item / n_kb, kb = item % n_kb * 64 * NWG;
      const HB hb(bh, a.H);
      const Mask m = mask_of(a, bh);
      int lo, hi;
      block_q_range<NWG, R>(m, kb, lo, hi);
      const int b = n % OB;
      if (lead) {  // this item's K and V, once their buffer is free
        const uint32_t own = bars.own + 8 * b;
        mbar_wait(bars.own_empty + 8 * b, ((n / OB) & 1) ^ 1);
        mbar_expect_tx(own, 2 * f32_load_bytes<D, NWG, 64>(kb, a.L));
        f32_load_rows<D, NWG, 64>(base + 2 * b * L_::kOwn, &p.maps.k, own, kb,
                                  hb, a.L);
        f32_load_rows<D, NWG, 64>(base + (2 * b + 1) * L_::kOwn, &p.maps.v,
                                  own, kb, hb, a.L);
      }
      for (int qt = lo; qt <= hi; ++qt) {
        if (!any_keys_need<NWG, R>(m, qt * R, kb)) continue;
        const int s = it % S, ph = (it / S) & 1;
        const uint32_t stage = base + L_::kStage + 4 * s * L_::kT;
        ++it;
        if (loader) {
          Stats<R> st;
          st.fetch(a, hb, qt * R);
          mbar_wait(bars.empty + 8 * s, ph ^ 1);
          const uint32_t full = bars.full + 8 * s;
          if (lead) {
            mbar_expect(full, 2 * L_::kT);
            f32_load_rows<D, 1, R>(stage, &p.maps.q, full, qt * R, hb, a.L);
            f32_load_rows<D, 1, R>(stage + L_::kT, &p.maps.dout, full, qt * R,
                                   hb, a.L);
          }
          float* nl = reinterpret_cast<float*>(smem + L_::kStats) + 2 * s * R;
          st.store(nl, nl + R);
          mbar_arrive(full);
        } else {
          mbar_wait(bars.full + 8 * s, ph);
          write_residuals<D, R>(smem + (stage - base), tid - NWG * 128 - 32);
          mbar_arrive(bars.ready + 8 * s);
        }
      }
    }
    return;
  }
  if constexpr (NWG == 2) reg_alloc<kConsumerRegsF>();

  // a consumer warpgroup: keys [k0, k0 + 64) of each work item
  const Frag f(tid & 127);
  const float sl2 = a.scale * kLog2e;
  int it = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int bh = item / n_kb, kb = item % n_kb * 64 * NWG;
    const Mask m = mask_of(a, bh);
    int lo, hi;
    block_q_range<NWG, R>(m, kb, lo, hi);
    const int k0 = kb + 64 * wg, b = n % OB;
    uint32_t kmix[2] = {0u, 0u};
    if (DROP) {
      const uint32_t sb = (uint32_t)a.seed[0] + (uint32_t)bh * 0xC2B2AE3Du;
      for (int h = 0; h < 2; ++h)
        kmix[h] = (uint32_t)(k0 + f.fr + 8 * h) * 0x85EBCA77u ^ sb;
    }
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    const uint32_t sk = base + 2 * b * L_::kOwn, sv = sk + L_::kOwn;
    mbar_wait(bars.own + 8 * b, (n / OB) & 1);
    for (int qt = lo; qt <= hi; ++qt) {
      const int q0 = qt * R;
      if (!any_keys_need<NWG, R>(m, q0, kb)) continue;
      const int s = it % S, ph = (it / S) & 1;
      mbar_wait(bars.full + 8 * s, ph);
      mbar_wait(bars.ready + 8 * s, ph);
      ++it;
      if (m.needed<R, 64>(q0, k0)) {
        const uint32_t sq = base + L_::kStage + 4 * s * L_::kT;
        const uint32_t sdo = sq + L_::kT;
        const float* nl =
            reinterpret_cast<const float*>(smem + L_::kStats) + 2 * s * R;
        float st[R / 2], dpt[R / 2];
        first_products<D, NWG * 64, R, CH>(st, dpt, smem, base, sk, sv,
                                           64 * wg, sq, sdo, f);
        if (m.interior<R, 64>(q0, k0))
          dkv_elems<R / 8, false, DROP>(st, dpt, m, f, q0, k0, nl, nl + R,
                                        sl2, kmix, a.thr, a.ks);
        else
          dkv_elems<R / 8, true, DROP>(st, dpt, m, f, q0, k0, nl, nl + R,
                                       sl2, kmix, a.thr, a.ks);
        mma_product<D, R>(dv, st, smem + (sdo - base));  // dV += P^T keep dO
        mma_product<D, R>(dk, dpt, smem + (sq - base));  // dK += dS^T Q
      }
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(bars.empty + 8 * s);
    }
    // dK scale and dV through this warpgroup's rows of the item's K and V
    // tiles, then TMA; K and V are then free for the item OB on
    uint8_t* kt = smem + (sk - base);
    frag_to_tile_f32<D, NWG * 64>(kt, 64 * wg, dk, a.scale, f);
    frag_to_tile_f32<D, NWG * 64>(kt + L_::kOwn, 64 * wg, dv, 1.f, f);
    fence_async_shared();
    named_sync(1 + wg, 128);
    if (k0 < a.L) {
      const HB w(bh, a.H);
      store_rows_f32<D, NWG * 64>(&p.maps.out, sk, 64 * wg, k0, w, tid & 127);
      store_rows_f32<D, NWG * 64>(&p.maps.out2, sv, 64 * wg, k0, w,
                                  tid & 127);
    }
    if ((tid & 127) == 0) mbar_arrive(bars.own_empty + 8 * b);
  }
}

// A launch's tensors in the order of Maps: q, k, v, the first output (#5:
// out, #6: dq, #7: dk), then the backward's dout and #7's dv; n of them.
struct Views {
  int n;
  CUtensorMap* map[6];
  const void* ptr[6];
  const Strides* st[6];
  Views(Maps& mp, const Args& a, Which w)
      : n(w == kFwd ? 4 : w == kDq ? 5 : 6),
        map{&mp.q, &mp.k, &mp.v, &mp.out, &mp.dout, &mp.out2},
        ptr{a.q, a.k, a.v, w == kFwd ? a.out : w == kDq ? a.dq : a.dk,
            a.dout, a.dv},
        st{&a.sq, &a.sk, &a.sv,
           w == kFwd ? &a.so : w == kDq ? &a.sdq : &a.sdk, &a.sdo,
           &a.sdv} {}
};

// A (B, H, L, D) view at strides st (in elements) as a (D, L, H, B)
// tensor map in boxes of (cols, rows, 1, 1).  TMA refuses a base that is
// not 16-byte aligned and strides that are not multiples of 16 bytes (the
// wrappers copy such views first).
int map_view(CUtensorMap* m, CUtensorMapDataType t, int elt, const void* p,
             const Strides& st, const Args& a, int BH, int D, int cols,
             int rows, CUtensorMapSwizzle sw) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)a.L,
                              (cuuint64_t)a.H, (cuuint64_t)(BH / a.H)};
  const cuuint64_t strides[3] = {(cuuint64_t)st.sl * elt,
                                 (cuuint64_t)st.sh * elt,
                                 (cuuint64_t)st.sb * elt};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  return mxt_tensor_map(m, t, 4, p, dims, strides, box, sw);
}

// the bf16 kernels' maps, in boxes of (min(D, 64), 64, 1, 1), swizzled as
// their rows are wide
int make_maps(Maps& mp, const Args& a, int BH, int D, Which w) {
  const int cols = D < 64 ? D : 64;
  const CUtensorMapSwizzle sw = cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                           : CU_TENSOR_MAP_SWIZZLE_64B;
  const Views vs(mp, a, w);
  int rc = 0;
  for (int i = 0; i < vs.n && !rc; ++i)
    rc = map_view(vs.map[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, vs.ptr[i],
                  *vs.st[i], a, BH, D, cols, 64, sw);
  return rc;
}

// the longest L at which the bf16 kernels run persistent
constexpr int kPersistentL = 256;

// warpgroups and ring stages per kernel and head dim: two warpgroups
// where their accumulators fit the registers (#7 at D 128 holds dK and dV
// at 128 fp32 a thread: one), three stages where shared memory allows
// (the forward, with no dO to hold, at every D)
template <int D>
struct Cfg {
  static constexpr int kDkvWG = D == 128 ? 1 : 2;
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kFwdStages = 3;
};

template <int D, bool DROP>
int launch_sm90(const Sm90Args& p, int BH, Which w, cudaStream_t st) {
  constexpr int S = Cfg<D>::kStages, SF = Cfg<D>::kFwdStages,
                WG7 = Cfg<D>::kDkvWG;
  auto kernel = flash_fwd_sm90<D, 2, SF, DROP>;
  int nwg = 2, smem = FwdSmem<D, 2, SF>::kBytes;
  if (w == kDq) {
    kernel = flash_bwd_dq_sm90<D, 2, S, DROP>;
    smem = DqSmem<D, 2, S>::kBytes;
  } else if (w == kDkv) {
    kernel = flash_bwd_dkv_sm90<D, WG7, S, DROP>;
    nwg = WG7;
    smem = DkvSmem<D, WG7, S>::kBytes;
  }
  smem += 1024;  // the tiles' 1024-byte alignment
  static bool attr_set[3] = {false, false, false};  // once per kernel
  if (!attr_set[w]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set[w] = true;
  }
  int dev, sms;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // Short rows: a block per SM walks several items, so one item's
  // prologue (barriers, the first loads) overlaps another's products.
  // Long rows: a block per item, which the hardware deals to SMs as they
  // free up, evening out items the mask leaves uneven.
  const int items = (p.a.L + 64 * nwg - 1) / (64 * nwg) * BH;
  const int grid = p.a.L > kPersistentL || items < sms ? items : sms;
  kernel<<<grid, (nwg + 1) * 128, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int run_sm90(const Args& a, int BH, Which w, cudaStream_t st) {
  Sm90Args p = {};
  p.a = a;
  p.BH = BH;
  const int rc = make_maps(p.maps, a, BH, D, w);
  if (rc) return rc;
  return a.seed ? launch_sm90<D, true>(p, BH, w, st)
                : launch_sm90<D, false>(p, BH, w, st);
}

// the float32 kernels' maps, in boxes of 32 columns (128-byte rows,
// 128-byte swizzle) by 64 rows for the block's own side and the outputs,
// by R rows for the streamed side (#5 and #6: k and v, #7: q and dout)
int make_maps_f32(Maps& mp, const Args& a, int BH, int D, Which w, int R) {
  const Views vs(mp, a, w);
  int rc = 0;
  for (int i = 0; i < vs.n && !rc; ++i) {
    const bool streamed = w == kDkv ? i == 0 || i == 4 : i == 1 || i == 2;
    rc = map_view(vs.map[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, vs.ptr[i],
                  *vs.st[i], a, BH, D, 32, streamed ? R : 64,
                  CU_TENSOR_MAP_SWIZZLE_128B);
  }
  return rc;
}

template <Which W, int D, bool DROP>
int launch_tf32(const Sm90Args& p, int BH, cudaStream_t st) {
  using C = CfgF<W, D>;
  constexpr int NWG = C::kWG, R = C::kR, S = C::kStages, OB = C::kOwnBufs;
  void (*kernel)(Sm90Args);
  if constexpr (W == kFwd)
    kernel = flash_fwd_tf32<D, NWG, R, S, OB, DROP>;
  else if constexpr (W == kDq)
    kernel = flash_bwd_dq_tf32<D, NWG, R, S, OB, DROP>;
  else
    kernel = flash_bwd_dkv_tf32<D, NWG, R, S, OB, DROP>;
  const int smem = C::Smem::kBytes + 1024;  // the 1024-byte alignment
  static bool attr_set = false;  // once per kernel
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  int dev, sms;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // the grid as the bf16 kernels' (launch_sm90)
  const int items = (p.a.L + 64 * NWG - 1) / (64 * NWG) * BH;
  const int grid = p.a.L > kPersistentL || items < sms ? items : sms;
  kernel<<<grid, (NWG + 1) * 128, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <Which W, int D>
int run_tf32(const Args& a, int BH, cudaStream_t st) {
  Sm90Args p = {};
  p.a = a;
  p.BH = BH;
  const int rc = make_maps_f32(p.maps, a, BH, D, W, CfgF<W, D>::kR);
  if (rc) return rc;
  return a.seed ? launch_tf32<W, D, true>(p, BH, st)
                : launch_tf32<W, D, false>(p, BH, st);
}

template <Which W>
int dispatch(const Args& a, int BH, int D, int dtype, cudaStream_t st) {
  if (dtype == 0) {
    if (D == 32) return run_tf32<W, 32>(a, BH, st);
    if (D == 64) return run_tf32<W, 64>(a, BH, st);
    if (D == 128) return run_tf32<W, 128>(a, BH, st);
  } else {
    if (D == 32) return run_sm90<32>(a, BH, W, st);
    if (D == 64) return run_sm90<64>(a, BH, W, st);
    if (D == 128) return run_sm90<128>(a, BH, W, st);
  }
  return (int)cudaErrorInvalidValue;
}

// delta = sum_d dO * O, the row statistic #6 and #7 read (the JAX package
// computes it in jnp between its kernels, flash_attention.py:466, so it
// replaces no TPU kernel).  A row of (batch, head) bh is read by G lanes
// of one warp, G = D * sizeof(T) / 16 (4 to 32), each lane one 16-byte
// vector of dO and one of O at the views' strides; each lane adds its
// rounded products in element order, then the G partials meet in a
// butterfly of shuffles.  That order depends on D and T alone, not on B,
// H, L, the strides or the grid, so a row's sum has the same bits however
// the tensors are cut (the #16 route against its per-shard composition).
// Bound: bytes, dO and O read once, delta written once (25.2 MB in fp32
// at B 32, H 12, L 128, D 64: 7.5 us at 3.35 TB/s; 12.6 MB in bf16).
// A one-wave grid of contiguous row runs timed the same (PERF.md section 6).
struct DeltaArgs {
  const void *dout, *out;
  float* delta;  // (BH, L), contiguous
  Strides sdo, so;
  long long rows;
  int H, L, G;
};

template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(DeltaArgs p) {
  constexpr int V = 16 / sizeof(T);  // elements of a 16-byte vector
  const int lane = threadIdx.x & 31, G = p.G;
  const int c = lane % G, sub = lane / G, per_warp = 32 / G;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x)
                         >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  // r0 is the same in every lane of the warp, so the shuffles converge
  for (long long r0 = warp * per_warp; r0 < p.rows; r0 += warps * per_warp) {
    const long long r = r0 + sub;
    float s = 0.f;
    if (r < p.rows) {
      const int bh = (int)(r / p.L), i = (int)(r - (long long)bh * p.L);
      const T* a = static_cast<const T*>(p.dout) + p.sdo.at(bh, p.H) +
                   (long long)i * p.sdo.sl + c * V;
      const T* b = static_cast<const T*>(p.out) + p.so.at(bh, p.H) +
                   (long long)i * p.so.sl + c * V;
      const uint4 va = __ldg(reinterpret_cast<const uint4*>(a));
      const uint4 vb = __ldg(reinterpret_cast<const uint4*>(b));
      const T* ea = reinterpret_cast<const T*>(&va);
      const T* eb = reinterpret_cast<const T*>(&vb);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float x, y;
        if constexpr (sizeof(T) == 4) {
          x = ea[e];
          y = eb[e];
        } else {
          x = __bfloat162float(ea[e]);
          y = __bfloat162float(eb[e]);
        }
        s = __fadd_rn(s, __fmul_rn(x, y));
      }
    }
    for (int o = G >> 1; o > 0; o >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    if (c == 0 && r < p.rows) p.delta[r] = s;
  }
}

int run_delta(const DeltaArgs& p, int dtype, cudaStream_t st) {
  const long long per_block = 8LL * (32 / p.G);  // rows a block's pass
  const long long want = (p.rows + per_block - 1) / per_block;
  const int grid = (int)(want < 4096 ? want : 4096);
  if (dtype == 0)
    flash_bwd_delta_kernel<float><<<grid, 256, 0, st>>>(p);
  else
    flash_bwd_delta_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// (BH, L, D) and (BH, L) contiguous
Strides contiguous(int L, int D, int H) {
  return Strides{(long long)H * L * D, (long long)L * D, (long long)D};
}

Args make_args(const void* q, const void* k, const void* v, const void* seed,
               const void* kvlen, int H, int L, int D, float scale,
               int causal, int window, unsigned thr, float ks) {
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
  a.sq = a.sk = a.sv = a.so = a.sdo = a.sdq = a.sdk = a.sdv =
      contiguous(L, D, H);
  a.slse = a.sdl = contiguous(L, 1, H);
  return a;
}

// An entry point's `strides`: the B, H and L strides of n (B, H, L, D)
// views, then the B and H strides of m (B, H, L) float32 tensors.
void read_strides(const long long* s, Strides* const* views, int n,
                  Strides* const* stats, int m) {
  for (int i = 0; i < n; ++i)
    *views[i] = Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
  for (int i = 0; i < m; ++i)
    *stats[i] = Strides{s[3 * n + 2 * i], s[3 * n + 2 * i + 1], 1};
}

}  // namespace

extern "C" const char* mxt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Common arguments: q, k, v (B, H, L, D) with BH = B * H <= 65535, of dtype
// 0 float32 or 1 bfloat16; D in {32, 64, 128}.  seed: one int64 on the
// card (its low 32 bits the seed), or null for no dropout; kvlen: (B,)
// int32 on the card, or null for no padding mask; window < 0 for no band;
// thr and ks: the rate's uint32 keep threshold and keep scale.  strides,
// on the host, or null for contiguous tensors: each (B, H, L, D) view's B,
// H and L strides in elements (unit stride along D), then each (B, H, L)
// float32 tensor's B and H strides (unit stride along L).  Each view's
// base 16-byte aligned and each of its strides a multiple of 16 bytes
// (TMA's rule); the float32 tensors need neither.  Each returns
// cudaGetLastError() after its launch.

// out like q; lse (B, H, L) float32.  strides: 14 int64, q's, k's, v's
// and out's three, then lse's two.
extern "C" int mxt_flash_fwd(const void* q, const void* k, const void* v,
                             const void* seed, const void* kvlen, void* out,
                             void* lse, int BH, int H, int L, int D,
                             int dtype, float scale, int causal, int window,
                             unsigned thr, float ks, void* stream,
                             const long long* strides) {
  Args a = make_args(q, k, v, seed, kvlen, H, L, D, scale, causal, window,
                     thr, ks);
  a.out = out;
  a.lse_out = lse;
  if (strides) {
    Strides* const views[4] = {&a.sq, &a.sk, &a.sv, &a.so};
    Strides* const stats[1] = {&a.slse};
    read_strides(strides, views, 4, stats, 1);
  }
  return dispatch<kFwd>(a, BH, D, dtype, (cudaStream_t)stream);
}

// dout, dq like q; lse, delta (B, H, L) float32.  strides: 19 int64, q's,
// k's, v's, dout's and dq's three, then lse's and delta's two.
extern "C" int mxt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* seed,
                                const void* kvlen, void* dq, int BH, int H,
                                int L, int D, int dtype, float scale,
                                int causal, int window, unsigned thr,
                                float ks, void* stream,
                                const long long* strides) {
  Args a = make_args(q, k, v, seed, kvlen, H, L, D, scale, causal, window,
                     thr, ks);
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.dq = dq;
  if (strides) {
    Strides* const views[5] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq};
    Strides* const stats[2] = {&a.slse, &a.sdl};
    read_strides(strides, views, 5, stats, 2);
  }
  return dispatch<kDq>(a, BH, D, dtype, (cudaStream_t)stream);
}

// dk, dv like q.  strides: 22 int64, q's, k's, v's, dout's, dk's and dv's
// three, then lse's and delta's two.
extern "C" int mxt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* seed,
                                 const void* kvlen, void* dk, void* dv,
                                 int BH, int H, int L, int D, int dtype,
                                 float scale, int causal, int window,
                                 unsigned thr, float ks, void* stream,
                                 const long long* strides) {
  Args a = make_args(q, k, v, seed, kvlen, H, L, D, scale, causal, window,
                     thr, ks);
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  if (strides) {
    Strides* const views[6] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdk, &a.sdv};
    Strides* const stats[2] = {&a.slse, &a.sdl};
    read_strides(strides, views, 6, stats, 2);
  }
  return dispatch<kDkv>(a, BH, D, dtype, (cudaStream_t)stream);
}

// delta (B, H, L) float32, contiguous, from dout and out like q (dtype 0
// float32 or 1 bfloat16, D in {32, 64, 128}).  strides: 6 int64, dout's
// and out's B, H and L strides, or null for contiguous tensors.
extern "C" int mxt_flash_bwd_delta(const void* dout, const void* out,
                                   void* delta, int BH, int H, int L, int D,
                                   int dtype, void* stream,
                                   const long long* strides) {
  DeltaArgs p = {};
  p.dout = dout;
  p.out = out;
  p.delta = static_cast<float*>(delta);
  p.sdo = p.so = contiguous(L, D, H);
  if (strides) {
    Strides* const views[2] = {&p.sdo, &p.so};
    read_strides(strides, views, 2, nullptr, 0);
  }
  p.rows = (long long)BH * L;
  p.H = H;
  p.L = L;
  p.G = D * (dtype == 0 ? 4 : 2) / 16;
  if (D != 32 && D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  return run_delta(p, dtype, (cudaStream_t)stream);
}
