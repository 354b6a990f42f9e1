// Persistent LSTM time loop, forward and backward, and the backward's gate
// recompute.  Wrapped by mxnet_tpu_torch/ops/kernels/fused_cell.py:
// lstm_sequence.
//
// Replaces the TPU kernels _lstm_fwd_kernel and _lstm_bwd_kernel
// (mxnet_tpu/ops/pallas/fused_cell.py:142, 195, launched at :177, :251).
//
//   forward   g = gx[t] + h W + b;  i, f, u, o = sigmoid, sigmoid, tanh,
//             sigmoid of g's four blocks of H (MXNet order i, f, c, o);
//             c' = f c + i u;  h' = o tanh(c');  out[t] = h', cseq[t] = c'
//   backward  the same loop time-reversed: the gates recomputed from the
//             saved h_prev[t], c_prev[t]; dgx[t] = dg; the carries
//             dh = dg W^T and dc = dc f; dh0, dc0 after the last step
//
// gx (T, B, 4H), out (T, B, H), h_prev (T, B, H), dout (T, B, H), dgx
// (T, B, 4H), h0/c0/dh0/dc0 (B, H) are of the layer's type (float32 or
// bfloat16); cseq, c_prev and dcseq are float32; W (H, 4H) and b (4H,)
// are float32 or bfloat16, W with any strides.  Every product and both
// carries are float32 or as accurate, as the JAX kernel casts W and h to
// float32.
//
// The TPU runs each time loop as a sequential grid on one core, with W
// latched in VMEM and the carries in VMEM scratch.  Here a time loop is
// one persistent set of blocks, all resident at once (cooperative launch,
// sized from the occupancy calculator), the steps separated by flags that
// each block releases and the others poll (no atomics).  Each block owns U consecutive hidden units j and loads their
// four gate columns W[:, gH + j] into shared memory once: the SM's
// counterpart of the latched W.
//
// Forward (lstm_fwd_kernel, #10).  Each step a block
//   1. loads its gx of the step into registers, off the serial chain;
//   2. stages the previous h (float32, kept transposed as (H, Bp) so that
//      32 batch rows of one unit are one 128-byte run): each warp polls
//      the flags of the blocks that own its K slice of h, then copies
//      those rows from the L2 into shared memory;
//   3. computes its (32 x 4U) gate pre-activations in 3xTF32 on mma.sync
//      m16n8k8 (two m16 tiles of batch rows, ceil(4U / 8) n8 tiles of
//      gate columns; each warp over the K slice it staged, the partial
//      sums added in warp order: two runs agree bit for bit);
//   4. applies the nonlinearities and updates c, which never leaves the
//      block, writes out[t], cseq[t] and its slice of the next h, and
//      releases its flag (double-buffered h: one flag a step suffices).
// The design's measurements are at lstm_fwd_kernel.
//
// Backward (#11): two kernels, launched in turn on one stream.
//
// 1. lstm_bwd_gates_kernel recomputes the forward's activations off the
//    serial chain: act = sigmoid/tanh(gx + h_prev W + b) for all T B rows
//    and 4H columns at once, the (T B x H) by (H x 4H) product on the
//    tensor cores (wgmma, 128 x 128 tiles, two warpgroups of 64 rows; an
//    ordinary tiled grid, so h_prev is read 4H / 128 times).  Both
//    operands are K-major in the 128-byte swizzle: h_prev's rows as they
//    lie, W's columns from w_h2h's rows (W = w_h2h^T).  TMA cannot read
//    them (a row of H 650 is 2600 or 1300 bytes, not a multiple of 16),
//    so each thread copies 4 bytes at a time (an fp32 element or two
//    bf16) with cp.async into a ring of 3 (tf32) or 4 (bf16) stages of
//    128-byte K steps, zero-filling the ragged M, N and K edges.
//      bf16 h with bf16 W (the AMP layer): wgmma bf16, fp32 accumulator;
//        each bf16 x bf16 product is exact in fp32, as JAX's cast-then-dot.
//      otherwise 3xTF32 on wgmma tf32, both operands fp32 (a bf16 one cast
//        by the wrapper): the tensor core reads an fp32 word truncated to
//        tf32 (hi); each thread writes the residual x - hi (lo) of the
//        elements it copied into a tile of its own, and hi hi + hi lo + lo
//        hi are summed in fp32 (lo lo left out; ~2^-21 relative).  An
//        operand that holds bf16 values is exact in tf32, so its residual
//        product is skipped (a template flag): a bf16 layer with an fp32
//        W takes two products.
//    The epilogue adds gx and b, applies the nonlinearities and writes
//    each element into the record the time loop reads, rec (T, 8, nb U,
//    B) fp32: for step t the fields i, f, u, o, tanh(cseq), c_prev, dout,
//    dcseq, each by unit and batch row, so that a warp's stores fill whole
//    32-byte sectors and a block's inputs of a step are 8 runs of U B
//    floats.  Fields 4..7 are copied from (T, B, H) through shared memory
//    in tiles of 32 units, read and written in coalesced runs.
//
// 2. lstm_bwd_kernel, the time loop (one cooperative launch, one barrier a
//    step).  A block owns units j0..j0+U-1; dc stays in the block.  Each
//    step (t = T-1 .. 0) it
//    a. sums the partial dh of the last step: every block k wrote, for
//       each block r, the slice of k's partial product over r's units,
//       part[k][r] (B U floats, padded to BUP); block r reads its slice
//       from all nb writers with 16-byte __ldcg loads, up to 24 in flight
//       a thread, and sums them in a fixed order: NG groups of consecutive
//       writers, each summed in block order, then the groups in order;
//    b. runs the elementwise update on the record of step t, which was
//       prefetched by cp.async into shared memory during the step before
//       (double-buffered), writes dgx[t] and keeps dg in shared memory;
//    c. forms its partial product part[b][k] = sum over its 4U gate
//       columns g of dg[b][g] W[k][g], for all H units k: a (B x 4U) by
//       (4U x H) product, 416k FMAs a block at the word LM's shape, in
//       fp32 on the CUDA cores (each sum over g in order): lane = batch
//       row, its row of dg in registers; a warp takes one reader's U units
//       at a time, reads their W rows as one (broadcast) and writes the
//       reader's slice to part as 16-byte runs as soon as it is formed.
//       On an H100 80GB HBM3 at 700 W, (35, 32, 650), this time loop
//       took 0.432 ms in fp32 and 0.429 in bf16, where the same loop with
//       the product on wgmma m64n32k8 in 3xTF32 (W's tiles as A from
//       registers, dg's value and residual tiles as B) took 0.497 and
//       0.495 in the same chip_flash_ab.py --phases lstm run: so few
//       products a step leave the tensor cores' rounds a latency chain;
//    d. passes one grid barrier (part is double-buffered).  The barrier
//       is a flag per block (release store, 128 bytes apart) that every
//       block polls with acquire loads: no atomics anywhere, and every sum
//       has a fixed order, so two launches agree bit for bit.
//    After the last step it sums the partials once more for dh0.
//
// Bound on the card.  Per layer at the word LM's shape (T 35, B 32, H 650)
// the backward does 4 T B H 4H = 7.57 GFLOP of products: the recompute's
// half on the tensor cores (bf16 x bf16 at 989 TFLOP/s; fp32-accurate as
// three tf32 products at 495, two where one operand holds bf16 values,
// exact in tf32) is parallel; the other half, the dh products, sits on the
// serial chain of T steps, each a barrier and an exchange of the partial
// sums (B H floats per block, 10.8 MB a step over the grid, read and
// written through the L2) on top of its arithmetic.  That chain, not the
// card's rates, bounds the time loop.  The parent kernel's stamps at that
// shape: 20.7 us a step (stage 1.8, gate products 4.3, elementwise 2.2,
// barrier 1.7, the all-gather of dg and its products 10.6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int UMAX = 8;              // hidden units per block, at most
constexpr int FUMAX = 10;            // the same, forward

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

// per-step data: float32 goes through the L2 only (written by other blocks
// during the launch, so a stale L1 line must not be read)
__device__ __forceinline__ float ld_step(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_step(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// 16 bytes: 4 floats or 8 bfloat16, as float
__device__ __forceinline__ void ld16(const float* p, float* v) {
  const float4 x = __ldcg(reinterpret_cast<const float4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void ld16(const __nv_bfloat16* p, float* v) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

struct Weights {
  const void* w;          // W[k][g] at w + k * sk + g * sg
  long long sk, sg;
  int w_bf16;
  const void* b;          // (4H,)
  int b_bf16;
};

__device__ __forceinline__ float ldw(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// shared-memory layout, in floats; every piece starts 16-byte aligned
__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// W's gate columns of units j0..j0+U-1 as wc[k * ws + gate * U + u] (row
// stride ws, at least 4U; columns past 4U are not written), their bias as
// bias[gate * U + u] unless bias is null; units past H read 0
template <int U>
__device__ void load_columns(float* wc, float* bias, const Weights& wt,
                             int H, int j0, int ws = 4 * U) {
  constexpr int NG = 4 * U;
  for (int e = threadIdx.x; e < H * NG; e += blockDim.x) {
    const int k = e / NG, c = e - k * NG;
    const int gate = c / U, j = j0 + c - gate * U;
    wc[k * ws + c] =
        j < H ? ldw(wt.w, k * wt.sk + (long long)(gate * H + j) * wt.sg,
                    wt.w_bf16)
              : 0.f;
  }
  if (!bias) return;
  for (int c = threadIdx.x; c < NG; c += blockDim.x) {
    const int gate = c / U, j = j0 + c - gate * U;
    bias[c] = j < H ? ldw(wt.b, gate * H + j, wt.b_bf16) : 0.f;
  }
}

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// ---------------------------------------------------------------------------
// backward, kernel 1: the gate recompute, a tiled GEMM on the tensor cores
// ---------------------------------------------------------------------------
constexpr int NFIELD = 8;          // i, f, u, o, tanh(cseq), c_prev, dout, dcseq
constexpr int GB = 128;            // a tile's rows (M) and columns (N)
constexpr int GTILE = GB * 128;    // bytes of a tile of 128 rows of 128 bytes

struct GateArgs {
  const void* hp;      // (M, H) h_prev rows, M = T B: the tiles' type
  const void* w;       // W[k][n] at w + n ldw + k: the tiles' type
  const void* gx;      // (M, 4H), the layer's type
  const void* b;       // (4H,), float32 or (b_bf16) bfloat16
  const float* cseq;   // (M, H)
  const float* cp;     // (M, H) c_prev
  const void* dout;    // (M, H), the layer's type
  const float* dcseq;  // (M, H)
  float* rec;          // (T, NFIELD, nb U, B)
  long long* timing;   // NULL, or 5 stamps of block (0, 0) (see below)
  long long ldw;
  int M, H, B, U, nb, b_bf16;
};

// byte `byte` of row r of a tile of 128-byte rows in the 128-byte swizzle:
// 16-byte chunk c of row r lies at chunk c ^ (r % 8)
__device__ __forceinline__ int swz(int r, int byte) {
  return r * 128 + ((((byte >> 4) ^ r) & 7) << 4) + (byte & 15);
}

// 4 bytes from global `src` to shared `dst`, or 4 zero bytes when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// E, the tiles' element: __nv_bfloat16 (bf16 h and W: wgmma bf16) or
// float (3xTF32 on wgmma tf32; ALO / BLO: h / W not exact in tf32, so
// its residual product is taken).  LT: the layer's type (gx, dout).
// Block (n, m) computes rows m0..m0+127 and columns n0..n0+127 of
// h_prev W; warpgroup wg rows wg 64.. of them as two m64n64 accumulators.
// A stage holds the A and B tiles of one 128-byte K step (and, in tf32,
// their residual tiles); S stages form a ring that cp.async fills S - 1
// steps ahead, 4 bytes a copy (an element, or two bf16), each thread its
// own 16 rows of both tiles, zero past the edges.
template <class E, bool ALO, bool BLO, class LT>
__global__ void __launch_bounds__(NTHREADS, 1)
    lstm_bwd_gates_kernel(GateArgs a) {
  extern __shared__ __align__(16) uint8_t gsm[];
  constexpr bool TF = std::is_same<E, float>::value;
  constexpr int EPW = 4 / (int)sizeof(E);    // elements of one 4-byte copy
  constexpr int KT = 128 / (int)sizeof(E);   // K of one 128-byte row
  constexpr int NT = ALO || BLO ? 4 : 2;     // tiles a stage: A, B (, lo)
  constexpr int S = TF ? 3 : 4;              // stages
  uint8_t* sm = gsm + ((1024 - (smem_u32(gsm) & 1023)) & 1023);
  const int M = a.M, K = a.H, N = 4 * a.H;
  const int m0 = blockIdx.y * GB, n0 = blockIdx.x * GB;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int lane = tid & 31, r0 = tid >> 5;  // rows r0 + 8 i, i < 16
  const E* hp = static_cast<const E*>(a.hp);
  const E* w = static_cast<const E*>(a.w);
  // with a timing buffer, block (0, 0)'s thread 0 stamps the start and
  // the ends of the products, of the loads of gx and b, of the
  // activations' stores and of the copy of the step's other inputs
  const bool stamp = a.timing != nullptr && blockIdx.x + blockIdx.y == 0 &&
                     tid == 0;
  if (stamp) a.timing[0] = globaltimer();
  auto issue = [&](int kt, int st) {
    const uint32_t s = smem_u32(sm + st * NT * GTILE);
    const int k = kt * KT + lane * EPW;
    const bool kin = k < K;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = r0 + 8 * i, m = m0 + r, n = n0 + r;
      const int off = swz(r, lane * 4);
      cp_async4(s + off, m < M && kin ? hp + (size_t)m * K + k : hp,
                m < M && kin);
      cp_async4(s + GTILE + off, n < N && kin ? w + n * a.ldw + k : w,
                n < N && kin);
    }
  };
  // the residual tiles of the thread's own elements (they have landed)
  auto residuals = [&](int st) {
    uint8_t* s = sm + st * NT * GTILE;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int off = swz(r0 + 8 * i, lane * 4);
      if constexpr (ALO)
        *reinterpret_cast<float*>(s + 2 * GTILE + off) =
            tf32_residual(*reinterpret_cast<const float*>(s + off));
      if constexpr (BLO)
        *reinterpret_cast<float*>(s + 3 * GTILE + off) =
            tf32_residual(*reinterpret_cast<const float*>(s + GTILE + off));
    }
  };
  float acc[2][32];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  // stage st's products into acc: per 32-byte K step, per 64-column half,
  // the residual products first (tf32), then hi hi
  auto products = [&](int st) {
    const uint32_t s = smem_u32(sm + st * NT * GTILE);
    const uint32_t ta = s + wg * 64 * 128, tb = s + GTILE;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = gmma_desc(ta + kk * 32, 1, 1024);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t bh = tb + h * 64 * 128 + kk * 32;
        const uint64_t db = gmma_desc(bh, 1, 1024);
        if constexpr (TF) {
          if constexpr (BLO)
            wgmma_tf32_ss<64>(acc[h], da,
                              gmma_desc(bh + 2 * GTILE, 1, 1024), 1);
          if constexpr (ALO)
            wgmma_tf32_ss<64>(acc[h],
                              gmma_desc(ta + 2 * GTILE + kk * 32, 1, 1024),
                              db, 1);
          wgmma_tf32_ss<64>(acc[h], da, db, 1);
        } else {
          wgmma_ss_n64(acc[h], da, db, 1);
        }
      }
    }
  };
  const int nk = (K + KT - 1) / KT;
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < nk) issue(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % S;
    cp_async_wait<S - 2>();   // this thread's copies of step kt landed
    if constexpr (ALO || BLO) residuals(st);
    fence_async_shared();     // the tensor cores read the tiles (async proxy)
    __syncthreads();
    wgmma_fence();
    products(st);
    wgmma_commit();
    // refill the stage step kt - 1 read: every warpgroup waited for its
    // products before the barrier above
    if (kt + S - 1 < nk) issue(kt + S - 1, (kt + S - 1) % S);
    cp_async_commit();
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
  }
  if (stamp) a.timing[1] = globaltimer();
  // epilogue: g = gx + h W + b, the nonlinearity, into the record.  The
  // tile's gx (cp.async, 4 bytes a copy) and b's columns go through
  // shared memory first (the stages are free now)
  __syncthreads();
  constexpr int GXS = 128 * (int)sizeof(LT) + 16;  // a gx row's bytes
  const LT* gxg = static_cast<const LT*>(a.gx);
  float* bs = reinterpret_cast<float*>(sm + GB * GXS);
  {
    constexpr int EPL = 4 / (int)sizeof(LT), CPR = 128 / EPL;
    const uint32_t g = smem_u32(sm);
    for (int q = tid; q < GB * CPR; q += NTHREADS) {
      const int r = q / CPR, c = (q - r * CPR) * EPL;
      const bool ok = m0 + r < M && n0 + c < N;
      cp_async4(g + r * GXS + c * (int)sizeof(LT),
                ok ? gxg + (size_t)(m0 + r) * N + n0 + c : gxg, ok);
    }
    cp_async_commit();
    if (tid < GB)
      bs[tid] = n0 + tid >= N ? 0.f
                : a.b_bf16
                    ? __bfloat162float(
                          static_cast<const __nv_bfloat16*>(a.b)[n0 + tid])
                    : static_cast<const float*>(a.b)[n0 + tid];
    cp_async_wait<0>();
    __syncthreads();
  }
  if (stamp) a.timing[2] = globaltimer();
  // the record's offset of (row m, column n) is rowp(m) + colp(n); a
  // thread holds 2 rows and 32 columns of the tile
  const int H = a.H, B = a.B, Hp = a.nb * a.U;
  const int rl = wg * 64 + 16 * (t >> 5) + ((t & 31) >> 2);
  const int cl = 2 * (t & 3);
  size_t rowp[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int m = min(m0 + rl + 8 * hr, M - 1), tt = m / B;
    rowp[hr] = (size_t)tt * NFIELD * Hp * B + (m - tt * B);
  }
  // every activation first (in acc), then every store
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int nl = cl + h * 64 + 8 * j + (i & 1), ml = rl + 8 * (i >> 1);
        const float x =
            to_f32(*reinterpret_cast<const LT*>(sm + ml * GXS +
                                                nl * (int)sizeof(LT))) +
            acc[h][4 * j + i] + bs[nl];
        acc[h][4 * j + i] = (n0 + nl) / H == 2 ? tanhf(x) : sigmoid(x);
      }
  float* __restrict__ rec = a.rec;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + cl + h * 64 + 8 * j + e, gate = n / H;
        const size_t colp = ((size_t)gate * Hp + n - gate * H) * B;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          if (m0 + rl + 8 * hr < M && n < N)
            rec[rowp[hr] + colp] = acc[h][4 * j + 2 * hr + e];
      }
  if (stamp) a.timing[3] = globaltimer();
  // the step's other inputs, fields 4..7 (tanh(cseq), c_prev, dout,
  // dcseq) of every (t, unit), from (T, B, H) to the record's (unit, b)
  // order: tiles of 32 units by the B rows of one step, over the whole
  // grid, read and written in coalesced runs through shared memory (the
  // stages are free now)
  const float* __restrict__ cseq = a.cseq;
  const float* __restrict__ cp = a.cp;
  const LT* __restrict__ dout = static_cast<const LT*>(a.dout);
  const float* __restrict__ dcseq = a.dcseq;
  float* tr = reinterpret_cast<float*>(sm);        // [4][32][B + 1]
  const int nj = (H + 31) / 32, T = M / B, BS = B + 1;
  __syncthreads();                                 // gx's tile is read
  for (int tile = blockIdx.y * gridDim.x + blockIdx.x; tile < T * nj;
       tile += gridDim.x * gridDim.y) {
    const int tt = tile / nj, j0 = (tile - tt * nj) * 32;
#pragma unroll 4
    for (int x = tid; x < B * 32; x += NTHREADS) {
      const int b = x >> 5, jl = x & 31;
      const size_t e = ((size_t)tt * B + b) * H + min(j0 + jl, H - 1);
      tr[jl * BS + b] = tanhf(cseq[e]);
      tr[(32 + jl) * BS + b] = cp[e];
      tr[(64 + jl) * BS + b] = to_f32(dout[e]);
      tr[(96 + jl) * BS + b] = dcseq[e];
    }
    __syncthreads();
    for (int x = tid; x < 32 * B; x += NTHREADS) {
      const int jl = x / B, b = x - jl * B, j = j0 + jl;
      if (j < H)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          rec[((size_t)(tt * NFIELD + 4 + f) * Hp + j) * B + b] =
              tr[(32 * f + jl) * BS + b];
    }
    __syncthreads();
  }
  if (stamp) a.timing[4] = globaltimer();
}

// ---------------------------------------------------------------------------
// backward, kernel 2: the time loop
// ---------------------------------------------------------------------------
// shared-memory layout of the time loop, in floats; every piece starts
// 16-byte aligned
struct BwdLayout {
  int sd, bup, ng, dg, wc, rec, red, dc, stg, total;
  __host__ __device__ BwdLayout(int H, int B, int U) {
    sd = 4 * U + (U % 2 ? 0 : 4);  // row stride of dg (16-byte loads by
                                   // row, conflict-free)
    bup = round4(B * U);           // one reader's slice of a partial
    const int nb = (H + U - 1) / U, nq = bup / 4;
    ng = NTHREADS / nq < nb ? NTHREADS / nq : nb;   // writer groups
    if (ng < 1) ng = 1;
    int o = 0;
    dg = o;   o += ((B + 31) & ~31) * sd;   // dg[b][own gate column], 0 pad
    wc = o;   o += nb * U * 4 * U;          // W[k][own gate column], 0 pad
    rec = o;  o += 2 * NFIELD * B * U;      // two steps' records
    red = o;  o += ng * bup;                // the writer groups' sums
    dc = o;   o += bup;                     // the carry dc
    stg = o;  o += NWARPS * 2 * 32 * U;     // each warp's slices of readers
    total = o;
  }
};

struct BwdArgs {
  const float* rec;    // (T, NFIELD, nb U, B) from lstm_bwd_gates_kernel
  Weights wt;
  void* dgx;           // (T, B, 4H)
  void* dh0;           // (B, H)
  void* dc0;           // (B, H)
  float* part;         // (2, nb, nb, BUP) float32: the partial dh sums,
                       // part[s & 1][writer][reader][b U + u]
  int* flags;          // nb flags 128 bytes apart, 0 at the launch
  long long* timing;   // NULL, or 1 + 4 T stamps (see lstm_bwd_kernel)
  int T, B, H, nb;
};

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// A barrier of the whole resident grid without atomics: every block's
// writes before it are visible to every block after it.  Each block
// releases its own flag with the barrier's epoch (1, 2, ... within a
// launch; the flags start at 0), then polls every flag until each has
// reached it.
__device__ void grid_barrier(int* flags, int nb, int epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(flags + blockIdx.x * 32, epoch);
  }
  for (int i = threadIdx.x; i < nb; i += blockDim.x)
    while (ld_acquire(flags + i * 32) < epoch) {
    }
  __syncthreads();
}

// red[gi][e] = the sum over writers w of group gi of part[w][blk][e], in
// block order; group gi holds the writers gi nb / ng .. (gi + 1) nb / ng
// - 1.  Four elements a thread, up to 24 loads in flight.
__device__ void sum_partials(const float* part, float* red, int nb, int blk,
                             int bup, int ng) {
  const int nq = bup / 4, n = nq * ng;
  const size_t stride = (size_t)nb * nq;     // float4s between writers
  const float4* base = reinterpret_cast<const float4*>(part) +
                       (size_t)blk * nq;
  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    const int gi = x / nq;
    const int w0 = gi * nb / ng, w1 = (gi + 1) * nb / ng;
    const float4* p = base + (x - gi * nq);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = w0; w < w1; w += 24) {
      float4 v[24];
#pragma unroll
      for (int i = 0; i < 24; ++i)
        if (w + i < w1) v[i] = __ldcg(p + (size_t)(w + i) * stride);
#pragma unroll
      for (int i = 0; i < 24; ++i)
        if (w + i < w1) {
          s.x += v[i].x;
          s.y += v[i].y;
          s.z += v[i].z;
          s.w += v[i].w;
        }
    }
    reinterpret_cast<float4*>(red)[x] = s;
  }
}

// the summed partial dh of element e (group sums added in group order)
__device__ __forceinline__ float dh_sum(const float* red, int e, int ng,
                                        int bup) {
  float s = red[e];
  for (int gi = 1; gi < ng; ++gi) s += red[gi * bup + e];
  return s;
}

// The block's partial product over its 4U gate columns, out[r][b U + u] =
// sum_c dg[b][c] W[k][c] with k = r U + u, for all H units k and B rows
// (out: the block's writer slab, nb slices of bup floats), with fp32 FMAs
// on the CUDA cores, 32 batch rows a pass.  Warp w takes the readers r =
// w, w + NWARPS, ...; lane = batch row, which holds its row of dg in
// registers and reads W's rows (the same for the whole warp: broadcast) as
// 16-byte words; each sum runs over c in order, the U sums of a reader
// side by side.  The warp stages its reader's 32 U floats in stg (two
// slices, in turn) and writes them to out as 16-byte runs.
template <int U>
__device__ void partial_product(const float* dg, const float* wc, float* stg,
                                float* out, int B, int nb, int bup, int sd) {
  constexpr int NG = 4 * U;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* st = stg + warp * 2 * 32 * U;
  int half = 0;
  for (int b0 = 0; b0 < B; b0 += 32) {
    float d[NG];
    const float4* d4 = reinterpret_cast<const float4*>(dg + (b0 + lane) * sd);
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const float4 v = d4[q];
      d[4 * q] = v.x;
      d[4 * q + 1] = v.y;
      d[4 * q + 2] = v.z;
      d[4 * q + 3] = v.w;
    }
    const int lo = b0 * U, n4 = (min((b0 + 32) * U, bup) - lo) / 4;
    for (int r = warp; r < nb; r += NWARPS, half ^= 1) {
      const float4* w4 = reinterpret_cast<const float4*>(wc + r * U * NG);
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) s[u] = 0.f;
#pragma unroll
      for (int q = 0; q < U; ++q)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float4 w = w4[u * U + q];
          s[u] = fmaf(d[4 * q], w.x, s[u]);
          s[u] = fmaf(d[4 * q + 1], w.y, s[u]);
          s[u] = fmaf(d[4 * q + 2], w.z, s[u]);
          s[u] = fmaf(d[4 * q + 3], w.w, s[u]);
        }
      // the slice written two readers ago has been read: a __syncwarp lies
      // between
      float* sh = st + half * 32 * U;
#pragma unroll
      for (int u = 0; u < U; ++u) sh[lane * U + u] = s[u];
      __syncwarp();
      for (int q = lane; q < n4; q += 32)
        reinterpret_cast<float4*>(out + (size_t)r * bup + lo)[q] =
            reinterpret_cast<const float4*>(sh)[q];
    }
  }
}

template <class T, int U>
__global__ void __launch_bounds__(NTHREADS, 1) lstm_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, B = a.B, G = 4 * H, nb = a.nb, blk = blockIdx.x;
  const int j0 = blk * U, BU = B * U, nrec = NFIELD * BU;
  const BwdLayout L(H, B, U);
  float *wc = smem + L.wc, *recs = smem + L.rec;
  float *red = smem + L.red, *dc_own = smem + L.dc, *stg = smem + L.stg;
  float* dgs = smem + L.dg;
  for (int e = threadIdx.x; e < L.total; e += NTHREADS) smem[e] = 0.f;
  __syncthreads();
  load_columns<U>(wc, nullptr, a.wt, H, j0);
  T* dgx = static_cast<T*>(a.dgx);
  // the block's record of step t, 8 runs of U B floats ([u][b]), into
  // buffer buf as [field][b U + u], by cp.async (one group)
  auto prefetch = [&](int t, int buf) {
    const uint32_t dst = smem_u32(recs + buf * nrec);
    for (int q = threadIdx.x; q < nrec; q += NTHREADS) {
      const int f = q / BU, ub = q - f * BU, u = ub / B, b = ub - u * B;
      cp_async4(dst + 4 * (f * BU + b * U + u),
                a.rec + ((size_t)(t * NFIELD + f) * nb * U + j0) * B + ub,
                true);
    }
    cp_async_commit();
  };
  // with a timing buffer, block 0's thread 0 stamps the start, then the
  // end of each step's dh sum (with the wait for the step's record),
  // elementwise update, partial products (written to part), and barrier
  const bool stamp = a.timing != nullptr && blk == 0 && threadIdx.x == 0;
  long long* ts = a.timing;
  prefetch(a.T - 1, 0);
  __syncthreads();
  if (stamp) *ts++ = globaltimer();
  for (int s = 0; s < a.T; ++s) {
    const int t = a.T - 1 - s, cur = s & 1;
    if (s + 1 < a.T)
      prefetch(t - 1, cur ^ 1);
    else
      cp_async_commit();
    if (s)
      sum_partials(a.part + (size_t)(cur ^ 1) * nb * nb * L.bup, red, nb,
                   blk, L.bup, L.ng);
    cp_async_wait<1>();       // the record of step t has landed
    __syncthreads();
    if (stamp) ts[0] = globaltimer();
    // element e = b U + u (lanes run along the units, so that dgx's
    // stores are runs)
    const float* r = recs + cur * nrec;
    for (int e = threadIdx.x; e < BU; e += NTHREADS) {
      const int b = e / U, u = e - b * U, j = j0 + u;
      if (j >= H) continue;
      const float i = r[e], f = r[BU + e], uu = r[2 * BU + e];
      const float o = r[3 * BU + e], tc = r[4 * BU + e];
      const float dh = (s ? dh_sum(red, e, L.ng, L.bup) : 0.f) +
                       r[6 * BU + e];
      const float d_o = dh * tc;
      const float dc = dc_own[e] + r[7 * BU + e] + dh * o * (1.f - tc * tc);
      const float dgi = (dc * uu) * i * (1.f - i);
      const float dgf = (dc * r[5 * BU + e]) * f * (1.f - f);
      const float dgu = (dc * i) * (1.f - uu * uu);
      const float dgo = d_o * o * (1.f - o);
      T* dgr = dgx + ((size_t)t * B + b) * G + j;
      dgr[0] = from_f32<T>(dgi);
      dgr[H] = from_f32<T>(dgf);
      dgr[2 * H] = from_f32<T>(dgu);
      dgr[3 * H] = from_f32<T>(dgo);
      float* dgr_s = dgs + b * L.sd + u;
      dgr_s[0] = dgi;
      dgr_s[U] = dgf;
      dgr_s[2 * U] = dgu;
      dgr_s[3 * U] = dgo;
      dc_own[e] = dc * f;
    }
    __syncthreads();
    if (stamp) ts[1] = globaltimer();
    partial_product<U>(dgs, wc, stg,
                       a.part + ((size_t)cur * nb + blk) * nb * L.bup, B, nb,
                       L.bup, L.sd);
    if (a.timing) {           // the stamp waits for every warp's writes
      __syncthreads();
      if (stamp) ts[2] = globaltimer();
    }
    grid_barrier(a.flags, nb, s + 1);
    if (stamp) ts[3] = globaltimer();
    ts += 4;
  }
  // dh0: the last step's partials, summed
  sum_partials(a.part + (size_t)((a.T - 1) & 1) * nb * nb * L.bup, red, nb,
               blk, L.bup, L.ng);
  __syncthreads();
  T* dh0 = static_cast<T*>(a.dh0);
  T* dc0 = static_cast<T*>(a.dc0);
  for (int e = threadIdx.x; e < BU; e += NTHREADS) {
    const int b = e / U, j = j0 + e - b * U;
    if (j < H) {
      dh0[(size_t)b * H + j] = from_f32<T>(dh_sum(red, e, L.ng, L.bup));
      dc0[(size_t)b * H + j] = from_f32<T>(dc_own[e]);
    }
  }
}

// ---------------------------------------------------------------------------
// forward: the time loop (#10)
// ---------------------------------------------------------------------------
constexpr int FROWS = 16;      // batch rows a pass: one m16 tile
constexpr int RS = 20;         // row stride of the warps' partial sums
constexpr int FLOADS = 12;     // 16-byte loads in flight a lane, staging

// W's row stride in shared memory: 4U gate columns rounded up to the n8
// tiles, then to 8 or 24 mod 32 floats, so that the B fragments' 32 loads
// (rows t, t + 4 of column g) fall in 32 banks
__host__ __device__ inline int fwd_wstride(int U) {
  const int n = (4 * U + 7) & ~7;
  return n % 32 == 8 || n % 32 == 24 ? n : n + 8;
}

// shared-memory layout of the forward, in floats; every piece starts
// 16-byte aligned.  hs holds the staged h, [k][16] with element (k, r) at
// k 16 + (r ^ 8 ((k / 2) % 2)) (conflict-free A fragments); the warps'
// partial sums alias it once the products are done.
struct FwdLayout {
  int kp, ws, w, bias, hs, own, total;
  __host__ __device__ FwdLayout(int H, int B, int U) {
    kp = (H + 7) & ~7;                 // K in whole k8 steps
    ws = fwd_wstride(U);
    int o = 0;
    w = o;     o += kp * ws;           // W[k][gate U + u], 0 past H, 4U
    bias = o;  o += round4(4 * U);
    hs = o;
    const int red = NWARPS * ws * RS;
    o += kp * FROWS > red ? kp * FROWS : red;
    own = o;   o += round4(B * U);     // c of the block's units
    total = o;
  }
};

struct FwdArgs {
  const void* gx;   // (T, B, 4H)
  const void* c0;   // (B, H)
  Weights wt;
  void* out;        // (T, B, H)
  float* cseq;      // (T, B, H)
  float* hbuf;      // (2, H, Bp) float32: h of the last two steps,
                    // transposed, Bp = B rounded up to 16; the caller puts
                    // h0 in hbuf[1].  Columns past B are never written:
                    // they feed only product rows past B, which no store
                    // reads.
  int* flags;       // nb flags 128 bytes apart, 0 at the launch
  long long* timing;  // NULL, or 3 + 4 T stamps (see lstm_fwd_kernel)
  int T, B, H, wlo;  // wlo: W not exact in tf32 (its lo product taken)
  int lanes;        // batch lanes: block (ug, bl) takes the groups of 16
                    // batch rows g = bl, bl + lanes, ...
};

// what the tensor core drops of x's fp32 word, as the word of a tf32 lo
__device__ __forceinline__ uint32_t lo_word(float x) {
  return __float_as_uint(tf32_residual(x));
}

// Warp w's K slice: the k8 steps [w nk / 8, (w + 1) nk / 8) of K padded
// to whole k8 steps, nk = kp / 8.  The warp stages these rows of h and
// forms the products over them.
struct KSlice {
  int s0, s1;
  __device__ explicit KSlice(int kp) {
    const int nk = kp / 8, w = threadIdx.x >> 5;
    s0 = w * nk / NWARPS;
    s1 = (w + 1) * nk / NWARPS;
  }
};

// Wait until the blocks that own the warp's rows of h in batch lane bl
// (units k / U: block (k / U) lanes + bl) have released `epoch` (written
// that step's h): the warp's lanes poll their flags.
__device__ void fwd_poll(const KSlice& ks, const int* flags, int epoch,
                         int H, int U, int lanes, int bl) {
  const int k0 = 8 * ks.s0, k1 = min(H, 8 * ks.s1);
  if (epoch > 0 && k0 < k1) {
    const int p0 = k0 / U, np = (k1 - 1) / U - p0 + 1;
    for (int i = threadIdx.x & 31; i < np; i += 32)
      while (ld_acquire(flags + ((p0 + i) * lanes + bl) * 32) < epoch) {
      }
  }
  __syncwarp();
}

// Copy the warp's rows of h_prev[:, b0 .. b0 + 15] (its K slice) into
// hs, 16 bytes a load from the L2, up to FLOADS loads in flight a lane
// (one round for a slice of up to 96 rows), row k's two 32-byte halves
// swapped when (k / 2) is odd (rows past H: zero).  Only the warp reads
// them, so the warp's own sync suffices: no block-wide barrier stands
// between a warp's copy and its products.
__device__ void fwd_copy(const KSlice& ks, float* hs, const float* hp,
                         int H, int Bp, int b0) {
  const int lane = threadIdx.x & 31;
  const int k0 = 8 * ks.s0, k1 = min(H, 8 * ks.s1);
  const int items = k1 > k0 ? (k1 - k0) * 4 : 0;   // 4 float4 a row
  for (int q0 = lane; q0 < items; q0 += 32 * FLOADS) {
    float4 v[FLOADS];
#pragma unroll
    for (int l = 0; l < FLOADS; ++l) {
      const int q = q0 + 32 * l;
      if (q < items)
        v[l] = __ldcg(reinterpret_cast<const float4*>(
            hp + (size_t)(k0 + (q >> 2)) * Bp + b0 + 4 * (q & 3)));
    }
#pragma unroll
    for (int l = 0; l < FLOADS; ++l) {
      const int q = q0 + 32 * l;
      if (q < items) {
        const int k = k0 + (q >> 2);
        reinterpret_cast<float4*>(hs)[k * 4 + ((q & 3) ^ (k & 2))] = v[l];
      }
    }
  }
  // rows past H (the partial sums of the last pass may have written them)
  for (int e = max(k0, H) * FROWS + lane; e < 8 * ks.s1 * FROWS; e += 32)
    hs[e] = 0.f;
  __syncwarp();
}

// W's gate columns of units j0..j0+U-1 into w[k ws + gate U + u] and
// their bias into bias[gate U + u] (units past H: 0; smem starts zeroed),
// as load_columns lays them out.  Where W's rows are contiguous along k
// (the layer's transposed view, sk 1) a warp takes a column and its
// lanes run along k, so that a warp reads whole sectors with many loads
// in flight and no division: the launch's set-up, not the steps, is what
// this costs.
template <int U, class WT>
__device__ void fwd_load_columns(float* w, const WT* src, long long sk,
                                 long long sg, int H, int j0, int ws) {
  constexpr int NG = 4 * U, N = 24;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (sk == 1) {
    // a warp a column, its lanes along k: each column one run of H
    // elements, up to N loads in flight a lane
    for (int c = warp; c < NG; c += NWARPS) {
      const int gate = c / U, j = j0 + c - gate * U;
      if (j >= H) continue;               // stays 0
      const WT* col = src + (long long)(gate * H + j) * sg;
      for (int k0 = lane; k0 < H; k0 += 32 * N) {
        float v[N];
#pragma unroll
        for (int i = 0; i < N; ++i)
          if (k0 + 32 * i < H) v[i] = to_f32(col[k0 + 32 * i]);
#pragma unroll
        for (int i = 0; i < N; ++i)
          if (k0 + 32 * i < H) w[(k0 + 32 * i) * ws + c] = v[i];
      }
    }
    return;
  }
  for (int e = threadIdx.x; e < H * NG; e += NTHREADS) {
    const int k = e / NG, c = e - k * NG;
    const int gate = c / U, j = j0 + c - gate * U;
    if (j < H)
      w[k * ws + c] = to_f32(src[k * sk + (long long)(gate * H + j) * sg]);
  }
}

template <int U>
__device__ void fwd_load_columns(float* w, float* bias, const Weights& wt,
                                 int H, int j0, int ws) {
  if (wt.w_bf16)
    fwd_load_columns<U>(w, static_cast<const __nv_bfloat16*>(wt.w), wt.sk,
                        wt.sg, H, j0, ws);
  else
    fwd_load_columns<U>(w, static_cast<const float*>(wt.w), wt.sk, wt.sg, H,
                        j0, ws);
  for (int c = threadIdx.x; c < 4 * U; c += NTHREADS) {
    const int gate = c / U, j = j0 + c - gate * U;
    bias[c] = j < H ? ldw(wt.b, gate * H + j, wt.b_bf16) : 0.f;
  }
}

// The warp's partial (16 x 4U) gate pre-activations over its K slice,
// written to red[warp][c][r] (row stride RS) once every warp is done
// reading hs (red aliases it): mma.sync m16n8k8 tf32 in 3xTF32, h (A, one
// m16 tile) and W (B, ceil(4U / 8) n8 tiles) each read as their fp32
// words (the tensor core takes the top 19 bits: hi) and split on the fly
// into the residual (lo); lo hi (and hi lo unless W is exact in tf32)
// before hi hi.
template <int U>
__device__ void fwd_products(const KSlice& ks, const float* hs,
                             const float* w, float* red, int ws, int wlo) {
  constexpr int NT = (4 * U + 7) / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int sw = (t & 2) << 2;          // 8 ((k / 2) % 2) for k, k + 4
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
#pragma unroll 2
  for (int s = ks.s0; s < ks.s1; ++s) {
    const int k = 8 * s + t;
    const float a[4] = {hs[k * FROWS + (g ^ sw)],
                        hs[k * FROWS + ((g + 8) ^ sw)],
                        hs[(k + 4) * FROWS + (g ^ sw)],
                        hs[(k + 4) * FROWS + ((g + 8) ^ sw)]};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ah[i] = __float_as_uint(a[i]);
      al[i] = lo_word(a[i]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float b0 = w[k * ws + 8 * n + g], b1 = w[(k + 4) * ws + 8 * n + g];
      const uint32_t bh0 = __float_as_uint(b0), bh1 = __float_as_uint(b1);
      mma_tf32(acc[n], al, bh0, bh1);
      if (wlo) mma_tf32(acc[n], ah, lo_word(b0), lo_word(b1));
      mma_tf32(acc[n], ah, bh0, bh1);
    }
  }
  __syncthreads();              // every warp is done with hs
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = g + 8 * (i >> 1), c = 8 * n + 2 * t + (i & 1);
      red[(warp * ws + c) * RS + r] = acc[n][i];
    }
  __syncthreads();
}

// Forward (lstm_fwd_kernel, #10): ceil(H / U) unit groups times `lanes`
// batch lanes of blocks, all resident (a cooperative launch).  Block blk =
// ug lanes + bl owns units j0 = ug U .. j0 + U - 1, W's gate columns of
// them in shared memory for the whole launch, and the groups of 16 batch
// rows g = bl, bl + lanes, ...: the lanes are independent recurrences,
// and each block stages only its rows of h (16 of B columns), so that
// two lanes of twice the units halve the L2's bytes a step.  Each step,
// for each of its groups of 16 batch rows, a block
//   1. loads its gx of the step into registers (used in 4: the HBM
//      latency lies off the serial chain);
//   2. stages h_prev: each warp polls the flags of the blocks whose rows
//      of h it needs, its K slice (fwd_poll), and copies those rows from
//      the L2 (fwd_copy); then, with no block-wide barrier between, it
//   3. forms its partial (16 x 4U) pre-activations over that slice on
//      the tensor cores (fwd_products), the warps' sums added in warp
//      order;
//   4. applies the nonlinearities, updates c (in the block), writes its
//      slice of h_next, (last pass) releases its flag with the step's
//      epoch, the only grid-wide sync of the step, and then writes out
//      and cseq, which no block waits for.
// No atomics, every sum in a fixed order: two launches agree bit for bit.
//
// What the design answers (NVIDIA H100 80GB HBM3, 700 W; T 35, B 32,
// H 650, fp32; us a step by the stamps of lstm_fwd_phase_times, the
// parent design's first): a grid sync, 1.17, becomes flag polling, ~1.0;
// every block staging the whole h behind a block barrier, 1.73, becomes
// each warp copying its own K slice of its lane's 16 columns, ~1.0; fp32
// FMA products, 4.42, become 3xTF32 on mma.sync, 1.75-1.9; the update,
// 1.08, ~1.0 with h released before out and cseq are written; W's
// columns, read a warp a column, take 12 us of set-up.  Measured and
// dropped: h staged once a cluster of 2 or 4 blocks through distributed
// shared memory (a stage of 3.5-3.8 us against 3.0-3.3 for a block
// alone, before the warps' own slices), polling by block or with a
// backoff (no change), FMA products (4.4-4.5), and at B 32 one lane of
// 5 units (0.29 ms a launch against 0.19 for two lanes of 10).
template <class T, int U>
__global__ void __launch_bounds__(NTHREADS, 1) lstm_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, B = a.B, G = 4 * H, Bp = (B + FROWS - 1) & ~(FROWS - 1);
  const int blk = blockIdx.x, lanes = a.lanes, bl = blk % lanes;
  const int j0 = blk / lanes * U;
  const FwdLayout L(H, B, U);
  const KSlice ks(L.kp);
  // with a timing buffer, block 0's thread 0 stamps its entry, the end of
  // the set-up's W columns and of the whole set-up, then the end of each
  // step's wait (warp 0's poll of its producers' flags: the barrier),
  // warp 0's copy (the stage), the products and the elementwise update
  // (with more than one group, the last group's)
  const bool stamp = a.timing != nullptr && blk == 0 && threadIdx.x == 0;
  long long* ts = a.timing;
  if (stamp) *ts++ = globaltimer();
  float *w = smem + L.w, *bias = smem + L.bias, *hs = smem + L.hs;
  float* c_own = smem + L.own;
  for (int e = threadIdx.x; e < L.total / 4; e += NTHREADS)
    reinterpret_cast<float4*>(smem)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  fwd_load_columns<U>(w, bias, a.wt, H, j0, L.ws);
  if (stamp) *ts++ = globaltimer();
  const T* c0 = static_cast<const T*>(a.c0);
  for (int e = threadIdx.x; e < B * U; e += NTHREADS) {
    const int b = e / U, j = j0 + e - b * U;
    c_own[e] = j < H && b / FROWS % lanes == bl ? to_f32(c0[(size_t)b * H + j])
                                                : 0.f;
  }
  const T* gx = static_cast<const T*>(a.gx);
  T* out = static_cast<T*>(a.out);
  __syncthreads();
  if (stamp) *ts++ = globaltimer();
  // the elementwise update's elements: e = threadIdx.x + NTHREADS i, row
  // r = e / U, unit u = e % U
  constexpr int NE = (FROWS * U + NTHREADS - 1) / NTHREADS;
  for (int t = 0; t < a.T; ++t) {
    float* h_next = a.hbuf + (size_t)(t & 1) * H * Bp;
    const float* h_prev = a.hbuf + (size_t)((t + 1) & 1) * H * Bp;
    for (int b0 = bl * FROWS; b0 < B; b0 += lanes * FROWS) {
      float gxv[NE][4];
#pragma unroll
      for (int i = 0; i < NE; ++i) {
        const int e = threadIdx.x + NTHREADS * i, r = e / U, u = e - r * U;
        const int b = b0 + r;
        if (e < FROWS * U && j0 + u < H && b < B) {
          const T* g = gx + ((size_t)t * B + b) * G + j0 + u;
#pragma unroll
          for (int q = 0; q < 4; ++q) gxv[i][q] = to_f32(g[q * H]);
        }
      }
      fwd_poll(ks, a.flags, t, H, U, lanes, bl);
      if (stamp) ts[0] = globaltimer();
      fwd_copy(ks, hs, h_prev, H, Bp, b0);
      if (stamp) ts[1] = globaltimer();
      fwd_products<U>(ks, hs, w, hs, L.ws, a.wlo);
      if (stamp) ts[2] = globaltimer();
      const float* red = hs;
      float hv[NE], cv[NE];
#pragma unroll
      for (int i = 0; i < NE; ++i) {
        const int e = threadIdx.x + NTHREADS * i, r = e / U, u = e - r * U;
        const int j = j0 + u, b = b0 + r;
        if (e >= FROWS * U || j >= H || b >= B) continue;
        float gs[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float s = 0.f;
          for (int wp = 0; wp < NWARPS; ++wp)
            s += red[(wp * L.ws + q * U + u) * RS + r];
          gs[q] = gxv[i][q] + s + bias[q * U + u];
        }
        const float ig = sigmoid(gs[0]), f = sigmoid(gs[1]),
                    uu = tanhf(gs[2]), o = sigmoid(gs[3]);
        cv[i] = f * c_own[b * U + u] + ig * uu;
        hv[i] = o * tanhf(cv[i]);
        c_own[b * U + u] = cv[i];
        h_next[(size_t)j * Bp + b] = hv[i];
      }
      __syncthreads();          // the release covers every thread's h
      if (b0 + lanes * FROWS >= B && threadIdx.x == 0)
        st_release(a.flags + blk * 32, t + 1);
      // out and cseq after the release: no other block waits for them
#pragma unroll
      for (int i = 0; i < NE; ++i) {
        const int e = threadIdx.x + NTHREADS * i, r = e / U, u = e - r * U;
        const int j = j0 + u, b = b0 + r;
        if (e >= FROWS * U || j >= H || b >= B) continue;
        const size_t row = (size_t)t * B + b;
        out[row * H + j] = from_f32<T>(hv[i]);
        a.cseq[row * H + j] = cv[i];
      }
      if (stamp) ts[3] = globaltimer();
    }
    ts += 4;
  }
}

#define MXT_LSTM_UNITS(CASE) \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)

template <class T>
const void* bwd_kernel_for(int U) {
#define MXT_LSTM_CASE(N) \
  case N:                \
    return (const void*)lstm_bwd_kernel<T, N>;
  switch (U) { MXT_LSTM_UNITS(MXT_LSTM_CASE) }
#undef MXT_LSTM_CASE
  return nullptr;
}

template <class T>
const void* fwd_kernel_for(int U) {
#define MXT_LSTM_CASE(N) \
  case N:                \
    return (const void*)lstm_fwd_kernel<T, N>;
  switch (U) { MXT_LSTM_UNITS(MXT_LSTM_CASE) MXT_LSTM_CASE(9) MXT_LSTM_CASE(10) }
#undef MXT_LSTM_CASE
  return nullptr;
}

const void* kernel_for(bool backward, int bf16, int U) {
  typedef __nv_bfloat16 bf;
  if (backward)
    return bf16 ? bwd_kernel_for<bf>(U) : bwd_kernel_for<float>(U);
  return bf16 ? fwd_kernel_for<bf>(U) : fwd_kernel_for<float>(U);
}

cudaError_t device_limits(int* sms, int* smem_max) {
  int dev = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  return cudaDeviceGetAttribute(smem_max,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// The backward's plan: the fewest units per block whose grid, ceil(H /
// U) blocks, is all resident at once.  units = 0 when none up to UMAX
// fits.
cudaError_t bwd_plan(int bf16, int H, int B, int* units, int* grid,
                     size_t* smem) {
  *units = *grid = 0;
  *smem = 0;
  int sms = 0, smem_max = 0;
  cudaError_t e;
  if ((e = device_limits(&sms, &smem_max)) != cudaSuccess) return e;
  for (int U = std::max(1, (H + sms - 1) / sms); U <= UMAX; ++U) {
    const size_t bytes = (size_t)BwdLayout(H, B, U).total * 4;
    if (bytes > (size_t)smem_max) break;     // grows with U
    const void* fn = kernel_for(true, bf16, U);
    if ((e = cudaFuncSetAttribute(fn,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bytes)) != cudaSuccess)
      return e;
    int per_sm = 0;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, fn, NTHREADS, bytes)) != cudaSuccess)
      return e;
    const int blocks = (H + U - 1) / U;
    if (blocks <= per_sm * sms) {
      *units = U;
      *grid = blocks;
      *smem = bytes;
      return cudaSuccess;
    }
  }
  return cudaSuccess;
}

// Let the forward's kernel for the type and U take all the dynamic shared
// memory a block may have (once a kernel; a launch takes what it needs)
cudaError_t fwd_allow_smem(int bf16, int U) {
  static bool allowed[2][FUMAX + 1] = {};
  bool& done = allowed[bf16 != 0][U];
  if (done) return cudaSuccess;
  int sms = 0, smem_max = 0;
  cudaError_t e;
  if ((e = device_limits(&sms, &smem_max)) != cudaSuccess) return e;
  if ((e = cudaFuncSetAttribute(kernel_for(false, bf16, U),
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_max)) != cudaSuccess)
    return e;
  done = true;
  return cudaSuccess;
}

// The forward's plan: U units a block (1..FUMAX), ceil(H / U) unit
// groups times `lanes` batch lanes of blocks, one cooperative launch.
// grid = its blocks when its shared memory fits a block's and every block
// is resident at once, else 0.
cudaError_t fwd_fits(int bf16, int H, int B, int U, int lanes, int* grid,
                     size_t* smem) {
  *grid = 0;
  *smem = 0;
  if (U < 1 || U > FUMAX || lanes < 1) return cudaSuccess;
  int sms = 0, smem_max = 0;
  cudaError_t e;
  if ((e = device_limits(&sms, &smem_max)) != cudaSuccess) return e;
  const size_t bytes = (size_t)FwdLayout(H, B, U).total * 4;
  if (bytes > (size_t)smem_max) return cudaSuccess;
  const void* fn = kernel_for(false, bf16, U);
  if ((e = fwd_allow_smem(bf16, U)) != cudaSuccess) return e;
  int per_sm = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, NTHREADS, bytes)) != cudaSuccess)
    return e;
  const int nb = (H + U - 1) / U * lanes;
  if (nb <= per_sm * sms) {
    *grid = nb;
    *smem = bytes;
  }
  return cudaSuccess;
}

Weights weights(const void* w, long long sk, long long sg, int w_bf16,
                const void* b, int b_bf16) {
  Weights wt;
  wt.w = w;
  wt.sk = sk;
  wt.sg = sg;
  wt.w_bf16 = w_bf16;
  wt.b = b;
  wt.b_bf16 = b_bf16;
  return wt;
}

template <class E, bool ALO, bool BLO, class LT>
cudaError_t launch_gates(const GateArgs& a, cudaStream_t stream) {
  constexpr int NT = ALO || BLO ? 4 : 2;
  constexpr int S = std::is_same<E, float>::value ? 3 : 4;
  const size_t smem = S * NT * GTILE + 1024;    // + the 1024-byte alignment
  auto fn = lstm_bwd_gates_kernel<E, ALO, BLO, LT>;
  static bool sized = false;     // the attribute, once per instantiation
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const dim3 grid((4 * a.H + GB - 1) / GB, (a.M + GB - 1) / GB);
  fn<<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* mxt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// The launch geometry of the backward time loop for the layer's type
// (bf16 = 1 for bfloat16), H and B: units per block, blocks and dynamic
// shared memory in bytes; units = 0 when the grid cannot be resident at
// once.
extern "C" int mxt_lstm_plan(int bf16, int H, int B, int* units, int* grid,
                             long long* smem) {
  size_t bytes = 0;
  const cudaError_t e = bwd_plan(bf16, H, B, units, grid, &bytes);
  *smem = (long long)bytes;
  return (int)e;
}

// Whether the forward with U units a block and `lanes` batch lanes fits
// the card for the layer's type (bf16 = 1 for bfloat16), H and B: grid =
// its blocks and smem its dynamic shared memory in bytes when it does,
// grid = 0 when it does not.
extern "C" int mxt_lstm_fwd_fits(int bf16, int H, int B, int U, int lanes,
                                 int* grid, long long* smem) {
  size_t bytes = 0;
  const cudaError_t e = fwd_fits(bf16, H, B, U, lanes, grid, &bytes);
  *smem = (long long)bytes;
  return (int)e;
}

// One launch of the forward time loop with U units a block and `lanes`
// batch lanes, a plan that mxt_lstm_fwd_fits accepted; hbuf holds 2 H Bp
// floats (Bp = B rounded up to 16), h0 transposed to (H, Bp) in float32
// in its second half (columns past B: anything); flags ceil(H / U) lanes
// * 32 int32 (zeroed here, on the stream); timing is NULL or 1 + 4 T
// int64.
extern "C" int mxt_lstm_fwd(const void* gx, const void* c0,
                            const void* w, long long sk, long long sg,
                            int w_bf16, const void* b, int b_bf16, void* out,
                            void* cseq, void* hbuf, void* flags,
                            long long* timing, int T, int B, int H, int bf16,
                            int U, int lanes, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const void* fn = kernel_for(false, bf16, U);
  if (!fn || lanes < 1) return (int)cudaErrorInvalidValue;
  const int grid = (H + U - 1) / U * lanes;
  const size_t smem = (size_t)FwdLayout(H, B, U).total * 4;
  cudaError_t e;
  if ((e = fwd_allow_smem(bf16, U)) != cudaSuccess) return (int)e;
  if ((e = cudaMemsetAsync(flags, 0, (size_t)grid * 32 * sizeof(int), st)) !=
      cudaSuccess)
    return (int)e;
  FwdArgs a;
  a.gx = gx;
  a.c0 = c0;
  a.wt = weights(w, sk, sg, w_bf16, b, b_bf16);
  a.out = out;
  a.cseq = (float*)cseq;
  a.hbuf = (float*)hbuf;
  a.flags = (int*)flags;
  a.timing = timing;
  a.T = T;
  a.B = B;
  a.H = H;
  a.wlo = !w_bf16;
  a.lanes = lanes;
  void* params[] = {&a};
  if ((e = cudaLaunchCooperativeKernel(fn, grid, NTHREADS, params, smem,
                                       st)) != cudaSuccess)
    return (int)e;
  return (int)cudaGetLastError();
}

// One launch of the backward's gate recompute into rec, (T, 8, nb U, B)
// floats for U units per block (the time loop's plan) and nb = ceil(H /
// U) blocks.  h_prev (T B rows of H, contiguous) and W (W[k][n] at w + n
// ldw + k) are both bf16 (tiles = 1; H and ldw even) or both float32
// (tiles = 0), a_exact / w_exact when they hold bf16 values; gx and dout
// are of the layer's type (bf16 = 1 for bfloat16), b float32 or bfloat16
// (b_bf16), cseq, c_prev and dcseq float32, all contiguous; timing is NULL
// or 5 int64.
extern "C" int mxt_lstm_bwd_gates(const void* hp, const void* w,
                                  long long ldw, int tiles, int a_exact,
                                  int w_exact, const void* gx,
                                  const void* b, int b_bf16, const void* cseq,
                                  const void* cp, const void* dout,
                                  const void* dcseq, void* rec,
                                  long long* timing, int T, int B, int H,
                                  int U, int bf16, void* stream) {
  GateArgs a;
  a.hp = hp;
  a.w = w;
  a.gx = gx;
  a.b = b;
  a.b_bf16 = b_bf16;
  a.cseq = (const float*)cseq;
  a.cp = (const float*)cp;
  a.dout = dout;
  a.dcseq = (const float*)dcseq;
  a.rec = (float*)rec;
  a.timing = timing;
  a.ldw = ldw;
  a.M = T * B;
  a.H = H;
  a.B = B;
  a.U = U;
  a.nb = (H + U - 1) / U;
  const cudaStream_t st = (cudaStream_t)stream;
  typedef __nv_bfloat16 bf;
  cudaError_t e;
  if (tiles)
    e = bf16 && a_exact && w_exact
            ? launch_gates<bf, false, false, bf>(a, st)
            : cudaErrorInvalidValue;
  else if (!bf16)
    e = a_exact ? cudaErrorInvalidValue
        : w_exact ? launch_gates<float, true, false, float>(a, st)
                  : launch_gates<float, true, true, float>(a, st);
  else
    e = !a_exact ? cudaErrorInvalidValue
        : w_exact ? launch_gates<float, false, false, bf>(a, st)
                  : launch_gates<float, false, true, bf>(a, st);
  return (int)e;
}

// One launch of the backward time loop over rec; part holds 2 nb nb BUP
// floats (BUP = B U rounded up to a multiple of 4), flags nb * 32 int32
// (zeroed here, on the stream); timing is NULL or 1 + 4 T int64.
extern "C" int mxt_lstm_bwd(const void* rec, const void* w, long long sk,
                            long long sg, int w_bf16, void* dgx, void* dh0,
                            void* dc0, void* part, void* flags,
                            long long* timing, int T, int B, int H, int bf16,
                            void* stream) {
  int U = 0, grid = 0;
  size_t smem = 0;
  cudaError_t e = bwd_plan(bf16, H, B, &U, &grid, &smem);
  if (e != cudaSuccess) return (int)e;
  if (U == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  if ((e = cudaMemsetAsync(flags, 0, (size_t)grid * 32 * sizeof(int),
                           (cudaStream_t)stream)) != cudaSuccess)
    return (int)e;
  BwdArgs a;
  a.rec = (const float*)rec;
  a.wt = weights(w, sk, sg, w_bf16, nullptr, 0);
  a.dgx = dgx;
  a.dh0 = dh0;
  a.dc0 = dc0;
  a.part = (float*)part;
  a.flags = (int*)flags;
  a.timing = timing;
  a.T = T;
  a.B = B;
  a.H = H;
  a.nb = grid;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel_for(true, bf16, U), grid, NTHREADS,
                                  params, smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
