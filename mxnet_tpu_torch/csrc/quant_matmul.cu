// Weight-only quantized matmul: y = x @ dequant(W).T in fp32, with the
// integer weight dequantized inside the kernel, never written out at full
// width.  Wrapped by mxnet_tpu_torch/ops/kernels/quant_matmul.py.
//
// Replaces the TPU kernels _qmm8_kernel (int8 codes, one scale per output
// channel; mxnet_tpu/ops/pallas/quant_matmul.py:179) and _qmm4_kernel (int4
// codes packed two per byte, low nibble = even input index, one scale per
// group of `group` inputs; :185).
//
// x (M, I) fp32, q (O, I) int8 or (O, I/2) uint8, s (O,) or (O, I/group)
// fp32 -> y (M, O) fp32.  On the serving path M is the decode batch (16)
// or a prefill chunk (64), and (O, I) is (768, 768), (3072, 768) or
// (768, 3072).
//
// Bound on the card: at decode sizes, the weight bytes (int8: O*I bytes,
// a quarter of the fp32 weight; int4: an eighth), since every weight is
// used by only M <= 16 rows; at a 64-row prefill chunk the fp32 FMAs.
// The design:
// - A block owns 32 output channels (one per lane) and a tile of up to 64
//   rows of x (more rows take more blocks along grid.y, and read the
//   weights again).  Each weight byte is read from device memory once per
//   row tile, as 16-byte cp.async copies, 128 bytes per channel per K tile.
// - The K loop is a cp.async pipeline as deep as shared memory allows
//   (3 to 8 stages): weights and the matching K tile of x (all rows of the
//   tile) land in shared memory up to 7 tiles ahead of the FMAs.
// - The 8 warps split each K tile: warp w takes the tile's w-th 16-byte
//   chunk of every channel (16 int8 or 32 int4 codes) for all rows, so
//   each code is decoded once per block.  The warps' partial sums are
//   added in a fixed order at the end, through shared memory.
// - In shared memory each channel's 128-byte weight row has its 16-byte
//   chunks XOR-swizzled by the channel, so the lanes' 16-byte reads of 32
//   channels are free of bank conflicts; x reads are broadcasts (every
//   lane of a warp reads the same address).
// - int8 sums code * x per channel and applies s[o] once, after the sum.
//   int4 multiplies each code by its group's scale as it decodes it (a
//   warp's chunks of one channel lie in different groups), which gives the
//   plain version's dequantized weight exactly; the scale is loaded a K
//   tile ahead.  So int8 differs from the plain version's x @ (q * s).T
//   in where the scale is rounded in, and both differ in the order of the
//   fp32 sums: they agree to fp32 rounding, not bit for bit.
// - No atomics: the result does not depend on timing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int BN = 32;         // output channels per block, one per lane
constexpr int ROW_BYTES = 128; // weight bytes per channel per K tile
constexpr int SMEM_BUDGET = 200 * 1024;  // shared memory per block

// inputs per K tile: int8 has one code per byte, int4 two
template <int FMT>
__host__ __device__ constexpr int k_per_tile() {
  return FMT == 8 ? ROW_BYTES : 2 * ROW_BYTES;
}

template <int FMT, int MT>
__host__ __device__ constexpr int stage_bytes() {
  return BN * ROW_BYTES + MT * k_per_tile<FMT>() * 4;
}

// pipeline depth: as many K tiles as fit the budget, 3 to 8
template <int FMT, int MT>
__host__ __device__ constexpr int stages() {
  return SMEM_BUDGET / stage_bytes<FMT, MT>() > 8
             ? 8
             : (SMEM_BUDGET / stage_bytes<FMT, MT>() < 3
                    ? 3
                    : SMEM_BUDGET / stage_bytes<FMT, MT>());
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
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

// sign-extended int4 nibble
__device__ __forceinline__ float nib(unsigned v) {
  return (float)((int)(v ^ 8u) - 8);
}

template <int FMT, int MT, int STAGES>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const float* __restrict__ x, const uint8_t* __restrict__ q,
           const float* __restrict__ s, float* __restrict__ y, int M, int O,
           int I, int G, int group) {
  constexpr int KT = k_per_tile<FMT>();  // inputs per K tile
  constexpr int CK = KT / WARPS;         // inputs per warp per K tile
  constexpr int W_BYTES = BN * ROW_BYTES;
  constexpr int STAGE_BYTES = stage_bytes<FMT, MT>();
  static_assert(STAGES * STAGE_BYTES >= WARPS * MT * BN * 4,
                "the pipeline's shared memory holds the warps' sums");
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int o0 = blockIdx.x * BN, m0 = blockIdx.y * MT;
  const int row_bytes = FMT == 8 ? I : I / 2;
  const int ntiles = I / KT;

  auto load_tile = [&](int t, int st) {
    unsigned char* ws = smem + st * STAGE_BYTES;
    float* xs = reinterpret_cast<float*>(ws + W_BYTES);
    {  // 32 channels x 8 chunks of 16 bytes: one chunk per thread
      const int ch = tid >> 3, j = tid & 7, o = o0 + ch;
      const uint8_t* src = q + (size_t)min(o, O - 1) * row_bytes +
                           (size_t)t * ROW_BYTES + j * 16;
      cp_async16(ws + ch * ROW_BYTES + ((j ^ (ch & 7)) << 4), src,
                 o < O ? 16 : 0);
    }
    constexpr int CPR = KT / 4;          // 16-byte chunks per row of x
    for (int e = tid; e < MT * CPR; e += THREADS) {
      const int r = e / CPR, c = e - r * CPR, m = m0 + r;
      const float* src =
          x + (size_t)min(m, M - 1) * I + (size_t)t * KT + c * 4;
      cp_async16(xs + r * KT + c * 4, src, m < M ? 16 : 0);  // past M: 0
    }
  };

  float acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0.f;
  const int o = o0 + lane;
  const float* srow = s + (size_t)min(o, O - 1) * G;  // int4 group scales
  float snext = FMT == 4 ? __ldg(srow + warp * CK / group) : 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ntiles) load_tile(st, st);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();   // tile t has landed
    __syncthreads();               // ... for every thread; tile t-1 is done
    if (t + STAGES - 1 < ntiles)
      load_tile(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();
    const unsigned char* ws = smem + (t % STAGES) * STAGE_BYTES;
    const float* xs = reinterpret_cast<const float*>(ws + W_BYTES) +
                      warp * CK;     // this warp's inputs, row 0
    const uint4 raw = *reinterpret_cast<const uint4*>(
        ws + lane * ROW_BYTES + ((warp ^ (lane & 7)) << 4));
    const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};
    float w[CK];                     // this chunk's weights, decoded
    if constexpr (FMT == 8) {
#pragma unroll
      for (int i = 0; i < 16; ++i)   // byte i = input i
        w[i] = (float)((int)(words[i >> 2] << (24 - 8 * (i & 3))) >> 24);
    } else {
      // byte i holds inputs 2i (low nibble) and 2i+1 (high); each code
      // takes the scale of its group (groups are even: pairs never split)
      const int kc = t * KT + warp * CK;   // the chunk's first input
      float sc = snext;
      if (t + 1 < ntiles) snext = __ldg(srow + (kc + KT) / group);
      int gpos = kc % group;               // position in the current group
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (gpos == group) {               // a group starts at input 2i
          sc = __ldg(srow + (kc + 2 * i) / group);
          gpos = 0;
        }
        const unsigned b = (words[i >> 2] >> (8 * (i & 3))) & 0xFFu;
        w[2 * i] = nib(b & 0xFu) * sc;
        w[2 * i + 1] = nib(b >> 4) * sc;
        gpos += 2;
      }
    }
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      const float4* xr = reinterpret_cast<const float4*>(xs + r * KT);
      float a = acc[r];
#pragma unroll
      for (int i4 = 0; i4 < CK / 4; ++i4) {
        const float4 xv = xr[i4];
        a = fmaf(w[4 * i4 + 3], xv.w,
                 fmaf(w[4 * i4 + 2], xv.z,
                      fmaf(w[4 * i4 + 1], xv.y, fmaf(w[4 * i4], xv.x, a))));
      }
      acc[r] = a;
    }
  }
  // the warps' partial sums, added in warp order
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // (WARPS, MT, BN)
#pragma unroll
  for (int r = 0; r < MT; ++r) red[(warp * MT + r) * BN + lane] = acc[r];
  __syncthreads();
  for (int e = tid; e < MT * BN; e += THREADS) {
    const int r = e / BN, c = e - r * BN, m = m0 + r, oc = o0 + c;
    float v = 0.f;
#pragma unroll
    for (int wp = 0; wp < WARPS; ++wp) v += red[(wp * MT + r) * BN + c];
    if (m < M && oc < O)
      y[(size_t)m * O + oc] = FMT == 8 ? v * __ldg(s + oc) : v;
  }
}

template <int FMT, int MT>
int launch(const float* x, const uint8_t* q, const float* s, float* y, int M,
           int O, int I, int G, int group, cudaStream_t stream) {
  constexpr int ST = stages<FMT, MT>();
  const size_t smem = (size_t)ST * stage_bytes<FMT, MT>();
  cudaError_t e = cudaFuncSetAttribute(
      qmm_kernel<FMT, MT, ST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((O + BN - 1) / BN, (M + MT - 1) / MT);
  qmm_kernel<FMT, MT, ST><<<grid, THREADS, smem, stream>>>(x, q, s, y, M, O,
                                                           I, G, group);
  return (int)cudaGetLastError();
}

template <int FMT>
int dispatch(const float* x, const uint8_t* q, const float* s, float* y,
             int M, int O, int I, int G, int group, cudaStream_t stream) {
  // the smallest row tile that covers M (up to 64 rows)
  if (M <= 8) return launch<FMT, 8>(x, q, s, y, M, O, I, G, group, stream);
  if (M <= 16) return launch<FMT, 16>(x, q, s, y, M, O, I, G, group, stream);
  if (M <= 32) return launch<FMT, 32>(x, q, s, y, M, O, I, G, group, stream);
  return launch<FMT, 64>(x, q, s, y, M, O, I, G, group, stream);
}

}  // namespace

extern "C" const char* mxt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Inputs per K tile for the format (I must be a multiple of it).
extern "C" int mxt_quant_matmul_k_tile(int fmt) {
  return fmt == 8 ? k_per_tile<8>() : k_per_tile<4>();
}

// fmt 8: q (O, I) int8, s (O,); fmt 4: q (O, I/2) uint8, s (O, I/group).
// x (M, I) and y (M, O) fp32, all contiguous and 16-byte aligned.
extern "C" int mxt_quant_matmul(const void* x, const void* q, const void* s,
                                void* y, int M, int O, int I, int fmt,
                                int group, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (fmt == 8)
    return dispatch<8>((const float*)x, (const uint8_t*)q, (const float*)s,
                       (float*)y, M, O, I, 1, I, st);
  return dispatch<4>((const float*)x, (const uint8_t*)q, (const float*)s,
                     (float*)y, M, O, I, I / group, group, st);
}
