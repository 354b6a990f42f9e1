// Hopper (sm_90a) building blocks for the port's kernels: TMA tensor maps,
// loads and stores, mbarrier rings, register hand-over between
// warpgroups, warpgroup matrix multiplies (wgmma) on bf16 and tf32 tiles
// in shared memory, and warp-level tf32 products (mma.sync).
//
// Tensor maps are encoded on the host through the driver's
// cuTensorMapEncodeTiled, fetched from the runtime with
// cudaGetDriverEntryPoint, so no library links against libcuda; a kernel
// takes them by value as __grid_constant__ parameters.
//
// Shared-memory tiles are what TMA writes with a 128- or 64-byte swizzle:
// rows of 128 (or 64) bytes, 8-row groups of 1024 (512) bytes, each
// 16-byte chunk of row r at chunk index c ^ (r % 8) (c ^ (r % 8) / 2 at
// 64 bytes).  A tile must start on a 1024-byte boundary.  A wgmma
// descriptor reads such a tile either K-major (the product's K dimension
// runs along the row: advance the start by 32 bytes per k16 step) or
// MN-major (K runs down the rows: advance by 16 rows per k16 step, with
// the transpose bit set); its stride byte offset is the 8-row group's
// bytes, and its layout type the swizzle (1: 128 B, 2: 64 B).  Nothing
// here faults on a wrong descriptor: it gives wrong numbers, so each
// kernel that uses them is held against its plain version on the card.
//
// Fragments: a warpgroup's m64nN fp32 accumulator gives thread t (0..127)
// rows 16 (t / 32) + (t % 32) / 4 + {0, 8} and columns 8 j + 2 (t % 4) +
// {0, 1}, j < N / 8, at d[4 j + 2 h + e] for row half h and column e.
// Its k16 slice kk, rounded to bf16 and packed in pairs (d[8 kk + 2 i],
// d[8 kk + 2 i + 1]), i < 4, is exactly wgmma's A fragment from registers.
//
// tf32: wgmma reads both shared-memory operands K-major only (the
// transpose bit exists for 16-bit types alone), a k8 step is 32 bytes of
// a row, and the tensor core reads an fp32 word's top 19 bits (the low 13
// are dropped).  A tf32 A fragment (k8; the same in mma.sync's m16n8k8)
// gives thread t rows 16 (t / 32) + (t % 32) / 4 + {0, 8} and columns
// t % 4 + {0, 4}: not the accumulator's 2 (t % 4) + {0, 1}, so an
// accumulator reused as A takes its K permuted within each 8-group.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------
typedef CUresult (*mxt_encode_tiled_fn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, or null
static inline mxt_encode_tiled_fn mxt_encode_tiled() {
  static mxt_encode_tiled_fn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<mxt_encode_tiled_fn>(p);
  }
  return fn;
}

// A tiled map over a tensor of `rank` dims (innermost first), strides in
// bytes of dims 1.., a box of `box` elements, rows past the end read as 0.
// Returns 0, or a CUDA error code when the encode is refused.
static inline int mxt_tensor_map(CUtensorMap* map, CUtensorMapDataType dt,
                                 int rank, const void* ptr,
                                 const cuuint64_t* dims,
                                 const cuuint64_t* strides,
                                 const cuuint32_t* box,
                                 CUtensorMapSwizzle swizzle) {
  mxt_encode_tiled_fn enc = mxt_encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = enc(map, dt, (cuuint32_t)rank, const_cast<void*>(ptr),
                         dims, strides, box, ones,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// device: shared addresses, mbarriers, TMA
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}
// make the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
// arrive and expect `bytes` more from TMA before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
// expect `bytes` more from TMA in the current phase, without arriving
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// a 1-D bulk copy of `bytes` (a multiple of 16) from global `src` into
// shared `dst`, both 16-byte aligned; completes on `bar`, whose phase must
// expect the bytes (mbar_expect_tx)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// fetch a tensor map into the TMA unit's cache ahead of its first load
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}
// a box of the 4-D `map` at coordinates (c0, c1, c2, c3) into shared
// `dst`; completes on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}
// shared `src` into the box of the 4-D `map` at (c0, c1, c2, c3) (rows
// past the end are not written); tma_store_commit_wait_read then commits
// and waits until the reads of shared memory are done
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit_wait_read() {
  asm volatile(
      "cp.async.bulk.commit_group;\n"
      "cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// order this thread's generic-proxy writes of shared memory before later
// async-proxy (TMA) reads of it
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// a barrier of `count` threads on hardware barrier `id` (1..15)
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Move registers between warpgroups: a producer warpgroup gives its
// registers up, consumers take them (each warpgroup as a whole, once, on a
// path that does not rejoin the other role's).
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------
// descriptor of a swizzled bf16 tile at shared address `addr`: layout 1
// (128-byte swizzle) or 2 (64-byte), `sbo` bytes between 8-row groups;
// the leading byte offset is not read for these layouts at N <= one
// swizzle atom (64 bf16 at 128 bytes, 32 at 64)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, int layout,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses of r across a fence or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// two floats rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d (64 x 64 fp32) = A B, plus d when scale_d: A (64 x 16) and B (16 x 64)
// bf16, both read from shared memory through K-major descriptors
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 fp32) = A B, plus d when scale_d: A (64 x 16 bf16) from
// registers, four b32 of two bf16 each in the accumulator fragment's
// layout (see frag_row); B (16 x 64) from shared memory through an
// MN-major descriptor (transposed, TB 1) or a K-major one (TB 0)
template <int TB = 1>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db,
                                             int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d), "n"(TB));
}

// d (64 x 32 fp32) += A B: A (64 x 16 bf16) from registers, four b32 of
// two bf16 each in the accumulator fragment's layout (see frag_row); B
// (16 x 32) from shared memory through an MN-major descriptor (transposed)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// device: tf32 products (3xTF32 splits, wgmma k8, mma.sync m16n8k8)
// ---------------------------------------------------------------------------
// x rounded to tf32 (to nearest, ties away from zero), low 13 bits zero
__device__ __forceinline__ uint32_t tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
// what the tensor core drops of x when it reads the fp32 word as tf32
__device__ __forceinline__ float tf32_residual(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}
// x = hi + lo to about 2^-21 of x: hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - __uint_as_float(hi));
}

#define MXT_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define MXT_D32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define MXT_OUT16(d)                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define MXT_OUT32(d)                                                        \
  MXT_OUT16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),        \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
      "+f"(d[30]), "+f"(d[31])

// d (64 x N fp32) = A B, plus d when scale_d: A (64 x 8) and B (8 x N)
// tf32 read K-major from shared memory, N 32 or 64
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t da,
                                              uint64_t db, int scale_d) {
  static_assert(N == 32 || N == 64, "wgmma_tf32_ss: N 32 or 64");
  if constexpr (N == 64)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " MXT_D32
        ", %32, %33, p, 1, 1;\n}\n"
        : MXT_OUT32(d)
        : "l"(da), "l"(db), "r"(scale_d));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " MXT_D16
        ", %16, %17, p, 1, 1;\n}\n"
        : MXT_OUT16(d)
        : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N fp32) += A B: A (64 x 8 tf32) from registers in the tf32 A
// fragment's layout, B (8 x N) read K-major from shared memory
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t* a,
                                              uint64_t db) {
  static_assert(N == 32 || N == 64, "wgmma_tf32_rs: N 32 or 64");
  if constexpr (N == 64)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " MXT_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : MXT_OUT32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " MXT_D16
        ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : MXT_OUT16(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef MXT_D16
#undef MXT_D32
#undef MXT_OUT16
#undef MXT_OUT32

// c (16 x 8 fp32) += A B on one warp: A (16 x 8) and B (8 x 8) tf32 in
// mma.sync's fragments (a: rows g, g + 8 and columns t, t + 4 as above;
// b: rows t, t + 4 of column g; c: as the accumulator, g = lane / 4,
// t = lane % 4)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
