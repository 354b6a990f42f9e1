// Paged decode attention: one query token per sequence, GQA, keys and
// values read through the page table up to each sequence's length, from
// fp32 pages or from int8 pages with one scale per (KV head, page).
// Wrapped by mxnet_tpu_torch/ops/kernels/paged_attention.py:paged_attention.
// Replaces the TPU's upstream Pallas paged-attention kernel called at
// mxnet_tpu/ops/pallas/paged_attention.py:251 (fp pages) and the XLA
// dequant-gather path of int8 pages at :237-247.
//
// Bound on the card: bytes.  Each key and value row is read once and used
// by the g = H / KVH query heads of its group (2 g flops per element), far
// below the card's ~20 flops per byte in fp32.
//
// Design: split-key units (flash-decoding), the attention of the TP
// attention phase #13 (decode_common.cuh:split_attend and split_merge).
// One cooperative launch: every block takes units of (row, KV head, 64
// keys) in turn, each writing its chunk's max, sum and unnormalised output
// to a scratch the wrapper allocates; a grid barrier; then each output
// element merges its row's chunks in chunk order.  Inside a unit each warp
// owns 8 keys and each lane D / 32 columns of them, so a lane's loads of
// all 8 key and value rows go out at once: one round trip to memory per
// unit, where one block a (row, KV head) walked the row's whole length in
// tiles of 64 keys, four block barriers a tile (the parent design).  int8
// pages take the same units: a lane loads its E = D / 32 codes of a row
// (2 bytes at D 64) and
// multiplies them by the page's scale, which the lane that found the
// key's page loads beside it; the loads are as many as for fp pages, each
// a quarter of the bytes, and the unit stays one round trip.  Four blocks
// an SM (64 registers at D 64, no spill): a row's units take fewer rounds
// of the grid.  Two plain launches (units, then merge) in place of the
// grid barrier read slower (PERF.md, section 6).  Sums run in a fixed order
// and no atomic decides a result: the output does not depend on timing.
#include "decode_common.cuh"

namespace cg = cooperative_groups;

namespace {

struct PagedArgs {
  const float* q;        // (B, H, D)
  const int* lengths;    // (B,)
  const int* tables;     // (B, pps)
  float* scratch;        // mxt_paged_attention_scratch floats
  float* out;            // (B, H, D)
  long long* timing;     // null, or PAGED_PHASES + 1 phase-end timestamps
  int B, H, KVH, P, S, pps;
  float scale;
};

// the kernel's phases (units, merge), each closed by a grid barrier
constexpr int PAGED_PHASES = 2;

// the units, a grid barrier, the merge; with a timing buffer block 0
// stamps the start and the end of each phase (the merge then gets a
// barrier of its own)
template <int E, class Pages>
__global__ void __launch_bounds__(mxt::NTHREADS, 4)
paged_split_kernel(PagedArgs a, Pages pages) {
  extern __shared__ __align__(16) float smem[];
  constexpr int D = 32 * E;
  const int g = a.H / a.KVH, max_keys = a.pps * a.S, Cq = a.H * D;
  const size_t U = mxt::split_units_max(a.B, a.KVH, max_keys);
  float* po = a.scratch;
  float* pm = po + mxt::round4(U * g * D);
  float* pl = pm + mxt::round4(U * g);
  const float* q = a.q;
  cg::grid_group grid = cg::this_grid();
  long long* stamp =
      blockIdx.x == 0 && threadIdx.x == 0 ? a.timing : nullptr;
  if (stamp) stamp[0] = mxt::globaltimer();
  mxt::split_attend<E>(
      [=](int b, int c) { return __ldg(q + (size_t)b * Cq + c); },
      [](int, int) {}, pages, a.tables, a.lengths, a.B, a.KVH, g, a.P, a.S,
      a.pps, a.scale, po, pm, pl, smem);
  grid.sync();
  if (stamp) stamp[1] = mxt::globaltimer();
  mxt::split_merge(po, pm, pl, a.lengths, a.B, a.KVH, g, D, max_keys, a.out);
  if (a.timing) {
    grid.sync();
    if (stamp) stamp[2] = mxt::globaltimer();
  }
}

template <int E, class Pages>
cudaError_t launch_split(const PagedArgs& a, const Pages& pages,
                         cudaStream_t stream) {
  auto kernel = paged_split_kernel<E, Pages>;
  int grid = 0;
  size_t smem = 0;
  cudaError_t e = mxt::coop_geometry(
      kernel, mxt::split_smem_floats(a.H / a.KVH, 32 * E), &grid, &smem);
  if (e != cudaSuccess) return e;
  PagedArgs args = a;
  Pages p = pages;
  void* params[] = {&args, &p};
  e = cudaLaunchCooperativeKernel((const void*)kernel, grid, mxt::NTHREADS,
                                  params, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <class Pages>
int launch(const PagedArgs& a, const Pages& pages, int D, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: return (int)launch_split<1>(a, pages, s);
    case 64: return (int)launch_split<2>(a, pages, s);
    case 128: return (int)launch_split<4>(a, pages, s);
  }
  return (int)cudaErrorInvalidValue;
}

PagedArgs make_args(const void* q, const void* lengths, const void* tables,
                    void* scratch, void* out, void* timing, int B, int H,
                    int KVH, int P, int S, int pps, float scale) {
  PagedArgs a;
  a.q = (const float*)q;
  a.lengths = (const int*)lengths;
  a.tables = (const int*)tables;
  a.scratch = (float*)scratch;
  a.out = (float*)out;
  a.timing = (long long*)timing;
  a.B = B; a.H = H; a.KVH = KVH; a.P = P; a.S = S; a.pps = pps;
  a.scale = scale;
  return a;
}

}  // namespace

extern "C" const char* mxt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Phases that timing stamps.
extern "C" int mxt_paged_attention_phases() { return PAGED_PHASES; }

// Floats of device scratch one launch needs: each unit's (g D) outputs,
// (g) maxima and (g) sums for the most units rows of at most pps * S keys
// can have.
extern "C" long long mxt_paged_attention_scratch(int B, int H, int KVH,
                                                 int D, int max_keys) {
  const int g = H / KVH;
  const size_t U = mxt::split_units_max(B, KVH, max_keys);
  return (long long)(mxt::round4(U * g * D) + 2 * mxt::round4(U * g));
}

// q (B, H, D), kp/vp (KVH, P, S, D), lengths (B,), tables (B, pps) int32,
// scratch of mxt_paged_attention_scratch floats, out (B, H, D); all fp32
// except the int32 lengths and tables; timing null, or
// mxt_paged_attention_phases() + 1 int64 that block 0 fills with
// %globaltimer stamps (the start, then the end of each phase).  D must be
// 32, 64 or 128.
extern "C" int mxt_paged_attention(const void* q, const void* kp,
                                   const void* vp, const void* lengths,
                                   const void* tables, void* scratch,
                                   void* out, void* timing, int B, int H,
                                   int KVH, int P, int S, int D, int pps,
                                   float scale, void* stream) {
  return launch(make_args(q, lengths, tables, scratch, out, timing, B, H,
                          KVH, P, S, pps, scale),
                mxt::SplitF32{(const float*)kp, (const float*)vp}, D,
                stream);
}

// As mxt_paged_attention, over int8 pages: kq/vq (KVH, P, S, D) int8 codes,
// ks/vs (KVH, P) fp32 scales.
extern "C" int mxt_paged_attention_i8(const void* q, const void* kq,
                                      const void* vq, const void* ks,
                                      const void* vs, const void* lengths,
                                      const void* tables, void* scratch,
                                      void* out, void* timing, int B, int H,
                                      int KVH, int P, int S, int D, int pps,
                                      float scale, void* stream) {
  return launch(make_args(q, lengths, tables, scratch, out, timing, B, H,
                          KVH, P, S, pps, scale),
                mxt::SplitI8{(const signed char*)kq, (const signed char*)vq,
                             (const float*)ks, (const float*)vs},
                D, stream);
}
