// Tensor-parallel decode phases: one shard of one decoder layer, for the
// whole decode batch, in two cooperative persistent launches.  Wrapped by
// mxnet_tpu_torch/ops/kernels/fused_cell.py:decode_attn_phase and
// :decode_ffn_phase.
//
// Replaces the TPU kernels _decode_attn_phase_kernel (kernel #13,
// mxnet_tpu/ops/pallas/fused_cell.py:509, launched by decode_attn_phase at
// :572) and _decode_ffn_phase_kernel (#14, :617, launched at :626).  A
// Pallas body cannot carry a cross-chip collective, so under tensor
// parallelism the layer-group fusion of _decode_group_kernel splits at the
// two all-reduces of a Megatron layer; the caller sums the shards' partial
// products between the launches (models/decoder.py:_all_reduce) and adds
// the replicated bias and the residual LayerNorm.  The contracts are the
// TPU kernels': one launch per layer per shard for each phase, the KV
// pages updated in place, partial products in fp32 with no bias.
//
// #13, attention phase (grid-wide barriers between the phases):
//   1. q/k/v GEMVs over the shard's heads (B rows x (Cl + 2 KVCl) outputs
//      from the full-width x, Cl = H_local D), as partial sums over slices
//      of K: 144 column groups at tp 2 would leave most of the ~400 blocks
//      idle
//   2. split-key paged attention (decode_common.cuh:split_attend): one
//      unit per (sequence, KV head, chunk of 64 keys), each writing its
//      chunk's running max, sum and unnormalised output; a unit sums its
//      query rows' slices (in slice order) + bias as it reads them, and
//      the unit of a row's last chunk first sums the step's k and v the
//      same way and writes them into the page slot meta names (the KV
//      append), then reads them back through the table like every key
//   3. the chunks of each (sequence, head) merged in chunk order
//      (split_merge) into the attention output (B, Cl)
//   4. out-projection over the shard's Cl inputs (wo's row shard, (C, Cl)),
//      as partial sums over slices of K
//   5. the slices summed in slice order into o_part (B, C)
// Why split the keys: a unit of a whole (sequence, KV head) left one block
// walking the longest row's 512 keys while most of the ~400 resident
// blocks waited at the barrier (96 units at tp 2, 48 at tp 4); with
// 64-key chunks the serving batch's lengths give about as many units as
// blocks, and a unit's work is bounded by 64 keys.  Inactive rows have
// no unit and append nothing (the plain version writes their k and v to
// the scratch page 0, which no row reads).  A merge of its own,
// rather than inside the out-projection's staging, because every column
// group of that GEMV stages the same rows and would merge them again:
// folded there (each block merging the K slice it stages), the serial
// L2 reads sat on the GEMV's path, and the phase read 0.0505 ms against
// this design's 0.0431 (H100 80GB HBM3, 700 W; tp 2, B 16, mixed
// lengths; chip_flash_ab.py --phases tp), more than the merge pass and
// its grid barrier (~4 us) cost.
// #14, FFN phase:
//   1. FFN1 on w1's column shard (Fl, C) + b1, erf GELU
//   2. FFN2 over the shard's Fl inputs (w2's row shard, (C, Fl)), as
//      partial sums over slices of K
//   3. the slices summed in slice order into f_part (B, C)
//
// Bound on the card: bytes.  A shard's layer reads C (2 Cl + 2 KVCl) fp32
// weights in the attention phase and 2 C Fl in the FFN phase (4.7 MB and
// 9.4 MB at tp 2, full width), plus the KV its rows' lengths name; each
// weight is used by the B = 16 rows (32 flops per 4 bytes).  The GEMVs
// therefore stream each weight row once, as the fused decode kernel does
// (decode_common.cuh); the TPU kernel reads the whole page slab behind a
// mask (fused_cell.py:543-552) where this one reads only the pages on each
// row's table up to its length, which computes the same thing under the
// allocator's invariants (page 0 is scratch, no page twice in one table).
// The partial sums of a split GEMV are added in slice order, with no
// atomics, so results do not depend on timing.
#include "decode_common.cuh"

namespace cg = cooperative_groups;

namespace {

using mxt::KSPLIT_MAX;
using mxt::NTHREADS;
using mxt::round4;

struct AttnArgs {
  const float* x;        // (B, C) activations entering the layer
  float* kp;             // (KVH, P, S, D) the shard's key page slab
  float* vp;             // (KVH, P, S, D) the shard's value page slab
  const float* wq;       // (Cl, C), bq (Cl,)
  const float* bq;
  const float* wk;       // (KVC, C), bk (KVC,)
  const float* bk;
  const float* wv;       // (KVC, C), bv (KVC,)
  const float* bv;
  const float* wo;       // (C, Cl): wo's row shard, contiguous
  const int* meta;       // (2, B): write page, write slot
  const int* tables;     // (B, pps) page tables
  const int* lengths;    // (B,) valid keys after this step's append
  float* scratch;        // attn_scratch_floats(...) floats
  float* out;            // (B, C) o_part
  long long* timing;     // null, or ATTN_PHASES + 1 phase-end timestamps
  int B, C, H, KVH, D, P, S, pps;
  float scale;
};

struct FfnArgs {
  const float* x;        // (B, C)
  const float* w1;       // (Fl, C): w1's column shard, b1 (Fl,)
  const float* b1;
  const float* w2;       // (C, Fl): w2's row shard, contiguous
  float* scratch;        // ffn_scratch_floats(B, C, Fl) floats
  float* out;            // (B, C) f_part
  int B, C, Fl;
};

// scratch: qkv parts (KSPLIT_MAX, B, Cl + 2 KVC) | att (B, Cl) | parts
// (KSPLIT_MAX, B, C) | the split attention's per-unit partials: outputs
// (U, g D), maxima (U, g), sums (U, g), U = split_units_max
__host__ __device__ inline size_t attn_scratch_floats(int B, int C, int Cl,
                                                      int KVC, int D,
                                                      int max_keys) {
  const int KVH = KVC / D, g = Cl / KVC;
  const size_t U = mxt::split_units_max(B, KVH, max_keys);
  return (size_t)KSPLIT_MAX * B * (Cl + 2 * KVC) + round4((size_t)B * Cl) +
         (size_t)KSPLIT_MAX * B * C + round4(U * g * D) + 2 * round4(U * g);
}

// scratch: h (B, Fl) | parts (KSPLIT_MAX, B, C)
__host__ __device__ inline size_t ffn_scratch_floats(int B, int C, int Fl) {
  return round4((size_t)B * Fl) + (size_t)KSPLIT_MAX * B * C;
}

// the attention phase's phases, each closed by a grid barrier
constexpr int ATTN_PHASES = 5;

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// out[b, c] = sum over s < ks of parts[s, b, c], in slice order
__device__ void sum_slices(float* out, const float* parts, int ks, int n) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < ks; ++s) acc += __ldcg(parts + (size_t)s * n + e);
    out[e] = acc;
  }
}

// one kernel per head dim, D = 32 E, so each carries one attention path
// under the register budget of three blocks an SM
template <int E>
__global__ void __launch_bounds__(NTHREADS, 3) attn_phase_kernel(AttnArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  // with a timing buffer, block 0 stamps the start and the end of every
  // phase (right after the grid barrier that closes it; the last phase
  // gets a barrier of its own only then)
  const bool stamp = a.timing != nullptr && blockIdx.x == 0 &&
                     threadIdx.x == 0;
  int n_stamp = 0;
  if (stamp) a.timing[n_stamp++] = globaltimer();
  auto sync = [&]() {
    grid.sync();
    if (stamp) a.timing[n_stamp++] = globaltimer();
  };
  const int B = a.B, C = a.C, D = a.D, S = a.S, P = a.P;
  const int Cl = a.H * D, KVC = a.KVH * D, N = Cl + 2 * KVC;
  const int g = a.H / a.KVH, max_keys = a.pps * S;
  const size_t U = mxt::split_units_max(B, a.KVH, max_keys);
  float* qkv = a.scratch;
  float* att = qkv + (size_t)KSPLIT_MAX * B * N;
  float* parts = att + round4((size_t)B * Cl);
  float* po = parts + (size_t)KSPLIT_MAX * B * C;
  float* pm = po + round4(U * g * D);
  float* pl = pm + round4(U * g);
  const float *wq = a.wq, *wk = a.wk, *wv = a.wv, *wo = a.wo;
  const float *bq = a.bq, *bk = a.bk, *bv = a.bv;
  float *kp = a.kp, *vp = a.vp;
  const int* meta = a.meta;

  // 1. q/k/v over the shard's heads, partial sums over K slices
  const int kq = mxt::ksplit_for(N);
  mxt::gemv(a.x, B, C, N, kq,
            [=](int n) {
              return n < Cl ? wq + (size_t)n * C
                   : n < Cl + KVC ? wk + (size_t)(n - Cl) * C
                                  : wv + (size_t)(n - Cl - KVC) * C;
            },
            [=](int b, int n, int s, float v) {
              qkv[((size_t)s * B + b) * N + n] = v;
            },
            smem);
  sync();

  // 2. split-key attention: each unit's chunk partials.  q, k and v are
  // the slices' sums in slice order + bias; the unit of a row's last chunk
  // appends the row's k and v at meta's (page, slot)
  auto qkv_at = [=](int b, int n) {
    float v = 0.f;
    for (int s = 0; s < kq; ++s)
      v += __ldcg(qkv + ((size_t)s * B + b) * N + n);
    return v;
  };
  auto q_at = [=](int b, int n) { return qkv_at(b, n) + bq[n]; };
  auto append = [=](int b, int kvh) {
    const size_t dst = (((size_t)kvh * P + meta[b]) * S + meta[B + b]) * D;
    for (int e = threadIdx.x; e < 2 * D; e += blockDim.x) {
      const int d = e < D ? e : e - D, c = kvh * D + d;
      if (e < D)
        kp[dst + d] = qkv_at(b, Cl + c) + bk[c];
      else
        vp[dst + d] = qkv_at(b, Cl + KVC + c) + bv[c];
    }
  };
  mxt::split_attend<E>(q_at, append, kp, vp, a.tables, a.lengths, B, a.KVH,
                       g, P, S, a.pps, a.scale, po, pm, pl, smem);
  sync();

  // 3. the chunks merged in chunk order
  mxt::split_merge(po, pm, pl, a.lengths, B, a.KVH, g, D, max_keys, att);
  sync();

  // 4. out-projection partial over the shard's Cl inputs, K split
  const int ks = mxt::ksplit_for(C);
  mxt::gemv(att, B, Cl, C, ks, [=](int n) { return wo + (size_t)n * Cl; },
            [=](int b, int n, int s, float v) {
              parts[((size_t)s * B + b) * C + n] = v;
            },
            smem);
  sync();

  // 5. o_part = the slices' sum, in order
  sum_slices(a.out, parts, ks, B * C);
  if (a.timing) sync();
}

__global__ void __launch_bounds__(NTHREADS, 3) ffn_phase_kernel(FfnArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int B = a.B, C = a.C, Fl = a.Fl;
  float* hbuf = a.scratch;
  float* parts = hbuf + round4((size_t)B * Fl);
  const float *w1 = a.w1, *b1 = a.b1, *w2 = a.w2;

  // 1. FFN1 on the column shard + b1, erf GELU
  mxt::gemv(a.x, B, C, Fl, 1, [=](int n) { return w1 + (size_t)n * C; },
            [=](int b, int n, int, float v) {
              hbuf[(size_t)b * Fl + n] = mxt::gelu_erf(v + b1[n]);
            },
            smem);
  grid.sync();

  // 2. FFN2 partial over the shard's Fl inputs, K split
  const int ks = mxt::ksplit_for(C);
  mxt::gemv(hbuf, B, Fl, C, ks, [=](int n) { return w2 + (size_t)n * Fl; },
            [=](int b, int n, int s, float v) {
              parts[((size_t)s * B + b) * C + n] = v;
            },
            smem);
  grid.sync();

  // 3. f_part = the slices' sum, in order
  sum_slices(a.out, parts, ks, B * C);
}

using AttnKernel = void (*)(AttnArgs);

// the attention phase kernel of head dim D (32, 64 or 128)
AttnKernel attn_kernel(int D) {
  return D == 32 ? attn_phase_kernel<1>
       : D == 64 ? attn_phase_kernel<2> : attn_phase_kernel<4>;
}

cudaError_t attn_geometry(int g, int D, int* grid, size_t* smem) {
  return mxt::coop_geometry(
      attn_kernel(D),
      std::max(mxt::STAGE_FLOATS, mxt::split_smem_floats(g, D)), grid, smem);
}

cudaError_t ffn_geometry(int* grid, size_t* smem) {
  return mxt::coop_geometry(ffn_phase_kernel, mxt::STAGE_FLOATS, grid, smem);
}

cudaError_t launch(const void* kernel, int grid, size_t smem, void* args,
                   void* stream) {
  void* params[] = {args};
  cudaError_t e = cudaLaunchCooperativeKernel(kernel, grid, NTHREADS, params,
                                              smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* mxt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Phases of the attention phase kernel that timing stamps.
extern "C" int mxt_decode_attn_phases() { return ATTN_PHASES; }

// Blocks each phase kernel launches with (for the caller's records).
extern "C" int mxt_decode_phase_grid(int g, int D, int* attn_grid,
                                     int* ffn_grid) {
  size_t smem = 0;
  cudaError_t e = attn_geometry(g, D, attn_grid, &smem);
  if (e != cudaSuccess) return (int)e;
  return (int)ffn_geometry(ffn_grid, &smem);
}

// Floats of device scratch one launch needs: the attention phase with
// Cl = H D query columns, KVC = KVH D key columns and rows of at most
// max_keys = pps S keys (ffn: Cl = Fl, the rest ignored).
extern "C" long long mxt_decode_phase_scratch(int ffn, int B, int C, int Cl,
                                              int KVC, int D, int max_keys) {
  return (long long)(ffn ? ffn_scratch_floats(B, C, Cl)
                         : attn_scratch_floats(B, C, Cl, KVC, D, max_keys));
}

// x (B, C); kp/vp (KVH, P, S, D); wq (H D, C), wk/wv (KVH D, C), biases;
// wo (C, H D); meta (2, B), tables (B, pps), lengths (B,) int32; scratch of
// mxt_decode_phase_scratch floats; out (B, C); timing null, or
// mxt_decode_attn_phases() + 1 int64 that block 0 fills with %globaltimer
// stamps (the start, then the end of each phase).  C must be a multiple of
// 4 and D 32, 64 or 128.
extern "C" int mxt_decode_attn_phase(const void* x, void* kp, void* vp,
                                     const void* wq, const void* bq,
                                     const void* wk, const void* bk,
                                     const void* wv, const void* bv,
                                     const void* wo, const void* meta,
                                     const void* tables, const void* lengths,
                                     void* scratch, void* out, void* timing,
                                     int B, int C, int H, int KVH, int D,
                                     int P, int S, int pps, float scale,
                                     void* stream) {
  if (D != 32 && D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  int grid = 0;
  size_t smem = 0;
  cudaError_t e = attn_geometry(H / KVH, D, &grid, &smem);
  if (e != cudaSuccess) return (int)e;
  AttnArgs a;
  a.x = (const float*)x;
  a.kp = (float*)kp;
  a.vp = (float*)vp;
  a.wq = (const float*)wq;
  a.bq = (const float*)bq;
  a.wk = (const float*)wk;
  a.bk = (const float*)bk;
  a.wv = (const float*)wv;
  a.bv = (const float*)bv;
  a.wo = (const float*)wo;
  a.meta = (const int*)meta;
  a.tables = (const int*)tables;
  a.lengths = (const int*)lengths;
  a.scratch = (float*)scratch;
  a.out = (float*)out;
  a.timing = (long long*)timing;
  a.B = B; a.C = C; a.H = H; a.KVH = KVH; a.D = D;
  a.P = P; a.S = S; a.pps = pps;
  a.scale = scale;
  return (int)launch((const void*)attn_kernel(D), grid, smem, &a, stream);
}

// x (B, C); w1 (Fl, C), b1 (Fl,); w2 (C, Fl); scratch of
// mxt_decode_phase_scratch floats; out (B, C).  C and Fl must be multiples
// of 4.
extern "C" int mxt_decode_ffn_phase(const void* x, const void* w1,
                                    const void* b1, const void* w2,
                                    void* scratch, void* out, int B, int C,
                                    int Fl, void* stream) {
  int grid = 0;
  size_t smem = 0;
  cudaError_t e = ffn_geometry(&grid, &smem);
  if (e != cudaSuccess) return (int)e;
  FfnArgs a;
  a.x = (const float*)x;
  a.w1 = (const float*)w1;
  a.b1 = (const float*)b1;
  a.w2 = (const float*)w2;
  a.scratch = (float*)scratch;
  a.out = (float*)out;
  a.B = B; a.C = C; a.Fl = Fl;
  return (int)launch((const void*)ffn_phase_kernel, grid, smem, &a, stream);
}
