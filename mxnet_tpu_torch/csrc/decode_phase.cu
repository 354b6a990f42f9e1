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
//   0. at launch, each block's weight rows on their way into shared
//      memory: one 1-D bulk copy (TMA) per row of its FFN1 unit (8 rows of
//      w1's column shard (Fl, C) over a K slice) and of its FFN2 unit (of
//      w2's row shard (C, Fl)), and per row of x over the FFN1 unit's
//      slice, each set completing on an mbarrier that the math waits on
//      only when it reaches the unit
//   1. FFN1 as partial sums over slices of K (2 at tp 2, 4 at tp 4: every
//      block holds a share of the weights)
//   2. h = erf GELU(the slices' sum in slice order + b1), once per element
//   3. FFN2 over the shard's Fl inputs, as partial sums over slices of K
//   4. the slices summed in slice order into f_part (B, C)
// Each resident unit multiplies from shared memory on register tiles (two
// rows by two weight rows a lane, the K columns spread over the warps,
// their partials added in warp order: ffn_tiles), a quarter of the
// shared-memory reads of one warp a column.  Why: one warp a column
// streaming its row from memory (mxt::gemv) left FFN1 at 192 column groups
// for ~400 blocks, staged x in two serial chunks, issued FFN2's 384-column
// slices one load at a time and started w2's stream only after the grid
// barrier; stamped, the parent design took ffn1 18.4 us, ffn2 12.2 and
// the slice sum 2.1 of 0.0371 ms (H100 80GB HBM3, 700 W; tp 2, B 16;
// chip_flash_ab.py --phases tp).  b1 and the GELU folded into FFN2's
// staging had each of FFN2's 96 column groups re-add the slices and
// re-take the GELU of the same elements, and FFN2 unsplit (96 busy
// blocks, two an SM) left most of the grid idle: both read slower than
// this design in the same call (PERF.md, section 6).
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

using mxt::FfnCopies;
using mxt::FfnUnits;
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
  long long* timing;     // null, or FFN_PHASES + 1 phase-end timestamps
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

// scratch: FFN1 parts (KSPLIT_MAX, B, Fl) | h (B, Fl) | FFN2 parts
// (KSPLIT_MAX, B, C)
__host__ __device__ inline size_t ffn_scratch_floats(int B, int C, int Fl) {
  return (size_t)KSPLIT_MAX * B * (Fl + C) + (size_t)B * Fl;
}

// #14's shared memory: two mbarriers, a block's resident w1 rows and w2
// rows (at tp 2, full width: 8 rows of 384 columns each), then the stage
// (16 rows of 384 columns), rows padded (ffn_pitch): 48.5 KB a block,
// three blocks an SM
constexpr int FFN_BAR_FLOATS = 4;
constexpr int FFN_W1_FLOATS = 8 * 388;
constexpr int FFN_W2_FLOATS = 8 * 388;
constexpr int FFN_STAGE_FLOATS = 16 * 388;
constexpr int FFN_SMEM_FLOATS =
    FFN_BAR_FLOATS + FFN_W1_FLOATS + FFN_W2_FLOATS + FFN_STAGE_FLOATS;

// the attention and the FFN phase's phases, each closed by a grid barrier
constexpr int ATTN_PHASES = 5;
constexpr int FFN_PHASES = 5;

using mxt::globaltimer;

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
  mxt::split_attend<E>(q_at, append, mxt::SplitF32{kp, vp}, a.tables,
                       a.lengths, B, a.KVH, g, P, S, a.pps, a.scale, po, pm,
                       pl, smem);
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
  // stamps as in attn_phase_kernel, but for the first phase: "copies"
  // ends when the last block's FFN1 rows have landed (each block raises
  // timing[1] to its landing time), and FFN1 follows it
  const bool stamp = a.timing != nullptr && blockIdx.x == 0 &&
                     threadIdx.x == 0;
  int n_stamp = 2;
  if (stamp) {
    a.timing[0] = globaltimer();
    atomicMax(reinterpret_cast<unsigned long long*>(a.timing + 1),
              (unsigned long long)a.timing[0]);
  }
  auto sync = [&]() {
    grid.sync();
    if (stamp) a.timing[n_stamp++] = globaltimer();
  };
  const int B = a.B, C = a.C, Fl = a.Fl;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* w1s = smem + FFN_BAR_FLOATS;
  float* w2s = w1s + FFN_W1_FLOATS;
  float* stage = w2s + FFN_W2_FLOATS;
  float* hparts = a.scratch;
  float* hbuf = hparts + (size_t)KSPLIT_MAX * B * Fl;
  float* parts = hbuf + (size_t)B * Fl;
  const float *x = a.x, *w1 = a.w1, *b1 = a.b1, *w2 = a.w2;
  // a unit is resident when its rows fit its buffer: then its 16 input
  // rows also fit the stage, at the same pitch (8 rows of 388 floats for
  // the weights, 16 for the stage)
  const FfnUnits u1(Fl, C, mxt::ksplit_for(Fl));
  const FfnUnits u2(C, Fl, mxt::ksplit_for(C));
  const bool r1 = u1.resident(FFN_W1_FLOATS);
  const bool r2 = u2.resident(FFN_W2_FLOATS);

  // 0. the block's resident weight rows (and FFN1's input rows) on their
  // way into shared memory before any math: thread 0 sets up the barriers
  // and the bytes each expects, then the copies go out from as many
  // threads
  const FfnCopies c1(u1, Fl, C, w1s, x, B, stage);
  const FfnCopies c2(u2, C, Fl, w2s, nullptr, 0, nullptr);
  auto w1_row = [=](int n) { return w1 + (size_t)n * C; };
  auto w2_row = [=](int n) { return w2 + (size_t)n * Fl; };
  if (threadIdx.x == 0) {
    mbar_init(smem_u32(bars), 1);
    mbar_init(smem_u32(bars + 1), 1);
    mbar_fence_init();
    if (r1) mbar_expect_tx(smem_u32(bars), c1.bytes());
    if (r2) mbar_expect_tx(smem_u32(bars + 1), c2.bytes());
  }
  __syncthreads();
  if (r1) c1.issue(0, bars, w1_row);
  if (r2) c2.issue(NTHREADS / 2, bars + 1, w2_row);
  const bool x_res = r1 && c1.xrows > 0;

  // 1. FFN1 partials over K slices: hparts[s, b, n]
  mxt::ffn_gemv(u1, B, C, Fl, w1_row,
                [=](float* st, int p, int b0, int nb, int k0, int kc) {
                  mxt::ffn_stage(st, p, x + (size_t)b0 * C, nb, C, k0, kc);
                },
                [=](int b, int n, int s, float v) {
                  hparts[((size_t)s * B + b) * Fl + n] = v;
                },
                stage, FFN_STAGE_FLOATS, r1 ? w1s : nullptr, x_res,
                smem_u32(bars), 0,
                a.timing ? reinterpret_cast<unsigned long long*>(a.timing + 1)
                         : nullptr);
  sync();

  // 2. h = gelu_erf(the FFN1 slices' sum in slice order + b1), once per
  // element
  const int ks1 = u1.ks;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < B * Fl / 4;
       e += gridDim.x * blockDim.x) {
    const int k = (e * 4) % Fl;
    const float* p = hparts + (size_t)e * 4;
    const float4 bv = __ldg(reinterpret_cast<const float4*>(b1 + k));
    // the slices in groups of 4 loads in flight, added in slice order
    float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < ks1; s0 += 4) {
      float4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (s0 + j < ks1)
          v[j] = __ldcg(reinterpret_cast<const float4*>(
              p + (size_t)(s0 + j) * B * Fl));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (s0 + j < ks1) {
          h.x += v[j].x;
          h.y += v[j].y;
          h.z += v[j].z;
          h.w += v[j].w;
        }
      }
    }
    reinterpret_cast<float4*>(hbuf)[e] =
        make_float4(mxt::gelu_erf(h.x + bv.x), mxt::gelu_erf(h.y + bv.y),
                    mxt::gelu_erf(h.z + bv.z), mxt::gelu_erf(h.w + bv.w));
  }
  sync();

  // 3. FFN2 over the shard's Fl inputs
  mxt::ffn_gemv(u2, B, Fl, C, w2_row,
                [=](float* st, int p, int b0, int nb, int k0, int kc) {
                  mxt::ffn_stage(st, p, hbuf + (size_t)b0 * Fl, nb, Fl, k0,
                                 kc);
                },
                [=](int b, int n, int s, float v) {
                  parts[((size_t)s * B + b) * C + n] = v;
                },
                stage, FFN_STAGE_FLOATS, r2 ? w2s : nullptr, false,
                smem_u32(bars + 1), 0, nullptr);
  sync();

  // 4. f_part = the slices' sum, in order
  sum_slices(a.out, parts, u2.ks, B * C);
  if (a.timing) sync();
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
  return mxt::coop_geometry(ffn_phase_kernel, FFN_SMEM_FLOATS, grid, smem);
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

// Phases of the attention and the FFN phase kernel that timing stamps.
extern "C" int mxt_decode_attn_phases() { return ATTN_PHASES; }
extern "C" int mxt_decode_ffn_phases() { return FFN_PHASES; }

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
// mxt_decode_phase_scratch floats; out (B, C); timing null, or
// mxt_decode_ffn_phases() + 1 int64 stamps as mxt_decode_attn_phase's.  C
// and Fl must be multiples of 4.
extern "C" int mxt_decode_ffn_phase(const void* x, const void* w1,
                                    const void* b1, const void* w2,
                                    void* scratch, void* out, void* timing,
                                    int B, int C, int Fl, void* stream) {
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
  a.timing = (long long*)timing;
  a.B = B; a.C = C; a.Fl = Fl;
  return (int)launch((const void*)ffn_phase_kernel, grid, smem, &a, stream);
}
