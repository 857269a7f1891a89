// Superblock tracking kernel for a channel bank (Hopper, sm_90a): one launch
// tracks every channel row through every epoch of a superblock, loop closure
// included.
//
// It is the redesign for this card of the epoch correlator of correlator.cu,
// which replaces the TPU kernel `correlate_bank_hbm` of
// cusdr_tpu/ops/correlator.py (Pallas call built by `_build_call_hbm`), in
// all three of its variants (no pilot, pilot, dual pilot) and both tap modes,
// together with the loop the reference runs around that kernel: the
// `lax.scan` over epochs of `track_superblock` (cusdr_tpu/tracking/engine.py)
// with the window geometry of `_epoch_bank_pallas` and the discriminators and
// loop filters of `_close_epoch`.  Its plain version is the port's eager epoch
// loop, `track_superblock_epochs` of tracking/engine.py, which launches
// correlator.cu once per epoch and closes the loops with [C]-wide tensor ops.
//
// What bounds the eager loop on an H100 is not its kernel: an epoch of 12 x
// 18 008 samples holds a fraction of a microsecond of memory or arithmetic
// time, and costs one kernel launch plus some ninety small elementwise
// launches, each paid for on the host.  The scan is sequential in the epoch
// but every step is elementwise in the channel, so here a sequential loop
// inside the block takes the scan's place:
//
//   * one thread block (or one thread-block cluster) owns one channel row
//     for the whole superblock.  The row's loop state (ChannelState's twelve
//     f64 fields, abs_sample, pilot_period, active) lives in shared memory;
//     only the record, the tables and the output stacks touch device memory;
//   * per epoch, thread 0 computes the window geometry and carrier steps in
//     f64 (what `_epoch_bank` computes with tensor ops, and the clamping the
//     per-epoch wrapper does on tensors), the block correlates through the
//     same `accumulate_row` / `reduce_block` / `output_sum` steps and the
//     same UvCarrier as the per-epoch kernels, thread 0 closes the loops
//     from the totals in shared memory, writes the epoch's outputs and goes
//     on to the next epoch's geometry: two block barriers per epoch beside
//     those of the reduction;
//   * `valid` is absorbing (the new `active` is `valid`): a row that goes
//     invalid writes its frozen state for the rest of the superblock and
//     correlates no more;
//   * with a cluster of S blocks per row (small banks: 12 rows x 8 blocks use
//     96 of the 132 SMs) block r correlates the r-th slice of the epoch's
//     samples, the blocks read each other's totals through distributed shared
//     memory in rank order, and every block closes the epoch redundantly from
//     the same totals, so nothing is broadcast.  The totals are double
//     buffered by epoch parity, which makes one `cluster.sync()` per epoch
//     enough; rank 0 writes the outputs.
//
// Arithmetic.  The closing repeats the eager loop's roundings on the card
// one by one: every product and sum is rounded by itself (`__dmul_rn`,
// `__fadd_rn`, ...; nvcc would contract them into FMAs), the discriminators
// are f32, the filters f64, `torch.remainder` is fmod plus a sign fix-up, and
// a division by a host scalar is a multiplication by its reciprocal, as
// PyTorch's CUDA division by a scalar is.  With one block per row the sums
// are those of correlator.cu to the bit, and so is everything else, as far as
// this toolkit's `atanf` equals PyTorch's; a cluster adds the slices in
// another order, which moves the sums by f32 rounding.
//
// No tensor cores and no TMA: the work is int8 loads and f32 FMAs on a 1-D
// stream, 33-75 operations per sample, with no matrix product in it.

#include <cooperative_groups.h>

#include "correlator_common.cuh"

namespace cg = cooperative_groups;

// Arguments of one launch; mirrored field by field by the ctypes structure
// `SuperblockArgs` of ops/correlator.py.  The scalars are computed by the
// caller in double (or rounded to f32 where the eager loop's tensors are
// f32) and used as given.
struct SuperblockArgs {
  const int8_t* iq;            // [2 S] interleaved I/Q record
  const int8_t* table;         // [R, table_len] replica tables
  const int8_t* ptable;        // [R, n_pilots, ptable_len] or null
  const double* state_in;      // [12, C] ChannelState's f64 fields
  const int64_t* abs_in;       // [C]
  const int32_t* pper_in;      // [C] pilot_period
  const uint8_t* active_in;    // [C]
  const int64_t* end_sample;   // [C] absolute end of each row's record
  double* state_out;           // [12, C]
  int64_t* abs_out;
  int32_t* pper_out;
  uint8_t* active_out;
  float* o32;                  // [E, 12, C]
  double* o64;                 // [E, 4, C]
  int64_t* oi;                 // [E, 2, C]
  int64_t sb_start;            // absolute sample index of iq[0]
  int64_t n_samples;           // S
  int64_t table_len;
  int64_t ptable_len;
  double inv_fs;               // 1 / fs
  double code_len;
  double two_pi;
  double inv_two_pi;
  double carr_a, carr_b;       // tau2 / tau1, pdi / tau1 of the PLL
  double code_a, code_b;       // the same of the DLL
  double pf1, pf2, pf3;        // 3rd-order PLL gains
  float inv_two_pi_f;          // f32(1) / f32(2 pi)
  float eps;                   // f32(1e-12)
  float data_weight, pilot_weight;
  float dll_data_weight, dll_pilot_weight, dll_scale;
  float w1, w2;                // dual-pilot combining weights
  int n_rows;                  // C
  int n_table_rows;            // R: row c reads table row c % R
  int n_epochs;                // E
  int blk;
  int k;
  int up_margin;
  int pll_order;
  int pilot_rot, pilot2_rot;
  int pilot_period_mod;
};

namespace {

using namespace cusdr;

// Order of ChannelState's f64 fields in `state_in` / `state_out`.
enum Field {
  kCarrFreq, kCarrFreqBasis, kCodeFreq, kCodeFreqBasis, kRemCode, kRemCarr,
  kCarrNco, kCarrErr, kCodeNco, kCodeErr, kDCarr, kD2Carr, kFields
};

struct RowState {
  double f[kFields];
  int64_t abs_sample;
  int32_t pilot_period;
  int32_t active;
};

// One epoch's window geometry and carrier steps, by thread 0 for the block.
struct Geometry {
  int64_t off, start, pstart;   // clamped window starts
  int64_t blksize;
  double step;                  // code phase step [chips / sample]
  double inc;                   // carrier step [rad / sample]
  float alpha, palpha, remc, shi, slo;
  int valid;
};

// torch.remainder: the result takes the divisor's sign.
__device__ __forceinline__ double remainder_f64(double a, double b) {
  double m = fmod(a, b);
  if (m != 0.0 && ((b < 0.0) != (m < 0.0))) m = __dadd_rn(m, b);
  return m;
}

// Window starts as `jax.lax.dynamic_slice` clamps them: a negative one counts
// from the end, then the window is held inside [0, size - win].
__device__ __forceinline__ int64_t clamp_start(int64_t x, int64_t size,
                                               int64_t win) {
  if (x < 0) x += size;
  if (x < 0) x = 0;
  return x > size - win ? size - win : x;
}

__device__ void epoch_geometry(const SuperblockArgs& a, const RowState& s,
                               int64_t end_sample, bool pilots,
                               Geometry* g) {
  const double step = __dmul_rn(s.f[kCodeFreq], a.inv_fs);
  int64_t bsz = static_cast<int64_t>(
      ceil(__ddiv_rn(__dsub_rn(a.code_len, s.f[kRemCode]), step)));
  if (bsz > a.blk) bsz = a.blk;
  const double shift_f = __ddiv_rn(s.f[kRemCode], step);
  const double shift = floor(shift_f);
  const int64_t win = a.blk + 2 * a.k + 1;
  int64_t start = a.up_margin - a.k + static_cast<int64_t>(shift);
  g->alpha = __double2float_rn(__dsub_rn(shift_f, shift));
  g->pstart = 0;
  g->palpha = 0.f;
  if (pilots) {
    int64_t pstart = start;
    g->palpha = g->alpha;
    if (a.pilot_period_mod > 1) {
      // long pilot: the window advances one code period per epoch within
      // the full-period table, whose chip -> index map is the build-time
      // step's (code_freq_basis), not the live DLL rate's
      const double pshift_f = __ddiv_rn(
          __dadd_rn(s.f[kRemCode],
                    __dmul_rn(static_cast<double>(s.pilot_period),
                              a.code_len)),
          __dmul_rn(s.f[kCodeFreqBasis], a.inv_fs));
      const double pshift = floor(pshift_f);
      g->palpha = __double2float_rn(__dsub_rn(pshift_f, pshift));
      pstart = a.up_margin - a.k + static_cast<int64_t>(pshift);
    }
    g->pstart = clamp_start(pstart, a.ptable_len, win);
  }
  g->start = clamp_start(start, a.table_len, win);
  g->blksize = bsz;
  g->step = step;
  g->inc = __dmul_rn(__dmul_rn(a.two_pi, s.f[kCarrFreq]), a.inv_fs);
  const double inc_c = __dmul_rn(s.f[kCarrFreq], a.inv_fs);
  g->shi = __double2float_rn(remainder_f64(__dmul_rn(inc_c, 128.0), 1.0));
  g->slo = __double2float_rn(remainder_f64(inc_c, 1.0));
  g->remc = __double2float_rn(
      remainder_f64(__dmul_rn(s.f[kRemCarr], a.inv_two_pi), 1.0));
  // i64 offsets: an i32 one would overflow past ~115 s of an 18 Msps record
  g->off = clamp_start(s.abs_sample - a.sb_start, a.n_samples, a.blk);
  g->valid = s.active && s.abs_sample + a.blk <= end_sample;
}

// atan Costas discriminator [cycles], f32.
__device__ __forceinline__ float costas(const SuperblockArgs& a, float i_p,
                                        float q_p) {
  return __fmul_rn(atanf(__fdiv_rn(q_p, __fadd_rn(i_p, a.eps))),
                   a.inv_two_pi_f);
}

// Normalised early-minus-late envelope discriminator, f32.
__device__ __forceinline__ float early_late(const SuperblockArgs& a,
                                            float i_e, float q_e, float i_l,
                                            float q_l) {
  const float env_e =
      __fsqrt_rn(__fadd_rn(__fmul_rn(i_e, i_e), __fmul_rn(q_e, q_e)));
  const float env_l =
      __fsqrt_rn(__fadd_rn(__fmul_rn(i_l, i_l), __fmul_rn(q_l, q_l)));
  return __fdiv_rn(__fsub_rn(env_e, env_l),
                   __fadd_rn(__fadd_rn(env_e, env_l), a.eps));
}

// Discriminators, loop filters and the state update of one valid epoch
// (`_close_epoch` of tracking/engine.py); `sums` are the twelve columns of
// the correlator's output row.  Writes the f32 loop outputs (code_err,
// code_nco, carr_err, carr_nco) to `loop`.
__device__ void close_epoch(const SuperblockArgs& a, const Geometry& g,
                            const float* sums, bool pilots, RowState* s,
                            float* loop) {
  const double bsf = static_cast<double>(g.blksize);
  const double rem_code = __dsub_rn(
      __dadd_rn(s->f[kRemCode], __dmul_rn(bsf, g.step)), a.code_len);
  const double rem_carr = remainder_f64(
      __dadd_rn(s->f[kRemCarr], __dmul_rn(g.inc, bsf)), a.two_pi);

  float carr_err_f = costas(a, sums[2], sums[3]);
  float code_err_f = early_late(a, sums[0], sums[1], sums[4], sums[5]);
  if (pilots) {
    const float pcarr = costas(a, sums[8], sums[9]);
    carr_err_f = __fadd_rn(__fmul_rn(a.data_weight, carr_err_f),
                           __fmul_rn(a.pilot_weight, pcarr));
    const float p_err = early_late(a, sums[6], sums[7], sums[10], sums[11]);
    code_err_f = __fmul_rn(
        a.dll_scale, __fadd_rn(__fmul_rn(a.dll_data_weight, code_err_f),
                               __fmul_rn(a.dll_pilot_weight, p_err)));
  }
  const double carr_err = static_cast<double>(carr_err_f);
  const double code_err = static_cast<double>(code_err_f);

  double d_carr = s->f[kDCarr];
  double d2_carr = s->f[kD2Carr];
  double carr_nco;
  if (a.pll_order == 3) {
    d2_carr = __dadd_rn(d2_carr, __dmul_rn(carr_err, a.pf3));
    d_carr = __dadd_rn(__dadd_rn(d2_carr, __dmul_rn(carr_err, a.pf2)),
                       d_carr);
    carr_nco = __dadd_rn(d_carr, __dmul_rn(carr_err, a.pf1));
  } else {
    carr_nco = __dadd_rn(
        __dadd_rn(s->f[kCarrNco],
                  __dmul_rn(a.carr_a, __dsub_rn(carr_err, s->f[kCarrErr]))),
        __dmul_rn(carr_err, a.carr_b));
  }
  const double code_nco = __dadd_rn(
      __dadd_rn(s->f[kCodeNco],
                __dmul_rn(a.code_a, __dsub_rn(code_err, s->f[kCodeErr]))),
      __dmul_rn(code_err, a.code_b));

  loop[0] = code_err_f;
  loop[1] = __double2float_rn(code_nco);
  loop[2] = carr_err_f;
  loop[3] = __double2float_rn(carr_nco);

  s->f[kCarrFreq] = __dadd_rn(s->f[kCarrFreqBasis], carr_nco);
  s->f[kCodeFreq] = __dsub_rn(s->f[kCodeFreqBasis], code_nco);
  s->f[kRemCode] = rem_code;
  s->f[kRemCarr] = rem_carr;
  s->f[kCarrNco] = carr_nco;
  s->f[kCarrErr] = carr_err;
  s->f[kCodeNco] = code_nco;
  s->f[kCodeErr] = code_err;
  s->f[kDCarr] = d_carr;
  s->f[kD2Carr] = d2_carr;
  s->abs_sample += g.blksize;
  if (a.pilot_period_mod > 1) {
    // pilot_period + 1 is positive, so % is torch.remainder
    s->pilot_period = (s->pilot_period + 1) % a.pilot_period_mod;
  }
}

// The output rows of one epoch: the state BEFORE the update, and the sums and
// the loop outputs times `valid`.
__device__ void write_epoch(const SuperblockArgs& a, int c, int e,
                            const RowState& before, const Geometry& g,
                            const float* sums, const float* loop,
                            bool pilots) {
  const int64_t n_rows = a.n_rows;
  const float v = g.valid ? 1.f : 0.f;
  float* o32 = a.o32 + (static_cast<int64_t>(e) * 12) * n_rows + c;
  for (int j = 0; j < 6; ++j) o32[j * n_rows] = __fmul_rn(sums[j], v);
  // rows 6, 7: the pilot prompt pair, or zeros without a pilot bank
  o32[6 * n_rows] = __fmul_rn(pilots ? sums[8] : 0.f, v);
  o32[7 * n_rows] = __fmul_rn(pilots ? sums[9] : 0.f, v);
  for (int j = 0; j < 4; ++j) o32[(8 + j) * n_rows] = __fmul_rn(loop[j], v);
  double* o64 = a.o64 + (static_cast<int64_t>(e) * 4) * n_rows + c;
  o64[0] = before.f[kCarrFreq];
  o64[n_rows] = before.f[kCodeFreq];
  o64[2 * n_rows] = before.f[kRemCode];
  o64[3 * n_rows] = before.f[kRemCarr];
  int64_t* oi = a.oi + (static_cast<int64_t>(e) * 2) * n_rows + c;
  oi[0] = before.abs_sample;
  oi[n_rows] = g.valid ? g.blksize : 0;
}

template <bool kInterp, int kPilots, bool kCluster>
__global__ void __launch_bounds__(kThreads)
track_superblock_kernel(const SuperblockArgs a) {
  constexpr int kSums = sums_of(kPilots);
  extern __shared__ float smem[];
  __shared__ float part[kWarps][kSums];
  __shared__ float tot[2][kSums];     // by epoch parity (see the cluster)
  __shared__ float sums[12];          // the output row's twelve columns
  __shared__ RowState st;
  __shared__ Geometry geo;

  int n_ranks = 1;
  int rank = 0;
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    n_ranks = static_cast<int>(cluster.num_blocks());
    rank = static_cast<int>(cluster.block_rank());
  }
  const int c = blockIdx.x / n_ranks;
  const int64_t end_sample = a.end_sample[c];
  const int64_t wrow = c % a.n_table_rows;
  const int8_t* __restrict__ table = a.table + wrow * a.table_len;
  const int8_t* ptable = nullptr;
  if constexpr (kPilots > 0)
    ptable = a.ptable + wrow * (kPilots * a.ptable_len);

  if (threadIdx.x == 0) {
    for (int j = 0; j < kFields; ++j)
      st.f[j] = a.state_in[static_cast<int64_t>(j) * a.n_rows + c];
    st.abs_sample = a.abs_in[c];
    st.pilot_period = a.pper_in[c];
    st.active = a.active_in[c] != 0;
    epoch_geometry(a, st, end_sample, kPilots > 0, &geo);
  }
  __syncthreads();

  for (int e = 0; e < a.n_epochs; ++e) {
    // every thread reads this epoch's geometry before thread 0 replaces it
    // (after the reduction's barriers)
    const bool valid = geo.valid;
    if (!valid) {
      // absorbing: the state is frozen, so every remaining epoch writes the
      // same rows and the loop needs no further barrier
      if (threadIdx.x == 0) {
        st.active = 0;
        const float zeros[12] = {};
        for (; rank == 0 && e < a.n_epochs; ++e)
          write_epoch(a, c, e, st, geo, zeros, zeros, kPilots > 0);
      }
      break;
    }
    const int n_valid =
        geo.blksize < 0 ? 0 : static_cast<int>(geo.blksize);
    const char2* __restrict__ x =
        reinterpret_cast<const char2*>(a.iq) + geo.off;
    const int8_t* __restrict__ w = table + geo.start;
    const int8_t* pw0 = nullptr;
    const int8_t* pw1 = nullptr;
    if constexpr (kPilots > 0) {
      pw0 = ptable + geo.pstart;
      if constexpr (kPilots > 1) pw1 = pw0 + a.ptable_len;
    }
    const float alpha = geo.alpha;
    const float palpha = geo.palpha;
    // the carrier's arrays are rebuilt in place: every thread is past its
    // reads of the previous epoch's (they end before the reduction)
    const UvCarrier carrier(smem, a.blk, geo.remc, geo.shi, geo.slo);

    // this block's slice of the epoch's samples (all of them without a
    // cluster), in chunks of whole 128-sample carrier steps
    int n_begin = 0;
    int n_end = n_valid;
    if constexpr (kCluster) {
      const int chunk = ((n_valid + n_ranks - 1) / n_ranks + 127) & ~127;
      n_begin = min(rank * chunk, n_valid);
      n_end = min(n_begin + chunk, n_valid);
    }
    float acc[kSums];
#pragma unroll
    for (int j = 0; j < kSums; ++j) acc[j] = 0.f;
    accumulate_row<kInterp, kPilots>(x, w, pw0, pw1, alpha, palpha, n_begin,
                                     n_end, a.k, carrier, acc);
    float* mine = tot[e & 1];
    reduce_block<kSums>(acc, part, mine);
    if constexpr (kCluster) {
      // the blocks' totals in rank order, each block for itself.  A block
      // writes tot[e & 1] again in epoch e + 2, past the sync of epoch
      // e + 1, which no block reaches before it has read epoch e's totals.
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      if (threadIdx.x < kSums) {
        float v = 0.f;
        for (int r = 0; r < n_ranks; ++r)
          v += cluster.map_shared_rank(mine, r)[threadIdx.x];
        part[0][threadIdx.x] = v;
      }
      __syncthreads();
      mine = part[0];
    }
    if (threadIdx.x < 12)
      sums[threadIdx.x] = output_sum<kPilots>(mine, threadIdx.x, a.pilot_rot,
                                              a.pilot2_rot, a.w1, a.w2);
    __syncthreads();
    if (threadIdx.x == 0) {
      const RowState before = st;
      float loop[4];
      close_epoch(a, geo, sums, kPilots > 0, &st, loop);
      if (rank == 0)
        write_epoch(a, c, e, before, geo, sums, loop, kPilots > 0);
      epoch_geometry(a, st, end_sample, kPilots > 0, &geo);
    }
    __syncthreads();
  }

  if constexpr (kCluster) {
    // no block leaves while another may still read its totals
    cg::this_cluster().sync();
  }
  if (threadIdx.x == 0 && rank == 0) {
    // thread 0 wrote the state itself, last at the final epoch's closing
    // or at the break
    for (int j = 0; j < kFields; ++j)
      a.state_out[static_cast<int64_t>(j) * a.n_rows + c] = st.f[j];
    a.abs_out[c] = st.abs_sample;
    a.pper_out[c] = st.pilot_period;
    a.active_out[c] = st.active ? 1 : 0;
  }
}

template <bool kInterp, int kPilots>
cudaError_t launch(const SuperblockArgs& a, int cluster, cudaStream_t s) {
  const size_t smem = uv_smem_bytes(a.blk);
  if (cluster <= 1) {
    track_superblock_kernel<kInterp, kPilots, false>
        <<<a.n_rows, kThreads, smem, s>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_rows * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, track_superblock_kernel<kInterp, kPilots, true>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// The size of SuperblockArgs, for the caller to hold its mirror to.
extern "C" int track_superblock_args_size() {
  return static_cast<int>(sizeof(SuperblockArgs));
}

// `cluster` blocks per channel row (1, 2, 4 or 8); `args->ptable` is ignored
// (and may be null) when n_pilots == 0.
extern "C" int track_superblock_launch(const SuperblockArgs* args,
                                       int interp_taps, int n_pilots,
                                       int cluster, void* stream) {
  if (cluster < 1 || cluster > 8 || (cluster & (cluster - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n_pilots * 2 + (interp_taps ? 1 : 0)) {
    case 0: err = launch<false, 0>(*args, cluster, s); break;
    case 1: err = launch<true, 0>(*args, cluster, s); break;
    case 2: err = launch<false, 1>(*args, cluster, s); break;
    case 3: err = launch<true, 1>(*args, cluster, s); break;
    case 4: err = launch<false, 2>(*args, cluster, s); break;
    case 5: err = launch<true, 2>(*args, cluster, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
