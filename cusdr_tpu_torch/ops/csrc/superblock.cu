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
// The record's sample type picks the instantiation: `track_superblock_launch`
// reads int8 I/Q (char2), `track_superblock_launch_int16` int16 I/Q (short2);
// the arithmetic after the conversion to f32 is the same.
//
// No tensor cores and no TMA: the work is int8 or int16 loads and f32 FMAs
// on a 1-D stream, 33-75 operations per sample, with no matrix product in
// it.  The
// geometry, the closing and the output rows are superblock_common.cuh's,
// shared with superblock_staged.cu.

#include <cooperative_groups.h>

#include "superblock_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace cusdr;

template <bool kInterp, int kPilots, bool kCluster, class Sample>
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
    const Sample* __restrict__ x =
        static_cast<const Sample*>(a.iq) + geo.off;
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

template <bool kInterp, int kPilots, class Sample>
cudaError_t launch(const SuperblockArgs& a, int cluster, cudaStream_t s) {
  const size_t smem = uv_smem_bytes(a.blk);
  if (cluster <= 1) {
    track_superblock_kernel<kInterp, kPilots, false, Sample>
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
      &cfg, track_superblock_kernel<kInterp, kPilots, true, Sample>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// `cluster` blocks per channel row (1, 2, 4 or 8); `args->ptable` is ignored
// (and may be null) when n_pilots == 0.
template <class Sample>
int launch_superblock(const SuperblockArgs* args, int interp_taps,
                      int n_pilots, int cluster, void* stream) {
  if (cluster < 1 || cluster > 8 || (cluster & (cluster - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n_pilots * 2 + (interp_taps ? 1 : 0)) {
    case 0: err = launch<false, 0, Sample>(*args, cluster, s); break;
    case 1: err = launch<true, 0, Sample>(*args, cluster, s); break;
    case 2: err = launch<false, 1, Sample>(*args, cluster, s); break;
    case 3: err = launch<true, 1, Sample>(*args, cluster, s); break;
    case 4: err = launch<false, 2, Sample>(*args, cluster, s); break;
    case 5: err = launch<true, 2, Sample>(*args, cluster, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // namespace

// The size of SuperblockArgs, for the caller to hold its mirror to.
extern "C" int track_superblock_args_size() {
  return static_cast<int>(sizeof(SuperblockArgs));
}

// An int8 record.
extern "C" int track_superblock_launch(const SuperblockArgs* args,
                                       int interp_taps, int n_pilots,
                                       int cluster, void* stream) {
  return launch_superblock<char2>(args, interp_taps, n_pilots, cluster,
                                  stream);
}

// An int16 record.
extern "C" int track_superblock_launch_int16(const SuperblockArgs* args,
                                             int interp_taps, int n_pilots,
                                             int cluster, void* stream) {
  return launch_superblock<short2>(args, interp_taps, n_pilots, cluster,
                                   stream);
}
