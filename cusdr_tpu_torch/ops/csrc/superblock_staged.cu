// Staged superblock tracking kernel for a channel bank (Hopper, sm_90a): one
// launch tracks every channel row through every epoch of a superblock, and
// each epoch's sample and replica windows are staged into shared memory by
// asynchronous bulk copies (`cp.async.bulk` with mbarriers) that run ahead
// of the arithmetic and across the loop closing.
//
// It is the redesign for this card of the staged-window correlator of
// correlator_staged.cu (`correlate_windows_launch`), which replaces the TPU
// kernel `correlate_bank` of cusdr_tpu/ops/correlator.py (Pallas call built
// by `_build_call`, body `_correlate_block`: windows staged into fast memory
// before the kernel runs), in all three of its variants (no pilot, pilot
// including the L2C CL long pilot, dual pilot) and both tap modes, together
// with the loop the reference runs around it: the `lax.scan` over epochs of
// `track_superblock` (cusdr_tpu/tracking/engine.py).  Its plain version is
// the port's eager epoch loop on staged windows, `track_superblock_epochs`
// with `fetch_in_kernel=False` (tracking/engine.py: per epoch
// `stage_windows`, one `correlate_windows` launch and `_close_epoch`).
//
// What bounds the eager staged loop on an H100 is the path around its
// kernel: per epoch a PyTorch gather of C x blk samples, one launch and
// about a hundred small launches for the closing, 1.1-1.7 ms of host time
// against ~0.02 ms of device time.  The design:
//
//   * one thread block (or one thread-block cluster) owns one channel row
//     for the whole superblock and closes its loops as superblock.cu does,
//     with the same code (superblock_common.cuh): thread 0 computes each
//     epoch's geometry, closes the epoch from the totals and writes its
//     outputs;
//   * the TPU kernel's "staged into fast memory" is a ring of `n_stages`
//     stages in dynamic shared memory.  A stage holds a chunk of `chunk`
//     samples of the epoch's window and the replica bytes the taps of those
//     samples read, one buffer per bank.  With one block per row `chunk` is
//     a multiple of the 512 threads, so thread t still sums samples t,
//     t + 512, ... in the order of `accumulate_row` and the sums are the
//     per-epoch kernels' to the bit (a cluster's slices are whole 128-sample
//     carrier steps).  Lane 0 of warp 1 is the producer: it fills a stage
//     with one bulk copy per buffer and arms the stage's "full" mbarrier
//     with the byte count; the block waits on it and accumulates, and each
//     warp arrives on the stage's "empty" mbarrier, which the producer waits
//     on before it fills the stage again.  The wrapper's stage plan takes
//     the fewest chunks per epoch that fit twice in shared memory (one,
//     where it can): the producer then works only while thread 0 closes;
//   * prefetch across the closing: epoch e + 1's sample window starts at
//     abs_sample + blksize, known from epoch e's geometry, and epoch e + 2's
//     within two samples of abs_sample + 2 blksize (a block size moves by a
//     sample at most from epoch to epoch), so while thread 0 closes epoch e
//     the producer copies epoch e + 1's chunks and those of e + 2 that fit.
//     The replica windows start at up_margin - k + shift, and shift is 0 or
//     1 once rem_code_phase is below one code-phase step (the long pilot
//     adds whole samples of a period known before the closing too): the
//     producer copies the superset of the starts shift - 1 .. shift + 2.
//     Every stage records the ranges it holds; a chunk whose exact windows
//     fall outside them is read from device memory instead (the slow path:
//     the same arithmetic on the same bytes, counted per row in `slow`);
//   * bulk copies need 16-byte aligned addresses and sizes: a buffer holds
//     the aligned superset of its range and is indexed from the offset
//     inside it.  No copy reads past its tensor: bytes of a tensor's last,
//     partial 16 are copied by the producer with plain loads;
//   * with a cluster of S blocks per row, block r streams the r-th run of
//     the epoch's chunks through its own ring, and the blocks exchange their
//     totals through distributed shared memory, double buffered by epoch
//     parity, as in superblock.cu.
//
// The record's sample type picks the instantiation:
// `track_superblock_staged_launch` stages int8 I/Q (char2, 2 bytes a
// sample), `track_superblock_staged_launch_int16` int16 I/Q (short2, 4
// bytes); the stage plan's sample buffers are sized for it.
//
// What bounds it: per row and epoch 2 bytes per sample (4 of an int16
// record) and 1 per sample and replica bank come from device memory (the rows of a bank read nearly the
// same stretch of the record, which the L2 cache holds) against 33-75 f32
// operations per sample, and the serial closing (a few microseconds of
// dependent f64 arithmetic on one thread) per epoch, under which the next
// epoch's copies run.  No tensor cores: there is no matrix product.

#include <cooperative_groups.h>

#include "bulk_copy.cuh"
#include "superblock_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace cusdr;

constexpr int kMaxStages = 8;
constexpr int kBuffers = 4;          // samples and up to three replica banks
// the prefetch copies the replica starts from the predicted one less
// kSpreadLo to the predicted one plus kSpreadHi
constexpr int kSpreadLo = 1;
constexpr int kSpreadHi = 2;
// and the sample window's start two epochs ahead within +-2 samples
constexpr int kSampleSpread = 4;
// the producer: lane 0 of warp 1, so that it issues while thread 0 closes
constexpr int kProducer = 32;

// The ring's layout: the wrapper's stage plan (`stage_plan` of
// ops/correlator.py).  Byte counts are multiples of 16.
struct StagePlan {
  int chunk;        // samples per stage, a multiple of kThreads
  int n_stages;     // stages in the ring, 2 .. kMaxStages
  int per_rank;     // chunks of an epoch per block
  int samp_bytes;   // a stage's sample buffer
  int rep_bytes;    // a stage's buffer per replica bank
  int uv_bytes;     // the carrier factors, ahead of the ring
};

// What a stage holds, per buffer (samples, then the banks): the offset in
// its tensor of the buffer's first byte, and the byte range [x0, x1) the
// producer was asked for.
struct StageMeta {
  int64_t lo[kBuffers];
  int64_t x0[kBuffers];
  int64_t x1[kBuffers];
};

// Where an epoch's chunks are copied from: the least and the greatest start
// of the sample window in the record and, per replica bank, of its window
// in the bank's table row.
struct Window {
  int64_t off_lo, off_hi;
  int64_t lo[kBuffers - 1];
  int64_t hi[kBuffers - 1];
};

// Epoch e + `ahead`'s windows (ahead 0, 1 or 2) from epoch e's state `s`
// and geometry `g`, before epoch e is closed.  Ahead 0: the geometry's.
// The sample window advances by blksize per epoch: exactly for the next
// epoch (e is valid), and by blksize again, give or take kSampleSpread / 2
// samples, for the one after (a block size moves by a sample at most from
// one epoch to the next).  The replica starts: a range around the shift of
// 0, the long pilot's period `ahead` periods on.
template <int kPilots>
__device__ Window ahead_window(const SuperblockArgs& a, const RowState& s,
                               const Geometry& g, int ahead) {
  Window w;
  if (ahead == 0) {
    w.off_lo = w.off_hi = g.off;
    w.lo[0] = w.hi[0] = g.start;
    for (int b = 1; b <= kPilots; ++b) w.lo[b] = w.hi[b] = g.pstart;
    return w;
  }
  const int64_t off = clamp_start(
      s.abs_sample + ahead * g.blksize - a.sb_start, a.n_samples, a.blk);
  const int64_t spread = ahead > 1 ? kSampleSpread / 2 : 0;
  w.off_lo = max(off - spread, int64_t{0});
  w.off_hi = min(off + spread, a.n_samples - a.blk);
  const int64_t win = a.blk + 2 * a.k + 1;
  const int64_t base = a.up_margin - a.k;
  w.lo[0] = clamp_start(base - kSpreadLo, a.table_len, win);
  w.hi[0] = clamp_start(base + kSpreadHi, a.table_len, win);
  if constexpr (kPilots > 0) {
    int64_t pbase = base;
    if (a.pilot_period_mod > 1) {
      // that period's whole samples on the table's build-time grid
      const int period = (s.pilot_period + ahead) % a.pilot_period_mod;
      pbase += static_cast<int64_t>(floor(__ddiv_rn(
          __dmul_rn(static_cast<double>(period), a.code_len),
          __dmul_rn(s.f[kCodeFreqBasis], a.inv_fs))));
    }
    const int64_t lo = clamp_start(pbase - kSpreadLo, a.ptable_len, win);
    const int64_t hi = clamp_start(pbase + kSpreadHi, a.ptable_len, win);
    for (int b = 1; b <= kPilots; ++b) {
      w.lo[b] = lo;
      w.hi[b] = hi;
    }
  }
  return w;
}

// Fill stage q % n_stages with chunk q of this block (the producer only;
// the stage is free).  Chunk q is the (q % per_rank)-th of the block's run in
// epoch q / per_rank; its samples are [n0, n1) of the window, clipped to
// the window's blk samples.  Bit s of `tailed` is set while stage s holds
// bytes the producer stored itself.
template <int kPilots, class Sample>
__device__ void issue_chunk(const SuperblockArgs& a, const StagePlan& p,
                            int rank, int64_t wrow, int q, const Window& win,
                            uint8_t* ring, StageMeta* meta, uint64_t* full,
                            uint32_t& tailed) {
  constexpr int kBufs = 1 + 1 + kPilots;
  const int s = q % p.n_stages;
  uint8_t* stage = ring + static_cast<int64_t>(s) *
                              (p.samp_bytes + (1 + kPilots) * p.rep_bytes);
  const int64_t n0 =
      static_cast<int64_t>(rank * p.per_rank + q % p.per_rank) * p.chunk;
  const int64_t n1 = min(n0 + p.chunk, static_cast<int64_t>(a.blk));
  const int8_t* src[kBufs];
  uint8_t* dst[kBufs];
  int64_t x0[kBufs], x1[kBufs], size[kBufs];
  constexpr int64_t kSampleBytes = sizeof(Sample);
  src[0] = static_cast<const int8_t*>(a.iq);
  dst[0] = stage;
  size[0] = kSampleBytes * a.n_samples;
  x0[0] = kSampleBytes * (win.off_lo + n0);
  x1[0] = kSampleBytes * (win.off_hi + n1);
  for (int b = 0; b <= kPilots; ++b) {
    const bool data = b == 0;
    const int64_t row = data ? wrow * a.table_len
                             : (wrow * kPilots + b - 1) * a.ptable_len;
    src[b + 1] = data ? a.table : a.ptable;
    dst[b + 1] = stage + p.samp_bytes + b * p.rep_bytes;
    size[b + 1] = data ? a.n_table_rows * a.table_len
                       : a.n_table_rows * kPilots * a.ptable_len;
    // the taps of samples [n0, n1) read [start + n0, start + n1 + 2k + 1)
    x0[b + 1] = row + win.lo[b] + n0;
    x1[b + 1] = row + win.hi[b] + n1 + 2 * a.k + 1;
  }
  uint32_t tx = 0;
  int64_t lo[kBufs], bulk[kBufs];
  // stores of the producer into this stage come before bulk copies into it
  // (the consumers' reads need no fence: the mbarriers order them)
  if (tailed >> s & 1u)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  tailed &= ~(1u << s);
  for (int i = 0; i < kBufs; ++i) {
    if (n0 >= n1) x0[i] = x1[i] = 0;           // past the window: nothing
    lo[i] = x0[i] & ~int64_t{15};
    int64_t hi = min((x1[i] + 15) & ~int64_t{15}, size[i] & ~int64_t{15});
    if (hi < lo[i]) hi = lo[i];
    bulk[i] = hi - lo[i];
    tx += static_cast<uint32_t>(bulk[i]);
    // the tensor's last bytes off the 16-byte grid, by plain loads
    for (int64_t t = hi; t < x1[i]; ++t) {
      dst[i][t - lo[i]] = static_cast<uint8_t>(src[i][t]);
      tailed |= 1u << s;
    }
    meta[s].lo[i] = lo[i];
    meta[s].x0[i] = x0[i];
    meta[s].x1[i] = x1[i];
  }
  bar_arrive_tx(&full[s], tx);
  for (int i = 0; i < kBufs; ++i)
    if (bulk[i] > 0)
      bulk_copy(dst[i], src[i] + lo[i], static_cast<uint32_t>(bulk[i]),
                &full[s]);
}

// The producer's step: issue chunks `issued`, `issued` + 1, ... below
// `limit` that belong to epoch `known` (geometry `g`, state `s`) or to one
// of the next two (predicted), each once its stage is free.  Returns the
// new `issued`.
template <int kPilots, class Sample>
__device__ int produce(const SuperblockArgs& a, const StagePlan& p, int rank,
                       int64_t wrow, int known, const RowState& s,
                       const Geometry& g, int issued, int limit,
                       uint8_t* ring, StageMeta* meta, uint64_t* full,
                       uint64_t* empty, uint32_t& tailed) {
  if (!g.valid) return issued;      // the row correlates no more
  limit = min(limit, min(a.n_epochs, known + 3) * p.per_rank);
  for (; issued < limit; ++issued) {
    if (issued >= p.n_stages)       // the stage's last chunk is consumed
      bar_wait(&empty[issued % p.n_stages],
               (issued / p.n_stages - 1) & 1);
    const Window w =
        ahead_window<kPilots>(a, s, g, issued / p.per_rank - known);
    issue_chunk<kPilots, Sample>(a, p, rank, wrow, issued, w, ring, meta,
                                 full, tailed);
  }
  return issued;
}

template <bool kInterp, int kPilots, bool kCluster, class Sample>
__global__ void __launch_bounds__(kThreads)
track_superblock_staged_kernel(const SuperblockArgs a, const StagePlan p,
                               int* __restrict__ slow) {
  constexpr int kSums = sums_of(kPilots);
  constexpr int64_t kSampleBytes = sizeof(Sample);
  extern __shared__ __align__(128) uint8_t dyn[];
  __shared__ float part[kWarps][kSums];
  __shared__ float tot[2][kSums];     // by epoch parity (see the cluster)
  __shared__ float sums[12];          // the output row's twelve columns
  __shared__ RowState st;
  __shared__ Geometry geo;
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  __shared__ StageMeta meta[kMaxStages];

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
  float* uv = reinterpret_cast<float*>(dyn);
  uint8_t* ring = dyn + p.uv_bytes;
  const int stage_bytes = p.samp_bytes + (1 + kPilots) * p.rep_bytes;
  int issued = 0;         // chunks issued (the producer)
  uint32_t tailed = 0;    // stages holding the producer's own stores
  int slow_epochs = 0;    // epochs with a chunk read from device memory

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.n_stages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int j = 0; j < kFields; ++j)
      st.f[j] = a.state_in[static_cast<int64_t>(j) * a.n_rows + c];
    st.abs_sample = a.abs_in[c];
    st.pilot_period = a.pper_in[c];
    st.active = a.active_in[c] != 0;
    epoch_geometry(a, st, end_sample, kPilots > 0, &geo);
  }
  __syncthreads();
  if (threadIdx.x == kProducer)
    issued = produce<kPilots, Sample>(a, p, rank, wrow, 0, st, geo, 0,
                                      p.n_stages, ring, meta, full, empty,
                                      tailed);

  int q = 0;              // chunks consumed
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
    const int64_t off = geo.off;
    const int64_t start = geo.start;
    const int64_t pstart = geo.pstart;
    const float alpha = geo.alpha;
    const float palpha = geo.palpha;
    // the slow path's windows in device memory, as superblock.cu reads them
    const Sample* __restrict__ x = static_cast<const Sample*>(a.iq) + off;
    const int8_t* __restrict__ w = table + start;
    const int8_t* pw0 = nullptr;
    const int8_t* pw1 = nullptr;
    if constexpr (kPilots > 0) {
      pw0 = ptable + pstart;
      if constexpr (kPilots > 1) pw1 = pw0 + a.ptable_len;
    }
    // the carrier's arrays are rebuilt in place: every thread is past its
    // reads of the previous epoch's (they end before the reduction)
    const UvCarrier carrier(uv, a.blk, geo.remc, geo.shi, geo.slo);

    float acc[kSums];
#pragma unroll
    for (int j = 0; j < kSums; ++j) acc[j] = 0.f;
    bool slow_epoch = false;
    for (int j = 0; j < p.per_rank; ++j, ++q) {
      const int s = q % p.n_stages;
      bar_wait(&full[s], (q / p.n_stages) & 1);
      const int n0 = (rank * p.per_rank + j) * p.chunk;
      const int n1 = min(n0 + p.chunk, n_valid);
      if (n0 < n1) {
        // the bytes this chunk's samples and taps read, in each tensor
        const StageMeta& m = meta[s];
        const int64_t span = n1 - n0 + 2 * a.k + 1;
        int64_t need[kBuffers];
        need[0] = kSampleBytes * (off + n0);
        need[1] = wrow * a.table_len + start + n0;
        bool held = need[0] >= m.x0[0] &&
                    kSampleBytes * (off + n1) <= m.x1[0] &&
                    need[1] >= m.x0[1] && need[1] + span <= m.x1[1];
#pragma unroll
        for (int b = 0; b < kPilots; ++b) {
          need[2 + b] = (wrow * kPilots + b) * a.ptable_len + pstart + n0;
          held = held && need[2 + b] >= m.x0[2 + b] &&
                 need[2 + b] + span <= m.x1[2 + b];
        }
        if (held) {
          const uint8_t* stage = ring + static_cast<int64_t>(s) * stage_bytes;
          const Sample* xs =
              reinterpret_cast<const Sample*>(stage + (need[0] - m.lo[0]));
          const int8_t* ws = reinterpret_cast<const int8_t*>(
              stage + p.samp_bytes + (need[1] - m.lo[1]));
          const int8_t* ps[2] = {nullptr, nullptr};
#pragma unroll
          for (int b = 0; b < kPilots; ++b)
            ps[b] = reinterpret_cast<const int8_t*>(
                stage + p.samp_bytes + (b + 1) * p.rep_bytes +
                (need[2 + b] - m.lo[2 + b]));
          accumulate_row<kInterp, kPilots>(xs, ws, ps[0], ps[1], alpha,
                                           palpha, n0, n1, a.k, carrier,
                                           acc, n0);
        } else {
          slow_epoch = true;
          accumulate_row<kInterp, kPilots>(x, w, pw0, pw1, alpha, palpha,
                                           n0, n1, a.k, carrier, acc);
        }
      }
      __syncwarp();
      if ((threadIdx.x & 31) == 0) bar_arrive(&empty[s]);
      // refill the stage freed one chunk ago (its other warps are done)
      if (threadIdx.x == kProducer)
        issued = produce<kPilots, Sample>(a, p, rank, wrow, e, st, geo,
                                          issued, q + p.n_stages, ring, meta,
                                          full, empty, tailed);
    }

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
    // the producer's copy of epoch e's state and geometry, which thread 0
    // replaces past the barrier
    RowState snap;
    Geometry snap_geo;
    if (threadIdx.x == kProducer) {
      snap = st;
      snap_geo = geo;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      slow_epochs += slow_epoch ? 1 : 0;
      const RowState before = st;
      float loop[4];
      close_epoch(a, geo, sums, kPilots > 0, &st, loop);
      if (rank == 0)
        write_epoch(a, c, e, before, geo, sums, loop, kPilots > 0);
      epoch_geometry(a, st, end_sample, kPilots > 0, &geo);
    } else if (threadIdx.x == kProducer) {
      // every stage is free: while thread 0 closes, fill the ring with the
      // next epoch's chunks and those of the one after it
      issued = produce<kPilots, Sample>(a, p, rank, wrow, e, snap, snap_geo,
                                        issued, q + p.n_stages, ring, meta,
                                        full, empty, tailed);
    }
    __syncthreads();
  }

  if (threadIdx.x == kProducer) {
    // no block leaves with copies into its shared memory in flight
    for (; q < issued; ++q) bar_wait(&full[q % p.n_stages],
                                     (q / p.n_stages) & 1);
  }
  if (threadIdx.x == 0 && slow_epochs) atomicAdd(slow + c, slow_epochs);
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
cudaError_t launch(const SuperblockArgs& a, const StagePlan& p, int cluster,
                   int* slow, cudaStream_t s) {
  const size_t smem =
      p.uv_bytes + static_cast<size_t>(p.n_stages) *
                       (p.samp_bytes + (1 + kPilots) * p.rep_bytes);
  auto kernel =
      cluster <= 1
          ? track_superblock_staged_kernel<kInterp, kPilots, false, Sample>
          : track_superblock_staged_kernel<kInterp, kPilots, true, Sample>;
  // above 48 KB only after opting in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (cluster <= 1) {
    kernel<<<a.n_rows, kThreads, smem, s>>>(a, p, slow);
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
  err = cudaLaunchKernelEx(&cfg, kernel, a, p, slow);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// `cluster` blocks per channel row (1, 2, 4 or 8); the stage plan as
// `stage_plan` of ops/correlator.py makes it for this sample type; `slow` [C]
// int32 gets the epochs (summed over a row's blocks) in which a chunk was
// read from device memory.  `args->ptable` is ignored (and may be null) when
// n_pilots == 0.
template <class Sample>
int launch_staged(const SuperblockArgs* args, int interp_taps, int n_pilots,
                  int cluster, int chunk, int n_stages, int per_rank,
                  int samp_bytes, int rep_bytes, int uv_bytes, int* slow,
                  void* stream) {
  // one block per row sums each thread's samples in the per-epoch kernels'
  // order only with chunks of whole block strides; a cluster's slices are
  // whole carrier steps
  if (cluster < 1 || cluster > 8 || (cluster & (cluster - 1)) ||
      n_stages < 2 || n_stages > kMaxStages || chunk <= 0 ||
      chunk % (cluster > 1 ? 128 : kThreads) || per_rank < 1 ||
      samp_bytes % 16 ||
      rep_bytes % 16 || uv_bytes % 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const StagePlan p{chunk, n_stages, per_rank, samp_bytes, rep_bytes,
                    uv_bytes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n_pilots * 2 + (interp_taps ? 1 : 0)) {
    case 0: err = launch<false, 0, Sample>(*args, p, cluster, slow, s); break;
    case 1: err = launch<true, 0, Sample>(*args, p, cluster, slow, s); break;
    case 2: err = launch<false, 1, Sample>(*args, p, cluster, slow, s); break;
    case 3: err = launch<true, 1, Sample>(*args, p, cluster, slow, s); break;
    case 4: err = launch<false, 2, Sample>(*args, p, cluster, slow, s); break;
    case 5: err = launch<true, 2, Sample>(*args, p, cluster, slow, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // namespace

// The size of SuperblockArgs, for the caller to hold its mirror to.
extern "C" int track_superblock_staged_args_size() {
  return static_cast<int>(sizeof(SuperblockArgs));
}

// An int8 record.
extern "C" int track_superblock_staged_launch(
    const SuperblockArgs* args, int interp_taps, int n_pilots, int cluster,
    int chunk, int n_stages, int per_rank, int samp_bytes, int rep_bytes,
    int uv_bytes, int* slow, void* stream) {
  return launch_staged<char2>(args, interp_taps, n_pilots, cluster, chunk,
                              n_stages, per_rank, samp_bytes, rep_bytes,
                              uv_bytes, slow, stream);
}

// An int16 record.
extern "C" int track_superblock_staged_launch_int16(
    const SuperblockArgs* args, int interp_taps, int n_pilots, int cluster,
    int chunk, int n_stages, int per_rank, int samp_bytes, int rep_bytes,
    int uv_bytes, int* slow, void* stream) {
  return launch_staged<short2>(args, interp_taps, n_pilots, cluster, chunk,
                               n_stages, per_rank, samp_bytes, rep_bytes,
                               uv_bytes, slow, stream);
}
