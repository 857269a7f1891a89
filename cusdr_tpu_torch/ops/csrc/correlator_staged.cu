// Epoch correlators on staged windows (Hopper, sm_90a).
//
// Three kernels that take, per channel row, a sample window and replica
// windows that were sliced out of the record and the tables BEFORE the
// launch, and return the six E/P/L x I/Q sums of correlator_common.cuh.
// They differ in how the carrier is made:
//
//   correlate_windows_launch        replaces `correlate_bank` of
//       cusdr_tpu/ops/correlator.py (Pallas call built by `_build_call`,
//       body `_correlate_block`): carrier as u[t] v[l] factors from
//       remc / shi / slo, no pilot, pilot or dual pilot windows, both tap
//       modes.  It is the per-epoch step of the eager loop on staged
//       windows (fetch_in_kernel = False), the CPU's path and the plain
//       version of superblock_staged.cu, which runs the card's.  It takes
//       int8 sample windows, or int16 ones through
//       correlate_windows_launch_int16.
//
// The phase-ramp and table-carrier kernels take int8 windows only: they
// are prototypes that no receiver path runs.
//   correlate_windows_ramp_launch   replaces `make_correlate_kernel` of
//       tools/perf_pallas.py:30: no pilot, interpolated taps, carrier from
//       a per-sample phase remc + shi * floor(n / 256) + slo * (n mod 256)
//       [cycles], cos and sin evaluated per sample.  A thread-block cluster
//       per row (see the note at its kernel below).
//   correlate_windows_table_launch  replaces `make_table_carrier_kernel` of
//       tools/perf_pallas.py: no pilot, interpolated taps, carrier from
//       basis tables: cos = c0 * tc[n] - s0 * ts[n],
//       sin = s0 * tc[n] + c0 * ts[n].
//
// Layout: siq [C, blk, 2] int8 or int16 (I and Q of a sample side by side,
// as the record keeps them, so a sample is one 2- or 4-byte load); wt [C, win] int8 with
// win >= blk + 2k + 1 and tap E of sample 0 at column 0; pilot windows
// [C, kPilots, win]; per-row scalars [C]; tc, ts [C, blk] f32.  blk need not
// be a multiple of anything: there is no channel-block padding and no
// fast-memory budget to fit (B1C's 180 008-sample windows simply run).
//
// What bounds them on an H100: per sample 2 bytes of samples and 1 byte per
// replica window come from device memory (plus 8 bytes of basis tables for
// the table carrier) against about 20 FLOPs (+ 12 per pilot window; the
// ramp carrier adds a sincos per sample).  At 12-96 rows x 18 008 samples
// that is 0.65-5.2 MB (19 MB with basis tables) and 4-35 MFLOP: a few
// microseconds of memory time at most.  The u.v and table kernels run one
// block per row, so the launch and 12-96 of the 132 SMs bound them, as they
// bound correlator.cu.  Their design is that file's: 512-thread blocks,
// every sample touched once with coalesced loads, register accumulators, a
// fixed-order block reduction.
// The staging itself (a gather of C x blk samples in PyTorch before the
// launch) costs more than the kernel; on the card the engine avoids it:
// superblock_staged.cu stages each epoch's windows itself, by bulk copies
// into shared memory, for every epoch of a superblock in one launch.

#include <cooperative_groups.h>

#include "bulk_copy.cuh"
#include "correlator_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace cusdr;

// Per-sample phase ramp cyc = remc + shi * floor(n / 256) + slo * (n mod
// 256) [cycles], and cos and sin of 2 pi cyc.  The phase is the plain
// version's f32 value: its products and sums are rounded one by one (no FMA
// contraction; at phases of up to a few hundred cycles one f32 ulp is 1e-5
// cycles).  `lo(n)` is the last term, which a thread striding through a row
// by a multiple of 256 samples computes once.
//
// cos and sin are evaluated in turns: cyc = q / 4 + r with q the nearest
// integer to 4 cyc (a float add of 1.5 * 2^23 rounds it, and q mod 4 is in
// the sum's low bits) and |r| <= 1/8 exactly, then degree-8 and degree-9
// polynomials in r (least-squares fits on Chebyshev nodes) and the
// quadrant's swap and signs.  The fits are within 8e-8 of cos and sin of
// 2 pi r in exact arithmetic; on an H100 the kernel's cos and sin differ
// from the plain version's torch.cos / torch.sin of fl(frac(cyc) * 2 pi) by
// at most 4.2e-7, sample by sample (`[ramp] carrier` of chip_smoke.py phase
// 3c).  No conversion instruction and no slow path for large arguments (a
// phase of 2^20 cycles or more is first reduced to its fraction, exactly).
// It takes
// the place of sincosf((cyc - floorf(cyc)) * 2 pi), about 30 instructions a
// sample and, in `nvcc -Xptxas -v`, a 32-byte stack frame: the local array
// of its slow path for huge arguments, a branch never taken here.
struct RampCarrier {
  float remc, shi, slo;
  __device__ __forceinline__ float lo(int n) const {
    return __fmul_rn(slo, static_cast<float>(n & 255));
  }
  __device__ __forceinline__ void operator()(float n_hi, float lo, float* cw,
                                             float* sw) const {
    float cyc = __fadd_rn(__fadd_rn(remc, __fmul_rn(shi, n_hi)), lo);
    if (fabsf(cyc) >= 1048576.f) cyc -= floorf(cyc);
    const float big = __fadd_rn(__fmul_rn(cyc, 4.f), 12582912.f);
    const int quad = __float_as_int(big);
    const float r = __fmaf_rn(__fadd_rn(big, -12582912.f), -0.25f, cyc);
    const float r2 = __fmul_rn(r, r);
    const float s =
        __fmul_rn(r, fmaf(fmaf(fmaf(fmaf(41.4728889465332f, r2,
                                          -76.69786834716797f),
                                     r2, 81.6052017211914f),
                                r2, -41.34170150756836f),
                           r2, 6.2831854820251465f));
    const float c =
        fmaf(fmaf(fmaf(fmaf(59.22028732299805f, r2, -85.4428482055664f), r2,
                       64.93931579589844f),
                  r2, -19.739208221435547f),
             r2, 1.f);
    const float x = quad & 1 ? s : c;   // cos: c, -s, -c, s by quadrant
    const float y = quad & 1 ? c : s;   // sin: s, c, -s, -c
    *cw = (quad + 1) & 2 ? -x : x;
    *sw = quad & 2 ? -y : y;
  }
};

// Basis tables rotated by the epoch's starting phase (angle addition).
struct TableCarrier {
  float c0, s0;
  const float* tc;
  const float* ts;
  __device__ __forceinline__ void operator()(int n, float* cw,
                                             float* sw) const {
    const float c = tc[n];
    const float s = ts[n];
    *cw = c0 * c - s0 * s;
    *sw = s0 * c + c0 * s;
  }
};

__device__ __forceinline__ int valid_samples(int64_t bsz, int blk) {
  return bsz < blk ? static_cast<int>(bsz) : blk;
}

template <bool kInterp, int kPilots, class Sample>
__global__ void __launch_bounds__(kThreads)
correlate_windows_kernel(const Sample* __restrict__ siq,
                         const int8_t* __restrict__ wt,
                         const int8_t* __restrict__ wp,
                         const float* __restrict__ alpha,
                         const float* __restrict__ palpha,
                         const float* __restrict__ remc,
                         const float* __restrict__ shi,
                         const float* __restrict__ slo,
                         const int64_t* __restrict__ bsz,
                         float* __restrict__ out, int blk, int k,
                         int64_t win, int pilot_rot, int pilot2_rot,
                         float w1, float w2) {
  constexpr int kOut = kPilots > 0 ? 16 : 8;
  extern __shared__ float smem[];
  const int64_t c = blockIdx.x;
  const UvCarrier carrier(smem, blk, remc[c], shi[c], slo[c]);
  const int8_t* pw0 = nullptr;
  const int8_t* pw1 = nullptr;
  float pal = 0.f;
  if constexpr (kPilots > 0) {
    pw0 = wp + c * kPilots * win;
    if constexpr (kPilots > 1) pw1 = pw0 + win;
    pal = palpha[c];
  }
  correlate_row<kInterp, kPilots>(
      siq + c * blk, wt + c * win, pw0, pw1,
      alpha[c], pal, valid_samples(bsz[c], blk), k, carrier, out + c * kOut,
      pilot_rot, pilot2_rot, w1, w2);
}

// ---------------------------------------------------------------------------
// The phase-ramp kernel: a thread-block cluster per row.
//
// Replaces `make_correlate_kernel` of tools/perf_pallas.py:30 (the sums and
// carrier of `correlate_windows_ramp_plain` in ops/correlator.py).
//
// What bounds it: bytes.  A call moves 2 bytes of samples and 1 replica
// byte per sample, 651 KB at 12 rows x 18 008 (0.19 us at 3.35 TB/s) and
// 5.2 MB at 96 rows (1.55 us), against ~30 f32 operations per sample
// (7-57 MFLOP, 0.1-0.9 us at 67 TFLOP/s).  At 12 rows the bound lies below
// the launch floor, the device time of an empty launch.  What held it back
// was the layout: one 512-thread block per row put 12 rows on 12 of the 132
// SMs, each thread walking ~35 samples in a dependent chain with ~10
// int-to-float conversions a sample (a pipe an eighth as fast as f32) and
// a full sincosf.  The design:
//
//   * every row is split over a cluster of S thread blocks (`ramp_plan` in
//     ops/correlator.py: as many as keep the bank within the card's SMs, 8
//     at 12 rows, 1 at 96), block r taking the row's samples
//     [r * chunk, (r + 1) * chunk), masked to the row's bsz;
//   * a block walks its slice in tiles through a ring of `stages` buffers
//     in shared memory.  One thread copies a tile's samples and its replica
//     stretch [t0, t1 + 2k + 1) in with two asynchronous bulk copies of
//     their 16-byte aligned spans (`cp.async.bulk`, completion on the
//     stage's mbarrier), the first `stages` tiles at the start, so a slice
//     that fits the ring is in flight at once and each later tile is asked
//     for as soon as its stage is free.  Rows start at any byte: a span
//     reaches past its stretch into the neighbouring rows, never past the
//     tensor (its last bytes are copied by hand);
//   * a tile's replica bytes are turned into the interpolated taps
//     w[m] + alpha (w[m + 1] - w[m]) once each, so a sample reads its three
//     taps as f32 and converts only its I and Q, by a float add on the
//     bytes' bits;
//   * thread j takes samples t0 + j, + 512, ...: neighbouring lanes read
//     neighbouring words of shared memory, and the phase term slo * (n mod
//     256) is the same at every step, so it is computed once;
//   * each block reduces its slice in a fixed order (`reduce_block`), writes
//     its totals into rank 0's shared memory and rank 0 adds them in rank
//     order, one cluster barrier in all (its first phase arrives at the
//     start): no atomics, so two launches on the same inputs give the same
//     bits.
//
// The carrier is RampCarrier's: the plain version's f32 phase, rounded
// step by step, and cos and sin within 4.2e-7 of the plain version's, so
// each sample's product is the plain version's to a few f32 ulp; only the
// order of the sums differs.
// ---------------------------------------------------------------------------

static_assert(kThreads % 256 == 0,
              "a thread's samples must keep n mod 256 (RampCarrier::lo)");
constexpr int kMaxRampCluster = 8;   // the portable cluster size
constexpr int kMaxRampStages = 2;
// dynamic shared memory a ramp block may be given: the card's 227 KB less
// the static arrays
constexpr int kMaxRampSmem = 232448 - 2048;

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// Byte offsets, in a ramp block's dynamic shared memory, of a stage's
// replica bytes (the 16-byte span of a stretch of tile + 2k + 1: up to 15
// bytes either side, and 4 read past it) and sample bytes (likewise), the
// interpolated taps (f32, tile + 2k of them) lying first; `total` is what
// the launch must give.  ops/correlator.py's `ramp_smem_bytes` computes the
// same.
struct RampSmem {
  int rep_bytes, samp_bytes, ring, total;
  __host__ __device__ int rep(int s) const {
    return ring + s * (rep_bytes + samp_bytes);
  }
  __host__ __device__ int samp(int s) const { return rep(s) + rep_bytes; }
};

__host__ __device__ inline RampSmem ramp_smem(int tile, int k, int stages) {
  const int rep = round16(tile + 2 * k + 1 + 30 + 4);
  const int samp = round16(2 * tile + 30);
  const int ring = round16(4 * (tile + 2 * k));
  return RampSmem{rep, samp, ring, ring + stages * (rep + samp)};
}

// The 16-byte span [a0, a0 + bytes) a bulk copy moves for the bytes
// [src, src + len) into `dst` (dst[i] then holds the byte at a0 + i), cut at
// the last 16-byte boundary of the tensor, which ends at `end`: the bytes
// past the cut (the tensor's last, when its size is no multiple of 16) are
// copied into `dst` here, by the calling thread.
struct Span {
  uintptr_t a0;
  uint32_t bytes;
};

__device__ __forceinline__ Span span_of(const int8_t* src, int len,
                                        const int8_t* end, uint8_t* dst) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a0 = p & ~static_cast<uintptr_t>(15);
  const uintptr_t e = p + static_cast<uintptr_t>(len);
  const uintptr_t cut = reinterpret_cast<uintptr_t>(end) &
                        ~static_cast<uintptr_t>(15);
  uintptr_t a1 = (e + 15) & ~static_cast<uintptr_t>(15);
  if (a1 > cut) {
    a1 = cut > a0 ? cut : a0;
    for (uintptr_t b = a1 > p ? a1 : p; b < e; ++b)
      dst[b - a0] = *reinterpret_cast<const uint8_t*>(b);
  }
  return Span{a0, static_cast<uint32_t>(a1 - a0)};
}

// The int8 value of the byte in bits 8 * J of `bits`, exactly: the byte,
// its sign bit flipped, is the low mantissa byte of 2^23 + (value + 128).
template <int J>
__device__ __forceinline__ float s8_at(unsigned bits) {
  unsigned m;
  asm("prmt.b32 %0, %1, %2, %3;"
      : "=r"(m) : "r"(bits ^ 0x80808080u), "r"(0x4B000000u),
        "n"(0x7540 | J));
  return __int_as_float(static_cast<int>(m)) - 8388736.0f;
}

// The cluster barrier (every block of the cluster arrives, then waits):
// `arrive_relaxed` orders nothing, `arrive_release` makes the block's
// earlier writes, distributed shared memory included, visible to the
// blocks that pass `wait` after it.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <bool kCluster>
__global__ void __launch_bounds__(kThreads)
correlate_windows_ramp_cluster_kernel(const char2* __restrict__ siq,
                                      const int8_t* __restrict__ wt,
                                      const float* __restrict__ alpha,
                                      const float* __restrict__ remc,
                                      const float* __restrict__ shi,
                                      const float* __restrict__ slo,
                                      const int64_t* __restrict__ bsz,
                                      float* __restrict__ out, int blk,
                                      int k, int64_t win, int chunk,
                                      int tile, int stages) {
  extern __shared__ int4 smem_words[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_words);
  float* taps = reinterpret_cast<float*>(smem);
  const RampSmem lay = ramp_smem(tile, k, stages);
  __shared__ float part[kWarps][6];
  __shared__ float tot[6];
  __shared__ float ranks[kMaxRampCluster][6];   // rank 0's: every block's
  __shared__ alignas(8) uint64_t full[kMaxRampStages];

  int n_ranks = 1;
  int rank = 0;
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    n_ranks = static_cast<int>(cluster.num_blocks());
    rank = static_cast<int>(cluster.block_rank());
    // the first phase of the barrier that the writes into rank 0 wait on:
    // every block of the cluster has started
    cluster_arrive_relaxed();
  }
  const int64_t c = blockIdx.x / n_ranks;
  const int64_t n_rows = gridDim.x / n_ranks;
  const int n_valid = max(valid_samples(bsz[c], blk), 0);
  const int n_begin = min(rank * chunk, n_valid);
  const int n_end = min(n_begin + chunk, n_valid);
  const int n_tiles = (n_end - n_begin + tile - 1) / tile;
  const char2* __restrict__ x = siq + c * blk;
  const int8_t* __restrict__ w = wt + c * win;
  const int8_t* x_end = reinterpret_cast<const int8_t*>(siq + n_rows * blk);
  const int8_t* w_end = wt + n_rows * win;
  const RampCarrier carrier{remc[c], shi[c], slo[c]};
  const float a = alpha[c];

  // tile j into stage j % stages, by thread 0: the bytes copied by hand,
  // then the arrival that expects the bulk copies' bytes (and releases the
  // former), then the copies.  The fence orders the block's earlier reads
  // and stores of the stage before the copies write it again.
  auto issue = [&](int j) {
    const int s = j % stages;
    const int t0 = n_begin + j * tile;
    const int t1 = min(t0 + tile, n_end);
    uint8_t* rep = smem + lay.rep(s);
    uint8_t* samp = smem + lay.samp(s);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const Span r = span_of(w + t0, t1 - t0 + 2 * k + 1, w_end, rep);
    const Span q = span_of(reinterpret_cast<const int8_t*>(x + t0),
                           2 * (t1 - t0), x_end, samp);
    bar_arrive_tx(&full[s], r.bytes + q.bytes);
    if (r.bytes > 0)
      bulk_copy(rep, reinterpret_cast<const void*>(r.a0), r.bytes, &full[s]);
    if (q.bytes > 0)
      bulk_copy(samp, reinterpret_cast<const void*>(q.a0), q.bytes,
                &full[s]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) bar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int j = 0; j < min(stages, n_tiles); ++j) issue(j);

  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % stages;
    const int t0 = n_begin + j * tile;
    const int t1 = min(t0 + tile, n_end);
    const int n_taps = t1 - t0 + 2 * k;
    bar_wait(&full[s], static_cast<uint32_t>(j / stages) & 1u);
    // taps[i]: the interpolated tap at replica index t0 + i, four a thread
    const uint8_t* rep = smem + lay.rep(s) +
                         (reinterpret_cast<uintptr_t>(w + t0) & 15);
    for (int g = threadIdx.x; 4 * g < n_taps; g += kThreads) {
      float b[5];
      b[0] = s8_at<0>(rep[4 * g]);
      b[1] = s8_at<0>(rep[4 * g + 1]);
      b[2] = s8_at<0>(rep[4 * g + 2]);
      b[3] = s8_at<0>(rep[4 * g + 3]);
      b[4] = s8_at<0>(rep[4 * g + 4]);
      reinterpret_cast<float4*>(taps)[g] = make_float4(
          b[0] + a * (b[1] - b[0]), b[1] + a * (b[2] - b[1]),
          b[2] + a * (b[3] - b[2]), b[3] + a * (b[4] - b[3]));
    }
    __syncthreads();
    // this thread's samples t0 + threadIdx.x, + kThreads, ...: its pointers
    // step by kThreads, its phase index n / 256 by kThreads / 256
    const int n_first = t0 + static_cast<int>(threadIdx.x);
    const float lo = carrier.lo(n_first);
    float n_hi = static_cast<float>(n_first >> 8);
    const unsigned short* sp = reinterpret_cast<const unsigned short*>(
        smem + lay.samp(s) + (reinterpret_cast<uintptr_t>(x + t0) & 15)) +
        threadIdx.x;
    const float* tp = taps + threadIdx.x;
    const float* tpk = tp + k;
    const float* tp2k = tp + 2 * k;
    for (int n = n_first; n < t1; n += kThreads) {
      const unsigned iq = *sp;
      const float si = s8_at<0>(iq);
      const float sq = s8_at<1>(iq);
      float cw, sw;
      carrier(n_hi, lo, &cw, &sw);
      const float bi = si * cw + sq * sw;
      const float bq = sq * cw - si * sw;
      const float e = *tp;
      const float p = *tpk;
      const float lt = *tp2k;
      acc[0] += e * bi;
      acc[1] += e * bq;
      acc[2] += p * bi;
      acc[3] += p * bq;
      acc[4] += lt * bi;
      acc[5] += lt * bq;
      sp += kThreads;
      tp += kThreads;
      tpk += kThreads;
      tp2k += kThreads;
      n_hi += static_cast<float>(kThreads / 256);
    }
    __syncthreads();   // every read of this stage and the taps is done
    if (threadIdx.x == 0 && j + stages < n_tiles) issue(j + stages);
  }
  reduce_block<6>(acc, part, tot);

  if constexpr (kCluster) {
    // each block writes its totals into rank 0's `ranks` (every block has
    // started once the first phase completes), the second phase makes them
    // visible there, and rank 0 adds them in rank order
    cg::cluster_group cluster = cg::this_cluster();
    cluster_wait();
    if (threadIdx.x < 6)
      cluster.map_shared_rank(&ranks[0][0], 0)[rank * 6 + threadIdx.x] =
          tot[threadIdx.x];
    cluster_arrive_release();
    cluster_wait();
    if (rank == 0 && threadIdx.x < 8) {
      float v = 0.f;
      if (threadIdx.x < 6)
        for (int r = 0; r < n_ranks; ++r) v += ranks[r][threadIdx.x];
      out[c * 8 + threadIdx.x] = v;
    }
  } else if (threadIdx.x < 8) {
    out[c * 8 + threadIdx.x] = threadIdx.x < 6 ? tot[threadIdx.x] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
correlate_windows_table_kernel(const int8_t* __restrict__ siq,
                               const int8_t* __restrict__ wt,
                               const float* __restrict__ tc,
                               const float* __restrict__ ts,
                               const float* __restrict__ alpha,
                               const float* __restrict__ c0,
                               const float* __restrict__ s0,
                               const int64_t* __restrict__ bsz,
                               float* __restrict__ out, int blk, int k,
                               int64_t win) {
  const int64_t c = blockIdx.x;
  const TableCarrier carrier{c0[c], s0[c], tc + c * blk, ts + c * blk};
  correlate_row<true, 0>(
      reinterpret_cast<const char2*>(siq) + c * blk, wt + c * win, nullptr,
      nullptr, alpha[c], 0.f, valid_samples(bsz[c], blk), k, carrier,
      out + c * 8, 0, 0, 0.f, 0.f);
}

template <bool kInterp, int kPilots, class Sample>
cudaError_t launch_windows(int n_rows, cudaStream_t s, const void* siq,
                           const void* wt, const void* wp, const void* alpha,
                           const void* palpha, const void* remc,
                           const void* shi, const void* slo, const void* bsz,
                           void* out, int blk, int k, int64_t win,
                           int pilot_rot, int pilot2_rot, float w1,
                           float w2) {
  correlate_windows_kernel<kInterp, kPilots, Sample>
      <<<n_rows, kThreads, uv_smem_bytes(blk), s>>>(
          static_cast<const Sample*>(siq), static_cast<const int8_t*>(wt),
          static_cast<const int8_t*>(wp), static_cast<const float*>(alpha),
          static_cast<const float*>(palpha), static_cast<const float*>(remc),
          static_cast<const float*>(shi), static_cast<const float*>(slo),
          static_cast<const int64_t*>(bsz), static_cast<float*>(out), blk, k,
          win, pilot_rot, pilot2_rot, w1, w2);
  return cudaGetLastError();
}

// wp and palpha are ignored (and may be null) when n_pilots == 0.
template <class Sample>
int launch_windows_of(const void* siq, const void* wt, const void* wp,
                      const void* alpha, const void* palpha, const void* remc,
                      const void* shi, const void* slo, const void* bsz,
                      void* out, int n_rows, int blk, int k, int64_t win,
                      int interp_taps, int n_pilots, int pilot_rot,
                      int pilot2_rot, float w1, float w2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CUSDR_LAUNCH(INTERP, PILOTS)                                          \
  launch_windows<INTERP, PILOTS, Sample>(n_rows, s, siq, wt, wp, alpha,       \
                                         palpha, remc, shi, slo, bsz, out,    \
                                         blk, k, win, pilot_rot, pilot2_rot,  \
                                         w1, w2)
  cudaError_t err;
  switch (n_pilots * 2 + (interp_taps ? 1 : 0)) {
    case 0: err = CUSDR_LAUNCH(false, 0); break;
    case 1: err = CUSDR_LAUNCH(true, 0); break;
    case 2: err = CUSDR_LAUNCH(false, 1); break;
    case 3: err = CUSDR_LAUNCH(true, 1); break;
    case 4: err = CUSDR_LAUNCH(false, 2); break;
    case 5: err = CUSDR_LAUNCH(true, 2); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CUSDR_LAUNCH
  return static_cast<int>(err);
}

// Lets `kernel` take up to kMaxRampSmem of dynamic shared memory, above the
// 48 KB a launch gets without opting in.  Called once per instantiation, at
// its first launch.
template <class Kernel>
cudaError_t allow_ramp_smem(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxRampSmem);
}

}  // namespace

#define CUSDR_WINDOWS_ARGS                                                    \
    const void* siq, const void* wt, const void* wp, const void* alpha,       \
    const void* palpha, const void* remc, const void* shi, const void* slo,   \
    const void* bsz, void* out, int n_rows, int blk, int k, int64_t win,      \
    int interp_taps, int n_pilots, int pilot_rot, int pilot2_rot, float w1,   \
    float w2, void* stream
#define CUSDR_WINDOWS_CALL                                                    \
    siq, wt, wp, alpha, palpha, remc, shi, slo, bsz, out, n_rows, blk, k,     \
    win, interp_taps, n_pilots, pilot_rot, pilot2_rot, w1, w2, stream

// int8 sample windows.
extern "C" int correlate_windows_launch(CUSDR_WINDOWS_ARGS) {
  return launch_windows_of<char2>(CUSDR_WINDOWS_CALL);
}

// int16 sample windows.
extern "C" int correlate_windows_launch_int16(CUSDR_WINDOWS_ARGS) {
  return launch_windows_of<short2>(CUSDR_WINDOWS_CALL);
}

// `cluster` blocks per row (1, 2, 4 or 8), each taking `chunk` samples of
// the row in tiles of `tile` through a ring of `stages`, with `smem_bytes`
// (= ramp_smem(tile, k, stages).total) of dynamic shared memory;
// ops/correlator.py's `ramp_plan` computes them.  siq and wt start on
// 16-byte boundaries.
extern "C" int correlate_windows_ramp_launch(
    const void* siq, const void* wt, const void* alpha, const void* remc,
    const void* shi, const void* slo, const void* bsz, void* out, int n_rows,
    int blk, int k, int64_t win, int cluster, int chunk, int tile,
    int stages, int smem_bytes, void* stream) {
  if (cluster < 1 || cluster > kMaxRampCluster || (cluster & (cluster - 1)) ||
      chunk < 1 || static_cast<int64_t>(chunk) * cluster < blk || tile < 1 ||
      stages < 1 ||
      stages > kMaxRampStages || smem_bytes > kMaxRampSmem ||
      smem_bytes != ramp_smem(tile, k, stages).total ||
      (reinterpret_cast<uintptr_t>(siq) | reinterpret_cast<uintptr_t>(wt)) &
          15)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const char2* x = static_cast<const char2*>(siq);
  const int8_t* w = static_cast<const int8_t*>(wt);
  const float* al = static_cast<const float*>(alpha);
  const float* rc = static_cast<const float*>(remc);
  const float* sh = static_cast<const float*>(shi);
  const float* sl = static_cast<const float*>(slo);
  const int64_t* bs = static_cast<const int64_t*>(bsz);
  float* o = static_cast<float*>(out);
  if (cluster == 1) {
    static const cudaError_t allowed =
        allow_ramp_smem(correlate_windows_ramp_cluster_kernel<false>);
    if (allowed != cudaSuccess) return static_cast<int>(allowed);
    correlate_windows_ramp_cluster_kernel<false>
        <<<n_rows, kThreads, smem_bytes, s>>>(x, w, al, rc, sh, sl, bs, o,
                                              blk, k, win, chunk, tile,
                                              stages);
    return static_cast<int>(cudaGetLastError());
  }
  static const cudaError_t allowed =
      allow_ramp_smem(correlate_windows_ramp_cluster_kernel<true>);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_rows * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, correlate_windows_ramp_cluster_kernel<true>, x, w, al, rc, sh,
      sl, bs, o, blk, k, win, chunk, tile, stages);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int correlate_windows_table_launch(
    const void* siq, const void* wt, const void* tc, const void* ts,
    const void* alpha, const void* c0, const void* s0, const void* bsz,
    void* out, int n_rows, int blk, int k, int64_t win, void* stream) {
  correlate_windows_table_kernel
      <<<n_rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(siq), static_cast<const int8_t*>(wt),
          static_cast<const float*>(tc), static_cast<const float*>(ts),
          static_cast<const float*>(alpha), static_cast<const float*>(c0),
          static_cast<const float*>(s0), static_cast<const int64_t*>(bsz),
          static_cast<float*>(out), blk, k, win);
  return static_cast<int>(cudaGetLastError());
}
