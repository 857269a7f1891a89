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
//       tools/perf_pallas.py: no pilot, interpolated taps, carrier from a
//       per-sample phase remc + shi * floor(n / 256) + slo * (n mod 256)
//       [cycles], cos and sin evaluated per sample.
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
// microseconds of memory time at most, so the launch and one block per row
// (12-96 of 132 SMs) bound them, as they bound correlator.cu.  The design
// is that file's: 512-thread blocks, every sample touched once with
// coalesced loads, register accumulators, a fixed-order block reduction.
// The staging itself (a gather of C x blk samples in PyTorch before the
// launch) costs more than the kernel; on the card the engine avoids it:
// superblock_staged.cu stages each epoch's windows itself, by bulk copies
// into shared memory, for every epoch of a superblock in one launch.

#include "correlator_common.cuh"

namespace {

using namespace cusdr;

// Per-sample phase ramp.  The products and sums are rounded one by one
// (no FMA contraction): at phases of up to a few hundred cycles one f32 ulp
// is 1e-5 cycles, and the plain version rounds each step.
struct RampCarrier {
  float remc, shi, slo;
  __device__ __forceinline__ void operator()(int n, float* cw,
                                             float* sw) const {
    const float n_hi = static_cast<float>(n >> 8);
    const float n_lo = static_cast<float>(n & 255);
    const float cyc = __fadd_rn(__fadd_rn(remc, __fmul_rn(shi, n_hi)),
                                __fmul_rn(slo, n_lo));
    sincosf((cyc - floorf(cyc)) * kTwoPi, sw, cw);
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

__global__ void __launch_bounds__(kThreads)
correlate_windows_ramp_kernel(const int8_t* __restrict__ siq,
                              const int8_t* __restrict__ wt,
                              const float* __restrict__ alpha,
                              const float* __restrict__ remc,
                              const float* __restrict__ shi,
                              const float* __restrict__ slo,
                              const int64_t* __restrict__ bsz,
                              float* __restrict__ out, int blk, int k,
                              int64_t win) {
  const int64_t c = blockIdx.x;
  const RampCarrier carrier{remc[c], shi[c], slo[c]};
  correlate_row<true, 0>(
      reinterpret_cast<const char2*>(siq) + c * blk, wt + c * win, nullptr,
      nullptr, alpha[c], 0.f, valid_samples(bsz[c], blk), k, carrier,
      out + c * 8, 0, 0, 0.f, 0.f);
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

extern "C" int correlate_windows_ramp_launch(
    const void* siq, const void* wt, const void* alpha, const void* remc,
    const void* shi, const void* slo, const void* bsz, void* out, int n_rows,
    int blk, int k, int64_t win, void* stream) {
  correlate_windows_ramp_kernel
      <<<n_rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(siq), static_cast<const int8_t*>(wt),
          static_cast<const float*>(alpha), static_cast<const float*>(remc),
          static_cast<const float*>(shi), static_cast<const float*>(slo),
          static_cast<const int64_t*>(bsz), static_cast<float*>(out), blk, k,
          win);
  return static_cast<int>(cudaGetLastError());
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
