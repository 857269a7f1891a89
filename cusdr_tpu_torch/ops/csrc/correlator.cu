// Epoch correlator for a channel bank (Hopper, sm_90a).
//
// Replaces the TPU kernel `correlate_bank_hbm` of cusdr_tpu/ops/correlator.py
// (Pallas call built by `_build_call_hbm`, body `_correlate_rows`), in all
// three of its variants (no pilot, pilot `wp4`, dual pilot `wp24`) and both
// tap modes.  Per channel row c it computes, over the valid samples n in
// [0, bsz[c]) of the row's window,
//
//   x[n]   = I + jQ       int8 record at sample off[c] + n (interleaved I/Q)
//   bb[n]  = x[n] * exp(-j 2 pi (remc + inc * n))        carrier wipe-off
//   w(m)   = tab[wrow[c]][start[c] + m]                   int8 replica
//   tap(d) = w(n + d) + alpha * (w(n + d + 1) - w(n + d))  (interp_taps)
//          = w(n + d)                                      (nearest)
//   out[c] = sum_n tap(d) * bb[n]  for d = 0, k, 2k  ->  iE qE iP qP iL qL
//
// The pilot variants (kPilots = 1, 2) add six sums per pilot bank on the
// same baseband, from the pilot table's own window: row wrow[c], bank b, at
// pstart[c] with fraction palpha[c].  The pilot carrier is j^pilot_rot times
// the data carrier; a quarter-turn rotation is a swap and a sign change,
// which commutes exactly with the real bilinear sums, so the kernel rotates
// the six reduced sums, not the baseband.  With two banks (B1C WB QMBOC)
// bank 2 is rotated by j^pilot2_rot and the pair is combined as
// w1 * bank1 + w2 * bank2 per sum.  Output row: 8 floats without pilots
// (iE qE iP qP iL qL 0 0), 16 with (+ piE pqE piP pqP piL pqL 0 0 0 0).
//
// The carrier keeps the reference's u.v factorization (UvCarrier in
// correlator_common.cuh, which also holds the per-row loop, the reduction
// and the pilot epilogue); a per-sample f32 phase remc + inc * n would drift
// by about blk * 2^-24 cycles.  u and v are computed once per block into
// shared memory.
//
// What bounds it on an H100: per sample it reads 2 bytes of record and about
// 2 bytes of replica per bank (each window is read from device memory once;
// neighbouring taps hit the cache) and does about 20 FLOPs plus 12 per pilot
// bank.  At the shapes of the ported paths (12 x 18 008 samples per 1 ms
// epoch at L1 C/A and E5a, 12 x 72 008 per 4 ms at E1C, 15 x 180 008 per
// 10 ms at B1C) that is 0.6-7 MB and 4-60 MFLOP per launch: microseconds of
// bandwidth or arithmetic.  The kernel is bound by its launch and by
// parallelism: one block per channel row keeps only 12-15 of the 132 SMs
// busy, and each thread walks blk / 512 samples in sequence (352 at B1C).
// The design answers with wide blocks (512 threads, each sample touched once,
// coalesced 2-byte record loads), 6-18 register accumulators and no global
// scratch; splitting a row over several blocks and running a superblock of
// epochs per launch are later steps.

#include "correlator_common.cuh"

namespace {

using namespace cusdr;

template <bool kInterp, int kPilots>
__global__ void __launch_bounds__(kThreads)
correlate_bank_kernel(const int8_t* __restrict__ iq,
                      const int64_t* __restrict__ off,
                      const int8_t* __restrict__ table,
                      const int64_t* __restrict__ wrow,
                      const int64_t* __restrict__ start,
                      const float* __restrict__ alpha,
                      const float* __restrict__ remc,
                      const float* __restrict__ shi,
                      const float* __restrict__ slo,
                      const int64_t* __restrict__ bsz,
                      const int8_t* __restrict__ ptable,
                      const int64_t* __restrict__ pstart,
                      const float* __restrict__ palpha,
                      float* __restrict__ out,
                      int blk, int k, int64_t table_len, int64_t ptable_len,
                      int pilot_rot, int pilot2_rot, float w1, float w2) {
  constexpr int kOut = kPilots > 0 ? 16 : 8;
  extern __shared__ float smem[];
  const int c = blockIdx.x;
  const UvCarrier carrier(smem, blk, remc[c], shi[c], slo[c]);

  // The wrapper has clamped off, start and pstart so every read is in
  // bounds.  Pilot tables are [R, kPilots, ptable_len].
  const char2* __restrict__ x =
      reinterpret_cast<const char2*>(iq) + off[c];
  const int8_t* __restrict__ w = table + wrow[c] * table_len + start[c];
  const int8_t* pw0 = nullptr;
  const int8_t* pw1 = nullptr;
  float pal = 0.f;
  if constexpr (kPilots > 0) {
    pw0 = ptable + wrow[c] * (kPilots * ptable_len) + pstart[c];
    if constexpr (kPilots > 1) pw1 = pw0 + ptable_len;
    pal = palpha[c];
  }
  const int64_t b = bsz[c];
  const int n_valid = b < blk ? static_cast<int>(b) : blk;
  correlate_row<kInterp, kPilots>(x, w, pw0, pw1, alpha[c], pal, n_valid, k,
                                  carrier, out + c * kOut, pilot_rot,
                                  pilot2_rot, w1, w2);
}

template <bool kInterp, int kPilots>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t s,
                   const void* iq, const void* off, const void* table,
                   const void* wrow, const void* start, const void* alpha,
                   const void* remc, const void* shi, const void* slo,
                   const void* bsz, const void* ptable, const void* pstart,
                   const void* palpha, void* out, int blk, int k,
                   int64_t table_len, int64_t ptable_len, int pilot_rot,
                   int pilot2_rot, float w1, float w2) {
  correlate_bank_kernel<kInterp, kPilots><<<grid, kThreads, smem, s>>>(
      static_cast<const int8_t*>(iq), static_cast<const int64_t*>(off),
      static_cast<const int8_t*>(table), static_cast<const int64_t*>(wrow),
      static_cast<const int64_t*>(start), static_cast<const float*>(alpha),
      static_cast<const float*>(remc), static_cast<const float*>(shi),
      static_cast<const float*>(slo), static_cast<const int64_t*>(bsz),
      static_cast<const int8_t*>(ptable),
      static_cast<const int64_t*>(pstart),
      static_cast<const float*>(palpha), static_cast<float*>(out), blk, k,
      table_len, ptable_len, pilot_rot, pilot2_rot, w1, w2);
  return cudaGetLastError();
}

}  // namespace

// Pilot arguments are ignored (and may be null) when n_pilots == 0.
extern "C" int correlate_bank_launch(
    const void* iq, const void* off, const void* table, const void* wrow,
    const void* start, const void* alpha, const void* remc, const void* shi,
    const void* slo, const void* bsz, void* out, int n_rows, int blk, int k,
    int64_t table_len, int interp_taps, const void* ptable,
    const void* pstart, const void* palpha, int64_t ptable_len,
    int n_pilots, int pilot_rot, int pilot2_rot, float w1, float w2,
    void* stream) {
  const size_t smem = cusdr::uv_smem_bytes(blk);
  const dim3 grid(n_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CUSDR_LAUNCH(INTERP, PILOTS)                                        \
  launch<INTERP, PILOTS>(grid, smem, s, iq, off, table, wrow, start, alpha, \
                         remc, shi, slo, bsz, ptable, pstart, palpha, out,  \
                         blk, k, table_len, ptable_len, pilot_rot,          \
                         pilot2_rot, w1, w2)
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
