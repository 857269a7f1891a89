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
// The carrier keeps the reference's u.v factorization: with n = 128 t + l,
// exp(j 2 pi (remc + inc n)) = u[t] v[l], u[t] = exp(j 2 pi (remc + shi t)),
// v[l] = exp(j 2 pi slo l), shi = frac(128 inc), slo = frac(inc).  Each f32
// phase stays below blk / 128 cycles before the mod-1 reduction, which bounds
// the phase error near 1e-5 cycles at blk = 18 008 (1e-4 at B1C's 180 008);
// a per-sample f32 phase remc + inc * n would drift by about blk * 2^-24
// cycles.  u and v are computed once per block into shared memory.
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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kTwoPi = 6.28318530717958647692f;

template <bool kInterp>
__device__ __forceinline__ float tap(const int8_t* __restrict__ w, int m,
                                     float alpha) {
  const float a = static_cast<float>(w[m]);
  if (!kInterp) return a;
  const float b = static_cast<float>(w[m + 1]);
  return a + alpha * (b - a);
}

// Component `comp` (0 = I, 1 = Q) of j^rot * (i + jq).
__device__ __forceinline__ float rotate(float i, float q, int rot, int comp) {
  switch (rot & 3) {
    case 0: return comp ? q : i;
    case 1: return comp ? i : -q;
    case 2: return comp ? -q : -i;
    default: return comp ? -i : q;
  }
}

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
  constexpr int kSums = 6 * (1 + kPilots);
  constexpr int kOut = kPilots > 0 ? 16 : 8;
  extern __shared__ float smem[];
  const int c = blockIdx.x;
  const int n_t = (blk + 127) / 128;
  float* ur = smem;
  float* ui = ur + n_t;
  float* vr = ui + n_t;
  float* vi = vr + 128;

  const float rc = remc[c];
  const float sh = shi[c];
  const float sl = slo[c];
  const float al = alpha[c];
  for (int t = threadIdx.x; t < n_t; t += kThreads) {
    float p = rc + sh * static_cast<float>(t);
    p = (p - floorf(p)) * kTwoPi;
    sincosf(p, &ui[t], &ur[t]);
  }
  for (int l = threadIdx.x; l < 128; l += kThreads) {
    float p = sl * static_cast<float>(l);
    p = (p - floorf(p)) * kTwoPi;
    sincosf(p, &vi[l], &vr[l]);
  }
  __syncthreads();

  // The wrapper has clamped off, start and pstart so every read is in
  // bounds.  Pilot tables are [R, kPilots, ptable_len].
  const char2* __restrict__ x =
      reinterpret_cast<const char2*>(iq) + off[c];
  const int8_t* __restrict__ w = table + wrow[c] * table_len + start[c];
  const int8_t* pw[kPilots > 0 ? kPilots : 1];
  float pal = 0.f;
  if constexpr (kPilots > 0) {
    pw[0] = ptable + wrow[c] * (kPilots * ptable_len) + pstart[c];
    if constexpr (kPilots > 1) pw[1] = pw[0] + ptable_len;
    pal = palpha[c];
  }
  const int64_t b = bsz[c];
  const int n_valid = b < blk ? static_cast<int>(b) : blk;

  float acc[kSums];
#pragma unroll
  for (int j = 0; j < kSums; ++j) acc[j] = 0.f;
  for (int n = threadIdx.x; n < n_valid; n += kThreads) {
    const char2 s = x[n];
    const float si = static_cast<float>(s.x);
    const float sq = static_cast<float>(s.y);
    const int t = n >> 7;
    const int l = n & 127;
    const float cw = ur[t] * vr[l] - ui[t] * vi[l];
    const float sw = ur[t] * vi[l] + ui[t] * vr[l];
    const float bi = si * cw + sq * sw;
    const float bq = sq * cw - si * sw;
    const float e = tap<kInterp>(w, n, al);
    const float p = tap<kInterp>(w, n + k, al);
    const float lt = tap<kInterp>(w, n + 2 * k, al);
    acc[0] += e * bi;
    acc[1] += e * bq;
    acc[2] += p * bi;
    acc[3] += p * bq;
    acc[4] += lt * bi;
    acc[5] += lt * bq;
#pragma unroll
    for (int bank = 0; bank < kPilots; ++bank) {
      const float pe = tap<kInterp>(pw[bank], n, pal);
      const float pp = tap<kInterp>(pw[bank], n + k, pal);
      const float pl = tap<kInterp>(pw[bank], n + 2 * k, pal);
      float* a = acc + 6 * (bank + 1);
      a[0] += pe * bi;
      a[1] += pe * bq;
      a[2] += pp * bi;
      a[3] += pp * bq;
      a[4] += pl * bi;
      a[5] += pl * bq;
    }
  }

  // Block reduction in a fixed order: warp shuffles, then one thread per
  // sum adds the warps' partials; the pilot sums are rotated and combined
  // after it.
  __shared__ float part[kWarps][kSums];
  __shared__ float tot[kSums];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kSums; ++j) {
    float v = acc[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) part[warp][j] = v;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float v = 0.f;
    for (int i = 0; i < kWarps; ++i) v += part[i][threadIdx.x];
    tot[threadIdx.x] = v;
  }
  __syncthreads();
  if (threadIdx.x < kOut) {
    const int j = threadIdx.x;
    float v = 0.f;
    if (j < 6) {
      v = tot[j];
    } else if constexpr (kPilots > 0) {
      if (j < 12) {
        const int i0 = 6 + ((j - 6) & ~1);   // I sum of this tap, bank 1
        const int comp = (j - 6) & 1;
        v = rotate(tot[i0], tot[i0 + 1], pilot_rot, comp);
        if constexpr (kPilots > 1) {
          const float v2 =
              rotate(tot[i0 + 6], tot[i0 + 7], pilot2_rot, comp);
          // no contraction into an FMA: the reference rounds each product
          v = __fadd_rn(__fmul_rn(w1, v), __fmul_rn(w2, v2));
        }
      }
    }
    out[c * kOut + j] = v;
  }
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
  const int n_t = (blk + 127) / 128;
  const size_t smem = static_cast<size_t>(2 * n_t + 2 * 128) * sizeof(float);
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
