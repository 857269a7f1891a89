// Device code shared by the epoch correlators (Hopper, sm_90a):
// correlator.cu (windows fetched in the kernel from the record and tables)
// and correlator_staged.cu (windows staged before the kernel).
//
// One thread block correlates one channel row: `correlate_row` walks the
// row's valid samples, wipes the carrier off with the cos/sin a Carrier
// functor supplies per sample, multiplies by the early/prompt/late replica
// taps of the data window and of up to two pilot windows, and reduces the
// sums over the block in a fixed order.  The kernels differ in where the
// row's windows lie and in how the carrier is made.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cusdr {

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

// Carrier exp(j 2 pi (remc + inc n)) as u[t] v[l] with n = 128 t + l:
// u[t] = exp(j 2 pi (remc + shi t)), v[l] = exp(j 2 pi slo l),
// shi = frac(128 inc), slo = frac(inc).  Each f32 phase stays below
// blk / 128 cycles before the mod-1 reduction, which bounds the phase error
// near 1e-5 cycles at blk = 18 008 (1e-4 at 180 008).  u and v are computed
// once per block into `smem` (uv_smem_bytes(blk) bytes of dynamic shared
// memory); every thread of the block must construct the carrier.
struct UvCarrier {
  const float* ur;
  const float* ui;
  const float* vr;
  const float* vi;

  __device__ UvCarrier(float* smem, int blk, float remc, float shi,
                       float slo) {
    const int n_t = (blk + 127) / 128;
    float* r = smem;
    float* i = r + n_t;
    float* wr = i + n_t;
    float* wi = wr + 128;
    for (int t = threadIdx.x; t < n_t; t += kThreads) {
      float p = remc + shi * static_cast<float>(t);
      p = (p - floorf(p)) * kTwoPi;
      sincosf(p, &i[t], &r[t]);
    }
    for (int l = threadIdx.x; l < 128; l += kThreads) {
      float p = slo * static_cast<float>(l);
      p = (p - floorf(p)) * kTwoPi;
      sincosf(p, &wi[l], &wr[l]);
    }
    __syncthreads();
    ur = r;
    ui = i;
    vr = wr;
    vi = wi;
  }

  __device__ __forceinline__ void operator()(int n, float* cw,
                                             float* sw) const {
    const int t = n >> 7;
    const int l = n & 127;
    *cw = ur[t] * vr[l] - ui[t] * vi[l];
    *sw = ur[t] * vi[l] + ui[t] * vr[l];
  }
};

inline size_t uv_smem_bytes(int blk) {
  return static_cast<size_t>(2 * ((blk + 127) / 128) + 2 * 128) *
         sizeof(float);
}

// Correlator sums of one channel row, by the whole block.
//
//   x[n]   = I + jQ                       the row's int8 sample window
//   bb[n]  = x[n] * (cw[n] - j sw[n])     carrier wipe-off, n < n_valid
//   tap(d) = w[n + d] + alpha * (w[n + d + 1] - w[n + d])   (kInterp)
//          = w[n + d]                                        (nearest)
//   sums   = sum_n tap(d) * bb[n],  d = 0, k, 2k  ->  iE qE iP qP iL qL
//
// and six more per pilot window (pw0, pw1; fraction palpha).  The pilot
// carrier is j^pilot_rot times the data carrier; a quarter turn is a swap
// and a sign change, which commutes exactly with the real bilinear sums, so
// the six reduced sums are rotated, not the baseband.  With two pilot
// windows the second is rotated by j^pilot2_rot and the pair is combined as
// w1 * bank1 + w2 * bank2 per sum.  `out_row` gets 8 floats without pilots
// (iE qE iP qP iL qL 0 0), 16 with (+ piE pqE piP pqP piL pqL 0 0 0 0).
template <bool kInterp, int kPilots, class Carrier>
__device__ __forceinline__ void correlate_row(
    const char2* __restrict__ x, const int8_t* __restrict__ w,
    const int8_t* __restrict__ pw0, const int8_t* __restrict__ pw1,
    float alpha, float palpha, int n_valid, int k, const Carrier& carrier,
    float* __restrict__ out_row, int pilot_rot, int pilot2_rot, float w1,
    float w2) {
  constexpr int kSums = 6 * (1 + kPilots);
  constexpr int kOut = kPilots > 0 ? 16 : 8;
  const int8_t* pw[2] = {pw0, pw1};

  float acc[kSums];
#pragma unroll
  for (int j = 0; j < kSums; ++j) acc[j] = 0.f;
  for (int n = threadIdx.x; n < n_valid; n += kThreads) {
    const char2 s = x[n];
    const float si = static_cast<float>(s.x);
    const float sq = static_cast<float>(s.y);
    float cw, sw;
    carrier(n, &cw, &sw);
    const float bi = si * cw + sq * sw;
    const float bq = sq * cw - si * sw;
    const float e = tap<kInterp>(w, n, alpha);
    const float p = tap<kInterp>(w, n + k, alpha);
    const float lt = tap<kInterp>(w, n + 2 * k, alpha);
    acc[0] += e * bi;
    acc[1] += e * bq;
    acc[2] += p * bi;
    acc[3] += p * bq;
    acc[4] += lt * bi;
    acc[5] += lt * bq;
#pragma unroll
    for (int bank = 0; bank < kPilots; ++bank) {
      const float pe = tap<kInterp>(pw[bank], n, palpha);
      const float pp = tap<kInterp>(pw[bank], n + k, palpha);
      const float pl = tap<kInterp>(pw[bank], n + 2 * k, palpha);
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
    out_row[j] = v;
  }
}

}  // namespace cusdr
