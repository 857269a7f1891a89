// Acquisition's fine-frequency search (Hopper, sm_90a).
//
// Replaces no Pallas kernel: the reference leaves this stage to XLA
// (cusdr_tpu/acquisition/pcps.py `_fine_kernel`, vmapped by
// `_fine_batched`).  It was added because the port's PyTorch version of that
// stage sampled each detected PRN's replica on the host (n_codes x spc
// floats a PRN, copied from pageable memory) and materialised the carrier
// and four products over [n_fine, n_codes x spc] in device memory: at E5a's
// 101 bins x 100 x 18 000 samples, 727 MB per tensor and ~15 GB of traffic a
// PRN.  Here neither exists.  For detected row r, fine bin b and code period
// c it computes, over the samples n of period c of the row's segment,
//
//   x[n]     = sig_r[cps[r] + n] + j sig_i[cps[r] + n]      f32 record
//   e(n)     = floor((off[r] + n * ratio) * epc) mod L[r]   f64, without FMA
//   w[n]     = x[n] * table[r][e(n)]                         int8 code table
//   theta    = omega[r][b] * (float)n                        f32, exact n
//   sr[r][b][c] = sum_n  Re(w) cos theta + Im(w) sin theta
//   si[r][b][c] = sum_n  Im(w) cos theta - Re(w) sin theta
//
// e(n) is `sample_code`'s index (signals/defs.py) element for element: the
// f64 product and sum are rounded one by one (__dmul_rn, __dadd_rn), so nvcc
// cannot contract them.  theta is the reference's f32 phase and sincosf is
// the full-accuracy one (no fast-math flag).  Sums are f32: each thread
// adds its samples, a warp adds by a fixed butterfly, the block adds its
// warps in order into a fixed slot per (row, bin, period, tile), and a
// second kernel adds the tiles in order.  No atomics: two launches on the
// same input are equal to the bit.
//
// Layout: the grid is (tiles of a period, periods, rows x bin tiles); a
// block of 256 threads takes one tile of 4 096 samples of one period
// (sample tile * 4096 + s * 256 + tid, so loads are coalesced), forms its
// 16 samples' wiped (Re w, Im w) once in registers and then walks the
// tile's bins (up to 128).  At E5a (12 rows, 100 periods of 18 000
// samples) that is 6 000 blocks, at L1 C/A (40 periods) 2 400; a period of
// 72 000 (E1C) or 180 000 samples (B1C) is simply more tiles.
//
// What bounds it on an H100: per sample and bin one sincosf (~30-40 f32
// instructions while |theta| < 105 615, Payne-Hanek past it, as at GLONASS's
// MHz carriers) and four FMAs; E5a's 12 x 101 x 1.8e6 = 2.2e9 sample-bins
// take ~1-4 ms at the card's f32 issue rate.  The segment is read once per
// bin tile (14.4 MB at E5a: ~4 us); the replica index (an int64 modulo) is
// formed once per sample, not per bin.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;
constexpr int kBinTile = 128;
// the f32 sample index is exact below 2^24
constexpr int64_t kMaxSamples = int64_t{1} << 24;

__global__ void __launch_bounds__(kThreads) fine_search_kernel(
    const float* __restrict__ sig_r, const float* __restrict__ sig_i,
    const int64_t* __restrict__ cps, const int8_t* __restrict__ tables,
    int64_t table_stride, const int64_t* __restrict__ lengths,
    const double* __restrict__ offsets, const float* __restrict__ omega,
    float2* __restrict__ partial, int n_fine, int n_codes, int spc,
    int n_tiles, int n_bin_tiles, int epc, double ratio) {
  __shared__ float s_omega[kBinTile];
  __shared__ float2 s_warp[kWarps][kBinTile];
  const int tile = blockIdx.x;
  const int code = blockIdx.y;
  const int row = blockIdx.z / n_bin_tiles;
  const int b0 = (blockIdx.z % n_bin_tiles) * kBinTile;
  const int nb = min(kBinTile, n_fine - b0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  for (int b = tid; b < nb; b += kThreads)
    s_omega[b] = omega[static_cast<int64_t>(row) * n_fine + b0 + b];

  // this thread's samples: period offset first + s * kThreads, s < n_mine
  const int first = tile * kTile + tid;
  const int n_mine =
      first < spc ? min(kPerThread, (spc - first + kThreads - 1) / kThreads)
                  : 0;
  const int64_t n0 = static_cast<int64_t>(code) * spc + first;
  const int64_t cp = cps[row];
  const int8_t* tab = tables + row * table_stride;
  const int64_t len = lengths[row];
  const double off = offsets[row];
  float wr[kPerThread], wi[kPerThread];
#pragma unroll
  for (int s = 0; s < kPerThread; ++s) {
    wr[s] = 0.f;
    wi[s] = 0.f;
    if (s < n_mine) {
      const int64_t n = n0 + s * kThreads;
      const double chips =
          __dadd_rn(off, __dmul_rn(static_cast<double>(n), ratio));
      int64_t e = static_cast<int64_t>(
                      floor(__dmul_rn(chips, static_cast<double>(epc)))) %
                  len;
      if (e < 0) e += len;
      const float rep = static_cast<float>(tab[e]);
      wr[s] = sig_r[cp + n] * rep;
      wi[s] = sig_i[cp + n] * rep;
    }
  }
  __syncthreads();

  // n0 + s * kThreads < 2^24: the f32 index is exact, as is each sum
  const float nf0 = static_cast<float>(n0);
  for (int b = 0; b < nb; ++b) {
    const float w = s_omega[b];
    float ar = 0.f, ai = 0.f;
#pragma unroll
    for (int s = 0; s < kPerThread; ++s) {
      if (s < n_mine) {
        float sn, c;
        sincosf(__fmul_rn(w, nf0 + static_cast<float>(s * kThreads)), &sn,
                &c);
        ar += wr[s] * c + wi[s] * sn;
        ai += wi[s] * c - wr[s] * sn;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ar += __shfl_xor_sync(0xffffffffu, ar, o);
      ai += __shfl_xor_sync(0xffffffffu, ai, o);
    }
    if (lane == 0) s_warp[warp][b] = make_float2(ar, ai);
  }
  __syncthreads();
  for (int b = tid; b < nb; b += kThreads) {
    float2 t = s_warp[0][b];
    for (int k = 1; k < kWarps; ++k) {
      t.x += s_warp[k][b].x;
      t.y += s_warp[k][b].y;
    }
    partial[((static_cast<int64_t>(row) * n_fine + b0 + b) * n_codes + code) *
                n_tiles +
            tile] = t;
  }
}

// Adds each (row, bin, period)'s tiles in order.
__global__ void fine_reduce_kernel(const float2* __restrict__ partial,
                                   float* __restrict__ sr,
                                   float* __restrict__ si, int64_t n_out,
                                   int n_tiles) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (k >= n_out) return;
  const float2* p = partial + k * n_tiles;
  float2 t = p[0];
  for (int i = 1; i < n_tiles; ++i) {
    t.x += p[i].x;
    t.y += p[i].y;
  }
  sr[k] = t.x;
  si[k] = t.y;
}

}  // namespace

// Samples of a period one block takes: the wrapper sizes `partial` as
// float2 [n_rows, n_fine, n_codes, n_tiles], n_tiles = ceil(spc / this).
extern "C" int fine_search_tile_samples() { return kTile; }

// The longest segment (n_codes x spc samples) a launch takes; the wrapper
// refuses a longer one before it launches.
extern "C" int fine_search_max_samples() {
  return static_cast<int>(kMaxSamples);
}

// sig_r, sig_i: f32 record; cps, lengths: int64 [n_rows]; tables: int8
// [n_rows, table_stride]; offsets: f64 [n_rows]; omega: f32 [n_rows,
// n_fine]; sr, si: f32 [n_rows, n_fine, n_codes].  The wrapper has checked
// that every segment lies inside the record and every length inside its
// table row.
extern "C" int fine_search_launch(
    const void* sig_r, const void* sig_i, const void* cps, const void* tables,
    int64_t table_stride, const void* lengths, const void* offsets,
    const void* omega, void* partial, void* sr, void* si, int n_rows,
    int n_fine, int n_codes, int spc, int n_tiles, int epc, double ratio,
    void* stream) {
  const int n_bin_tiles = (n_fine + kBinTile - 1) / kBinTile;
  if (n_rows < 1 || n_fine < 1 || n_codes < 1 || n_codes > 65535 ||
      spc < 1 || epc < 1 || n_tiles != (spc + kTile - 1) / kTile ||
      static_cast<int64_t>(n_rows) * n_bin_tiles > 65535 ||
      static_cast<int64_t>(n_codes) * spc > kMaxSamples)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* part = static_cast<float2*>(partial);
  fine_search_kernel<<<dim3(n_tiles, n_codes, n_rows * n_bin_tiles),
                       kThreads, 0, s>>>(
      static_cast<const float*>(sig_r), static_cast<const float*>(sig_i),
      static_cast<const int64_t*>(cps), static_cast<const int8_t*>(tables),
      table_stride, static_cast<const int64_t*>(lengths),
      static_cast<const double*>(offsets), static_cast<const float*>(omega),
      part, n_fine, n_codes, spc, n_tiles, n_bin_tiles, epc, ratio);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_out = static_cast<int64_t>(n_rows) * n_fine * n_codes;
  fine_reduce_kernel<<<static_cast<unsigned>((n_out + 255) / 256), 256, 0,
                       s>>>(part, static_cast<float*>(sr),
                            static_cast<float*>(si), n_out, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
