// Device code shared by the two superblock kernels (Hopper, sm_90a):
// superblock.cu (windows read from the record and the tables at per-row
// offsets) and superblock_staged.cu (windows staged into shared memory by
// asynchronous bulk copies).  Both track a channel bank through every epoch
// of a superblock in one launch, on the same arguments, and close each
// epoch with the same code: the window geometry (`epoch_geometry`), the
// discriminators and loop filters (`close_epoch`) and the output rows
// (`write_epoch`), each computed by thread 0 for its block.

#pragma once

#include "correlator_common.cuh"

// Arguments of one launch; mirrored field by field by the ctypes structure
// `SuperblockArgs` of ops/correlator.py.  The scalars are computed by the
// caller in double (or rounded to f32 where the eager loop's tensors are
// f32) and used as given.
struct SuperblockArgs {
  const void* iq;              // [2 S] interleaved I/Q record: int8, or
                               // int16 in the `_int16` instantiations
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

namespace cusdr {

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

}  // namespace cusdr
