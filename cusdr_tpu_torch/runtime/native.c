/* Native sample-ingest runtime for cusdr_tpu.
 *
 * Hot host-side byte work: 2-bit sign/magnitude unpacking (the
 * GPS_L2C/include/unpack_cplx.m format) and interleaved int8/int16 ->
 * planar float32 I/Q conversion used to stage superblocks for the device.
 * Compiled as a plain shared library and bound with ctypes
 * (cusdr_tpu/runtime/__init__.py); a pure-numpy fallback exists in
 * io/ingest.py.
 *
 * Build: make -C cusdr_tpu/runtime   (gcc -O3 -march=native -shared)
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

/* Byte layout (unpack_cplx.m LUTs): bit0=I1 sign, bit1=Q1 sign,
 * bit2=I1 mag, bit3=Q1 mag, bit4..7 same for sample 2;
 * value = (mag?3:1) * (sign?-1:+1). */
void unpack_2bit_iq(const uint8_t *in, int64_t n_bytes, int8_t *out)
{
    static int8_t lut[256][4];
    static int init = 0;
    if (!init) {
        for (int b = 0; b < 256; b++) {
            int8_t i1 = ((b >> 2) & 1) ? 3 : 1;
            if (b & 1) i1 = (int8_t)-i1;
            int8_t q1 = ((b >> 3) & 1) ? 3 : 1;
            if ((b >> 1) & 1) q1 = (int8_t)-q1;
            int8_t i2 = ((b >> 6) & 1) ? 3 : 1;
            if ((b >> 4) & 1) i2 = (int8_t)-i2;
            int8_t q2 = ((b >> 7) & 1) ? 3 : 1;
            if ((b >> 5) & 1) q2 = (int8_t)-q2;
            lut[b][0] = i1; lut[b][1] = q1; lut[b][2] = i2; lut[b][3] = q2;
        }
        init = 1;
    }
    for (int64_t k = 0; k < n_bytes; k++) {
        memcpy(out + 4 * k, lut[in[k]], 4);
    }
}

/* Interleaved int8 I/Q -> planar float32 (superblock staging). */
void deinterleave_i8_to_f32(const int8_t *in, int64_t n_samples,
                            float *out_i, float *out_q)
{
    for (int64_t k = 0; k < n_samples; k++) {
        out_i[k] = (float)in[2 * k];
        out_q[k] = (float)in[2 * k + 1];
    }
}

/* Interleaved int16 I/Q -> planar float32. */
void deinterleave_i16_to_f32(const int16_t *in, int64_t n_samples,
                             float *out_i, float *out_q)
{
    for (int64_t k = 0; k < n_samples; k++) {
        out_i[k] = (float)in[2 * k];
        out_q[k] = (float)in[2 * k + 1];
    }
}

/* Real int8 -> interleaved I/Q int8 with Q=0 (fileType 1 adaptation). */
void real_i8_to_iq(const int8_t *in, int64_t n_samples, int8_t *out)
{
    for (int64_t k = 0; k < n_samples; k++) {
        out[2 * k] = in[k];
        out[2 * k + 1] = 0;
    }
}
