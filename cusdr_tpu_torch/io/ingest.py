"""IF sample-file ingest.

Replaces the reference's fread-based front end (GPS/GPS_L1CA/include/
postProcessing.m:59-96, tracking.m:226-236): files hold either real samples
(fileType 1: S0,S1,...) or interleaved I/Q (fileType 2: I0,Q0,I1,Q1,...) as
schar or int16, plus the packed 2-bit sign/magnitude format handled by
GPS/GPS_L2C/include/unpack_cplx.m.  We read bytes once and hand the device
raw int8/int16 arrays; conversion to complex happens on device.
"""

from __future__ import annotations

import numpy as np

def unpack_2bit_iq(raw: np.ndarray) -> np.ndarray:
    """Unpack bytes of 2-bit sign/mag I/Q pairs into interleaved int8 I/Q.

    Uses the native C loader (runtime/native.c) when built; numpy
    otherwise.

    Each byte holds 2 complex samples with LSB-first bit layout
    (GPS/GPS_L2C/include/unpack_cplx.m LUTs):
      bit0 = I1 sign, bit1 = Q1 sign, bit2 = I1 mag, bit3 = Q1 mag,
      bit4 = I2 sign, bit5 = Q2 sign, bit6 = I2 mag, bit7 = Q2 mag
    where value = (mag ? 3 : 1) * (sign ? -1 : +1).
    Returns int8 array of length 4*len(raw) (interleaved I,Q,I,Q,...).
    """
    raw = np.asarray(raw, dtype=np.uint8)
    try:
        from .. import runtime
        if runtime.available():
            return runtime.unpack_2bit_iq(raw)
    except Exception:
        pass

    def val(sign_bit, mag_bit):
        mag = np.where((raw >> mag_bit) & 1, 3, 1).astype(np.int8)
        sign = np.where((raw >> sign_bit) & 1, -1, 1).astype(np.int8)
        return mag * sign

    out = np.empty(raw.size * 4, dtype=np.int8)
    out[0::4] = val(0, 2)   # I1
    out[1::4] = val(1, 3)   # Q1
    out[2::4] = val(4, 6)   # I2
    out[3::4] = val(5, 7)   # Q2
    return out


def read_if_file(path: str, cfg, offset_samples: int = 0,
                 num_samples: int | None = None) -> np.ndarray:
    """Read raw IF samples from ``path`` starting at ``offset_samples``.

    Returns int8/int16 array, interleaved I/Q when cfg.file_type == 2.
    ``offset_samples`` counts complex (or real) samples, on top of
    cfg.skip_number_of_bytes (initSettings.m:53, postProcessing.m:74).
    """
    per = 2 if cfg.file_type == 2 else 1
    dtype = np.int8 if cfg.data_type == "schar" else np.int16
    isize = np.dtype(dtype).itemsize
    with open(path, "rb") as f:
        f.seek(cfg.skip_number_of_bytes + offset_samples * per * isize)
        count = -1 if num_samples is None else num_samples * per
        data = np.fromfile(f, dtype=dtype, count=count)
    return data


def load_if_samples(path: str, cfg, offset_samples: int = 0,
                    num_samples: int | None = None) -> np.ndarray:
    """Read and convert to complex64 (host-side convenience for acquisition).

    For fileType 1 returns real samples cast to complex.
    """
    raw = read_if_file(path, cfg, offset_samples, num_samples)
    if cfg.file_type == 2:
        return (raw[0::2].astype(np.float32)
                + 1j * raw[1::2].astype(np.float32))
    return raw.astype(np.float32) + 0j
