"""Native host runtime: ctypes bindings for the C sample-ingest library.

``available()`` is False until `make -C cusdr_tpu/runtime` has produced
libcusdr_native.so (built automatically on first use if a compiler is
present); callers fall back to the numpy implementations in io/ingest.py.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_LIB_PATH = _DIR / "libcusdr_native.so"
_lib = None


def _try_build() -> bool:
    try:
        subprocess.run(["make", "-C", str(_DIR)], check=True,
                       capture_output=True, timeout=60)
        return _LIB_PATH.exists()
    except Exception:
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists() and not _try_build():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.unpack_2bit_iq.argtypes = [u8p, ctypes.c_int64, i8p]
    lib.deinterleave_i8_to_f32.argtypes = [i8p, ctypes.c_int64, f32p, f32p]
    lib.deinterleave_i16_to_f32.argtypes = [i16p, ctypes.c_int64, f32p,
                                            f32p]
    lib.real_i8_to_iq.argtypes = [i8p, ctypes.c_int64, i8p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def unpack_2bit_iq(raw: np.ndarray) -> np.ndarray:
    lib = _load()
    raw = np.ascontiguousarray(raw, np.uint8)
    out = np.empty(raw.size * 4, np.int8)
    lib.unpack_2bit_iq(raw, raw.size, out)
    return out


def deinterleave_to_f32(iq: np.ndarray):
    """Interleaved int8/int16 I/Q -> (I, Q) float32 planar arrays."""
    lib = _load()
    n = iq.size // 2
    out_i = np.empty(n, np.float32)
    out_q = np.empty(n, np.float32)
    if iq.dtype == np.int8:
        lib.deinterleave_i8_to_f32(np.ascontiguousarray(iq), n, out_i,
                                   out_q)
    elif iq.dtype == np.int16:
        lib.deinterleave_i16_to_f32(np.ascontiguousarray(iq), n, out_i,
                                    out_q)
    else:
        raise TypeError(iq.dtype)
    return out_i, out_q


def real_to_iq(real: np.ndarray) -> np.ndarray:
    lib = _load()
    real = np.ascontiguousarray(real, np.int8)
    out = np.empty(real.size * 2, np.int8)
    lib.real_i8_to_iq(real, real.size, out)
    return out
