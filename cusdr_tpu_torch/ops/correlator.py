"""Epoch correlator for a channel bank: the CUDA kernel and its plain
PyTorch version.

``correlate_bank`` replaces the TPU kernel ``correlate_bank_hbm``
(cusdr_tpu/ops/correlator.py:563; Pallas call built by ``_build_call_hbm``,
body ``_correlate_rows``) in its three variants, each in both tap modes:
no pilot (``[C, 8]`` out), pilot (``wp4``: six more sums on a second
replica window, ``[C, 16]`` out) and dual pilot (``wp24``: B1C WB QMBOC,
two pilot banks combined in the kernel).  On a CUDA tensor it launches
``csrc/correlator.cu`` (built with nvcc for sm_90a at first use, loaded
with ctypes, launched on PyTorch's current stream) or raises; on a CPU
tensor it runs ``correlate_bank_plain``.

What bounds the kernel on an H100, and what its design does about it: per
sample the work is an int8 record read, a few replica reads per bank and
~20-45 FLOPs; at the ported paths' 12-15 channels x 18 008-180 008 samples
per epoch that is a few microseconds of memory or arithmetic time at most.
It is bound by the launch and by using only one block per channel row
(12-15 of 132 SMs): the kernel uses wide blocks (512 threads), computes
the carrier's u and v factors once per block in shared memory and touches
each sample once.  See the source for the rest.

The Mosaic-only machinery of the TPU kernel has no counterpart here: the
record stays interleaved int8 I/Q, windows are read at any int64 offset by
pointer arithmetic (no 512-sample-aligned DMA, no re-layout, no in-kernel
rotate, no residual folded into the carrier phase) and the bank needs no
padding to 8-channel blocks.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

_TWO_PI = float(np.float32(2.0 * np.pi))

_SRC = Path(__file__).resolve().parent / "csrc" / "correlator.cu"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the kernel keeps u (2 * ceil(blk / 128) floats) and v (256 floats) in
# the 48 KB of shared memory a launch gets without opting in (less 2 KB
# for the reduction's partial sums)
MAX_BLK = 128 * (46 * 1024 // 4 - 256) // 2
# kernel variants by number of pilot banks, as chip_smoke.py names them
VARIANTS = ("correlate_bank", "correlate_bank_pilot",
            "correlate_bank_dual_pilot")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA correlator is built "
                           "from csrc/correlator.cu at first use")
    return path


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library.

    The shared object is named by a hash of the source and flags, so an
    edited source is rebuilt; the compiler's register and spill report
    is kept beside it as ``<name>.log``."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"libcorrelator_{digest[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                              str(_SRC)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        so.with_suffix(".log").write_text(res.stdout + res.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.correlate_bank_launch.argtypes = [
        p, p, p, p, p, p, p, p, p, p, p,
        i32, i32, i32, i64, i32,
        p, p, p, i64, i32, i32, i32, ctypes.c_float, ctypes.c_float,
        p]
    lib.correlate_bank_launch.restype = ctypes.c_int
    return lib


def _check_vectors(dev, c, named):
    for name, x, dt in named:
        if x.dtype != dt or x.shape != (c,):
            raise ValueError(f"{name} must be {dt} of shape ({c},), got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, iq on {dev}")


def _check(iq, off, table, wrow, start, alpha, remc, shi, slo, bsz, k,
           blk, ptable, pstart, palpha):
    dev = iq.device
    if iq.dtype != torch.int8 or iq.dim() != 1 or iq.numel() % 2:
        raise ValueError("iq must be a 1-D int8 tensor of interleaved I/Q")
    if table.dtype != torch.int8 or table.dim() != 2:
        raise ValueError("table must be a 2-D int8 tensor [R, L]")
    c = off.shape[0]
    _check_vectors(dev, c, (
        ("off", off, torch.int64), ("wrow", wrow, torch.int64),
        ("start", start, torch.int64), ("bsz", bsz, torch.int64),
        ("alpha", alpha, torch.float32), ("remc", remc, torch.float32),
        ("shi", shi, torch.float32), ("slo", slo, torch.float32)))
    if table.device != dev:
        raise ValueError(f"table is on {table.device}, iq on {dev}")
    if k < 1:
        raise ValueError(f"E-L spacing k={k} samples must be >= 1")
    win = blk + 2 * k + 1
    if iq.numel() // 2 < blk or table.shape[1] < win:
        raise ValueError("record or replica table shorter than one window")
    if ptable is None:
        if pstart is not None or palpha is not None:
            raise ValueError("pstart/palpha given without a pilot table")
        return
    if (ptable.dtype != torch.int8 or ptable.dim() not in (2, 3)
            or (ptable.dim() == 3 and ptable.shape[1] != 2)):
        raise ValueError("ptable must be an int8 tensor [R, Lp] or, for "
                         "the dual bank, [R, 2, Lp]")
    if ptable.device != dev:
        raise ValueError(f"ptable is on {ptable.device}, iq on {dev}")
    if ptable.shape[0] != table.shape[0]:
        raise ValueError(f"ptable has {ptable.shape[0]} rows, table "
                         f"{table.shape[0]}")
    if ptable.shape[-1] < win:
        raise ValueError("pilot table shorter than one window")
    if pstart is None or palpha is None:
        raise ValueError("a pilot table needs pstart and palpha")
    _check_vectors(dev, c, (("pstart", pstart, torch.int64),
                            ("palpha", palpha, torch.float32)))


def _clamp(x, size: int, win: int):
    """Clamp window offsets as ``jax.lax.dynamic_slice`` clamps them: a
    negative offset counts from the end, then a window that would run past
    the end starts at the last full window (and at 0 below the start), so
    no read leaves the record or table."""
    return torch.where(x < 0, x + size, x).clamp(0, size - win)


def _rotate(sums, rot: int):
    """j^rot · (i + jq) for each (i, q) pair of a six-sum list."""
    out = []
    for i, q in zip(sums[0::2], sums[1::2]):
        out += [(i, q), (-q, i), (-i, -q), (q, -i)][rot % 4]
    return out


def correlate_bank_plain(iq, off, table, wrow, start, alpha, remc, shi,
                         slo, bsz, *, k: int, blk: int,
                         interp_taps: bool = True, ptable=None, pstart=None,
                         palpha=None, pilot_rot: int = 1,
                         pilot2_rot: int = 2, pilot_w1: float = 1.0,
                         pilot_w2: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same signature and layout.

    iq: [2S] int8 interleaved I/Q record; off: [C] int64 window start
    (samples into iq); table: [R, L] int8 replica tables; wrow: [C] int64
    table row; start: [C] int64 replica window start (tap E of sample 0);
    alpha/remc/shi/slo: [C] f32 interpolation fraction, carrier phase
    [cycles] and the u/v carrier steps frac(128·inc), frac(inc); bsz: [C]
    int64 valid samples.  Returns [C, 8] f32: iE qE iP qP iL qL 0 0.

    Pilot banks: ptable [R, Lp] int8 (or [R, 2, Lp] for the dual bank),
    read at row wrow from pstart [C] int64 with fraction palpha [C] f32.
    Their sums are rotated by j^pilot_rot (bank 2 by j^pilot2_rot) and the
    dual banks combined as pilot_w1·bank1 + pilot_w2·bank2.  Returns then
    [C, 16]: iE qE iP qP iL qL piE pqE piP pqP piL pqL 0 0 0 0.

    Offsets are clamped into range (``_clamp``: ``pstart`` against the
    pilot table's own length); ``wrow`` must index rows of ``table``
    (values are not checked: that would cost a host sync).
    """
    _check(iq, off, table, wrow, start, alpha, remc, shi, slo, bsz, k,
           blk, ptable, pstart, palpha)
    win = blk + 2 * k + 1
    off = _clamp(off, iq.shape[0] // 2, blk)
    start = _clamp(start, table.shape[1], win)
    dev = iq.device
    n = torch.arange(blk, device=dev)
    idx = 2 * (off[:, None] + n[None, :])
    si = iq[idx].float()
    sq = iq[idx + 1].float()
    # carrier as u[t]·v[l] with n = 128 t + l (see csrc/correlator.cu)
    t_f = torch.arange((blk + 127) // 128, device=dev, dtype=torch.float32)
    l_f = torch.arange(128, device=dev, dtype=torch.float32)
    pu = remc[:, None] + shi[:, None] * t_f[None, :]
    pu = (pu - torch.floor(pu)) * _TWO_PI
    pv = slo[:, None] * l_f[None, :]
    pv = (pv - torch.floor(pv)) * _TWO_PI
    ur, ui = torch.cos(pu)[:, n // 128], torch.sin(pu)[:, n // 128]
    vr, vi = torch.cos(pv)[:, n % 128], torch.sin(pv)[:, n % 128]
    cosw = ur * vr - ui * vi
    sinw = ur * vi + ui * vr
    mask = (n[None, :] < bsz[:, None]).float()
    bb_i = (si * cosw + sq * sinw) * mask
    bb_q = (sq * cosw - si * sinw) * mask
    m = torch.arange(win, device=dev)

    def tap_sums(tab, s0, frac):
        """Six E/P/L x I/Q sums on the window tab[wrow, s0:s0 + win]."""
        w = tab[wrow[:, None], s0[:, None] + m].float()
        a_col = frac[:, None]
        sums = []
        for d in (0, k, 2 * k):
            r = w[:, d:d + blk]
            if interp_taps:
                r = r + a_col * (w[:, d + 1:d + 1 + blk] - r)
            sums += [(r * bb_i).sum(1), (r * bb_q).sum(1)]
        return sums

    sums = tap_sums(table, start, alpha)
    z = torch.zeros_like(sums[0])
    if ptable is None:
        return torch.stack(sums + [z, z], dim=1)
    pstart = _clamp(pstart, ptable.shape[-1], win)
    banks = [ptable] if ptable.dim() == 2 else [ptable[:, 0], ptable[:, 1]]
    psums = _rotate(tap_sums(banks[0], pstart, palpha), pilot_rot)
    if len(banks) == 2:
        psums2 = _rotate(tap_sums(banks[1], pstart, palpha), pilot2_rot)
        psums = [pilot_w1 * a + pilot_w2 * b for a, b in zip(psums, psums2)]
    return torch.stack(sums + psums + [z] * 4, dim=1)


def correlate_bank(iq, off, table, wrow, start, alpha, remc, shi, slo,
                   bsz, *, k: int, blk: int, interp_taps: bool = True,
                   ptable=None, pstart=None, palpha=None,
                   pilot_rot: int = 1, pilot2_rot: int = 2,
                   pilot_w1: float = 1.0,
                   pilot_w2: float = 0.0) -> torch.Tensor:
    """Correlator sums of one epoch for a channel bank (arguments as
    ``correlate_bank_plain``).  CUDA tensors launch the kernel — a build
    or launch failure raises; CPU tensors take the plain version."""
    pilot = dict(ptable=ptable, pstart=pstart, palpha=palpha,
                 pilot_rot=pilot_rot, pilot2_rot=pilot2_rot,
                 pilot_w1=pilot_w1, pilot_w2=pilot_w2)
    if iq.device.type == "cpu":
        return correlate_bank_plain(iq, off, table, wrow, start, alpha,
                                    remc, shi, slo, bsz, k=k, blk=blk,
                                    interp_taps=interp_taps, **pilot)
    if iq.device.type != "cuda":
        raise ValueError(f"no correlator for device {iq.device}")
    _check(iq, off, table, wrow, start, alpha, remc, shi, slo, bsz, k,
           blk, ptable, pstart, palpha)
    if not (iq.is_contiguous() and table.is_contiguous()
            and (ptable is None or ptable.is_contiguous())):
        raise ValueError("iq, table and ptable must be contiguous")
    if iq.data_ptr() % 2:
        # the kernel reads each I/Q pair as one 2-byte char2
        raise ValueError("iq must start at an even address")
    if blk > MAX_BLK:
        raise ValueError(f"blk={blk} exceeds the kernel's {MAX_BLK}: its "
                         "carrier factors would overflow 48 KB of shared "
                         "memory")
    win = blk + 2 * k + 1
    off = _clamp(off, iq.shape[0] // 2, blk)
    start = _clamp(start, table.shape[1], win)
    wrow, alpha, remc, shi, slo, bsz = (
        x.contiguous() for x in (wrow, alpha, remc, shi, slo, bsz))
    n_pilots, p_ptr, ps_ptr, pa_ptr, p_len = 0, None, None, None, 0
    if ptable is not None:
        n_pilots = 1 if ptable.dim() == 2 else 2
        pstart = _clamp(pstart, ptable.shape[-1], win)
        palpha = palpha.contiguous()
        p_ptr, ps_ptr, pa_ptr = (ptable.data_ptr(), pstart.data_ptr(),
                                 palpha.data_ptr())
        p_len = int(ptable.shape[-1])
    c = off.shape[0]
    out = torch.empty((c, 16 if n_pilots else 8), dtype=torch.float32,
                      device=iq.device)
    lib = load_library()
    rc = lib.correlate_bank_launch(
        iq.data_ptr(), off.data_ptr(), table.data_ptr(), wrow.data_ptr(),
        start.data_ptr(), alpha.data_ptr(), remc.data_ptr(),
        shi.data_ptr(), slo.data_ptr(), bsz.data_ptr(), out.data_ptr(),
        c, int(blk), int(k), int(table.shape[1]), int(bool(interp_taps)),
        p_ptr, ps_ptr, pa_ptr, p_len, n_pilots, int(pilot_rot) % 4,
        int(pilot2_rot) % 4, float(pilot_w1), float(pilot_w2),
        torch.cuda.current_stream(iq.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"correlate_bank launch failed: CUDA error {rc}")
    correlate_bank.launches[VARIANTS[n_pilots]] += 1
    return out


def reset_launches() -> None:
    """Set every launch count to 0."""
    correlate_bank.launches = dict.fromkeys(VARIANTS, 0)


# Kernel launches since the last reset, by variant (chip_smoke.py reads
# them to show each path ran on its kernel).
reset_launches()
