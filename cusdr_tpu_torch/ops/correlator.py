"""Epoch correlators for a channel bank: the CUDA kernels and their plain
PyTorch versions.

Two kernel sources, one wrapper each per TPU kernel they replace:

``csrc/correlator.cu`` — ``correlate_bank`` replaces ``correlate_bank_hbm``
(cusdr_tpu/ops/correlator.py:563; Pallas call built by ``_build_call_hbm``,
body ``_correlate_rows``) in its three variants, each in both tap modes:
no pilot (``[C, 8]`` out), pilot (``wp4``: six more sums on a second
replica window, ``[C, 16]`` out) and dual pilot (``wp24``: B1C WB QMBOC,
two pilot banks combined in the kernel).  The windows are read in the
kernel from the record and the tables at per-row offsets.

``csrc/correlator_staged.cu`` — the same sums on windows that were sliced
before the launch: ``correlate_windows`` replaces ``correlate_bank``
(cusdr_tpu/ops/correlator.py:237, ``_build_call``; all three pilot variants,
both tap modes, u·v carrier), ``correlate_windows_ramp`` replaces
``make_correlate_kernel`` (tools/perf_pallas.py:30; per-sample phase ramp)
and ``correlate_windows_table`` replaces ``make_table_carrier_kernel``
(tools/perf_pallas.py:208; carrier from cos/sin basis tables).

On a CUDA tensor a wrapper launches its kernel (built with nvcc for sm_90a
at first use, loaded with ctypes, launched on PyTorch's current stream) or
raises; on a CPU tensor it runs the ``*_plain`` version beside it.  Each
launch adds one to ``LAUNCHES[<variant>]``.

What bounds the kernels on an H100, and what their design does about it:
per sample the work is an int8 sample read, a few replica reads per bank
and ~20-45 FLOPs; at the ported paths' 12-96 rows x 18 008-180 008 samples
per epoch that is a few microseconds of memory or arithmetic time at most.
They are bound by the launch and by using only one block per row (12-96 of
132 SMs): the kernels use wide blocks (512 threads), compute the carrier's
u and v factors once per block in shared memory and touch each sample
once.  See the sources for the rest.

The Mosaic-only machinery of the TPU kernels has no counterpart here: the
record stays interleaved int8 I/Q, windows are read at any int64 offset by
pointer arithmetic (no 512-sample-aligned DMA, no re-layout, no in-kernel
rotate, no residual folded into the carrier phase), the bank needs no
padding to 8-channel blocks, window lengths need not be multiples of 128
and no fast-memory budget limits the staged windows.
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

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
# kernel sources by library name; both include correlator_common.cuh
SOURCES = ("correlator", "correlator_staged")
_HEADER = "correlator_common.cuh"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the u·v kernels keep u (2 * ceil(blk / 128) floats) and v (256 floats) in
# the 48 KB of shared memory a launch gets without opting in (less 2 KB
# for the reduction's partial sums)
MAX_BLK = 128 * (46 * 1024 // 4 - 256) // 2
# kernel variants by number of pilot banks, as chip_smoke.py names them
VARIANTS = ("correlate_bank", "correlate_bank_pilot",
            "correlate_bank_dual_pilot")
WINDOW_VARIANTS = ("correlate_windows", "correlate_windows_pilot",
                   "correlate_windows_dual_pilot")
# kernel launches since the last reset, by variant (chip_smoke.py reads them
# to show each path ran on its kernel)
LAUNCHES = dict.fromkeys(VARIANTS + WINDOW_VARIANTS + (
    "correlate_windows_ramp", "correlate_windows_table"), 0)


def reset_launches() -> None:
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA correlators are built "
                           "from ops/csrc/*.cu at first use")
    return path


def _declare(lib: ctypes.CDLL, name: str) -> None:
    p, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)
    if name == "correlator":
        signatures = {"correlate_bank_launch": [
            p, p, p, p, p, p, p, p, p, p, p,
            i32, i32, i32, i64, i32,
            p, p, p, i64, i32, i32, i32, f32, f32,
            p]}
    else:
        signatures = {
            "correlate_windows_launch": [
                p, p, p, p, p, p, p, p, p, p,
                i32, i32, i32, i64, i32, i32, i32, i32, f32, f32, p],
            "correlate_windows_ramp_launch": [
                p, p, p, p, p, p, p, p, i32, i32, i32, i64, p],
            "correlate_windows_table_launch": [
                p, p, p, p, p, p, p, p, p, i32, i32, i32, i64, p]}
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int


@functools.lru_cache(maxsize=None)
def load_library(name: str = "correlator") -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library
    ``name`` (one of ``SOURCES``).

    The shared object is named by a hash of the source, the shared header
    and the flags, so an edited source is rebuilt; the compiler's register
    and spill report is kept beside it as ``<name>.log``."""
    if name not in SOURCES:
        raise ValueError(f"no kernel source {name!r}; have {SOURCES}")
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + (CSRC_DIR / _HEADER).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"lib{name}_{digest[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                              str(src)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        so.with_suffix(".log").write_text(res.stdout + res.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _declare(lib, name)
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


def _uv_carrier(remc, shi, slo, blk: int):
    """cos and sin [C, blk] of the carrier as u[t]·v[l] with n = 128 t + l
    (see csrc/correlator_common.cuh)."""
    dev = remc.device
    n = torch.arange(blk, device=dev)
    t_f = torch.arange((blk + 127) // 128, device=dev, dtype=torch.float32)
    l_f = torch.arange(128, device=dev, dtype=torch.float32)
    pu = remc[:, None] + shi[:, None] * t_f[None, :]
    pu = (pu - torch.floor(pu)) * _TWO_PI
    pv = slo[:, None] * l_f[None, :]
    pv = (pv - torch.floor(pv)) * _TWO_PI
    ur, ui = torch.cos(pu)[:, n // 128], torch.sin(pu)[:, n // 128]
    vr, vi = torch.cos(pv)[:, n % 128], torch.sin(pv)[:, n % 128]
    return ur * vr - ui * vi, ur * vi + ui * vr


def _baseband(siq, cosw, sinw, bsz):
    """Carrier wipe-off of the sample windows siq [C, blk, 2] int8, masked
    to each row's first bsz samples.  Returns (bb_i, bb_q) [C, blk] f32."""
    si, sq = siq[..., 0].float(), siq[..., 1].float()
    n = torch.arange(siq.shape[1], device=siq.device)
    mask = (n[None, :] < bsz[:, None]).float()
    return (si * cosw + sq * sinw) * mask, (sq * cosw - si * sinw) * mask


def _tap_sums(w, frac, bb_i, bb_q, k: int, interp_taps: bool):
    """Six E/P/L x I/Q sums of the replica windows w [C, >= blk + 2k + 1]
    (tap E of sample 0 at column 0) against the baseband."""
    blk = bb_i.shape[1]
    w = w.float()
    sums = []
    for d in (0, k, 2 * k):
        r = w[:, d:d + blk]
        if interp_taps:
            r = r + frac[:, None] * (w[:, d + 1:d + 1 + blk] - r)
        sums += [(r * bb_i).sum(1), (r * bb_q).sum(1)]
    return sums


def _pack(sums, pilot_sums, pilot_rot, pilot2_rot, pilot_w1, pilot_w2):
    """Output rows [C, 8], or [C, 16] with the rotated (and, for two banks,
    combined) pilot sums; ``pilot_sums`` is a list of 0-2 six-sum lists."""
    z = torch.zeros_like(sums[0])
    if not pilot_sums:
        return torch.stack(sums + [z, z], dim=1)
    psums = _rotate(pilot_sums[0], pilot_rot)
    if len(pilot_sums) == 2:
        psums2 = _rotate(pilot_sums[1], pilot2_rot)
        psums = [pilot_w1 * a + pilot_w2 * b for a, b in zip(psums, psums2)]
    return torch.stack(sums + psums + [z] * 4, dim=1)


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
    siq, wt, wp = stage_windows(iq, off, table, wrow, start, k=k, blk=blk,
                                ptable=ptable, pstart=pstart)
    return correlate_windows_plain(
        siq, wt, alpha, remc, shi, slo, bsz, k=k, interp_taps=interp_taps,
        wp=wp, palpha=palpha, pilot_rot=pilot_rot, pilot2_rot=pilot2_rot,
        pilot_w1=pilot_w1, pilot_w2=pilot_w2)


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
    if not _on_card("correlate_bank", iq, table,
                    *(() if ptable is None else (ptable,))):
        return correlate_bank_plain(iq, off, table, wrow, start, alpha,
                                    remc, shi, slo, bsz, k=k, blk=blk,
                                    interp_taps=interp_taps, **pilot)
    _check(iq, off, table, wrow, start, alpha, remc, shi, slo, bsz, k,
           blk, ptable, pstart, palpha)
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
    _launched(VARIANTS[n_pilots], rc)
    return out


# --------------------------------------------------------------------------
# Staged windows
# --------------------------------------------------------------------------

def stage_windows(iq, off, table, wrow, start, *, k: int, blk: int,
                  ptable=None, pstart=None):
    """Slice each row's windows out of the record and the tables, as the
    reference stages them with ``dynamic_slice`` before its staged kernel
    (offsets clamped by ``_clamp``).  Arguments as ``correlate_bank_plain``.
    Returns (siq [C, blk, 2], wt [C, win], wp [C, win] / [C, 2, win] /
    None), win = blk + 2k + 1, all int8 and contiguous."""
    win = blk + 2 * k + 1
    dev = iq.device
    off = _clamp(off, iq.shape[0] // 2, blk)
    siq = iq.view(-1, 2)[off[:, None] + torch.arange(blk, device=dev)]
    m = torch.arange(win, device=dev)
    start = _clamp(start, table.shape[1], win)
    wt = table[wrow[:, None], start[:, None] + m]
    wp = None
    if ptable is not None:
        pidx = _clamp(pstart, ptable.shape[-1], win)[:, None] + m
        if ptable.dim() == 2:
            wp = ptable[wrow[:, None], pidx]
        else:
            wp = ptable[wrow[:, None, None],
                        torch.arange(2, device=dev)[None, :, None],
                        pidx[:, None, :]]
    return siq, wt, wp


def _check_windows(siq, wt, k, named_f32, bsz, wp=None, palpha=None):
    """Shapes, types and devices of staged-window arguments; returns
    (C, blk, win)."""
    if siq.dtype != torch.int8 or siq.dim() != 3 or siq.shape[2] != 2:
        raise ValueError("siq must be an int8 tensor [C, blk, 2] of I/Q "
                         "sample windows")
    c, blk, _ = siq.shape
    if k < 1:
        raise ValueError(f"E-L spacing k={k} samples must be >= 1")
    if (wt.dtype != torch.int8 or wt.dim() != 2 or wt.shape[0] != c
            or wt.shape[1] < blk + 2 * k + 1):
        raise ValueError(f"wt must be int8 [{c}, >= {blk + 2 * k + 1}], got "
                         f"{wt.dtype} {tuple(wt.shape)}")
    if wt.device != siq.device:
        raise ValueError(f"wt is on {wt.device}, siq on {siq.device}")
    _check_vectors(siq.device, c, [(n, x, torch.float32)
                                   for n, x in named_f32]
                   + [("bsz", bsz, torch.int64)])
    if wp is None:
        if palpha is not None:
            raise ValueError("palpha given without pilot windows")
        return c, blk, wt.shape[1]
    if (wp.dtype != torch.int8 or wp.shape[0] != c
            or wp.shape[-1] != wt.shape[1]
            or not (wp.dim() == 2 or (wp.dim() == 3 and wp.shape[1] == 2))):
        raise ValueError("wp must be int8 pilot windows [C, win] or, for "
                         "the dual bank, [C, 2, win], win as wt's")
    if wp.device != siq.device:
        raise ValueError(f"wp is on {wp.device}, siq on {siq.device}")
    if palpha is None:
        raise ValueError("pilot windows need palpha")
    _check_vectors(siq.device, c, [("palpha", palpha, torch.float32)])
    return c, blk, wt.shape[1]


def _on_card(name: str, samples, *others):
    """False for CPU tensors (the caller takes its plain version); True
    for CUDA tensors the kernel can take; raises otherwise.  ``samples``
    holds the interleaved I/Q pairs, ``others`` the replica tensors."""
    if samples.device.type == "cpu":
        return False
    if samples.device.type != "cuda":
        raise ValueError(f"no correlator for device {samples.device}")
    if not all(x.is_contiguous() for x in (samples, *others)):
        raise ValueError(f"{name}: samples and replicas must be contiguous")
    if samples.data_ptr() % 2:
        # the kernels read each I/Q pair as one 2-byte char2
        raise ValueError("the samples must start at an even address")
    return True


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def correlate_windows_plain(siq, wt, alpha, remc, shi, slo, bsz, *, k: int,
                            interp_taps: bool = True, wp=None, palpha=None,
                            pilot_rot: int = 1, pilot2_rot: int = 2,
                            pilot_w1: float = 1.0,
                            pilot_w2: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of ``correlate_windows``.

    siq: [C, blk, 2] int8 sample windows, I and Q of a sample side by side
    (the record's own interleaving, so staging is one gather); wt: [C, win]
    int8 replica windows, win >= blk + 2k + 1, tap E of sample 0 at column
    0; alpha/remc/shi/slo: [C] f32 as in ``correlate_bank_plain``; bsz: [C]
    int64 valid samples; wp: pilot windows [C, win] or [C, 2, win] (dual
    bank) with fraction palpha [C] f32.  Returns [C, 8] or, with pilot
    windows, [C, 16], laid out as ``correlate_bank_plain``'s."""
    _check_windows(siq, wt, k, (("alpha", alpha), ("remc", remc),
                                ("shi", shi), ("slo", slo)), bsz, wp, palpha)
    cosw, sinw = _uv_carrier(remc, shi, slo, siq.shape[1])
    bb_i, bb_q = _baseband(siq, cosw, sinw, bsz)
    banks = [] if wp is None else [wp] if wp.dim() == 2 else [wp[:, 0],
                                                             wp[:, 1]]
    return _pack(_tap_sums(wt, alpha, bb_i, bb_q, k, interp_taps),
                 [_tap_sums(b, palpha, bb_i, bb_q, k, interp_taps)
                  for b in banks],
                 pilot_rot, pilot2_rot, pilot_w1, pilot_w2)


def correlate_windows(siq, wt, alpha, remc, shi, slo, bsz, *, k: int,
                      interp_taps: bool = True, wp=None, palpha=None,
                      pilot_rot: int = 1, pilot2_rot: int = 2,
                      pilot_w1: float = 1.0,
                      pilot_w2: float = 0.0) -> torch.Tensor:
    """Correlator sums of one epoch on staged windows (arguments as
    ``correlate_windows_plain``).  CUDA tensors launch the kernel — a build
    or launch failure raises; CPU tensors take the plain version."""
    if not _on_card("correlate_windows", siq, wt,
                    *(() if wp is None else (wp,))):
        return correlate_windows_plain(
            siq, wt, alpha, remc, shi, slo, bsz, k=k,
            interp_taps=interp_taps, wp=wp, palpha=palpha,
            pilot_rot=pilot_rot, pilot2_rot=pilot2_rot, pilot_w1=pilot_w1,
            pilot_w2=pilot_w2)
    c, blk, win = _check_windows(
        siq, wt, k, (("alpha", alpha), ("remc", remc), ("shi", shi),
                     ("slo", slo)), bsz, wp, palpha)
    if blk > MAX_BLK:
        raise ValueError(f"blk={blk} exceeds the kernel's {MAX_BLK}: its "
                         "carrier factors would overflow 48 KB of shared "
                         "memory")
    alpha, remc, shi, slo, bsz = (
        x.contiguous() for x in (alpha, remc, shi, slo, bsz))
    n_pilots, wp_ptr, pa_ptr = 0, None, None
    if wp is not None:
        n_pilots = wp.dim() - 1
        palpha = palpha.contiguous()
        wp_ptr, pa_ptr = wp.data_ptr(), palpha.data_ptr()
    out = torch.empty((c, 16 if n_pilots else 8), dtype=torch.float32,
                      device=siq.device)
    rc = load_library("correlator_staged").correlate_windows_launch(
        siq.data_ptr(), wt.data_ptr(), wp_ptr, alpha.data_ptr(), pa_ptr,
        remc.data_ptr(), shi.data_ptr(), slo.data_ptr(), bsz.data_ptr(),
        out.data_ptr(), c, blk, int(k), win, int(bool(interp_taps)),
        n_pilots, int(pilot_rot) % 4, int(pilot2_rot) % 4, float(pilot_w1),
        float(pilot_w2), torch.cuda.current_stream(siq.device).cuda_stream)
    _launched(WINDOW_VARIANTS[n_pilots], rc)
    return out


def correlate_windows_ramp_plain(siq, wt, alpha, remc, shi, slo, bsz, *,
                                 k: int) -> torch.Tensor:
    """Plain PyTorch version of ``correlate_windows_ramp``: the no-pilot,
    interpolated-tap sums with the carrier from a per-sample phase
    ``remc + shi·⌊n/256⌋ + slo·(n mod 256)`` [cycles] (shi =
    frac(256·inc), slo = frac(inc)), cos and sin taken per sample.  Other
    arguments as ``correlate_windows_plain``; returns [C, 8]."""
    _check_windows(siq, wt, k, (("alpha", alpha), ("remc", remc),
                                ("shi", shi), ("slo", slo)), bsz)
    n = torch.arange(siq.shape[1], device=siq.device)
    n_hi = (n // 256).float()
    n_lo = (n % 256).float()
    cyc = (remc[:, None] + shi[:, None] * n_hi[None, :]
           + slo[:, None] * n_lo[None, :])
    ph = (cyc - torch.floor(cyc)) * _TWO_PI
    bb_i, bb_q = _baseband(siq, torch.cos(ph), torch.sin(ph), bsz)
    return _pack(_tap_sums(wt, alpha, bb_i, bb_q, k, True), [], 0, 0, 0, 0)


def correlate_windows_ramp(siq, wt, alpha, remc, shi, slo, bsz, *,
                           k: int) -> torch.Tensor:
    """Phase-ramp correlator on staged windows (arguments as
    ``correlate_windows_ramp_plain``).  CUDA tensors launch the kernel or
    raise; CPU tensors take the plain version."""
    if not _on_card("correlate_windows_ramp", siq, wt):
        return correlate_windows_ramp_plain(siq, wt, alpha, remc, shi, slo,
                                            bsz, k=k)
    c, blk, win = _check_windows(
        siq, wt, k, (("alpha", alpha), ("remc", remc), ("shi", shi),
                     ("slo", slo)), bsz)
    alpha, remc, shi, slo, bsz = (
        x.contiguous() for x in (alpha, remc, shi, slo, bsz))
    out = torch.empty((c, 8), dtype=torch.float32, device=siq.device)
    rc = load_library("correlator_staged").correlate_windows_ramp_launch(
        siq.data_ptr(), wt.data_ptr(), alpha.data_ptr(), remc.data_ptr(),
        shi.data_ptr(), slo.data_ptr(), bsz.data_ptr(), out.data_ptr(), c,
        blk, int(k), win, torch.cuda.current_stream(siq.device).cuda_stream)
    _launched("correlate_windows_ramp", rc)
    return out


def _check_basis(siq, tc, ts):
    for name, x in (("tc", tc), ("ts", ts)):
        if (x.dtype != torch.float32 or x.shape != siq.shape[:2]
                or x.device != siq.device):
            raise ValueError(f"{name} must be f32 {tuple(siq.shape[:2])} on "
                             f"{siq.device}, got {x.dtype} {tuple(x.shape)} "
                             f"on {x.device}")


def correlate_windows_table_plain(siq, wt, tc, ts, alpha, c0, s0, bsz, *,
                                  k: int) -> torch.Tensor:
    """Plain PyTorch version of ``correlate_windows_table``: the no-pilot,
    interpolated-tap sums with the carrier from basis tables tc, ts
    [C, blk] f32 (cos and sin of the row's fixed-frequency ramp) rotated by
    the epoch's starting phase (c0, s0) [C] f32: ``cos = c0·tc − s0·ts``,
    ``sin = s0·tc + c0·ts``.  Other arguments as
    ``correlate_windows_plain``; returns [C, 8]."""
    _check_windows(siq, wt, k, (("alpha", alpha), ("c0", c0), ("s0", s0)),
                   bsz)
    _check_basis(siq, tc, ts)
    cosw = c0[:, None] * tc - s0[:, None] * ts
    sinw = s0[:, None] * tc + c0[:, None] * ts
    bb_i, bb_q = _baseband(siq, cosw, sinw, bsz)
    return _pack(_tap_sums(wt, alpha, bb_i, bb_q, k, True), [], 0, 0, 0, 0)


def correlate_windows_table(siq, wt, tc, ts, alpha, c0, s0, bsz, *,
                            k: int) -> torch.Tensor:
    """Table-carrier correlator on staged windows (arguments as
    ``correlate_windows_table_plain``).  CUDA tensors launch the kernel or
    raise; CPU tensors take the plain version."""
    if not _on_card("correlate_windows_table", siq, wt, tc, ts):
        return correlate_windows_table_plain(siq, wt, tc, ts, alpha, c0, s0,
                                             bsz, k=k)
    c, blk, win = _check_windows(
        siq, wt, k, (("alpha", alpha), ("c0", c0), ("s0", s0)), bsz)
    _check_basis(siq, tc, ts)
    alpha, c0, s0, bsz = (x.contiguous() for x in (alpha, c0, s0, bsz))
    out = torch.empty((c, 8), dtype=torch.float32, device=siq.device)
    rc = load_library("correlator_staged").correlate_windows_table_launch(
        siq.data_ptr(), wt.data_ptr(), tc.data_ptr(), ts.data_ptr(),
        alpha.data_ptr(), c0.data_ptr(), s0.data_ptr(), bsz.data_ptr(),
        out.data_ptr(), c, blk, int(k), win,
        torch.cuda.current_stream(siq.device).cuda_stream)
    _launched("correlate_windows_table", rc)
    return out
