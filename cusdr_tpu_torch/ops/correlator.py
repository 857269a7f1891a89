"""Epoch correlators for a channel bank: the CUDA kernels and their plain
PyTorch versions.

Three kernel sources.  Two hold one wrapper per TPU kernel they replace:

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

``csrc/superblock.cu`` — ``track_superblock_bank`` is the redesign of
``correlate_bank`` for the card: one launch runs every epoch of a superblock
for the whole bank, window geometry, correlator sums (the same device code)
and loop closure included, in the same three variants and both tap modes.
Its plain version is the eager epoch loop of tracking/engine.py
(``track_superblock_epochs``), which calls ``correlate_bank`` once per
epoch; the engine picks between the two by where the record lies.

``csrc/superblock_staged.cu`` — ``track_superblock_staged_bank`` is the
same redesign of ``correlate_windows``: one launch per superblock, each
epoch's windows staged into a ring in shared memory by asynchronous bulk
copies that run ahead of the sums and across the loop closing
(``stage_plan`` lays the ring out).  Its plain version is the eager loop on
staged windows (``fetch_in_kernel=False``), which calls
``correlate_windows`` once per epoch.

On a CUDA tensor a wrapper launches its kernel (built with nvcc for sm_90a
at first use, loaded with ctypes, launched on PyTorch's current stream) or
raises; on a CPU tensor it runs the ``*_plain`` version beside it
(``track_superblock_bank`` takes CUDA tensors only).  Each launch adds one
to ``LAUNCHES[<variant>]``.

The record's samples are int8 or int16 I/Q (``cfg.data_type`` "schar" or
"int16").  ``correlate_bank``, ``correlate_windows`` and the two superblock
kernels are instantiated for both (a ``char2`` or ``short2`` load per
sample, then the same f32 arithmetic); the wrapper picks the library symbol
by the tensor's dtype (``<symbol>_int16``) and counts an int16 launch under
``<variant>[int16]``.  The plain versions convert the samples to f32 and do
not care which.  The phase-ramp and table-carrier prototypes take int8.

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
from typing import NamedTuple

import numpy as np
import torch

_TWO_PI = float(np.float32(2.0 * np.pi))

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
# kernel sources by library name; all include correlator_common.cuh, the
# superblock kernels superblock_common.cuh
SOURCES = ("correlator", "correlator_staged", "superblock",
           "superblock_staged")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the u·v kernels keep u (2 * ceil(blk / 128) floats) and v (256 floats) in
# the 48 KB of shared memory a launch gets without opting in (less 2 KB
# for the reduction's partial sums and, in the superblock kernel, the row's
# state and geometry: 1.5 KB at most together)
MAX_BLK = 128 * (46 * 1024 // 4 - 256) // 2
# kernel variants by number of pilot banks, as chip_smoke.py names them
VARIANTS = ("correlate_bank", "correlate_bank_pilot",
            "correlate_bank_dual_pilot")
WINDOW_VARIANTS = ("correlate_windows", "correlate_windows_pilot",
                   "correlate_windows_dual_pilot")
SUPERBLOCK_VARIANTS = ("track_superblock", "track_superblock_pilot",
                       "track_superblock_dual_pilot")
STAGED_SUPERBLOCK_VARIANTS = ("track_superblock_staged",
                              "track_superblock_staged_pilot",
                              "track_superblock_staged_dual_pilot")
# streaming multiprocessors of the H100: a bank takes as many thread blocks
# per channel row (a cluster, at most 8) as fit on the card at once
N_SMS = 132
# record sample types: the suffix of the library symbol that reads them
SAMPLE_SYMBOLS = {torch.int8: "", torch.int16: "_int16"}
_INT16_VARIANTS = tuple(f"{v}[int16]" for v in (
    VARIANTS + WINDOW_VARIANTS + SUPERBLOCK_VARIANTS
    + STAGED_SUPERBLOCK_VARIANTS))
# kernel launches since the last reset, by variant and sample type
# (chip_smoke.py reads them to show each path ran on its kernel)
LAUNCHES = dict.fromkeys(VARIANTS + WINDOW_VARIANTS + (
    "correlate_windows_ramp", "correlate_windows_table")
    + SUPERBLOCK_VARIANTS + STAGED_SUPERBLOCK_VARIANTS + _INT16_VARIANTS, 0)


def launch_name(variant: str, dtype) -> str:
    """The launch count of ``variant`` on samples of ``dtype``:
    ``variant`` for int8, ``variant[int16]`` for int16."""
    return variant if dtype == torch.int8 else f"{variant}[int16]"


def _sample_symbol(fn: str, samples) -> str:
    """The library symbol ``fn`` for the dtype of ``samples``."""
    return fn + SAMPLE_SYMBOLS[samples.dtype]


def reset_launches() -> None:
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class SuperblockArgs(ctypes.Structure):
    """Arguments of one ``track_superblock_launch``: the structure of the
    same name in csrc/superblock.cu, field by field."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "iq", "table", "ptable", "state_in", "abs_in", "pper_in",
            "active_in", "end_sample", "state_out", "abs_out", "pper_out",
            "active_out", "o32", "o64", "oi")]
        + [(n, ctypes.c_int64) for n in (
            "sb_start", "n_samples", "table_len", "ptable_len")]
        + [(n, ctypes.c_double) for n in (
            "inv_fs", "code_len", "two_pi", "inv_two_pi", "carr_a", "carr_b",
            "code_a", "code_b", "pf1", "pf2", "pf3")]
        + [(n, ctypes.c_float) for n in (
            "inv_two_pi_f", "eps", "data_weight", "pilot_weight",
            "dll_data_weight", "dll_pilot_weight", "dll_scale", "w1", "w2")]
        + [(n, ctypes.c_int) for n in (
            "n_rows", "n_table_rows", "n_epochs", "blk", "k", "up_margin",
            "pll_order", "pilot_rot", "pilot2_rot", "pilot_period_mod")])


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
    elif name == "superblock":
        signatures = {
            "track_superblock_args_size": [],
            "track_superblock_launch": [
                ctypes.POINTER(SuperblockArgs), i32, i32, i32, p]}
    elif name == "superblock_staged":
        signatures = {
            "track_superblock_staged_args_size": [],
            "track_superblock_staged_launch": [
                ctypes.POINTER(SuperblockArgs), i32, i32, i32,
                i32, i32, i32, i32, i32, i32, p, p]}
    else:
        signatures = {
            "correlate_windows_launch": [
                p, p, p, p, p, p, p, p, p, p,
                i32, i32, i32, i64, i32, i32, i32, i32, f32, f32, p],
            "correlate_windows_ramp_launch": [
                p, p, p, p, p, p, p, p, i32, i32, i32, i64, p],
            "correlate_windows_table_launch": [
                p, p, p, p, p, p, p, p, p, i32, i32, i32, i64, p]}
    # every launch reading the record has an int16 twin of the same
    # signature
    signatures.update({fn + "_int16": argtypes
                       for fn, argtypes in list(signatures.items())
                       if fn.endswith("_launch") and "_ramp" not in fn
                       and "_table" not in fn})
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int


@functools.lru_cache(maxsize=None)
def load_library(name: str = "correlator") -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library
    ``name`` (one of ``SOURCES``).

    The shared object is named by a hash of the source, the shared headers
    and the flags, so an edited source is rebuilt; the compiler's register
    and spill report is kept beside it as ``<name>.log``."""
    if name not in SOURCES:
        raise ValueError(f"no kernel source {name!r}; have {SOURCES}")
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes()
        + b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
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
    if name.startswith("superblock") and (
            getattr(lib, f"track_{name}_args_size")()
            != ctypes.sizeof(SuperblockArgs)):
        raise RuntimeError(f"SuperblockArgs differs from csrc/{name}.cu's")
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
    _check_samples(iq)
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


def _check_samples(iq):
    if (iq.dtype not in SAMPLE_SYMBOLS or iq.dim() != 1
            or iq.numel() % 2):
        raise ValueError("iq must be a 1-D int8 or int16 tensor of "
                         "interleaved I/Q")


def clamp_offsets(x, size: int, win: int):
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
    """Carrier wipe-off of the sample windows siq [C, blk, 2] (int8 or
    int16), masked to each row's first bsz samples.  Returns (bb_i, bb_q)
    [C, blk] f32."""
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


def pack_sums(sums, pilot_sums, pilot_rot, pilot2_rot, pilot_w1,
              pilot_w2):
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

    iq: [2S] int8 or int16 interleaved I/Q record; off: [C] int64 window
    start (samples into iq); table: [R, L] int8 replica tables; wrow: [C]
    int64 table row; start: [C] int64 replica window start (tap E of
    sample 0); alpha/remc/shi/slo: [C] f32 interpolation fraction, carrier phase
    [cycles] and the u/v carrier steps frac(128·inc), frac(inc); bsz: [C]
    int64 valid samples.  Returns [C, 8] f32: iE qE iP qP iL qL 0 0.

    Pilot banks: ptable [R, Lp] int8 (or [R, 2, Lp] for the dual bank),
    read at row wrow from pstart [C] int64 with fraction palpha [C] f32.
    Their sums are rotated by j^pilot_rot (bank 2 by j^pilot2_rot) and the
    dual banks combined as pilot_w1·bank1 + pilot_w2·bank2.  Returns then
    [C, 16]: iE qE iP qP iL qL piE pqE piP pqP piL pqL 0 0 0 0.

    Offsets are clamped into range (``clamp_offsets``: ``pstart`` against
    the pilot table's own length); ``wrow`` must index rows of ``table``
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
    off = clamp_offsets(off, iq.shape[0] // 2, blk)
    start = clamp_offsets(start, table.shape[1], win)
    wrow, alpha, remc, shi, slo, bsz = (
        x.contiguous() for x in (wrow, alpha, remc, shi, slo, bsz))
    n_pilots, p_ptr, ps_ptr, pa_ptr, p_len = 0, None, None, None, 0
    if ptable is not None:
        n_pilots = 1 if ptable.dim() == 2 else 2
        pstart = clamp_offsets(pstart, ptable.shape[-1], win)
        palpha = palpha.contiguous()
        p_ptr, ps_ptr, pa_ptr = (ptable.data_ptr(), pstart.data_ptr(),
                                 palpha.data_ptr())
        p_len = int(ptable.shape[-1])
    c = off.shape[0]
    out = torch.empty((c, 16 if n_pilots else 8), dtype=torch.float32,
                      device=iq.device)
    launch = getattr(load_library(), _sample_symbol("correlate_bank_launch",
                                                     iq))
    rc = launch(
        iq.data_ptr(), off.data_ptr(), table.data_ptr(), wrow.data_ptr(),
        start.data_ptr(), alpha.data_ptr(), remc.data_ptr(),
        shi.data_ptr(), slo.data_ptr(), bsz.data_ptr(), out.data_ptr(),
        c, int(blk), int(k), int(table.shape[1]), int(bool(interp_taps)),
        p_ptr, ps_ptr, pa_ptr, p_len, n_pilots, int(pilot_rot) % 4,
        int(pilot2_rot) % 4, float(pilot_w1), float(pilot_w2),
        torch.cuda.current_stream(iq.device).cuda_stream)
    _launched(launch_name(VARIANTS[n_pilots], iq.dtype), rc)
    return out


# --------------------------------------------------------------------------
# Staged windows
# --------------------------------------------------------------------------

def stage_windows(iq, off, table, wrow, start, *, k: int, blk: int,
                  ptable=None, pstart=None):
    """Slice each row's windows out of the record and the tables, as the
    reference stages them with ``dynamic_slice`` before its staged kernel
    (offsets clamped by ``clamp_offsets``).  Arguments as
    ``correlate_bank_plain``.
    Returns (siq [C, blk, 2] of iq's dtype, wt [C, win], wp [C, win] /
    [C, 2, win] / None, int8), win = blk + 2k + 1, all contiguous."""
    win = blk + 2 * k + 1
    dev = iq.device
    off = clamp_offsets(off, iq.shape[0] // 2, blk)
    siq = iq.view(-1, 2)[off[:, None] + torch.arange(blk, device=dev)]
    m = torch.arange(win, device=dev)
    start = clamp_offsets(start, table.shape[1], win)
    wt = table[wrow[:, None], start[:, None] + m]
    wp = None
    if ptable is not None:
        pidx = clamp_offsets(pstart, ptable.shape[-1], win)[:, None] + m
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
    if (siq.dtype not in SAMPLE_SYMBOLS or siq.dim() != 3
            or siq.shape[2] != 2):
        raise ValueError("siq must be an int8 or int16 tensor [C, blk, 2] "
                         "of I/Q sample windows")
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
    if samples.data_ptr() % (2 * samples.element_size()):
        # the kernels read each I/Q pair as one char2 (int8) or short2
        # (int16)
        raise ValueError("the samples must start at an even address (a "
                         "multiple of 4 for int16)")
    return True


def _int8_only(name: str, siq) -> None:
    if siq.dtype != torch.int8:
        raise ValueError(f"{name} takes int8 sample windows, got {siq.dtype}")


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

    siq: [C, blk, 2] int8 or int16 sample windows, I and Q of a sample side
    by side (the record's own interleaving, so staging is one gather); wt:
    [C, win] int8 replica windows, win >= blk + 2k + 1, tap E of sample 0
    at column 0; alpha/remc/shi/slo: [C] f32 as in ``correlate_bank_plain``; bsz: [C]
    int64 valid samples; wp: pilot windows [C, win] or [C, 2, win] (dual
    bank) with fraction palpha [C] f32.  Returns [C, 8] or, with pilot
    windows, [C, 16], laid out as ``correlate_bank_plain``'s."""
    _check_windows(siq, wt, k, (("alpha", alpha), ("remc", remc),
                                ("shi", shi), ("slo", slo)), bsz, wp, palpha)
    cosw, sinw = _uv_carrier(remc, shi, slo, siq.shape[1])
    bb_i, bb_q = _baseband(siq, cosw, sinw, bsz)
    banks = [] if wp is None else [wp] if wp.dim() == 2 else [wp[:, 0],
                                                             wp[:, 1]]
    return pack_sums(_tap_sums(wt, alpha, bb_i, bb_q, k, interp_taps),
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
    launch = getattr(load_library("correlator_staged"),
                     _sample_symbol("correlate_windows_launch", siq))
    rc = launch(
        siq.data_ptr(), wt.data_ptr(), wp_ptr, alpha.data_ptr(), pa_ptr,
        remc.data_ptr(), shi.data_ptr(), slo.data_ptr(), bsz.data_ptr(),
        out.data_ptr(), c, blk, int(k), win, int(bool(interp_taps)),
        n_pilots, int(pilot_rot) % 4, int(pilot2_rot) % 4, float(pilot_w1),
        float(pilot_w2), torch.cuda.current_stream(siq.device).cuda_stream)
    _launched(launch_name(WINDOW_VARIANTS[n_pilots], siq.dtype), rc)
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
    return pack_sums(_tap_sums(wt, alpha, bb_i, bb_q, k, True), [],
                     0, 0, 0, 0)


def correlate_windows_ramp(siq, wt, alpha, remc, shi, slo, bsz, *,
                           k: int) -> torch.Tensor:
    """Phase-ramp correlator on staged windows (arguments as
    ``correlate_windows_ramp_plain``).  CUDA tensors launch the kernel or
    raise; CPU tensors take the plain version."""
    if not _on_card("correlate_windows_ramp", siq, wt):
        return correlate_windows_ramp_plain(siq, wt, alpha, remc, shi, slo,
                                            bsz, k=k)
    _int8_only("correlate_windows_ramp", siq)
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
    return pack_sums(_tap_sums(wt, alpha, bb_i, bb_q, k, True), [],
                     0, 0, 0, 0)


def correlate_windows_table(siq, wt, tc, ts, alpha, c0, s0, bsz, *,
                            k: int) -> torch.Tensor:
    """Table-carrier correlator on staged windows (arguments as
    ``correlate_windows_table_plain``).  CUDA tensors launch the kernel or
    raise; CPU tensors take the plain version."""
    if not _on_card("correlate_windows_table", siq, wt, tc, ts):
        return correlate_windows_table_plain(siq, wt, tc, ts, alpha, c0, s0,
                                             bsz, k=k)
    _int8_only("correlate_windows_table", siq)
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


# --------------------------------------------------------------------------
# One launch per superblock
# --------------------------------------------------------------------------

def cluster_size(n_rows: int) -> int:
    """Thread blocks per channel row of the superblock kernel: the largest
    of 8, 4, 2 that keeps the bank within the card's SMs, else 1."""
    for size in (8, 4, 2):
        if n_rows * size <= N_SMS:
            return size
    return 1


def _superblock_args(name, iq, sb_start, table, ptable, state_f64,
                     abs_sample, pilot_period, active, end_sample, n_epochs,
                     params, up_margin):
    """Check what the superblock kernels take and make one launch's
    ``SuperblockArgs`` and output tensors (arguments as
    ``track_superblock_bank``).  Returns (args, n_pilots, the new state
    (f64, abs_sample, pilot_period, active), the output stacks (o32, o64,
    oi)); ``args`` points into the returned tensors."""
    dev = iq.device
    blk, k = params.blk, params.k_spacing
    if dev.type != "cuda":
        raise ValueError(f"the superblock kernel takes CUDA tensors, iq is "
                         f"on {dev}")
    banks = (table,) if ptable is None else (table, ptable)
    _on_card(name, iq, *banks)
    _check_samples(iq)
    if table.dtype != torch.int8 or table.dim() != 2:
        raise ValueError("table must be a 2-D int8 tensor [R, L]")
    if state_f64.dim() != 2 or state_f64.shape[0] != 12 \
            or state_f64.dtype != torch.float64:
        raise ValueError("state_f64 must be f64 [12, C]")
    c = state_f64.shape[1]
    _check_vectors(dev, c, (
        ("abs_sample", abs_sample, torch.int64),
        ("pilot_period", pilot_period, torch.int32),
        ("active", active, torch.bool),
        ("end_sample", end_sample, torch.int64)))
    if state_f64.device != dev or any(x.device != dev for x in banks):
        raise ValueError(f"state and tables must be on {dev}")
    if n_epochs < 1 or k < 1:
        raise ValueError(f"n_epochs={n_epochs} and k={k} must be >= 1")
    win = blk + 2 * k + 1
    if iq.numel() // 2 < blk or table.shape[1] < win:
        raise ValueError("record or replica table shorter than one window")
    n_pilots, p_len = 0, 0
    if ptable is not None:
        if (ptable.dtype != torch.int8 or ptable.dim() not in (2, 3)
                or (ptable.dim() == 3 and ptable.shape[1] != 2)
                or ptable.shape[0] != table.shape[0]
                or ptable.shape[-1] < win):
            raise ValueError("ptable must be int8 [R, Lp] or [R, 2, Lp], "
                             "R as table's, Lp at least one window")
        n_pilots = ptable.dim() - 1
        p_len = int(ptable.shape[-1])
    state_f64, abs_sample, pilot_period, active, end_sample = (
        x.contiguous() for x in (state_f64, abs_sample, pilot_period,
                                 active, end_sample))
    new = (torch.empty_like(state_f64), torch.empty_like(abs_sample),
           torch.empty_like(pilot_period), torch.empty_like(active))
    outs = (torch.empty((n_epochs, 12, c), dtype=torch.float32, device=dev),
            torch.empty((n_epochs, 4, c), dtype=torch.float64, device=dev),
            torch.empty((n_epochs, 2, c), dtype=torch.int64, device=dev))
    two_pi = 2.0 * np.pi
    args = SuperblockArgs(
        iq=iq.data_ptr(), table=table.data_ptr(),
        ptable=None if ptable is None else ptable.data_ptr(),
        state_in=state_f64.data_ptr(), abs_in=abs_sample.data_ptr(),
        pper_in=pilot_period.data_ptr(), active_in=active.data_ptr(),
        end_sample=end_sample.data_ptr(), state_out=new[0].data_ptr(),
        abs_out=new[1].data_ptr(), pper_out=new[2].data_ptr(),
        active_out=new[3].data_ptr(), o32=outs[0].data_ptr(),
        o64=outs[1].data_ptr(), oi=outs[2].data_ptr(),
        sb_start=int(sb_start), n_samples=iq.numel() // 2,
        table_len=int(table.shape[1]), ptable_len=p_len,
        # the eager loop divides tensors by these host scalars, which
        # PyTorch computes on the card as a product with the reciprocal
        inv_fs=1.0 / params.fs, code_len=float(params.code_len),
        two_pi=two_pi, inv_two_pi=1.0 / two_pi,
        carr_a=params.tau2_carr / params.tau1_carr,
        carr_b=params.pdi / params.tau1_carr,
        code_a=params.tau2_code / params.tau1_code,
        code_b=params.pdi / params.tau1_code,
        pf1=params.pf1, pf2=params.pf2, pf3=params.pf3,
        inv_two_pi_f=float(np.float32(1.0) / np.float32(two_pi)),
        eps=1e-12,
        data_weight=params.data_weight, pilot_weight=params.pilot_weight,
        dll_data_weight=params.dll_data_weight,
        dll_pilot_weight=params.dll_pilot_weight,
        dll_scale=params.dll_scale, w1=params.pilot_w1, w2=params.pilot_w2,
        n_rows=c, n_table_rows=int(table.shape[0]), n_epochs=int(n_epochs),
        blk=int(blk), k=int(k), up_margin=int(up_margin),
        pll_order=int(params.pll_order), pilot_rot=int(params.pilot_rot) % 4,
        pilot2_rot=int(params.pilot2_rot) % 4,
        pilot_period_mod=int(params.pilot_period_mod))
    # the (possibly new) contiguous inputs live as long as the structure
    # that points into them, past the launch
    args.inputs = (state_f64, abs_sample, pilot_period, active, end_sample)
    return args, n_pilots, new, outs


def track_superblock_bank(iq, sb_start: int, table, ptable, state_f64,
                          abs_sample, pilot_period, active, end_sample,
                          n_epochs: int, params, *, up_margin: int,
                          cluster=None):
    """Track a channel bank through ``n_epochs`` epochs in one kernel
    launch (csrc/superblock.cu).  CUDA tensors only: a build or launch
    failure raises, and on the CPU the caller runs the eager epoch loop.

    iq: [2S] int8 or int16 interleaved I/Q record, sample 0 at absolute
    index ``sb_start``; table: [R, L] int8 replica tables, ptable: None, [R, Lp]
    or [R, 2, Lp] pilot tables (row c reads table row c % R); state_f64:
    [12, C] f64, ``ChannelState``'s f64 fields in order; abs_sample [C]
    int64, pilot_period [C] int32, active [C] bool; end_sample: [C] int64
    absolute end of each row's record; params: the engine's
    ``TrackParams`` (block size, spacing, tap mode, loop constants and
    pilot settings, read by name); up_margin: the tables' front margin
    [samples].  ``cluster``: thread blocks per row (1, 2, 4, 8), default
    ``cluster_size(C)``.

    Returns (state_f64, abs_sample, pilot_period, active) after the last
    epoch and the output stacks (o32 [E, 12, C] f32, o64 [E, 4, C] f64,
    oi [E, 2, C] int64), laid out as the eager loop's."""
    if params.blk > MAX_BLK:
        raise ValueError(f"blk={params.blk} exceeds the kernel's {MAX_BLK}: "
                         "its carrier factors would overflow 48 KB of shared "
                         "memory")
    args, n_pilots, new, outs = _superblock_args(
        "track_superblock", iq, sb_start, table, ptable, state_f64,
        abs_sample, pilot_period, active, end_sample, n_epochs, params,
        up_margin)
    if cluster is None:
        cluster = cluster_size(state_f64.shape[1])
    launch = getattr(load_library("superblock"),
                     _sample_symbol("track_superblock_launch", iq))
    rc = launch(ctypes.byref(args), int(bool(params.interp_taps)), n_pilots,
                int(cluster), torch.cuda.current_stream(iq.device).cuda_stream)
    _launched(launch_name(SUPERBLOCK_VARIANTS[n_pilots], iq.dtype), rc)
    return new, outs


# --------------------------------------------------------------------------
# One launch per superblock, windows staged into shared memory
# --------------------------------------------------------------------------

# shared memory a thread block of the H100 may opt into (227 KB), less what
# the staged superblock kernel holds statically (reduction partials, totals,
# the row's state and geometry, the ring's barriers and stage records:
# 2.5 KB at most)
SMEM_BUDGET = 232448 - 4096
MAX_STAGES = 4             # stages in the ring (the kernel takes up to 8)
# the prefetched replica starts: the predicted start less 1 to plus 2
# (csrc/superblock_staged.cu kSpreadLo, kSpreadHi); the sample window two
# epochs ahead: the predicted start +-2 (kSampleSpread)
PREFETCH_SPREAD = (1, 2)
SAMPLE_SPREAD = 4
_STAGE_ALIGN = 16          # bulk copies move whole aligned 16-byte units


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class StagePlan(NamedTuple):
    """The staged superblock kernel's ring: ``chunk`` samples per stage
    (a multiple of the kernel's 512 threads), ``n_stages`` stages,
    ``per_rank`` chunks of an epoch per thread block (one block per row, or
    each block of a cluster), and the bytes of a stage's sample buffer, of
    its buffer per replica bank and of the carrier factors ahead of the
    ring."""
    chunk: int
    n_stages: int
    per_rank: int
    samp_bytes: int
    rep_bytes: int
    uv_bytes: int

    def stage_bytes(self, n_pilots: int) -> int:
        return self.samp_bytes + (1 + n_pilots) * self.rep_bytes

    def smem_bytes(self, n_pilots: int) -> int:
        """Dynamic shared memory of one thread block."""
        return self.uv_bytes + self.n_stages * self.stage_bytes(n_pilots)


def stage_plan(blk: int, k: int, n_pilots: int, cluster: int, *,
               sample_bytes: int = 2) -> StagePlan:
    """Lay out the staged superblock kernel's ring for windows of ``blk``
    samples of ``sample_bytes`` bytes (2 for int8 I/Q, 4 for int16), E-L
    spacing ``k``, ``n_pilots`` pilot banks and ``cluster`` thread blocks
    per row: each block's share of the window in the fewest
    runs (chunks) of which two stages fit in ``SMEM_BUDGET`` beside the
    carrier factors, and as many stages as fit, 2 to ``MAX_STAGES`` and at
    most an epoch's chunks + 1.  A chunk is a whole number of the block's
    512-thread strides (a cluster's, of 128-sample carrier steps).  A
    sample buffer holds a chunk's samples plus the prefetch's spread,
    a replica buffer the chunk + 2k + 1 bytes its taps read plus the spread,
    each widened to the 16-byte grid.  Fewer chunks mean fewer waits and
    copies per epoch: with one, the producer copies only while the epoch is
    closed.  Raises ValueError when no chunk of one stride fits twice."""
    share = -(-blk // cluster)
    step = 512 if cluster == 1 else 128
    pad = 2 * (_STAGE_ALIGN - 1)          # an unaligned start and end
    uv = _round_up(4 * (2 * -(-blk // 128) + 2 * 128), 128)
    for runs in range(1, -(-share // step) + 1):
        chunk = _round_up(-(-share // runs), step)
        samp = _round_up(sample_bytes * (chunk + SAMPLE_SPREAD) + pad,
                         _STAGE_ALIGN)
        rep = _round_up(chunk + 2 * k + 1 + sum(PREFETCH_SPREAD) + pad,
                        _STAGE_ALIGN)
        stage = samp + (1 + n_pilots) * rep
        if uv + 2 * stage <= SMEM_BUDGET:
            per_rank = -(-(-(-blk // chunk)) // cluster)
            n_stages = min(MAX_STAGES, per_rank + 1,
                           (SMEM_BUDGET - uv) // stage)
            return StagePlan(chunk, n_stages, per_rank, samp, rep, uv)
    raise ValueError(f"blk={blk}: two stages of {step} samples and {uv} "
                     f"bytes of carrier factors exceed the {SMEM_BUDGET} "
                     f"bytes of shared memory")


def staged_ranges(plan: StagePlan, j: int, rank: int, offs, starts,
                  k: int, blk: int, *, sample_bytes: int = 2):
    """What the kernel copies for chunk ``j`` of block ``rank``'s run of an
    epoch (``issue_chunk`` of csrc/superblock_staged.cu): per buffer (the
    samples at a window offset within ``offs`` = (least, greatest); a
    replica bank per ``(lo, hi)`` in ``starts``, its window's least and
    greatest start), the byte range [x0, x1) asked for and the first byte
    ``lo`` of its aligned copy, in units of the tensor's bytes from the
    window's sample 0 (``sample_bytes`` a sample) / tap E of sample 0 at
    start 0.  Returns
    [(lo, x0, x1)]; all zero past the window."""
    n0 = (rank * plan.per_rank + j) * plan.chunk
    n1 = min(n0 + plan.chunk, blk)
    if n0 >= n1:
        return [(0, 0, 0)] * (1 + len(starts))
    out = [(sample_bytes * (offs[0] + n0), sample_bytes * (offs[1] + n1))]
    out += [(lo + n0, hi + n1 + 2 * k + 1) for lo, hi in starts]
    return [(x0 // _STAGE_ALIGN * _STAGE_ALIGN, x0, x1) for x0, x1 in out]


def prefetch_window(ahead: int, abs_sample: int, blksize: int,
                    pilot_period: int, code_freq_basis: float, params, *,
                    sb_start: int, n_samples: int, up_margin: int,
                    table_len: int, ptable_len: int):
    """The windows the staged superblock kernel copies for epoch e +
    ``ahead`` (1 or 2) while epoch e runs (``ahead_window`` of
    csrc/superblock_staged.cu), from epoch e's state (``abs_sample``,
    ``pilot_period``, ``code_freq_basis``) and block size: ((least,
    greatest) sample window start in the record, (least, greatest) data
    replica start, the same of the pilot windows or None).  An epoch whose
    exact starts lie outside them reads its chunks from device memory (the
    kernel's slow path)."""
    k, blk = params.k_spacing, params.blk
    win = blk + 2 * k + 1

    def clamp(x, size, width):
        """``clamp_start`` of csrc/superblock_common.cuh
        (``clamp_offsets``)."""
        return min(max(x + size if x < 0 else x, 0), size - width)

    off = clamp(abs_sample + ahead * blksize - sb_start, n_samples, blk)
    spread = SAMPLE_SPREAD // 2 if ahead > 1 else 0
    offs = (max(off - spread, 0), min(off + spread, n_samples - blk))
    below, above = PREFETCH_SPREAD

    def span(base, size):
        return clamp(base - below, size, win), clamp(base + above, size, win)

    base = up_margin - k
    data = span(base, table_len)
    if not params.has_pilot:
        return offs, data, None
    pbase = base
    if params.pilot_period_mod > 1:
        period = (int(pilot_period) + ahead) % params.pilot_period_mod
        pbase += int(np.floor((period * float(params.code_len))
                              / (code_freq_basis * (1.0 / params.fs))))
    return offs, data, span(pbase, ptable_len)


def track_superblock_staged_bank(iq, sb_start: int, table, ptable,
                                 state_f64, abs_sample, pilot_period, active,
                                 end_sample, n_epochs: int, params, *,
                                 up_margin: int, cluster=None):
    """``track_superblock_bank`` with the windows staged into shared memory
    (csrc/superblock_staged.cu): the same arguments and results, the same
    arithmetic as the eager loop on staged windows
    (``fetch_in_kernel=False``).  CUDA tensors only, each starting on a
    16-byte boundary (bulk copies need it); a build or launch failure
    raises.  Returns also ``slow`` [C] int32: the epochs (summed over a
    row's blocks) in which a chunk missed the prefetched windows and was
    read from device memory."""
    args, n_pilots, new, outs = _superblock_args(
        "track_superblock_staged", iq, sb_start, table, ptable, state_f64,
        abs_sample, pilot_period, active, end_sample, n_epochs, params,
        up_margin)
    sources = (iq, table) + (() if ptable is None else (ptable,))
    if any(x.data_ptr() % _STAGE_ALIGN for x in sources):
        raise ValueError("the staged superblock kernel copies from 16-byte "
                         "aligned tensors: iq, table and ptable must start "
                         "on a 16-byte boundary")
    c = state_f64.shape[1]
    if cluster is None:
        cluster = cluster_size(c)
    plan = stage_plan(params.blk, params.k_spacing, n_pilots, int(cluster),
                      sample_bytes=2 * iq.element_size())
    slow = torch.zeros(c, dtype=torch.int32, device=iq.device)
    launch = getattr(load_library("superblock_staged"),
                     _sample_symbol("track_superblock_staged_launch", iq))
    rc = launch(ctypes.byref(args), int(bool(params.interp_taps)), n_pilots,
                int(cluster), *plan, slow.data_ptr(),
                torch.cuda.current_stream(iq.device).cuda_stream)
    _launched(launch_name(STAGED_SUPERBLOCK_VARIANTS[n_pilots], iq.dtype),
              rc)
    return new, outs, slow
