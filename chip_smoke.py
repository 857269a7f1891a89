#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cusdr_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run when it fails:

1. environment: the card, its power limit, CUDA and nvcc versions;
2. build the CUDA kernels from cusdr_tpu_torch/ops/csrc/correlator.cu,
   correlator_staged.cu, superblock.cu, superblock_staged.cu and fine.cu
   (one nvcc each, started together);
3. the fetch kernel against its plain PyTorch version at the main path's
   shapes (12 channels, and the 96 rows of eight time blocks, blk = 18 008
   samples, k = 9, both tap modes, some windows clamped at the record's
   end), with both times and the card's bound for the same work;
3b. the pilot and dual-pilot variants against the plain version at the
   shapes of their paths (gal_e5a 12 x 18 008 k = 1, gal_e1c 12 x 72 008
   k = 5, bds_b1c WB 15 x 180 008 k = 1), both tap modes, windows clamped
   at the record's, the code table's and the pilot table's ends, with
   both times;
3c. the staged-window kernels against their plain versions: the u.v
   carrier (no pilot at gps_l1ca 12 and 96 x 18 008 k = 9, pilot at gal_e1c
   12 x 72 008 k = 5, dual pilot at bds_b1c WB 15 x 180 008, both tap
   modes), the phase-ramp and the table carrier (12 and 96 x 18 008), and
   the 500-epoch loops of cusdr_tpu_torch/tools/perf_correlator.py; the
   int16 instantiations of the fetch and the staged-window kernel on an
   int16 record (12 x 18 008).  The phase-ramp kernel (a thread-block
   cluster per row) also at each cluster size and in smaller tiles, on
   ragged rows whose replica windows start off the 16-byte grid, two
   launches equal bit for bit, timed by CUDA events over back-to-back
   launches (a CUDA graph) beside the launch floor (a one-element fill),
   ``correlate_windows`` (one block per row) on the same windows and the
   bound, and its cos/sin held to the plain version's sample by sample;
3e. the superblock kernel (one launch tracks a bank through every epoch of
   a superblock) against its plain version, the eager epoch loop
   ``track_superblock_epochs``, on the card, on the records of the scenes
   below from the SVs' true code phases and carriers: gps_l1ca 12 rows x
   250 epochs, the 96 rows of eight time blocks with per-row record ends
   (half the blocks freeze part way), gal_e5a 12 rows x 250 (pilot),
   bds_b1c WB 15 rows x 100 (dual pilot), the gps_l2c CL long pilot (3
   rows x 250 at 2.048 Msps, periods rolling over), glo_l1 at its preset's
   12 Msps and IF 0 (12 rows on FDMA channels -7..4, carriers to +-3.94
   MHz) and the int16 instantiation on the gps_l1ca case's record as int16
   times 64 (12 x 250), and the shapes of phase 18's presets that no other
   case runs: bds_b1i (12 x 18 008, k = 4), bds_b3i (15 rows, a cluster of
   8: 120 blocks) and gal_e1c (pilot, 12 x 72 008, 250 epochs of 4 ms),
   and gps_l1ca banks of 17, 32, 33, 34, 40, 64, 66 and 67 rows (the main
   record's SVs repeated, 100 epochs: clusters of 4, 2 and 1 at sizes
   first run with phase 20), each in both tap modes, with one block per
   row (every field equal to the eager loop's, bit for bit) and with a
   thread-block cluster per row (within the tolerances stated at
   TRACK_RTOL below); per case the count
   of differing elements and the largest difference per field, both times
   and the card's bound;
3f. the staged superblock kernel (each epoch's windows staged into shared
   memory by bulk copies) against its plain version, the eager loop on
   staged windows, on phase 3e's cases, held as 3e holds the fetch kernel
   (one block per row bit for bit, raising on any differing element); per
   case the slow-path epochs, both times, the bound, and the fetch
   superblock kernel's time on the same bank, timed in turns with it;
3g. acquisition's fine search (``pcps.fine_search``, ops/csrc/fine.cu)
   against its plain version ``fine_search_plain`` on the same card
   tensors at the fine shapes of gal_e5a (12 rows x 101 bins x 100
   periods x 18 000 samples) and gps_l1ca (12 x 21 x 40 x 18 000): sums
   within FINE_RTOL, each row's bin of largest power the plain version's
   and the scene's, two launches equal to the bit, both times by CUDA
   events and the bound; every ``Receiver.run`` below launches it once
   (its ``acquire``), and its launches are read from phase 4's run;
4. the main path at the gps_l1ca preset's full width (18 Msps, 12
   channels, 32 PRNs x 29 Doppler bins x 20 ms): ``Receiver.run`` on four
   seconds of a 12-SV synthetic scene; every SV acquired, every channel in
   lock, one superblock-kernel launch per superblock and no per-epoch
   launch; then the record's first second again through the eager loop
   ``track_superblock_epochs`` (one per-epoch launch per epoch), so that
   both are timed in one call;
5. PVT: the 40 s, 2.048 Msps, 6-SV scene of tests/test_e2e_l1ca.py through
   ``Receiver.run``; fixes within that test's bounds;
6. the pilot path at the gal_e5a preset's full width (18 Msps, 12
   channels, 36 PRNs x 21 bins x 15 ms, the 100 ms coherent CS100 fine
   stage) on a 3 s 12-SV scene at 50 dB-Hz: every SV acquired, data and
   pilot prompts locked, launches as in phase 4 (pilot variants);
7. the dual pilot bank at the bds_b1c preset in WB mode (pilot_trk_flag=2,
   18 Msps, 15 channels, 62 PRNs x 201 bins x 10 ms) on a 2.5 s 15-SV
   scene, checked as phase 6;
8. PVT on a pilot signal: the 26 s, 12.288 Msps, 4-SV GPS L5 scene of
   tests/test_e2e_l5c.py (pilot_trk_flag=1); fixes within that test's
   bounds;
9. time-parallel tracking at full width: phase 4's record through
   ``Receiver.run`` with ``time_blocks=8`` (a 96-row flat bank, two
   passes): every channel in lock over each block's tail, prompt signs as
   the sequential run's across every block boundary, one superblock-kernel
   launch per pass; then the same record through the per-block path
   (staged windows: one staged superblock-kernel launch per pass, then the
   eager loop in its place, one staged per-epoch kernel launch per epoch
   step, for the real-time factors before and after), and the pilot and
   dual-pilot staged variants likewise on the records of phases 6 and 7
   (two blocks each);
10. time-parallel PVT: phase 5's scene with ``time_blocks=8``; fixes
   within phase 5's bounds;
11. gps_l2c at the preset (8 Msps, 12 channels, the 32-PRN circular-shift
   search over +-10 kHz at 12.5 Hz, the CL period search; the fine stage at
   the reference tests' 5 Hz step, see ``L2C_PRESET_OVER``): ``Receiver.run``
   on 3.1 s of 12 SVs at 46 dB-Hz, each at a known CL period: every SV
   acquired within 2 samples with its CL period, every channel locked, one
   superblock-kernel launch per superblock; the acquisition's seconds split
   into coarse, CL search and fine;
12. GLONASS: ``Receiver.run`` at the glo_l1 preset (12 Msps, IF 0, the
   14-channel FDMA search) on 3 s of 12 SVs at 45 dB-Hz: every SV acquired,
   every channel locked; then glo_l2 with ``time_blocks=8`` through the
   flat bank and the per-block path, locked over every block's tail;
13. int16: phase 4's record times 64 as int16 through ``track`` (the
   superblock kernel's int16 instantiation) and through the per-block path
   (the staged one's): equal to the int8 runs, the sums exactly 64 times;
   the eager loops of both on the int16 record (the int16 per-epoch
   kernels);
14. multi-signal tracking at full width: ``track_multi`` over the records
   of phases 4, 6 and 7 at their presets (12, 12 and 15 channels at the
   SVs' truth; a 10 ms hyperepoch over their common 2.47 s), each bank on
   its own CUDA stream through its superblock kernel; each bank equal, every
   field element for element, to a standalone ``track`` of it with the
   lock gate off, timed in the same call; then ``run_multi`` on the
   gps_l1ca and gal_e5a records from acquisition to nav: every SV
   acquired, every channel in lock;
15. the gather path: ``Receiver.run`` at bds_b1c with ``sampling_freq``
   4.096 Msps (the 0.06-chip spacing is 0.24 samples) on a 2.5 s 15-SV
   scene at 47 dB-Hz, in NB and WB mode: every SV acquired, every channel
   locked, no tracking kernel of ops/ launched (acquisition's one fine
   search only); 100 epochs of the card's gather
   step held against the CPU's from the same states; then
   ``time_blocks=2`` on the per-block gather path, locked over each
   block's tail;
16. the CLI as subprocesses: ``run --out D --no-plots --timing`` on phase
   5's record written to a file at the preset's defaults (three
   checkpoints, fixes within phase 5's bounds, the timing table; tracking
   and fixes equal to ``Receiver(cfg).run()`` on the same file), the same
   with ``--skip-acquisition D/acqResults.npz`` (equal tracking outputs),
   and ``run-multi`` on 1.3 s cut from the records of phases 4 and 6 at
   their presets;
17. multi-device on the one card, every mesh entry cuda:0 (cusdr_tpu_torch/
   parallel/): (a) one 250-epoch superblock of phase 4's record from the
   SVs' truth through ``tracking_step_sharded`` on a 2-entry 'ch' mesh (two
   6-row banks, one superblock-kernel launch each) against
   ``track_superblock`` on the whole 12-row bank and against the eager
   loop on each shard, within phase 3e's tolerances, and the card time of
   the two shard launches beside the whole bank's one; (b) the preset's 32 PRN x 29 bin x 20 ms search on that
   record through ``pcps_sharded`` on 2 shards against the unsharded
   search (bins and code phases equal, peaks rtol 1e-5, every SV detected
   at its code phase); (c) ``track_time_parallel`` with ``time_blocks=8``
   over a 1x2 ch x tb mesh (48 rows a shard, shards x passes launches)
   against the flat bank and against the eager loop on the same mesh
   (per-row ends, a cluster of 2 blocks a row) in the same call, every
   block's tail locked;
   (d) two spawned ranks (gloo, both on cuda:0) over a 2x1 ch x tb mesh:
   each rank's stitched result equal to (c)'s within the same tolerances,
   the two ranks' equal;
18. the six presets no earlier phase runs as shipped: gps_l5c (data only),
   gal_e1c (pilot, 4 ms epochs), gal_e5b (pilot), bds_b1i (k = 4), bds_b2a
   and bds_b3i (15 channels), each through ``Receiver.run`` at full width
   (18 Msps, the preset's channels and PCPS grid) on a 12-SV (15-SV) scene
   of 2.5-3 s (``PRESET_SCENES``): every SV acquired within 2 samples of
   its code phase and half a coarse step of its carrier, every channel
   locked (data and pilot prompt), one superblock-kernel launch per
   superblock and no per-epoch launch; acquisition seconds and tracking
   real-time factor;
19. PVT on a non-GPS signal: the 40 s, 4.096 Msps, 6-SV B1I scene of
   tests/test_e2e_b1i.py (D1 under NH20) through ``Receiver.run`` (the
   superblock kernel: the E-L spacing is about a sample); fixes within
   that test's bounds, channel 0's decoded ephemeris equal to truth at rel
   1e-6;
20. the gps_l1ca main path at the preset's own size: 60.5 s at 18 Msps of
   make_gps_scenario's 8-SV sky at 46 dB-Hz, synthesized on the card
   (``card_if``: io/synth.py's signal model in torch, chunk by chunk) into
   an int8 record of 2.178e9 elements (past 2^31) written to a file; (b)
   ``python -m cusdr_tpu_torch run --no-plots --timing`` on the file at
   the preset as shipped (every SV acquired, every channel locked, >= 100
   fixes with a 3-D error of mean < 15 m and max < 50 m; the process's
   wall time, stage seconds and peak resident memory), and its resume with
   ``--skip-acquisition`` (equal trkResults.npz); (c) ``Receiver.run`` on
   the record in this process (troposphere correction off: the scene has
   none), the same gates and one superblock-kernel launch per superblock,
   the card's peak memory; then the record x 64 as int16: channels, states
   and fixes equal, sums 64 times; (d) ``time_blocks`` 2, 4, 5, 8 and 9 on
   the flat bank (16-72 rows: clusters of 8, 4, 2, 2 and 1) and 4 and 8 on
   the per-block path: every block's tail locked, prompt signs as (c)'s,
   the fix bounds, one launch per pass;
21. ``engine.track``'s pipelined superblock loop (through
   ``Receiver.track``: each superblock staged into one of two reused,
   page-locked host buffers and copied to the card on a side stream while
   the card tracks the previous one) against ``sync_track``, a synchronous
   loop on the same window plan (a fresh buffer, a blocking copy and a
   synchronisation per superblock), the lock gate off: on phase 4's
   record, phase 20's 60 s record as int8 and as int16 x 64, and phase 4's
   record in 400 superblocks of 10 ms; the loops run in turns (sync,
   pipelined, pipelined, sync), every field of every run equal to the
   first's, element for element; each run's tracking seconds, real-time
   factor, host milliseconds per superblock (also less the seconds of the
   ``trk.results`` span: the merge and the TrackResults built at the end),
   each run under a ``torch.profiler`` session of CPU activity, its
   superblocks and ``trk.results`` read from the span totals of its
   "tracking" stage.

The scenes of phases 3e-19 are made in worker processes, one each, while
the kernel checks of phases 1-3c and 3g run, and are all finished before the
host-bound measurements (the 500-epoch loops) and phase 4 start.

Prints a JSON line with each kernel's numbers (launches on its path, and
for the superblock kernels also on the other paths, phase 17's mesh,
phase 18's presets and phase 20's full-size runs among them; error
against the plain version, device time, the plain version's, the card's
bound for the same work), the
card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA card, and
outside a checkout of the repository.  Imports no jax and nothing of
cusdr_tpu.
"""

from __future__ import annotations

import json
import multiprocessing
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if __name__ in ("__main__", "__mp_main__"):
    # the port must run where jax is absent: make any jax import fail
    # loudly, in the script and its scene workers (not in a test that
    # imports the card scene helpers beside the reference)
    sys.modules["jax"] = None

# |kernel - plain| <= KERNEL_RTOL * (max|plain| + 1): the two sum 18 000-
# 180 000 f32 products in different orders (per-thread strides and a block
# tree against PyTorch's reductions), so they differ by f32 rounding of the
# sums, which grows with the sum's magnitude
KERNEL_RTOL = 1e-4
N_TIMED = 200          # launches per timing round
_CSRC = "cusdr_tpu_torch/ops/csrc/"
# kernel: (source, the TPU kernel it replaces, its name in a trace)
KERNELS = {
    "correlate_bank": (
        _CSRC + "correlator.cu", "cusdr_tpu/ops/correlator.py:563",
        "correlate_bank_kernel"),
    "correlate_windows": (
        _CSRC + "correlator_staged.cu", "cusdr_tpu/ops/correlator.py:237",
        "correlate_windows_kernel"),
    "correlate_windows_ramp": (
        _CSRC + "correlator_staged.cu", "tools/perf_pallas.py:30",
        "correlate_windows_ramp_cluster_kernel"),
    "correlate_windows_table": (
        _CSRC + "correlator_staged.cu", "tools/perf_pallas.py:208",
        "correlate_windows_table_kernel"),
    "track_superblock": (
        _CSRC + "superblock.cu", "cusdr_tpu/ops/correlator.py:563",
        "track_superblock_kernel"),
    "track_superblock_staged": (
        _CSRC + "superblock_staged.cu", "cusdr_tpu/ops/correlator.py:237",
        "track_superblock_staged_kernel"),
}
for _base in ("correlate_bank", "correlate_windows", "track_superblock",
              "track_superblock_staged"):
    for _suffix in ("_pilot", "_dual_pilot"):
        KERNELS[_base + _suffix] = KERNELS[_base]
    # the int16 instantiation of the same source, launched on the int16
    # paths of phases 3e, 3f and 13
    KERNELS[_base + "[int16]"] = KERNELS[_base]
# phase 3e: the superblock kernel against the eager loop through a
# superblock.  With one block per row every operation is the eager loop's,
# rounded the same way: every field must be equal, bit for bit.  With a
# cluster the slices of an epoch are added in rank order, so the sums differ
# from the eager loop's by f32 rounding, which the loops feed back.  Integer
# and boolean fields (abs_sample, blksize, pilot_period, active) must still
# be equal.  The f32 fields are held to TRACK_RTOL * (max|eager| + 1), the
# tolerance of the CPU parity tests for sums added in another order.  The
# f64 frequencies and filter integrators are held to FREQ_ATOL in Hz,
# whatever the size of the frequency: a prompt sum off by 1e-4 of itself
# moves the PLL discriminator by ~1e-5 cycles, and the loop filter's gain
# of some tens to hundreds of Hz per cycle turns that into ~1e-3 Hz.  The
# other f64 fields (phases in chips and radians, the discriminators) are
# held to rtol 1e-6, atol 1e-4, as the CPU parity tests hold them.
TRACK_RTOL = 2e-4
STATE_RTOL, STATE_ATOL = 1e-6, 1e-4
FREQ_ATOL = 2e-3
FREQ_FIELDS = ("carr_freq", "code_freq", "carr_nco", "code_nco", "d_carr",
               "d2_carr")
# the card's published peaks (H100 SXM): device memory and f32 outside the
# tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# phases 3-3c: (kernel, the path it stands for, rows, blk, k); the first
# shape listed for a kernel is the one its ``ms`` is reported at
SHAPES = (
    ("correlate_bank", "gps_l1ca", 12, 18008, 9),
    ("correlate_bank", "gps_l1ca time_blocks=8", 96, 18008, 9),
    ("correlate_bank_pilot", "gal_e5a", 12, 18008, 1),
    ("correlate_bank_pilot", "gal_e1c", 12, 72008, 5),
    ("correlate_bank_dual_pilot", "bds_b1c WB", 15, 180008, 1),
    ("correlate_windows", "gps_l1ca", 12, 18008, 9),
    ("correlate_windows", "gps_l1ca time_blocks=8", 96, 18008, 9),
    ("correlate_windows_pilot", "gal_e1c", 12, 72008, 5),
    ("correlate_windows_dual_pilot", "bds_b1c WB", 15, 180008, 1),
    ("correlate_windows_ramp", "gps_l1ca", 12, 18008, 9),
    ("correlate_windows_ramp", "gps_l1ca time_blocks=8", 96, 18008, 9),
    ("correlate_windows_table", "gps_l1ca time_blocks=8", 96, 18008, 9),
    ("correlate_windows_table", "gps_l1ca", 12, 18008, 9),
    ("correlate_bank[int16]", "gps_l1ca int16", 12, 18008, 9),
    ("correlate_windows[int16]", "gps_l1ca int16", 12, 18008, 9),
)
INT16_SCALE = 64       # an int16 record made from an int8 one, times 64
# phase 3g: acquisition's fine search (F1) at the fine shapes of the
# presets whose benchmark cells run it, (preset, detected rows): gal_e5a
# 12 x 101 bins x 100 periods x 18 000 samples, gps_l1ca 12 x 21 x 40 x
# 18 000.  Its sums against the plain version's within FINE_RTOL *
# (max|plain| + 1): each period's 18 000 products are added in another
# order (per thread, a warp butterfly, warps, tiles) and with an FMA where
# the plain version rounds the product, as the card tests hold them.
# FINE_OPS: f32 operations a sample and bin (the phase, a full-accuracy
# sincosf counted as 20, four products, four sums)
FINE_SHAPES = (("gal_e5a", 12), ("gps_l1ca", 12))
FINE_RTOL = 1e-4
FINE_OPS = 30
# phase 3c: a shared-memory budget that splits the ramp kernel's slice
# into tiles through its ring of two stages at every cluster size (3 tiles
# a block at 12 x 18 008 with 8 blocks a row), held to the plain version
# and timed beside its plan; and launches per CUDA graph when timing it
RAMP_RING_BYTES = 8 * 1024
N_GRAPH = 200


def log(msg: str) -> None:
    print(msg, flush=True)


def environment():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from cusdr_tpu_torch.ops.correlator import _nvcc
    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    log(f"[env] {smi}")
    log(f"[env] torch {torch.__version__}, torch.version.cuda "
        f"{torch.version.cuda}, nvcc: {nvcc.splitlines()[-1]}")
    return smi


def build():
    """Build every kernel source, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor
    from cusdr_tpu_torch.ops import correlator
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(correlator.SOURCES)) as threads:
        list(threads.map(correlator.load_library, correlator.SOURCES))
    sec = time.perf_counter() - t0
    logs = sorted(correlator.BUILD_DIR.glob("*.log"))
    regs = [ln.strip() for p in logs for ln in p.read_text().splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln]
    log(f"[build] {', '.join(n + '.cu' for n in correlator.SOURCES)} built "
        f"and loaded in {sec:.2f} s")
    for ln in regs:
        log(f"[build] {ln}")


def _timed(fn, n):
    """Mean device milliseconds per call over n calls (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def _fine_inputs(preset, n_rows, seed=20):
    """``fine_search``'s arguments at the preset's fine shape on the card:
    a record of int8-sized noise holding each of ``n_rows`` PRNs' replicas
    (``sample_code``, with one of its fine hypotheses' signs) at its own
    segment start, on a fine bin of its own.  Returns (args, keywords,
    hypotheses, envelope, the rows' true bins)."""
    import numpy as np
    import torch
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.acquisition import pcps
    from cusdr_tpu_torch.signals.defs import get_signal, sample_code
    cfg, sig = get_config(preset), get_signal(preset)
    fs, spc = cfg.sampling_freq, cfg.samples_per_code
    n_codes = cfg.fine_n_codes or max(int(round(40.0 / sig.code_period_ms)),
                                      4)
    n_fine = int(round(cfg.acq_search_step / cfg.fine_search_step)) + 1
    n_seg = n_codes * spc
    rng = np.random.default_rng(seed)
    x = (rng.integers(-40, 41, n_seg + 2 * spc)
         + 1j * rng.integers(-40, 41, n_seg + 2 * spc))
    prns = [int(p) for p in cfg.acq_satellite_list[:n_rows]]
    cps = [int(c) for c in rng.integers(0, 2 * spc, n_rows)]
    freqs = (cfg.if_freq + rng.uniform(-3000, 3000, (n_rows, 1))
             + cfg.acq_search_step / 2
             - cfg.fine_search_step * np.arange(n_fine)[None, :]
             ).astype(np.float32)
    truth = rng.integers(0, n_fine, n_rows)
    t = np.arange(n_seg) / fs
    tables, hyps, envelope = [], [], False
    for j, prn in enumerate(prns):
        code_fn, H = pcps.fine_setup(sig, prn, n_codes)
        envelope = H is None
        rep = sample_code(code_fn(prn), sig.elements_per_chip,
                          sig.chip_rate_hz, fs, n_seg).astype(np.float32)
        signs = np.ones(n_codes) if envelope else H[j % len(H)]
        x[cps[j]:cps[j] + n_seg] += 8.0 * rep * np.repeat(signs, spc) \
            * np.exp(2j * np.pi * float(freqs[j, truth[j]]) * t)
        tables.append(torch.from_numpy(code_fn(prn).astype(np.int8)))
        hyps.append(np.ones((1, n_codes), np.float32) if envelope else H)
    dev = torch.device("cuda")
    args = (torch.from_numpy(x.real.astype(np.float32)).to(dev),
            torch.from_numpy(x.imag.astype(np.float32)).to(dev), cps,
            torch.nn.utils.rnn.pad_sequence(tables, batch_first=True
                                            ).to(dev),
            [len(tb) for tb in tables], [0.0] * n_rows,
            float(2.0 * np.pi * np.float32(1.0 / fs))
            * torch.from_numpy(freqs).to(dev))
    kw = dict(epc=sig.elements_per_chip, ratio=sig.chip_rate_hz / fs,
              n_codes=n_codes, spc=spc)
    return (args, kw, torch.from_numpy(np.stack(hyps)).to(dev), envelope,
            truth.tolist())


def fine_check(card):
    """Phase 3g: ``pcps.fine_search`` (F1) against ``fine_search_plain`` on
    the same card tensors at each of FINE_SHAPES: the sums within
    FINE_RTOL * (max|plain| + 1), every row's bin of largest power the
    plain version's and the scene's, a second launch equal to the bit;
    both timed by CUDA events (back-to-back calls), beside the bound.
    Returns one entry per shape."""
    import torch
    from cusdr_tpu_torch.acquisition import pcps
    out = []
    for preset, n_rows in FINE_SHAPES:
        args, kw, hyp, envelope, truth = _fine_inputs(preset, n_rows)
        sr, si = pcps.fine_search(*args, **kw)
        sr2, si2 = pcps.fine_search(*args, **kw)
        if not (torch.equal(sr, sr2) and torch.equal(si, si2)):
            raise AssertionError(f"[fine {preset}] two launches differ")
        pr, pi = pcps.fine_search_plain(*args, **kw)
        err = max(float((sr - pr).abs().max()), float((si - pi).abs().max()))
        tol = FINE_RTOL * (max(float(pr.abs().max()),
                               float(pi.abs().max())) + 1.0)
        bins = pcps._fine_powers(sr, si, hyp, envelope).argmax(1).tolist()
        plain_bins = pcps._fine_powers(pr, pi, hyp, envelope
                                       ).argmax(1).tolist()
        if not err <= tol or bins != plain_bins or bins != truth:
            raise AssertionError(
                f"[fine {preset}] max|err| {err:.3g} (tol {tol:.3g}); bins "
                f"{bins}, plain {plain_bins}, scene {truth}")
        del pr, pi
        ms = _timed(lambda: pcps.fine_search(*args, **kw), 20)
        plain_ms = _timed(lambda: pcps.fine_search_plain(*args, **kw), 3)
        n_det, n_fine = args[6].shape
        n_codes, n_seg = kw["n_codes"], kw["n_codes"] * kw["spc"]
        # each row's segment (two f32), the tables, omega and the sums
        n_bytes = (8 * n_det * n_seg + args[3].numel()
                   + 4 * n_det * n_fine * (1 + 2 * n_codes))
        ops = FINE_OPS * n_det * n_fine * n_seg
        t_bytes = n_bytes / PEAK_BYTES_S * 1e3
        t_ops = ops / PEAK_F32_FLOPS * 1e3
        entry = dict(
            shape=(f"{preset}: {n_det} rows x {n_fine} bins x {n_codes} "
                   f"periods x {kw['spc']} samples"),
            max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=n_bytes, operations=ops)
        out.append(entry)
        log(f"[fine] {entry['shape']} on {card}: max|err| {err:.3g} (tol "
            f"{tol:.3g}), bins equal the plain version's and the scene's, "
            f"relaunch equal to the bit; {ms:.4f} ms (CUDA events), plain "
            f"{plain_ms:.3f} ms, bound {entry['bound_ms']:.4f} ms "
            f"({entry['bound_by']}): {entry['bound_ms'] / ms:.1%} of it")
    return out


def _bank_inputs(rng, n_ch, blk, k, n_pilots):
    """Random kernel inputs on the card: a 1000 ms 18 Msps record (the
    last three windows run off its end), tables of blk + 2 * 1024 (banks of
    more than 15 rows share 12 table rows by row modulo, as the
    time-parallel bank does).  With pilot banks, a pilot table of the same
    length at its own starts and fractions; one code-table and two
    pilot-table windows run off their tables' ends.  All are clamped by the
    wrapper.  Returns (args, keywords, carrier steps in cycles/sample)."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    n_samp = 1_000 * 18_000
    n_tab = n_ch if n_ch <= 15 else 12
    table_len = blk + 2 * 1024
    iq = torch.from_numpy(rng.integers(-16, 17, 2 * n_samp).astype(
        np.int8)).to(dev)
    table = torch.from_numpy(rng.choice(np.array([-1, 1], np.int8),
                                        (n_tab, table_len))).to(dev)
    off = rng.integers(0, n_samp - blk, n_ch)
    off[-3:] = [n_samp - blk, n_samp - blk + 5, n_samp + 100]  # clamped
    start = rng.integers(1024 - k - 1, 1024 - k + 2, n_ch)
    if n_pilots:
        start[-3] = table_len                                # clamped
    inc = (20e3 + rng.uniform(-7e3, 7e3, n_ch)) / 18e6

    def t(x, dt):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

    f32, i64 = torch.float32, torch.int64
    args = (iq, t(off, i64), table, torch.arange(n_ch, device=dev) % n_tab,
            t(start, i64), t(rng.uniform(0, 1, n_ch), f32),
            t(rng.uniform(0, 1, n_ch), f32),
            t(np.mod(inc * 128, 1.0), f32), t(np.mod(inc, 1.0), f32),
            t(blk - rng.integers(0, 9, n_ch), i64))
    kw = dict(k=k, blk=blk)
    if n_pilots:
        shape = (n_tab, table_len) if n_pilots == 1 \
            else (n_tab, 2, table_len)
        pstart = rng.integers(0, table_len - blk - 2 * k - 1, n_ch)
        pstart[-2:] = [table_len - blk, -3]                  # clamped
        kw.update(
            ptable=t(rng.choice(np.array([-1, 1], np.int8), shape),
                     torch.int8),
            pstart=t(pstart, i64), palpha=t(rng.uniform(0, 1, n_ch), f32),
            pilot_rot=3 if n_pilots == 2 else 1, pilot2_rot=2,
            pilot_w1=float(np.sqrt(29 / 33)) if n_pilots == 2 else 1.0,
            pilot_w2=float(np.sqrt(4 / 33)) if n_pilots == 2 else 0.0)
    return args, kw, inc


def bound(name, blk, k, valid, interp):
    """The least time the card could take for one call: the larger of the
    bytes the function must move over the card's memory rate and its f32
    operations over the card's f32 peak.

    ``valid`` holds each row's valid samples in this call's inputs (its bsz
    clamped to [0, blk]); a row of v valid samples needs v of its samples
    and v + 2k + 1 bytes of each replica window (none when v is 0).
    Bytes, each input read once and the output written once: 2 per valid
    sample (4 for an int16 record), 1 per replica window element, the
    per-row scalars (8 per int64, 4 per f32), 8 per valid sample of the
    table carrier's f32 basis tables, and 32 or 64 per output row.
    Operations, per valid sample: 6 to make the carrier (u.v: a complex
    product; ramp: two products, two sums, a floor and a sincos counted as
    one each; table: a complex product), 6 to wipe it off, and per replica
    bank 12 for the six products and sums plus 9 for three interpolated
    taps; u.v adds 4 per carrier factor (blk / 128 + 128 per row).  Returns
    (milliseconds, "bytes" or "operations", bytes, ops)."""
    n_pilots = 2 if "dual" in name else 1 if "pilot" in name else 0
    banks = 1 + n_pilots
    n_ch = len(valid)
    n_valid = sum(valid)
    staged = name.startswith("correlate_windows")
    # fetch kernel: off, wrow, start, bsz + alpha, remc, shi, slo (+ pstart,
    # palpha); staged: bsz + four f32 (+ palpha); table: bsz + three f32
    scalars = ((8 + 16 + (4 if n_pilots else 0)) if staged
               else (32 + 16 + (12 if n_pilots else 0)))
    n_bytes = (_sample_bytes(name) * n_valid
               + banks * sum(v + 2 * k + 1 for v in valid if v > 0)
               + n_ch * (scalars + (64 if n_pilots else 32)))
    ops = n_valid * (12 + banks * (12 + (9 if interp else 0)))
    if name.endswith("_table"):
        n_bytes += n_valid * 8 - n_ch * 4
    elif not name.endswith("_ramp"):
        ops += n_ch * 4 * ((blk + 127) // 128 + 128)
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", n_bytes, ops)


def _sample_bytes(name):
    """Bytes of one I/Q sample of the record kernel ``name`` reads."""
    return 4 if name.endswith("[int16]") else 2


def _kernel_calls(name, args, kw, inc):
    """(kernel call, plain call) of ``name`` on the bank inputs, each taking
    ``interp_taps``; the staged kernels get their windows staged once,
    outside the timed calls."""
    import numpy as np
    import torch
    from cusdr_tpu_torch.ops import correlator as corr
    if name.startswith("correlate_bank"):
        return (lambda i: corr.correlate_bank(*args, interp_taps=i, **kw),
                lambda i: corr.correlate_bank_plain(*args, interp_taps=i,
                                                    **kw))
    iq, off, table, wrow, start, alpha, remc, shi, slo, bsz = args
    siq, wt, wp = corr.stage_windows(iq, off, table, wrow, start,
                                     k=kw["k"], blk=kw["blk"],
                                     ptable=kw.get("ptable"),
                                     pstart=kw.get("pstart"))
    k = kw["k"]
    if name.endswith("_ramp"):
        shi256 = torch.as_tensor(np.mod(inc * 256, 1.0),
                                 dtype=torch.float32, device=iq.device)
        scal = (siq, wt, alpha, remc, shi256, slo, bsz)
        return (lambda i: corr.correlate_windows_ramp(*scal, k=k),
                lambda i: corr.correlate_windows_ramp_plain(*scal, k=k))
    if name.endswith("_table"):
        ph = 2 * np.pi * inc[:, None] * np.arange(kw["blk"])[None, :]
        f32 = dict(dtype=torch.float32, device=iq.device)
        scal = (siq, wt, torch.as_tensor(np.cos(ph), **f32),
                torch.as_tensor(np.sin(ph), **f32), alpha,
                torch.cos(remc * 6.2831855), torch.sin(remc * 6.2831855),
                bsz)
        return (lambda i: corr.correlate_windows_table(*scal, k=k),
                lambda i: corr.correlate_windows_table_plain(*scal, k=k))
    pkw = dict(k=k, wp=wp, palpha=kw.get("palpha"),
               **{n: v for n, v in kw.items() if n.startswith("pilot")})
    scal = (siq, wt, alpha, remc, shi, slo, bsz)
    return (lambda i: corr.correlate_windows(*scal, interp_taps=i, **pkw),
            lambda i: corr.correlate_windows_plain(*scal, interp_taps=i,
                                                   **pkw))


def kernel_check(name, label, n_ch, blk, k, seed=0):
    """One kernel against its plain version on the same CUDA tensors, in
    its tap modes (the ramp and table carriers have interpolated taps
    only), with its device time (torch.profiler), its wall time per
    wrapper call (CUDA events) beside the plain version's, and the card's
    bound for the same work."""
    import numpy as np
    import torch
    n_pilots = 2 if "dual" in name else 1 if "pilot" in name else 0
    rng = np.random.default_rng(seed)
    args, kw, inc = _bank_inputs(rng, n_ch, blk, k, n_pilots)
    if name.endswith("[int16]"):
        # the int16 instantiation on the same record times 64
        args = (args[0].to(torch.int16) * INT16_SCALE,) + args[1:]
    call, call_plain = _kernel_calls(name, args, kw, inc)
    valid = args[9].clamp(0, blk).tolist()
    n_out = 16 if n_pilots else 8
    both = not name.endswith(("_ramp", "_table"))
    rows = {}
    for interp in ((True, False) if both else (True,)):
        got = call(interp)
        want = call_plain(interp)
        torch.cuda.synchronize()
        if got.shape != (n_ch, n_out) or not torch.isfinite(got).all():
            raise AssertionError(f"{name} {label}: kernel output "
                                 f"{tuple(got.shape)} not finite "
                                 f"[{n_ch}, {n_out}]")
        err = (got - want).abs().max().item()
        tol = KERNEL_RTOL * (want.abs().max().item() + 1.0)
        if not err <= tol:
            raise AssertionError(f"{name} {label}: kernel disagrees with "
                                 f"plain version (interp_taps={interp}): "
                                 f"{err} > {tol}")

        def kern():
            call(interp)

        def plain():
            call_plain(interp)

        # wall time per wrapper call, host work included: alternate plain,
        # kernel, kernel, plain on the same card
        p1, k1, k2, p2 = (_timed(f, N_TIMED)
                          for f in (plain, kern, kern, plain))
        b_ms, b_by, n_bytes, ops = bound(name, blk, k, valid, interp)
        row = dict(err=err, tol=tol, wrapper_ms=(k1 + k2) / 2,
                   plain_wrapper_ms=(p1 + p2) / 2,
                   device_ms=_device_ms(kern, KERNELS[name][2]),
                   plain_device_ms=_device_ms(plain),
                   bound_ms=b_ms, bound_by=b_by, bytes=n_bytes, ops=ops)
        rows[interp] = row
        tag = f"[kernel] {name} {label} {n_ch} x {blk}, interp_taps={interp}"
        log(f"{tag}: max|kernel-plain|={err:.3e} <= {tol:.3e}")
        log(f"{tag}: device time per call (torch.profiler): kernel "
            f"{_fmt_ms(row['device_ms'])}, plain "
            f"{_fmt_ms(row['plain_device_ms'])}; bound {b_ms:.6f} ms by "
            f"{b_by} ({n_bytes} bytes, {ops} operations)")
        log(f"{tag}: wall time per wrapper call (CUDA events, mean of "
            f"{N_TIMED}): kernel {row['wrapper_ms']:.4f} ms ({k1:.4f}, "
            f"{k2:.4f}), plain {row['plain_wrapper_ms']:.4f} ms "
            f"({p1:.4f}, {p2:.4f})")
    return dict(name=name, label=label, n_ch=n_ch, blk=blk, k=k, rows=rows)


def _graph_ms(fn, n=N_GRAPH, repeats=3):
    """Device milliseconds per call of ``fn`` run back to back: ``n`` calls
    captured in one CUDA graph, which is replayed after a warm-up between
    two CUDA events, ``repeats`` times.  A wrapper's host work (tens of
    microseconds a call) is paid once, at the capture, so a launch of a few
    microseconds is timed by the card, not by the host.  Returns the
    replays' times per call."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    del graph
    return times


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def ramp_layout(label, n_ch, blk, k, seed=0):
    """The ramp kernel (a thread-block cluster per row) at its plan, at
    each cluster size of ``corr.RAMP_CLUSTERS``, and at each cluster size
    in the smaller tiles of RAMP_RING_BYTES (a ring of two stages), on
    ragged rows (bsz 0 on row 1, past blk on row 2, blk / 3 on row 3; the
    replica rows, blk + 2k + 1 bytes apart, start off the 16-byte grid):
    against its plain version, two launches equal bit for bit, and its
    device time by CUDA events over back-to-back launches (``_graph_ms``).
    In the same way, the launch floor (a one-element fill) and
    ``correlate_windows`` (#2, one block per row) on the same windows; the
    bound from this call's inputs; the carrier alone (``ramp_carrier``).
    Raises on any difference.  Returns the numbers."""
    import numpy as np
    import torch
    from cusdr_tpu_torch.ops import correlator as corr
    rng = np.random.default_rng(seed)
    args, kw, inc = _bank_inputs(rng, n_ch, blk, k, 0)
    iq, off, table, wrow, start, alpha, remc, shi128, slo, bsz = args
    siq, wt, _ = corr.stage_windows(iq, off, table, wrow, start, k=k,
                                    blk=blk)
    bsz = bsz.clone()
    bsz[1], bsz[2], bsz[3] = 0, blk + 100, blk // 3
    shi = torch.as_tensor(np.mod(inc * 256, 1.0), dtype=torch.float32,
                          device=iq.device)
    scal = (siq, wt, alpha, remc, shi, slo, bsz)
    want = corr.correlate_windows_ramp_plain(*scal, k=k)
    tol = KERNEL_RTOL * (want.abs().max().item() + 1.0)
    plan = corr.ramp_plan(n_ch, blk, k)
    # the plan, each cluster size, and each in more, smaller tiles through
    # the ring of two stages; a layout reached twice is run once
    plans = {"plan": plan}
    for s in corr.RAMP_CLUSTERS:
        for name, p in ((f"cluster {s}", corr.ramp_plan(n_ch, blk, k, s)),
                        (f"cluster {s}, {RAMP_RING_BYTES // 1024} KB",
                         corr.ramp_plan(n_ch, blk, k, s,
                                        smem_bytes=RAMP_RING_BYTES))):
            if p not in plans.values():
                plans[name] = p
    timed = {}
    for name, p in plans.items():
        if name == "plan":
            def launch():
                return corr.correlate_windows_ramp(*scal, k=k)
        else:
            def launch(p=p):
                return corr._ramp_launch(*scal, k=k, plan=p)
        got = launch()
        again = launch()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tag = f"[ramp] {label} {n_ch} x {blk}, {name} {tuple(p)}"
        if not (torch.isfinite(got).all() and err <= tol):
            raise AssertionError(f"{tag}: max|kernel-plain| {err} > {tol}")
        if not torch.equal(got, again):
            raise AssertionError(f"{tag}: two launches differ")
        if got[1].any() or got[:, 6:].any():
            raise AssertionError(f"{tag}: a row of 0 samples or a zero "
                                 "column is not 0")
        timed[name] = dict(err=err, ms=_graph_ms(launch))
    x = torch.zeros(1, device=iq.device)
    floor = _graph_ms(lambda: x.fill_(1.0))
    windows = _graph_ms(lambda: corr.correlate_windows(
        siq, wt, alpha, remc, shi128, slo, bsz, k=k))
    plain = _graph_ms(lambda: corr.correlate_windows_ramp_plain(*scal, k=k))
    b_ms, b_by, b_bytes, b_ops = bound("correlate_windows_ramp", blk, k,
                                       bsz.clamp(0, blk).tolist(), True)
    ms = _median(timed["plan"]["ms"])
    out = dict(
        ramp_cluster=plan.cluster, ramp_plan=tuple(plan), events_ms=ms,
        events_ms_repeats=timed["plan"]["ms"],
        plain_events_ms=_median(plain), floor_ms=_median(floor),
        windows_ms=_median(windows), ragged_bound_ms=b_ms,
        ragged_bound_by=b_by, ragged_bytes=b_bytes, ragged_ops=b_ops,
        ragged_max_abs_err=max(v["err"] for v in timed.values()),
        ragged_tol=tol,
        layout_ms={f"{name} {tuple(plans[name])}": _median(v["ms"])
                   for name, v in timed.items() if name != "plan"},
        **ramp_carrier(label, n_ch, blk, k, remc, shi, slo))
    log(f"[ramp] {label} {n_ch} x {blk}, k={k}: kernel {ms:.4f} ms "
        f"(plan {tuple(plan)}: cluster, chunk, tile, stages, shared "
        f"bytes; CUDA events over {N_GRAPH} back-to-back launches in a CUDA "
        f"graph, median of "
        f"{', '.join(f'{t:.4f}' for t in timed['plan']['ms'])}), "
        f"launch floor {out['floor_ms']:.4f} ms (a one-element fill), "
        f"bound {b_ms:.6f} ms by {b_by} ({b_bytes} bytes, {b_ops} "
        f"operations on these ragged rows), correlate_windows (#2, one block "
        f"per row) {out['windows_ms']:.4f} ms, plain "
        f"{out['plain_events_ms']:.4f} ms; max|kernel-plain| "
        f"{out['ragged_max_abs_err']:.3e} <= {tol:.3e} over every layout "
        f"(ragged rows, replica rows off the 16-byte grid; two launches "
        f"equal bit for bit)")
    log(f"[ramp] {label} {n_ch} x {blk}: ms by layout: " + "; ".join(
        f"{name}: {t:.4f}" for name, t in out["layout_ms"].items()))
    return out


def ramp_carrier(label, n_ch, blk, k, remc, shi, slo, n_rows=4096,
                 seed=1):
    """The ramp kernel's cos and sin, sample by sample, against the plain
    version's.  Row r carries the phase ramp of bank row r mod n_ch and a
    single sample 1 + 0j at a random index n_r (every other sample 0), its
    replica taps all 1: its P sums are then exactly cos and -sin of the
    carrier at n_r, as the kernel and the plain version compute them (one
    nonzero product in each sum).  At the wrapper's plan and with a
    cluster of 8.  Raises above KERNEL_RTOL * 2, the sums' tolerance at
    max|plain| = 1.  Returns the largest difference."""
    import numpy as np
    import torch
    from cusdr_tpu_torch.ops import correlator as corr
    rng = np.random.default_rng(seed)
    dev = remc.device
    at = torch.as_tensor(rng.integers(0, blk, n_rows), device=dev)
    rows = torch.arange(n_rows, device=dev)
    siq = torch.zeros((n_rows, blk, 2), dtype=torch.int8, device=dev)
    siq[rows, at, 0] = 1
    wt = torch.ones((n_rows, blk + 2 * k + 1), dtype=torch.int8, device=dev)
    pick = rows % n_ch
    scal = (siq, wt, torch.zeros(n_rows, device=dev), remc[pick],
            shi[pick], slo[pick],
            torch.full((n_rows,), blk, dtype=torch.int64, device=dev))
    want = corr.correlate_windows_ramp_plain(*scal, k=k)[:, 2:4]
    err = 0.0
    for name, got in (
            ("plan", corr.correlate_windows_ramp(*scal, k=k)),
            ("cluster 8", corr._ramp_launch(
                *scal, k=k, plan=corr.ramp_plan(n_rows, blk, k, 8)))):
        e = (got[:, 2:4] - want).abs().max().item()
        if not e <= KERNEL_RTOL * 2:
            raise AssertionError(f"[ramp] carrier {label}, {name}: "
                                 f"max|cos, sin kernel - plain| {e}")
        err = max(err, e)
    log(f"[ramp] carrier {label}: max|cos, sin kernel - plain| {err:.3e} "
        f"over {n_rows} samples (one a row at a random index of {blk}, the "
        f"phase ramps of the {n_ch} rows; the plan and a cluster of 8)")
    return dict(carrier_max_abs_err=err, carrier_samples=n_rows)


def _device_ms(fn, name=None, n=50):
    """Device milliseconds per call from torch.profiler (CUPTI): the
    kernels whose name contains ``name``, or all kernels; None when the
    trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if name is None or name in e.key)
    return us / n / 1e3 if us > 0 else None


def _fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def scene(cfg, sig, prns, seconds, cn0_dbhz=45.0, seed=1, dopplers=None):
    """SVs at ``cn0_dbhz`` with random nav symbols, spread over the
    Doppler search band (or at ``dopplers``) and the code period.  Returns
    (svs, iq, seconds it took to make them)."""
    import numpy as np
    from cusdr_tpu_torch.io.synth import (SynthSV, quantize_iq_int8,
                                               synthesize_if)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    spc = cfg.samples_per_code
    n_bits = int(seconds * 1000 / sig.nav_symbol_ms) + 2
    if dopplers is None:
        dopplers = np.linspace(-4400.0, 4600.0, len(prns))
    svs = [SynthSV(prn=p, code_phase=float(rng.uniform(0, spc - 1)),
                   doppler_hz=float(d), cn0_dbhz=cn0_dbhz,
                   nav_bits=rng.choice([-1.0, 1.0], n_bits),
                   # an FDMA signal's PRN is its frequency channel
                   fdma_channel=p if sig.fdma else 0)
           for p, d in zip(prns, dopplers)]
    iq = quantize_iq_int8(synthesize_if(cfg, sig, svs,
                                        num_ms=int(seconds * 1000),
                                        seed=seed))
    return svs, iq, time.perf_counter() - t0


def scene_job(signal, overrides, prns, seconds, cn0_dbhz=45.0,
              dopplers=None):
    """``scene`` at the ``signal`` preset with ``overrides``, made in a
    worker process of the scene pool."""
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.signals.defs import get_signal
    return scene(get_config(signal, **overrides), get_signal(signal), prns,
                 seconds, cn0_dbhz, dopplers=dopplers)


# the gps_l2c CL long pilot at the shape of
# tests/test_torch_pilot_correlator.py's case: 2.048 Msps, three channels
# (PRN, carrier, code phase, starting CL period), periods 73 and 74 rolling
# over to 0; 254 code periods of 20 ms
L2C_CHANNELS = [(1, 7000.0, 101, 73), (2, 7200.0, 138, 5),
                (3, 7400.0, 175, 74)]
L2C_OVER = dict(sampling_freq=2.048e6, if_freq=7000.0, pilot_trk_flag=1)
L2C_EPOCHS = 250


def l2c_scene_job():
    """One SV per channel of ``L2C_CHANNELS`` at its carrier and code phase,
    46 dB-Hz, its CL code at the channel's starting period; made in a
    worker process of the scene pool.  Returns (None, int8 I/Q, seconds)."""
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.io.synth import (SynthSV, quantize_iq_int8,
                                          synthesize_if)
    from cusdr_tpu_torch.signals.defs import get_signal
    t0 = time.perf_counter()
    cfg, sig = get_config("gps_l2c", **L2C_OVER), get_signal("gps_l2c")
    svs = []
    for prn, carr, phase, period in L2C_CHANNELS:
        dop = carr - cfg.if_freq
        code_freq = sig.chip_rate_hz * (1.0 + dop / sig.carrier_freq_hz)
        per_samples = sig.code_length_chips * cfg.sampling_freq / code_freq
        svs.append(SynthSV(prn=prn, code_phase=phase - period * per_samples,
                           doppler_hz=dop, cn0_dbhz=46.0))
    iq = quantize_iq_int8(synthesize_if(
        cfg, sig, svs, num_ms=int((L2C_EPOCHS + 4) * sig.code_period_ms),
        seed=3))
    return None, iq, time.perf_counter() - t0


def _union_length(starts, lengths):
    """Samples covered by the union of the windows [start, start + length)."""
    import numpy as np
    order = np.argsort(starts, kind="stable")
    lo, hi = starts[order], (starts + lengths)[order]
    reach = np.maximum.accumulate(hi)
    # what each window adds beyond the furthest end before it
    return int(hi[0] - lo[0]
               + np.maximum(reach[1:] - np.maximum(lo[1:], reach[:-1]),
                            0).sum())


def superblock_bound(n_pilots, interp, blk, n_rows, n_epochs, abs_sample,
                     blksize, sample_bytes=2):
    """The least time the card could take for one superblock launch on this
    run's data (``abs_sample``, ``blksize``: the [E, C] outputs, the window
    starts in the record and their lengths, 0 where a row was frozen), as
    benchmark/roofline.py counts it, the record read once over the union
    of the valid windows (the rows of a bank read nearly the same stretch
    of one record, which is one input).  Returns (milliseconds, "bytes" or
    "operations", bytes, operations)."""
    from benchmark.roofline import bound_s, superblock_work
    valid = blksize > 0
    n_bytes, ops = superblock_work(
        rows=n_rows, epochs=n_epochs, valid_epochs=int(valid.sum()),
        valid_samples=int(blksize.sum()),
        span=_union_length(abs_sample[valid], blksize[valid]), blk=blk,
        pilots=n_pilots, interp=interp, sample_bytes=sample_bytes)
    seconds, by = bound_s(n_bytes, ops)
    return seconds * 1e3, by, n_bytes, ops


def _track_arrays(track):
    """{"kind.field": numpy array} of a superblock's (state, outputs) pair
    of tensors, or of a stitched TrackResults (its outputs, active_until
    and status)."""
    import numpy as np
    from cusdr_tpu_torch.tracking.engine import TrackOutputs
    if isinstance(track, tuple):
        return {f"{kind}.{name}": v.cpu().numpy()
                for kind, part in zip(("state", "out"), track)
                for name, v in zip(part._fields, part)}
    return {f"out.{name}": np.asarray(getattr(track, name))
            for name in TrackOutputs._fields + ("active_until", "status")}


def _compare_tracks(got, want):
    """Field by field, a superblock's (state, outputs) from the kernel
    against the eager loop's, or two stitched TrackResults: integer
    fields and the status equal, f32 sums within TRACK_RTOL·(max + 1),
    frequencies within FREQ_ATOL, the other f64 fields within STATE_RTOL /
    STATE_ATOL.  Returns (differing elements, largest |difference| over
    the f32 outputs, {field: largest |difference|} of the fields that
    differ, the fields beyond their tolerance)."""
    import numpy as np
    got, want = _track_arrays(got), _track_arrays(want)
    n_diff, err32, worst, beyond = 0, 0.0, {}, []
    for key, g in got.items():
        w = want[key]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{key}: {g.dtype} {g.shape} against "
                                 f"{w.dtype} {w.shape}")
        if g.dtype.kind == "f" and not np.isfinite(g).all():
            raise AssertionError(f"{key}: not finite")
        differ = int((g != w).sum())
        if not differ:
            continue
        n_diff += differ
        if g.dtype.kind not in "biuf":
            beyond.append(key)
            continue
        d = np.abs(g.astype(np.float64) - w.astype(np.float64))
        worst[key] = float(d.max())
        if g.dtype == np.float32:
            err32 = max(err32, float(d.max()))
            ok = d.max() <= TRACK_RTOL * (np.abs(w).max() + 1.0)
        elif key.split(".")[1] in FREQ_FIELDS:
            ok = d.max() <= FREQ_ATOL
        elif g.dtype == np.float64:
            ok = bool((d <= STATE_ATOL + STATE_RTOL * np.abs(w)).all())
        else:
            ok = False
        if not ok:
            beyond.append(key)
    return n_diff, err32, worst, beyond


def _hold_tracks(tag, got, want):
    """``_compare_tracks`` that raises beyond the tolerances.  Returns
    (differing elements, largest f32 |difference|)."""
    n_diff, err32, worst, beyond = _compare_tracks(got, want)
    if beyond:
        raise AssertionError(f"[{tag}] beyond the tolerance: {beyond}; "
                             f"largest differences {worst}")
    return n_diff, err32


def superblock_check(name, label, cfg, sig, iq, channels, n_epochs,
                     n_blocks=1, staged=False):
    """Phase 3e (3f with ``staged``), one bank: the superblock kernel (the
    staged one) against the eager loop (on staged windows) on the first
    ``n_blocks * n_epochs`` epochs of the record ``iq`` from the channels'
    given code phases and carriers, in both tap modes, with one block per
    row and with the wrapper's own cluster size; the card's time per launch
    (CUDA events over back-to-back launches on the packed state: a trace of
    launches this few can come back empty), the wall time per
    ``track_superblock`` call, the eager loop's device time (torch.profiler)
    and wall time, and the card's bound for this run's data.  With
    ``staged`` also the slow-path epochs and, timed in turns with it on the
    same bank, the fetch superblock kernel.  With ``n_blocks`` > 1 the bank
    holds that many time blocks of the channels and every odd block's rows
    end part way through the superblock.  A cluster's largest
    carrier-frequency difference is logged with its row, epoch and the
    eager loop's prompt pair there."""
    import dataclasses
    import numpy as np
    import torch
    from cusdr_tpu_torch.ops import correlator as corr
    from cusdr_tpu_torch.parallel.timeblocks import predict_block_states
    from cusdr_tpu_torch.tracking import engine
    dev = torch.device("cuda")
    spc = cfg.samples_per_code
    n_samp = min(len(iq) // 2, (n_blocks * n_epochs + 5) * spc)
    rec = torch.from_numpy(np.ascontiguousarray(iq[:2 * n_samp])).to(dev)
    # the code-rate aiding leaves an FDMA channel's carrier offset out
    dops = engine.code_dopplers(cfg, sig, channels)
    n_ch = len(channels)
    end = None
    if n_blocks > 1:
        st2, starts = predict_block_states(channels, cfg, sig, n_blocks,
                                           n_epochs, dev)
        state = engine.ChannelState(*(x.reshape(-1) for x in st2))
        ends = np.full((n_blocks, n_ch), n_samp, np.int64)
        for b in range(1, n_blocks, 2):
            ends[b] = starts[b].min() + (n_epochs // 2
                                         + n_epochs // 25 * b) * spc
        end = torch.from_numpy(ends.reshape(-1)).to(dev)
    else:
        state = engine.init_channel_state(
            channels, sig.chip_rate_hz, dev, dopplers=dops,
            carrier_freq_hz=sig.carrier_freq_hz)
    n_rows = state.abs_sample.shape[0]
    variants = (corr.STAGED_SUPERBLOCK_VARIANTS if staged
                else corr.SUPERBLOCK_VARIANTS)
    n_pilots = variants.index(name.removesuffix("[int16]"))
    rows = {}
    for interp in (True, False):
        params = dataclasses.replace(engine.make_track_params(cfg, sig),
                                     interp_taps=interp,
                                     fetch_in_kernel=not staged)
        ctabs, ptabs = engine.build_replica_tables(cfg, sig, params,
                                                   channels, dops)
        tables = torch.from_numpy(ctabs).to(dev)
        ptables = None if ptabs is None else torch.from_numpy(ptabs).to(dev)
        args = (rec, 0, tables, ptables, state, params, n_epochs, end)

        def eager():
            return engine.track_superblock_epochs(*args)

        def kern():
            return engine.track_superblock(*args)

        packed_state = engine.pack_state(state)
        end_rows = end if end is not None else torch.full(
            (n_rows,), n_samp, dtype=torch.int64, device=dev)
        slow = {}

        def launch(size, fetch=not staged):
            """A wrapper alone on the packed state: back to back, the
            card's time per call is the kernel's."""
            bank = corr.track_superblock_bank if fetch \
                else corr.track_superblock_staged_bank
            res = bank(rec, 0, tables, ptables, *packed_state, end_rows,
                       n_epochs, dataclasses.replace(
                           params, fetch_in_kernel=fetch),
                       up_margin=engine.UP_MARGIN, cluster=size)
            if not fetch:
                slow[size] = res[2]
            return engine._finish_bank(engine.unpack_state(*res[0]), res[1])

        want = eager()
        torch.cuda.synchronize()
        blksize = want[1].blksize.cpu().numpy()
        if n_blocks > 1 and not ((blksize[-1] == 0).any()
                                 and (blksize[-1] > 0).any()):
            raise AssertionError(f"{name} {label}: the per-row ends froze "
                                 "no row or every row")
        tag = (f"[{'staged ' if staged else ''}superblock] {name} {label} "
               f"{n_rows} x {params.blk} x {n_epochs} epochs, "
               f"interp_taps={interp}")
        cluster = corr.cluster_size(n_rows)
        measured = {}
        for size in sorted({1, cluster}):
            def fn():
                return launch(size)

            got = kern() if size == cluster else fn()
            torch.cuda.synchronize()
            n_diff, err32, worst, beyond = _compare_tracks(got, want)
            log(f"{tag}, {size} block(s) per row: {n_diff} elements differ "
                f"from the eager loop's; largest |difference| per field: "
                f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} }")
            if n_diff:
                d = (got[1].carr_freq - want[1].carr_freq).abs()
                e, r = divmod(int(d.argmax().item()), n_rows)
                log(f"{tag}, {size} block(s) per row: largest carrier "
                    f"difference {d.max().item():.3g} Hz at epoch {e}, row "
                    f"{r}, where the eager loop's I_P, Q_P are "
                    f"{want[1].i_p[e, r].item():.1f}, "
                    f"{want[1].q_p[e, r].item():.1f}")
            if size == 1 and n_diff:
                raise AssertionError(f"{tag}, one block per row: not the "
                                     f"eager loop's bits: {worst}")
            if beyond:
                raise AssertionError(f"{tag}, {size} block(s) per row: "
                                     f"beyond the tolerance: {beyond}")
            if staged:
                # the staged kernel and the fetch kernel in turns
                def fetch_fn():
                    return launch(size, fetch=True)

                f1, s1, s2, f2 = (_timed(f, 5)
                                  for f in (fetch_fn, fn, fn, fetch_fn))
                n_slow = int(slow[size].sum().item())
                if n_slow:
                    log(f"{tag}, {size} block(s) per row: slow-path epochs "
                        f"per row {slow[size].tolist()}")
                log(f"{tag}, {size} block(s) per row: slow-path epochs "
                    f"{n_slow} (summed over rows and blocks); time on the "
                    f"card per superblock (CUDA events over back-to-back "
                    f"launches): staged {(s1 + s2) / 2:.4f} ms ({s1:.4f}, "
                    f"{s2:.4f}), fetch superblock kernel "
                    f"{(f1 + f2) / 2:.4f} ms ({f1:.4f}, {f2:.4f}): "
                    f"staged / fetch {(s1 + s2) / (f1 + f2):.3f}")
                measured[size] = (n_diff, err32, (s1 + s2) / 2,
                                  (f1 + f2) / 2, n_slow)
            else:
                measured[size] = (n_diff, err32, _timed(fn, 5))
        row = dict(err=measured[cluster][1], n_diff=measured[cluster][0],
                   cluster=cluster, device_ms=measured[cluster][2],
                   n_diff_one_block=measured[1][0],
                   device_ms_one_block=measured[1][2])
        if staged:
            row.update(fetch_ms=measured[cluster][3],
                       fetch_ms_one_block=measured[1][3],
                       slow_epochs=measured[cluster][4],
                       slow_epochs_one_block=measured[1][4])
        scale = max(getattr(want[1], f).abs().max().item()
                    for f in ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l"))
        e1, k1, k2, e2 = (_timed(f, 2) for f in (eager, kern, kern, eager))
        b_ms, b_by, n_bytes, ops = superblock_bound(
            n_pilots, interp, params.blk, n_rows, n_epochs,
            want[1].abs_sample.cpu().numpy(), blksize,
            sample_bytes=2 * rec.element_size())
        row.update(tol=TRACK_RTOL * (scale + 1.0), wrapper_ms=(k1 + k2) / 2,
                   plain_wrapper_ms=(e1 + e2) / 2,
                   plain_device_ms=_device_ms(eager, n=1), bound_ms=b_ms,
                   bound_by=b_by, bytes=n_bytes, ops=ops)
        rows[interp] = row
        log(f"{tag}: time on the card per superblock: kernel (CUDA events "
            f"over back-to-back launches) {_fmt_ms(row['device_ms'])} with "
            f"{cluster} block(s) per row, "
            f"{_fmt_ms(row['device_ms_one_block'])} with one; eager loop "
            f"(torch.profiler device time) "
            f"{_fmt_ms(row['plain_device_ms'])}; bound {b_ms:.6f} ms by "
            f"{b_by} ({n_bytes} bytes, {ops} operations)")
        log(f"{tag}: wall time per call (CUDA events): kernel "
            f"{row['wrapper_ms']:.3f} ms ({k1:.3f}, {k2:.3f}), eager loop "
            f"{row['plain_wrapper_ms']:.3f} ms ({e1:.3f}, {e2:.3f})")
    return dict(name=name, label=label, n_ch=n_rows, blk=params.blk,
                k=params.k_spacing, rows=rows)


def superblock_checks(scenes, staged=False):
    """Phase 3e (3f with ``staged``: the staged superblock kernel) on the
    scenes' records; returns {kernel: [checks]}, the first check of a
    kernel at its path's shape."""
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.ops import correlator as corr
    from cusdr_tpu_torch.signals.defs import get_signal

    def truth(cfg, svs):
        return [(sv.prn, _true_carrier(cfg, sv), int(round(sv.code_phase)))
                for sv in svs]

    l1, e5a = get_config("gps_l1ca"), get_config("gal_e5a")
    b1c = get_config("bds_b1c", **B1C_WB)
    l2c = get_config("gps_l2c", **L2C_OVER)
    glo = get_config("glo_l1")
    b1i, b3i, e1c = (get_config(p) for p in ("bds_b1i", "bds_b3i",
                                             "gal_e1c"))
    # the first 255 code periods of the main record as int16, times 64
    svs, iq8, _ = scenes["main"]
    iq16 = iq8[:2 * 255 * l1.samples_per_code].astype("int16") * INT16_SCALE
    main_truth = truth(l1, svs)
    # (pilot banks, path, config, scene, channels, epochs, time blocks)
    cases = (
        (0, "gps_l1ca", l1, scenes["main"], None, 250, 1),
        (0, "gps_l1ca time_blocks=8, per-row ends", l1, scenes["main"],
         None, 250, TIME_BLOCKS),
        (1, "gal_e5a", e5a, scenes["e5a"], None, 250, 1),
        (1, "gps_l2c CL long pilot", l2c, scenes["l2c"], L2C_CHANNELS,
         L2C_EPOCHS, 1),
        (2, "bds_b1c WB", b1c, scenes["b1c"], None, 100, 1),
        (0, "glo_l1 FDMA, k = -7..4, IF 0", glo, scenes["glo_l1"], None,
         250, 1),
        (0, "gps_l1ca int16 (the int8 record x 64)", l1, (svs, iq16, 0.0),
         None, 250, 1),
        # the shapes of phase 18's presets no other case runs
        (0, "bds_b1i, k = 4", b1i, scenes["bds_b1i"], None, 250, 1),
        (0, "bds_b3i, 15 rows", b3i, scenes["bds_b3i"], None, 250, 1),
        (1, "gal_e1c, 4 ms epochs", e1c, scenes["gal_e1c"], None,
         E1C_EPOCHS, 1),
        # a bank in each cluster class at sizes the card had not run
        # before phase 20: the main record's 12 SVs, repeated
        *((0, f"gps_l1ca, {n} rows", l1, scenes["main"],
           [main_truth[i % len(main_truth)] for i in range(n)],
           CLASS_EPOCHS, 1) for n in CLASS_ROWS))
    variants = (corr.STAGED_SUPERBLOCK_VARIANTS if staged
                else corr.SUPERBLOCK_VARIANTS)
    checks = {}
    for n_pilots, label, cfg, made, channels, n_epochs, n_blocks in cases:
        if channels is None:
            channels = truth(cfg, made[0])
        name = variants[n_pilots] + ("[int16]" if made[1].itemsize == 2
                                     else "")
        checks.setdefault(name, []).append(superblock_check(
            name, label, cfg, get_signal(cfg.signal), made[1], channels,
            n_epochs, n_blocks, staged))
    return checks


def check_main(cfg, svs, res, launches=None, tail_epochs=500,
               pilot=False, acq_carr_tol_hz=None, acq_code_tol=None):
    """Every simulated SV acquired where it was put (within
    ``acq_carr_tol_hz``, by default two fine steps, and ``acq_code_tol``
    samples, by default the DLL's half-chip pull-in, or the one-sample grid
    of the search where a chip spans under two samples), every channel in
    lock near its true frequency (means over the last ``tail_epochs``; the
    pilot prompt too with ``pilot``), outputs finite, ``launches`` (where
    given) one per superblock of ``cfg.superblock_ms``.  Returns (epochs,
    prompt SNRs, tracked and acquired carrier errors)."""
    import numpy as np
    acq_err = _check_acquired(cfg, svs, res.channels, acq_carr_tol_hz,
                              acq_code_tol)
    trk = res.track
    n_ep = trk.i_p.shape[1]
    names = ["i_p", "q_p", "carr_freq", "code_freq"]
    pairs = [("i_p", "q_p")]
    if pilot:
        names += ["pilot_ip", "pilot_qp"]
        pairs.append(("pilot_ip", "pilot_qp"))
    for name in names:
        if not np.isfinite(getattr(trk, name)).all():
            raise AssertionError(f"non-finite {name}")
    tail = slice(n_ep - tail_epochs, n_ep)
    snr = [np.abs(getattr(trk, i)[:, tail]).mean(axis=1)
           / getattr(trk, q)[:, tail].std(axis=1) for i, q in pairs]
    truth = {sv.prn: _true_carrier(cfg, sv) for sv in svs}
    fr_err = np.asarray([trk.carr_freq[c, tail].mean() - truth[p]
                         for c, p in enumerate(trk.prns)])
    if not (all(s == "T" for s in trk.status)
            and all((x > 3.0).all() for x in snr)
            and (np.abs(fr_err) < 5.0).all()):
        raise AssertionError(f"lock lost: status {trk.status}, mean|I_P|"
                             f"/std(Q_P) {snr}, carrier error {fr_err} Hz")
    if launches is not None and launches != _superblocks(cfg, n_ep):
        raise AssertionError(f"{launches} kernel launches for {n_ep} "
                             f"tracked epochs in superblocks of "
                             f"{cfg.superblock_ms} ms")
    return n_ep, snr, fr_err, acq_err


def _check_acquired(cfg, svs, channels, acq_carr_tol_hz=None,
                    acq_code_tol=None):
    """Every SV of ``svs`` among the acquired ``channels``, at its code
    phase (within ``acq_code_tol`` samples) and carrier at sample 0
    (within ``acq_carr_tol_hz``; defaults as ``check_main``'s).  Returns
    the carrier errors [Hz]."""
    import numpy as np
    if acq_carr_tol_hz is None:
        acq_carr_tol_hz = 2 * cfg.fine_search_step
    if acq_code_tol is None:
        acq_code_tol = max(0.5 * cfg.sampling_freq / cfg.code_freq_basis,
                           1.0)
    spc = cfg.samples_per_code
    acq_err = []
    got = {c[0]: c for c in channels}
    missing = [sv.prn for sv in svs if sv.prn not in got]
    if missing:
        raise AssertionError(f"SVs not acquired: {missing}")
    for sv in svs:
        _, carr, cp, _ = got[sv.prn]
        dcp = (cp - sv.code_phase + spc / 2) % spc - spc / 2
        dfr = carr - _true_carrier(cfg, sv)
        acq_err.append(dfr)
        if abs(dcp) > acq_code_tol or abs(dfr) > acq_carr_tol_hz:
            raise AssertionError(f"PRN {sv.prn}: code phase off by {dcp} "
                                 f"samples, carrier by {dfr} Hz")
    return np.asarray(acq_err)


def _true_carrier(cfg, sv):
    """The carrier an SV of the scene was put at: the IF, its Doppler and,
    for an FDMA signal, its frequency channel's offset."""
    from cusdr_tpu_torch.signals.defs import get_signal
    sig = get_signal(cfg.signal)
    offset = sig.fdma_spacing_hz * sv.fdma_channel if sig.fdma else 0.0
    return cfg.if_freq + offset + sv.doppler_hz


def _superblocks(cfg, n_epochs):
    """Superblocks ``engine.track`` cuts ``n_epochs`` into."""
    from cusdr_tpu_torch.signals.defs import get_signal
    from cusdr_tpu_torch.tracking.engine import (superblock_epochs,
                                                 superblock_plan)
    return len(superblock_plan(
        n_epochs, superblock_epochs(cfg, get_signal(cfg.signal))))


def eager_track(card, tag, cfg, made, res, variant, n_epochs):
    """The record's first superblock of ``n_epochs`` epochs again through
    the eager epoch loop ``engine.track_superblock_epochs`` (the superblock
    kernel's plain version), step by step as ``engine.track`` runs a
    superblock (tables, state, staging buffer, copy to the card, tracking,
    outputs to the host), on the channels ``res`` acquired: one launch of
    the per-epoch kernel ``variant`` per epoch and none of the superblock
    kernel; its block sizes and prompt signs are the kernel run's.  Returns
    the launches of ``variant``."""
    import numpy as np
    import torch
    from cusdr_tpu_torch.ops.correlator import LAUNCHES, reset_launches
    from cusdr_tpu_torch.signals.defs import get_signal
    from cusdr_tpu_torch.tracking import engine
    sig = get_signal(cfg.signal)
    dev = torch.device("cuda")
    iq, channels = made[1], res.channels
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    params = engine.make_track_params(cfg, sig)
    dops = engine.code_dopplers(cfg, sig, channels)
    ctabs, ptabs = engine.build_replica_tables(cfg, sig, params, channels,
                                               dops)
    tables = torch.from_numpy(ctabs).to(dev)
    ptables = None if ptabs is None else torch.from_numpy(ptabs).to(dev)
    state = engine.init_channel_state(channels, sig.chip_rate_hz, dev,
                                      dopplers=dops,
                                      carrier_freq_hz=sig.carrier_freq_hz)
    buf_len = (max(ch[2] for ch in channels)
               + (n_epochs + 4) * cfg.samples_per_code + params.blk)
    buf = engine.stage_superblock(iq, 0, buf_len)
    _, outs = engine.track_superblock_epochs(
        torch.from_numpy(buf).to(dev), 0, tables, ptables, state, params,
        n_epochs, len(iq) // 2)
    blksize, i_p = outs.blksize.cpu().numpy().T, outs.i_p.cpu().numpy().T
    sec = time.perf_counter() - t0
    _only(tag, dict(LAUNCHES), variant, n_epochs)
    new = res.track
    if not np.array_equal(blksize, new.blksize[:, :n_epochs]):
        raise AssertionError(f"[{tag}] the eager loop's block sizes differ "
                             "from the superblock kernel's")
    same = (np.sign(i_p) == np.sign(new.i_p[:, :n_epochs])).mean()
    if same < 0.999:
        raise AssertionError(f"[{tag}] prompt signs agree in {same:.4f} of "
                             "the epochs")
    rec_s = n_epochs * sig.code_period_ms * 1e-3
    new_n = new.i_p.shape[1]
    new_rt = new_n * sig.code_period_ms * 1e-3 / res.timings["tracking_s"]
    log(f"[{tag}] same call on {card}: eager loop {len(res.channels)} "
        f"channels x {n_epochs} epochs in {sec:.3f} s = {rec_s / sec:.3f}x "
        f"real time ({sec / n_epochs * 1e3:.3f} ms per epoch); superblock "
        f"kernel {new_n} epochs in {res.timings['tracking_s']:.3f} s = "
        f"{new_rt:.3f}x real time "
        f"({res.timings['tracking_s'] / new_n * 1e3:.4f} ms per epoch); "
        f"block sizes equal, prompt signs equal in {same:.5f} of the epochs")
    return n_epochs


def run_path(card, tag, cfg, made, variant, pilot, tail_epochs,
             acq_carr_tol_hz=None, acq_code_tol=None):
    """``Receiver(cfg, "cuda").run`` on the scene ``made`` (``scene``'s
    result) with every launch count set to 0 just before it; returns the
    launches of ``variant`` and the receiver's results."""
    import numpy as np
    import torch
    from cusdr_tpu_torch.signals.defs import get_signal
    from cusdr_tpu_torch.ops.correlator import LAUNCHES, reset_launches
    from cusdr_tpu_torch.receiver import Receiver
    sig = get_signal(cfg.signal)
    svs, iq, made_s = made
    log(f"[{tag}] scene: {len(svs)} SVs at {svs[0].cn0_dbhz:g} dB-Hz, "
        f"{len(iq) // 2} samples at {cfg.sampling_freq / 1e6:g} Msps, "
        f"made in {made_s:.1f} s")
    rx = Receiver(cfg, "cuda")
    torch.cuda.synchronize()
    reset_launches()
    res = rx.run(iq)
    launches = dict(LAUNCHES)
    _only(tag, launches, variant, launches[variant], fine=1)
    n_ep, snr, fr_err, acq_err = check_main(cfg, svs, res,
                                            launches[variant], tail_epochs,
                                            pilot, acq_carr_tol_hz,
                                            acq_code_tol)
    tm = res.timings
    rec_s = n_ep * sig.code_period_ms * 1e-3
    n_samp = rec_s * cfg.sampling_freq
    log(f"[{tag}] acquisition on {card}: {len(res.channels)} channels, "
        f"{len(cfg.acq_satellite_list)} PRNs x {cfg.num_freq_bins} bins x "
        f"{cfg.acq_non_coh_time} x {cfg.acq_coh_time} ms, "
        f"{tm['acquisition_s']:.3f} s")
    log(f"[{tag}] tracking on {card}: {len(res.channels)} channels x "
        f"{n_ep} epochs of {sig.code_period_ms:g} ms in "
        f"{tm['tracking_s']:.3f} s = {n_samp / tm['tracking_s']:.4g} "
        f"record samples/s ({rec_s / tm['tracking_s']:.3f}x real time), "
        f"{launches[variant]} {variant} launches (one per superblock)")
    for (i, q), x in zip([("I_P", "Q_P"), ("pilot I_P", "pilot Q_P")],
                         snr):
        log(f"[{tag}] mean|{i}|/std({q}) "
            f"{[round(float(v), 1) for v in x]}")
    log(f"[{tag}] carrier error: acquisition max "
        f"{np.abs(acq_err).max():.2f} Hz, tracking (mean) max "
        f"{np.abs(fr_err).max():.2f} Hz")
    return launches[variant], res


# four seconds: phase 9 tracks the same record as 8 blocks of ~500 epochs
MAIN_SCENE = ("gps_l1ca", {}, [1, 3, 6, 8, 11, 13, 17, 19, 22, 24, 28, 31],
              4.0)
TIME_BLOCKS = 8
# phases 3e, 3f: the gal_e1c bank (12 x 72 008 samples) through one
# superblock of 4 ms epochs
E1C_EPOCHS = 250
# phases 3e, 3f: gps_l1ca banks of these rows, 100 epochs each, in the
# cluster classes of ``cluster_size`` (4 blocks a row at 17-33 rows, 2 at
# 34-66, 1 from 67) at sizes the card had not run before phase 20
CLASS_ROWS = (17, 32, 33, 34, 40, 64, 66, 67)
CLASS_EPOCHS = 100
# gal_e5a at 50 dB-Hz: the preset's GLRT threshold of 4.5 over 15 x 1 ms
# non-coherent rounds of the primary code leaves most 45 dB-Hz SVs below
# it (metrics 3.5-4.8 on the card), as tests/test_e2e_l5c.py notes for L5
# at the same threshold
E5A_SCENE = ("gal_e5a", {}, [1, 3, 5, 7, 9, 11, 13, 19, 21, 24, 26, 30],
             3.0, 50.0)
B1C_WB = dict(pilot_trk_flag=2)
# bds_b1c WB: the spread of the other scenes snapped to the fine stage's
# 25 Hz grid, 5 Hz off it.  The fine stage leaves up to half a step plus
# noise, and the 10 ms PLL does not pull in 14 Hz: at -4400..4600 Hz
# unsnapped, PRN 28 at +1385.7 Hz is acquired 14.3 Hz off and stays 16.5
# Hz off, in the reference as in the port (ROADMAP.md Queue C)
B1C_SCENE = ("bds_b1c", B1C_WB, list(range(19, 34)), 2.5, 45.0,
             [-4395, -3745, -3120, -2470, -1820, -1170, -545, 105, 755,
              1380, 2030, 2680, 3330, 3955, 4605])


def main_path(card: str, made):
    from cusdr_tpu_torch import get_config
    return run_path(card, "main", get_config("gps_l1ca"), made,
                    "track_superblock", pilot=False, tail_epochs=500)


def pilot_path(card: str, made):
    """The acquired carrier is held to half a coarse step, not two fine
    steps: the fine stage searches 5 Hz bins only within half a coarse
    step of the coarse pick, so a Doppler within a few Hz of a coarse-bin
    boundary whose neighbouring bin wins the coarse search is left at the
    fine window's edge (13.6 Hz from truth for PRN 5's -2763.6 Hz here,
    in the reference as in the port).  The PLL pulls it in; the tracked
    carrier is held to 5 Hz."""
    from cusdr_tpu_torch import get_config
    cfg = get_config("gal_e5a")
    return run_path(card, "e5a", cfg, made, "track_superblock_pilot",
                    pilot=True, tail_epochs=500,
                    acq_carr_tol_hz=cfg.acq_search_step / 2)


def dual_pilot_path(card: str, made):
    from cusdr_tpu_torch import get_config
    return run_path(card, "b1c-wb", get_config("bds_b1c", **B1C_WB), made,
                    "track_superblock_dual_pilot", pilot=True,
                    tail_epochs=100)


def _block_tails_locked(tag, trk, tail, pilot=False):
    """mean|I_P| / std(Q_P) over the last ``tail`` epochs of every block
    and channel (and the pilot prompt's with ``pilot``): all above 3; every
    channel tracking to the end.  A sequential run is one block.  Returns
    the lowest."""
    import numpy as np
    epb = getattr(trk, "epochs_per_block", trk.i_p.shape[1])
    worst = np.inf
    for i, q in [("i_p", "q_p")] + ([("pilot_ip", "pilot_qp")] if pilot
                                    else []):
        for b in range(getattr(trk, "n_blocks", 1)):
            sl = slice((b + 1) * epb - tail, (b + 1) * epb)
            snr = (np.abs(getattr(trk, i)[:, sl]).mean(axis=1)
                   / getattr(trk, q)[:, sl].std(axis=1))
            worst = min(worst, float(snr.min()))
            if not (snr > 3.0).all():
                raise AssertionError(f"[{tag}] block {b}: mean|{i}|/std({q})"
                                     f" {snr} over its last {tail} epochs")
    if not all(st == "T" for st in trk.status):
        raise AssertionError(f"[{tag}] status {trk.status}")
    return worst


def _signs_as_sequential(tag, trk, seq):
    """The stitched prompt stream has the sequential run's bit signs in
    every block: per channel and block, the share of epochs whose I_P sign
    equals the sequential run's is above 99 % (or below 1 % in every
    block, were block 0 itself locked half a cycle away).  Returns the
    lowest share."""
    import numpy as np
    row = {prn: c for c, prn in enumerate(seq.prns)}
    epb = trk.epochs_per_block
    n = min(trk.i_p.shape[1], seq.i_p.shape[1]) // epb * epb
    worst = 1.0
    for c, prn in enumerate(trk.prns):
        same = (np.sign(trk.i_p[c, :n]) == np.sign(seq.i_p[row[prn], :n]))
        share = same.reshape(-1, epb).mean(axis=1)
        if share[0] < 0.5:
            share = 1.0 - share
        worst = min(worst, float(share.min()))
        if not (share > 0.99).all():
            raise AssertionError(f"[{tag}] PRN {prn}: sign agreement with "
                                 f"the sequential run per block {share}")
    return worst


def _only(tag, launches, variant, want, fine=0):
    """``launches`` holds ``want`` launches of ``variant``, ``fine`` of
    acquisition's fine search (one per ``acquire`` that detected a PRN:
    ``Receiver.run`` makes one) and none of any other kernel."""
    others = {k: v for k, v in launches.items()
              if k not in (variant, "fine_search") and v}
    if (others or launches[variant] != want
            or launches["fine_search"] != fine):
        raise AssertionError(f"[{tag}] {launches[variant]} {variant} "
                             f"launches, {want} expected; "
                             f"{launches['fine_search']} fine_search, "
                             f"{fine} expected; other kernels: {others}")


def time_parallel_path(card: str, made, seq_res):
    """Phase 9 on the main path's record: ``Receiver.run`` with
    ``time_blocks=8`` (flat bank: one superblock-kernel launch per pass),
    then the per-block path through ``track_time_parallel``: one staged
    superblock-kernel launch per pass, then the eager loop in its place
    (one staged per-epoch kernel launch per epoch step) on the same card.
    Returns the launches of (track_superblock, track_superblock_staged,
    correlate_windows)."""
    import numpy as np
    import torch
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.ops.correlator import LAUNCHES, reset_launches
    from cusdr_tpu_torch.parallel.timeblocks import track_time_parallel
    from cusdr_tpu_torch.receiver import Receiver
    from cusdr_tpu_torch.signals.defs import get_signal
    cfg = get_config("gps_l1ca", time_blocks=TIME_BLOCKS)
    sig = get_signal("gps_l1ca")
    svs, iq, _ = made
    passes = cfg.handoff_iters + 1
    rx = Receiver(cfg, "cuda")
    torch.cuda.synchronize()
    reset_launches()
    res = rx.run(iq)
    launches = dict(LAUNCHES)
    trk = res.track
    n_ep, epb = trk.i_p.shape[1], trk.epochs_per_block
    if trk.n_blocks != TIME_BLOCKS or n_ep != TIME_BLOCKS * epb:
        raise AssertionError(f"[tp] {trk.n_blocks} blocks x {epb} epochs "
                             f"for {n_ep} epochs")
    _only("tp", launches, "track_superblock", passes, fine=1)
    check_main(cfg, svs, res, None, tail_epochs=200)
    worst_snr = _block_tails_locked("tp", trk, 200)
    share = _signs_as_sequential("tp", trk, seq_res.track)
    rec_s = n_ep * sig.code_period_ms * 1e-3
    seq_n = seq_res.track.i_p.shape[1]
    seq_rt = (seq_n * sig.code_period_ms * 1e-3
              / seq_res.timings["tracking_s"])
    flat_s = res.timings["tracking_s"]
    log(f"[tp] flat bank on {card}: {TIME_BLOCKS} blocks x "
        f"{len(res.channels)} channels = {TIME_BLOCKS * len(res.channels)} "
        f"rows x {epb} epochs x {passes} passes in {flat_s:.3f} s = "
        f"{rec_s / flat_s:.3f}x real time "
        f"({flat_s / (epb * passes) * 1e3:.4f} ms per epoch step), "
        f"{launches['track_superblock']} track_superblock launches; lowest "
        f"block-tail mean|I_P|/std(Q_P) {worst_snr:.1f}; lowest per-block "
        f"sign agreement with the sequential run {share:.4f}")

    # the per-block path: staged windows, on the record's first two seconds,
    # through the staged superblock kernel and then through its plain
    # version, the eager loop, for the rate before and after in one call
    n_short = TIME_BLOCKS * 250
    blocks = {}
    for eager in (False, True):
        variant = "correlate_windows" if eager else "track_superblock_staged"
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        trk_b = track_time_parallel(cfg, sig, iq, res.channels, n_short,
                                    TIME_BLOCKS, device="cuda",
                                    fetch_in_kernel=False, epoch_loop=eager)
        sec = time.perf_counter() - t0
        launches_b = dict(LAUNCHES)
        _only("tp-blocks", launches_b, variant,
              250 * passes if eager else passes)
        worst_b = _block_tails_locked("tp-blocks", trk_b, 100)
        share_b = _signs_as_sequential("tp-blocks", trk_b, seq_res.track)
        blocks[variant] = (launches_b[variant], sec, trk_b)
        log(f"[tp-blocks] per-block path on {card}, "
            f"{'eager loop' if eager else 'staged superblock kernel'}: "
            f"{TIME_BLOCKS} blocks x {len(res.channels)} channels x 250 "
            f"epochs x {passes} passes in {sec:.3f} s = "
            f"{n_short * 1e-3 / sec:.3f}x real time "
            f"({sec / (250 * passes) * 1e3:.3f} ms per epoch step), "
            f"{launches_b[variant]} {variant} launches; lowest block-tail "
            f"mean|I_P|/std(Q_P) {worst_b:.1f}; lowest per-block sign "
            f"agreement {share_b:.4f}")
    (n_staged, staged_s, trk_s), (n_windows, eager_s, trk_e) = (
        blocks["track_superblock_staged"], blocks["correlate_windows"])
    if not np.array_equal(trk_s.blksize, trk_e.blksize):
        raise AssertionError("[tp-blocks] the eager loop's block sizes "
                             "differ from the staged kernel's")
    log(f"[tp] real-time factors on {card}: sequential {seq_rt:.3f}x "
        f"({seq_n} epochs), flat time_blocks={TIME_BLOCKS} "
        f"{rec_s / flat_s:.3f}x ({n_ep} epochs), per-block "
        f"{n_short * 1e-3 / staged_s:.3f}x on the staged superblock kernel "
        f"and {n_short * 1e-3 / eager_s:.3f}x on the eager loop "
        f"({n_short} epochs)")
    return (launches["track_superblock"], n_staged, n_windows,
            rec_s / flat_s)


def staged_pilot_path(card, tag, cfg, made, res, variant, epb, tail):
    """The per-block path on a pilot signal: two blocks of ``epb`` epochs
    of the record ``made`` on the channels ``res`` acquired, through
    ``track_time_parallel`` with staged windows, on the staged superblock
    kernel ``variant`` (one launch per pass) and then on the eager loop
    (one launch of its per-epoch kernel per epoch step).  Returns the
    launches of (``variant``, the per-epoch kernel)."""
    import torch
    from cusdr_tpu_torch.ops import correlator as corr
    from cusdr_tpu_torch.parallel.timeblocks import track_time_parallel
    from cusdr_tpu_torch.signals.defs import get_signal
    sig = get_signal(cfg.signal)
    passes = cfg.handoff_iters + 1
    per_epoch = corr.WINDOW_VARIANTS[
        corr.STAGED_SUPERBLOCK_VARIANTS.index(variant)]
    rec_s = 2 * epb * sig.code_period_ms * 1e-3
    counts, rates = [], []
    for eager in (False, True):
        name = per_epoch if eager else variant
        torch.cuda.synchronize()
        corr.reset_launches()
        t0 = time.perf_counter()
        trk = track_time_parallel(cfg, sig, made[1], res.channels, 2 * epb,
                                  2, device="cuda", fetch_in_kernel=False,
                                  epoch_loop=eager)
        sec = time.perf_counter() - t0
        launches = dict(corr.LAUNCHES)
        _only(tag, launches, name, epb * passes if eager else passes)
        worst = _block_tails_locked(tag, trk, tail, pilot=True)
        counts.append(launches[name])
        rates.append(rec_s / sec)
        log(f"[{tag}] per-block path on {card}, "
            f"{'eager loop' if eager else 'staged superblock kernel'}: "
            f"2 blocks x {len(res.channels)} channels x {epb} epochs of "
            f"{sig.code_period_ms:g} ms x {passes} passes in {sec:.3f} s = "
            f"{rec_s / sec:.3f}x real time, {launches[name]} {name} "
            f"launches; lowest block-tail prompt SNR (data and pilot) "
            f"{worst:.1f}")
    log(f"[{tag}] real-time factors on {card}: staged superblock kernel "
        f"{rates[0]:.3f}x, eager loop {rates[1]:.3f}x")
    return tuple(counts)


def pvt_time_parallel(card: str, made):
    """Phase 10: phase 5's scene with time_blocks=8."""
    from cusdr_tpu_torch.ops.correlator import LAUNCHES, reset_launches
    from cusdr_tpu_torch.receiver import Receiver
    scn, samples, _ = made
    cfg = _pvt_config().replace(time_blocks=TIME_BLOCKS)
    reset_launches()
    res = Receiver(cfg, "cuda").run(samples)
    _only("pvt-tp", dict(LAUNCHES), "track_superblock",
          cfg.handoff_iters + 1, fine=1)
    if res.track.n_blocks != TIME_BLOCKS or res.track.settle_epochs != 0:
        raise AssertionError("[pvt-tp] not an exactly stitched 8-block run")
    _check_fixes("pvt-tp", card, scn, res, "test_e2e_timeparallel", 60,
                 15.0, 50.0)


def perf_tool(card: str):
    """The 500-epoch loops of tools/perf_correlator.py, with the launch
    counts set to 0 before them; returns the launches of
    (correlate_windows_ramp, correlate_windows_table) in the timed loops
    and the tool's results."""
    from cusdr_tpu_torch.ops.correlator import LAUNCHES, reset_launches
    from cusdr_tpu_torch.tools import perf_correlator
    import torch
    dev = torch.device("cuda")
    reset_launches()
    results = [perf_correlator.bench_ramp(dev),
               perf_correlator.bench_table(dev)]
    launches = dict(LAUNCHES)
    for r in results:
        log(f"[perf_correlator] on {card}: "
            f"{perf_correlator.report(r, dev)}")
        # one launch outside the loops: the comparison with the plain version
        if not 0 < r["loop_launches"] == launches[r["name"]] - 1:
            raise AssertionError(f"[perf_correlator] {r['name']}: "
                                 f"{r['loop_launches']} launches in the "
                                 f"loops, {launches[r['name']]} counted")
    others = {k: v for k, v in launches.items()
              if v and k not in (r["name"] for r in results)}
    if others:
        raise AssertionError(f"[perf_correlator] other kernels ran: "
                             f"{others}")
    return results


def _pvt_config():
    from cusdr_tpu_torch import get_config
    return get_config("gps_l1ca", sampling_freq=2.048e6, if_freq=7000.0,
                      acq_satellite_list=tuple(range(1, 33)),
                      acq_non_coh_time=12, use_trop_corr=False,
                      ms_to_process=40_000)


def pvt_scene_job():
    """The L1 C/A PVT scene, made in a worker process of the scene pool.
    Returns (scenario, int8 I/Q, seconds it took)."""
    from cusdr_tpu_torch.io.scenario import make_gps_scenario
    from cusdr_tpu_torch.io.synth import quantize_iq_int8, synthesize_if
    from cusdr_tpu_torch.signals.defs import get_signal
    cfg = _pvt_config()
    sig = get_signal("gps_l1ca")
    t0 = time.perf_counter()
    scn = make_gps_scenario(cfg, sig, n_svs=6, duration_s=40.0,
                            cn0_dbhz=46.0)
    samples = quantize_iq_int8(
        synthesize_if(cfg, sig, scn.svs, num_ms=40_500, seed=7))
    return scn, samples, time.perf_counter() - t0


def pvt(card: str, made):
    scn, samples, _ = made
    res = _run_sequential("pvt", _pvt_config(), samples, "track_superblock")
    _check_fixes("pvt", card, scn, res, "test_e2e_l1ca", 60, 15.0, 50.0)


def _run_sequential(tag, cfg, samples, variant):
    """``Receiver(cfg).run`` on the card (the default device) with the
    launch counts set to 0 before it: one launch of ``variant`` per
    superblock and no other kernel."""
    from cusdr_tpu_torch.ops.correlator import LAUNCHES, reset_launches
    from cusdr_tpu_torch.receiver import Receiver
    reset_launches()
    res = Receiver(cfg).run(samples)
    _only(tag, dict(LAUNCHES), variant,
          _superblocks(cfg, res.track.i_p.shape[1]), fine=1)
    return res


def _check_fixes(tag, card, scn, res, test, min_fixes, mean_m, max_m):
    """Every SV of the scenario ``scn`` acquired, and at least
    ``min_fixes`` fixes with a 3-D error of mean below ``mean_m`` and max
    below ``max_m``; logs them with ``res.timings``' stage seconds.
    Returns the errors [m]."""
    missing = {sv.prn for sv in scn.svs} - {c[0] for c in res.channels}
    if missing or res.nav is None:
        raise AssertionError(f"{tag}: SVs {missing} not acquired or no "
                             "fix")
    err = _fix_errors(scn, res.nav.X, res.nav.Y, res.nav.Z)
    stages = ", ".join(f"{k.removesuffix('_s')} {v:.2f} s"
                       for k, v in res.timings.items())
    log(f"[{tag}] on {card}: {len(err)} fixes, 3-D error mean "
        f"{err.mean():.2f} m, max {err.max():.2f} m; {stages} for "
        f"{res.track.i_p.shape[1]} epochs x {len(res.channels)} channels")
    _hold_fixes(tag, test, err, min_fixes, mean_m, max_m)
    return err


def _fix_errors(scn, x, y, z):
    """3-D distances [m] of fixes from the scenario's receiver."""
    import numpy as np
    return np.sqrt((np.asarray(x) - scn.rx_ecef[0]) ** 2
                   + (np.asarray(y) - scn.rx_ecef[1]) ** 2
                   + (np.asarray(z) - scn.rx_ecef[2]) ** 2)


def _hold_fixes(tag, test, err, min_fixes, mean_m, max_m):
    if not (len(err) >= min_fixes and err.mean() < mean_m
            and err.max() < max_m):
        raise AssertionError(f"{tag}: fixes outside the {test} bounds: "
                             f"{len(err)} fixes, mean {err.mean()} m, max "
                             f"{err.max()} m")


L5_MSG_S = 6.0          # one CNAV message at 50 bps = 6 s


def _cnav_eph(prn: int, toe: float, *, m0: float, omega0: float) -> dict:
    """CNAV MT10/11/30 ephemeris on the codec's field grids, orbit near
    the GPS nominal shell (as tests/test_e2e_l5c.py builds it)."""
    import numpy as np
    rng = np.random.default_rng(prn + 100)
    toe = 300.0 * round(toe / 300.0)      # t_oe grid is 300 s (MT10)
    return dict(
        PRN=float(prn), weekNumber=1214.0, health=0.0, T_op=toe,
        URA_ED=1.0, t_oe=toe, t_oc=toe,
        deltaA=float(rng.uniform(-200.0, 200.0)), ADot=0.0,
        delta_n_0=float(rng.uniform(3.5e-9, 5.5e-9)), delta_n_0Dot=0.0,
        M_0=m0, e=float(rng.uniform(0.003, 0.02)),
        omega=float(rng.uniform(-np.pi, np.pi) * 0.99),
        omega_0=omega0, i_0=np.radians(55.0),
        delta_omegaDot=0.0, i_0Dot=0.0,
        C_is=float(rng.uniform(-2e-7, 2e-7)),
        C_ic=float(rng.uniform(-2e-7, 2e-7)),
        C_rs=float(rng.uniform(-80, 80)),
        C_rc=float(rng.uniform(150, 350)),
        C_us=float(rng.uniform(2e-6, 9e-6)),
        C_uc=float(rng.uniform(-6e-6, 6e-6)),
        a_f0=float(rng.uniform(-2e-4, 2e-4)), a_f1=0.0, a_f2=0.0,
        T_GD=float(rng.uniform(-8e-9, 8e-9)), ISC_L5I=0.0, ISC_L2C=0.0,
    )


def _cnav_stream(eph, frame_t0):
    """±1 CNAV symbols at 10 ms/symbol from signal time frame_t0."""
    import numpy as np
    from cusdr_tpu_torch.nav import cnav
    mids = [10, 11, 30, 10, 11, 30]
    msgs = [cnav.encode_message(mid, eph,
                                int(frame_t0 + L5_MSG_S * (k + 1)),
                                prn=int(eph["PRN"]))
            for k, mid in enumerate(mids)]
    return cnav.encode_symbol_stream(msgs).astype(np.int8)


def _l5_config():
    from cusdr_tpu_torch import get_config
    return get_config("gps_l5c", sampling_freq=12.288e6, if_freq=7000.0,
                      acq_satellite_list=tuple(range(1, 13)),
                      acq_non_coh_time=10, pilot_trk_flag=1,
                      use_trop_corr=False, ms_to_process=26_000)


def l5_scene_job():
    """The L5 PVT scene, made in a worker process of the scene pool.
    Returns (scenario, int8 I/Q, seconds it took)."""
    from cusdr_tpu_torch.io.scenario import make_generic_scenario
    from cusdr_tpu_torch.io.synth import quantize_iq_int8, synthesize_if
    from cusdr_tpu_torch.orbits.cnav_kepler import sat_pos_cnav
    from cusdr_tpu_torch.signals.defs import get_signal
    cfg = _l5_config()
    sig = get_signal("gps_l5c")
    t0 = time.perf_counter()
    scn = make_generic_scenario(
        cfg, sig, eph_factory=_cnav_eph, satpos_fn=sat_pos_cnav,
        nav_stream_fn=_cnav_stream, frame_period_s=L5_MSG_S, n_svs=4,
        duration_s=26.0, cn0_dbhz=50.0, prn_pool=range(1, 13))
    samples = quantize_iq_int8(
        synthesize_if(cfg, sig, scn.svs, num_ms=26_400, seed=11))
    return scn, samples, time.perf_counter() - t0


def pvt_pilot(card: str, made):
    cfg = _l5_config()
    scn, samples, made_s = made
    log(f"[pvt-l5] scene: 4 SVs, {len(samples) // 2} samples at "
        f"{cfg.sampling_freq / 1e6:g} Msps, made in {made_s:.1f} s")
    res = _run_sequential("pvt-l5", cfg, samples, "track_superblock_pilot")
    _check_fixes("pvt-l5", card, scn, res, "test_e2e_l5c", 5, 20.0, 60.0)


# phase 11: gps_l2c at the preset (8 Msps, 12 channels, the 32-PRN
# circular-shift search over +-10 kHz at 12.5 Hz with the CL period search)
# on 12 SVs at 46 dB-Hz, each at a known code phase and CL period.  The
# fine stage runs at the 5 Hz step tests/test_e2e_l2c.py and
# tests/test_multisignal.py give the preset: at its own 25 Hz step, twice
# the coarse step, the fine stage has one bin, 6.25 Hz above the coarse
# pick, and the 10 Hz, 20 ms PLL settles 12.5 Hz off on channels left ~9-11
# Hz off, in the reference as in the port (tests/test_torch_l2c.py,
# ``test_shipped_fine_step_pulls_in_as_the_reference``)
L2C_PRESET_OVER = dict(fine_search_step=5.0)
L2C_PRESET_PRNS = [1, 3, 6, 8, 11, 13, 17, 19, 22, 24, 28, 31]
L2C_PRESET_MS = 3100
L2C_PRESET_DOPPLERS = (-4400.0, 4600.0)      # spread over the SVs


def l2c_preset_scene_job():
    """Phase 11's scene, made in a worker process of the scene pool.
    Returns (SVs at the code phase where their CL period starts, int8 I/Q,
    seconds it took, {prn: that CL period})."""
    import numpy as np
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.io.synth import (SynthSV, quantize_iq_int8,
                                          synthesize_if)
    from cusdr_tpu_torch.signals.defs import get_signal
    t0 = time.perf_counter()
    cfg, sig = get_config("gps_l2c"), get_signal("gps_l2c")
    rng = np.random.default_rng(21)
    spc = cfg.samples_per_code
    n_bits = int(L2C_PRESET_MS / sig.nav_symbol_ms) + 2
    synth, truth, periods = [], [], {}
    for prn, dop in zip(L2C_PRESET_PRNS,
                        np.linspace(*L2C_PRESET_DOPPLERS,
                                    len(L2C_PRESET_PRNS))):
        phase = float(rng.uniform(0, spc - 1))
        period = int(rng.integers(0, sig.pilot_phase_hypotheses))
        code_freq = sig.chip_rate_hz * (1.0 + dop / sig.carrier_freq_hz)
        per_samples = sig.code_length_chips * cfg.sampling_freq / code_freq
        synth.append(SynthSV(prn=prn, code_phase=phase - period * per_samples,
                             doppler_hz=float(dop), cn0_dbhz=46.0,
                             nav_bits=rng.choice([-1.0, 1.0], n_bits)))
        truth.append(SynthSV(prn=prn, code_phase=phase,
                             doppler_hz=float(dop), cn0_dbhz=46.0))
        periods[prn] = period
    # one chunk: the CL code generator caches four PRNs' codes, and the
    # synthesizer asks for every SV's code again in every chunk
    iq = quantize_iq_int8(synthesize_if(cfg, sig, synth,
                                        num_ms=L2C_PRESET_MS, seed=21,
                                        chunk_ms=L2C_PRESET_MS))
    return truth, iq, time.perf_counter() - t0, periods


def l2c_path(card: str, made):
    """Phase 11: ``Receiver.run`` at the gps_l2c preset (the fine step of
    ``L2C_PRESET_OVER``): every SV acquired
    within 2 samples of its code phase and with its CL period, every
    channel locked over the last second, one superblock-kernel launch per
    superblock; the acquisition's seconds split into the coarse search,
    the CL period search and the fine stage.  Returns the launches."""
    from cusdr_tpu_torch import get_config
    cfg = get_config("gps_l2c", **L2C_PRESET_OVER)
    svs, iq, made_s, periods = made
    launches, res = run_path(card, "l2c", cfg, (svs, iq, made_s),
                             "track_superblock", pilot=False, tail_epochs=50)
    spc = cfg.samples_per_code
    by_prn = {sv.prn: sv for sv in svs}
    for prn, _, cp, pilot_phase in res.channels:
        sv = by_prn[prn]
        # the peak may lie a period on, where the next CL period starts
        n = round((cp - sv.code_phase) / spc)
        want = (periods[prn] + n) % 75
        if abs(cp - sv.code_phase - n * spc) > 2 or pilot_phase != want:
            raise AssertionError(f"[l2c] PRN {prn}: code phase {cp} against "
                                 f"{sv.code_phase:.1f} + {n} periods, CL "
                                 f"period {pilot_phase} against {want}")
    tm = res.acq.timings
    log(f"[l2c] acquisition on {card}: coarse (circular-shift search) "
        f"{tm['coarse_s']:.3f} s, CL period search {tm['pilot_phase_s']:.3f}"
        f" s, fine {tm['fine_s']:.3f} s; every CL period as the scene's")
    return launches


GLO_L1_SCENE = ("glo_l1", {}, list(range(-7, 5)), 3.0, 45.0)
GLO_L2_SCENE = ("glo_l2", {}, list(range(-7, 5)), 3.0, 45.0)


def glonass_path(card: str, made_l1, made_l2):
    """Phase 12: ``Receiver.run`` at the glo_l1 preset (12 Msps, IF 0, the
    14-channel FDMA search): every SV acquired, every channel locked, one
    superblock-kernel launch per superblock; then glo_l2 with
    ``time_blocks=8`` through the flat bank (one launch per pass) and the
    per-block path (one staged launch per pass), every channel locked over
    every block's tail.  Returns the launches of (glo_l1, the flat bank,
    the per-block path)."""
    import torch
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.ops.correlator import LAUNCHES, reset_launches
    from cusdr_tpu_torch.parallel.timeblocks import track_time_parallel
    from cusdr_tpu_torch.receiver import Receiver
    from cusdr_tpu_torch.signals.defs import get_signal
    n_l1, _ = run_path(card, "glo-l1", get_config("glo_l1"), made_l1,
                       "track_superblock", pilot=False, tail_epochs=500)
    cfg = get_config("glo_l2", time_blocks=TIME_BLOCKS)
    sig = get_signal("glo_l2")
    svs, iq, _ = made_l2
    passes = cfg.handoff_iters + 1
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = Receiver(cfg, "cuda").run(iq)
    sec = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    _only("glo-l2-tp", launches, "track_superblock", passes, fine=1)
    check_main(cfg, svs, res, None, tail_epochs=100)
    trk = res.track
    worst = _block_tails_locked("glo-l2-tp", trk, 100)
    n_ep = trk.i_p.shape[1]
    log(f"[glo-l2-tp] flat bank on {card}: {TIME_BLOCKS} blocks x "
        f"{len(res.channels)} channels x {trk.epochs_per_block} epochs x "
        f"{passes} passes, acquisition {res.timings['acquisition_s']:.3f} s,"
        f" tracking {res.timings['tracking_s']:.3f} s = "
        f"{n_ep * 1e-3 / res.timings['tracking_s']:.3f}x real time, "
        f"{launches['track_superblock']} track_superblock launches; lowest "
        f"block-tail mean|I_P|/std(Q_P) {worst:.1f} (Receiver.run {sec:.3f}"
        f" s)")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    trk_b = track_time_parallel(cfg, sig, iq, res.channels, n_ep,
                                TIME_BLOCKS, device="cuda",
                                fetch_in_kernel=False)
    sec = time.perf_counter() - t0
    launches_b = dict(LAUNCHES)
    _only("glo-l2-blocks", launches_b, "track_superblock_staged", passes)
    worst = _block_tails_locked("glo-l2-blocks", trk_b, 100)
    log(f"[glo-l2-blocks] per-block path on {card}: {TIME_BLOCKS} blocks x "
        f"{len(res.channels)} channels x {trk_b.epochs_per_block} epochs x "
        f"{passes} passes in {sec:.3f} s = {n_ep * 1e-3 / sec:.3f}x real "
        f"time, {launches_b['track_superblock_staged']} "
        f"track_superblock_staged launches; lowest block-tail "
        f"mean|I_P|/std(Q_P) {worst:.1f}")
    return n_l1, launches["track_superblock"], \
        launches_b["track_superblock_staged"]


_SUMS = ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l", "pilot_ip", "pilot_qp")


def _int16_differs(tag, got, want):
    """Elements of the int16 run ``got`` (TrackResults) that differ from
    the int8 run ``want``'s: its correlator sums 64 times, every other
    array equal.  Raises if any differs."""
    import numpy as np
    n_diff, fields = 0, []
    for name, w in vars(want).items():
        if not isinstance(w, np.ndarray):
            continue
        g = getattr(got, name)
        differ = int((g != (INT16_SCALE * w if name in _SUMS else w)).sum())
        if differ:
            n_diff += differ
            fields.append(name)
    if n_diff or got.status != want.status:
        raise AssertionError(f"[{tag}] the int16 run differs from the int8 "
                             f"run in {n_diff} elements of {fields}, status "
                             f"{got.status} against {want.status}")
    return n_diff


def int16_path(card: str, made, seq_res):
    """Phase 13: phase 4's record times 64 as int16 through ``track`` (the
    superblock kernel's int16 instantiation, one launch per superblock),
    equal to phase 4's int8 run: the same states, block sizes and loop
    outputs and 64 times its sums, element for element; then its first
    second through the eager loop (the int16 per-epoch kernel); then the
    per-block path (8 blocks x 250 epochs) on the int8 and the int16
    record, equal the same way, and the eager loop in its place on the
    int16 record.  Returns the launches of the four int16 kernels."""
    import types
    import numpy as np
    import torch
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.ops.correlator import LAUNCHES, reset_launches
    from cusdr_tpu_torch.parallel.timeblocks import track_time_parallel
    from cusdr_tpu_torch.signals.defs import get_signal
    from cusdr_tpu_torch.tracking.engine import track
    cfg, sig = get_config("gps_l1ca"), get_signal("gps_l1ca")
    svs, iq8, _ = made
    iq16 = iq8.astype(np.int16) * INT16_SCALE
    channels = seq_res.channels
    out = {}
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    trk = track(cfg, sig, iq16, channels, "cuda")
    sec = time.perf_counter() - t0
    n_ep = trk.i_p.shape[1]
    out["track_superblock[int16]"] = LAUNCHES["track_superblock[int16]"]
    _only("int16", dict(LAUNCHES), "track_superblock[int16]",
          _superblocks(cfg, n_ep))
    _int16_differs("int16", trk, seq_res.track)
    log(f"[int16] sequential on {card}: {len(channels)} channels x {n_ep} "
        f"epochs of the int16 record (the int8 record x {INT16_SCALE}) in "
        f"{sec:.3f} s = {n_ep * 1e-3 / sec:.3f}x real time (int8, phase 4: "
        f"{n_ep * 1e-3 / seq_res.timings['tracking_s']:.3f}x), "
        f"{out['track_superblock[int16]']} track_superblock[int16] "
        "launches; 0 elements differ from the int8 run (sums x "
        f"{INT16_SCALE}, everything else equal)")
    out["correlate_bank[int16]"] = eager_track(
        card, "int16", cfg, (svs, iq16, 0.0),
        types.SimpleNamespace(channels=channels, track=trk,
                              timings={"tracking_s": sec}),
        "correlate_bank[int16]", 1000)
    tb = get_config("gps_l1ca", time_blocks=TIME_BLOCKS)
    passes = tb.handoff_iters + 1
    n_short = TIME_BLOCKS * 250
    runs = {}
    for name, iq, eager in (("int8", iq8, False), ("int16", iq16, False),
                            ("int16 eager", iq16, True)):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        runs[name] = track_time_parallel(tb, sig, iq, channels, n_short,
                                         TIME_BLOCKS, device="cuda",
                                         fetch_in_kernel=False,
                                         epoch_loop=eager)
        sec = time.perf_counter() - t0
        variant = ("correlate_windows" if eager
                   else "track_superblock_staged")
        if iq is iq16:
            variant += "[int16]"
            out[variant] = LAUNCHES[variant]
        _only(f"int16-blocks {name}", dict(LAUNCHES), variant,
              250 * passes if eager else passes)
        log(f"[int16-blocks] per-block path on {card}, {name} record"
            f"{', eager loop' if eager else ''}: {TIME_BLOCKS} blocks x "
            f"{len(channels)} channels x 250 epochs x {passes} passes in "
            f"{sec:.3f} s = {n_short * 1e-3 / sec:.3f}x real time, "
            f"{LAUNCHES[variant]} {variant} launches")
    _int16_differs("int16-blocks", runs["int16"], runs["int8"])
    if not np.array_equal(runs["int16 eager"].blksize, runs["int16"].blksize):
        raise AssertionError("[int16-blocks] the eager loop's block sizes "
                             "differ from the staged kernel's")
    log("[int16-blocks] 0 elements differ between the int16 and the int8 "
        f"per-block runs (sums x {INT16_SCALE}, everything else equal)")
    return out


def _truth_channels(cfg, svs):
    """Channels at the SVs' true carriers and code phases."""
    return [(sv.prn, _true_carrier(cfg, sv), int(round(sv.code_phase)))
            for sv in svs]


# phase 14: (preset, overrides, scene, the superblock kernel of its bank)
MULTI_BANKS = (("gps_l1ca", {}, "main", "track_superblock"),
               ("gal_e5a", {}, "e5a", "track_superblock_pilot"),
               ("bds_b1c", B1C_WB, "b1c", "track_superblock_dual_pilot"))


def multi_signal_path(card: str, scenes):
    """Phase 14: ``track_multi`` over the records of phases 4, 6 and 7 at
    their presets, channels at the SVs' truth, over the common span (a 10
    ms hyperepoch, strides 10, 10, 1), each bank on its own stream; each
    bank against a standalone ``track`` of it with the lock gate off, in
    the same call: every field equal, element for element.  Then
    ``run_multi`` on the gps_l1ca and gal_e5a records from acquisition to
    nav: every SV acquired, every channel in lock.  Returns the launches
    of each bank's superblock kernel in (the ``track_multi`` run, the
    ``run_multi`` run)."""
    import numpy as np
    import torch
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.ops.correlator import LAUNCHES, reset_launches
    from cusdr_tpu_torch.receiver import run_multi
    from cusdr_tpu_torch.signals.defs import get_signal
    from cusdr_tpu_torch.tracking import engine
    from cusdr_tpu_torch.tracking.multi import track_multi
    specs = []
    for signal, over, name, _ in MULTI_BANKS:
        cfg = get_config(signal, lock_detect=False, **over)
        svs, iq, _ = scenes[name]
        specs.append((cfg, get_signal(signal), iq,
                      _truth_channels(cfg, svs)))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    multi = track_multi(specs, device="cuda")
    multi_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    variants = [b[3] for b in MULTI_BANKS]
    others = {k: v for k, v in launches.items() if v and k not in variants}
    if others or not all(launches[v] for v in variants):
        raise AssertionError(f"[multi] launches {launches}")
    span_ms = multi[0].i_p.shape[1] * specs[0][1].code_period_ms
    solo_s, n_samples = 0.0, 0
    for (cfg, sig, iq, chans), got, variant in zip(specs, multi, variants):
        n_ep = got.i_p.shape[1]
        if n_ep * sig.code_period_ms != span_ms:
            raise AssertionError(f"[multi] {cfg.signal}: {n_ep} epochs")
        if launches[variant] != _superblocks(cfg, n_ep):
            raise AssertionError(f"[multi] {cfg.signal}: "
                                 f"{launches[variant]} {variant} launches "
                                 f"for {n_ep} epochs")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        solo = engine.track(cfg, sig, iq, chans, "cuda", n_epochs=n_ep)
        solo_s += time.perf_counter() - t0
        _only(f"multi {cfg.signal} alone", dict(LAUNCHES), variant,
              _superblocks(cfg, n_ep))
        differ = {f: int((getattr(got, f) != getattr(solo, f)).sum())
                  for f in engine.TrackOutputs._fields}
        if any(differ.values()):
            raise AssertionError(f"[multi] {cfg.signal}: elements differing "
                                 f"from the standalone track: {differ}")
        n_samples += span_ms * 1e-3 * cfg.sampling_freq
        log(f"[multi] {cfg.signal}: {len(chans)} channels x {n_ep} epochs "
            f"of {sig.code_period_ms:g} ms, {launches[variant]} {variant} "
            f"launches; 0 elements differ from the standalone track")
    log(f"[multi] on {card}: 3 banks over {span_ms:g} ms at once in "
        f"{multi_s:.3f} s (records to the card included) against "
        f"{solo_s:.3f} s for the three standalone tracks in turn; "
        f"{n_samples / multi_s / 1e6:.1f} record Msps in all "
        f"({span_ms * 1e-3 / multi_s:.3f}x real time for the three)")
    overlap = _stream_overlap(card, specs, span_ms)

    entries = [(get_config("gps_l1ca"), scenes["main"][1]),
               (get_config("gal_e5a"), scenes["e5a"][1])]
    torch.cuda.synchronize()
    reset_launches()
    results = run_multi(entries, device="cuda", n_ms=2500)
    rm = dict(LAUNCHES)
    want = {"track_superblock": 3, "track_superblock_pilot": 3,
            "fine_search": 2}
    if {k: v for k, v in rm.items() if v} != want:
        raise AssertionError(f"[run-multi] launches {rm}")
    for (cfg, _), res, name, pilot in zip(entries, results, ("main", "e5a"),
                                          (False, True)):
        tol = cfg.acq_search_step / 2 if pilot else None
        n_ep, snr, fr_err, acq_err = check_main(
            cfg, scenes[name][0], res, None, tail_epochs=500, pilot=pilot,
            acq_carr_tol_hz=tol)
        log(f"[run-multi] {cfg.signal} on {card}: {len(res.channels)} "
            f"channels acquired in {res.timings['acquisition_s']:.3f} s, "
            f"{n_ep} epochs locked (lowest mean|I_P|/std(Q_P) "
            f"{min(float(x.min()) for x in snr):.1f}, carrier error max "
            f"{np.abs(fr_err).max():.2f} Hz); both banks tracked at once "
            f"in {res.timings['tracking_s']:.3f} s")
    return ({v: launches[v] for v in variants},
            {v: rm.get(v, 0) for v in variants}, overlap)


def _stream_overlap(card, specs, span_ms):
    """Whether the banks' superblock kernels overlap on their streams: the
    card's time (CUDA events on the current stream) for the phase-14
    banks' superblocks over ``span_ms``, records already on the card, run
    one bank after another and all at once by
    ``track_superblock_multi``, in turns (apart, together, together,
    apart).  Returns the four spans in ms."""
    import torch
    from cusdr_tpu_torch.tracking import engine
    from cusdr_tpu_torch.tracking.multi import (BankInputs, _hyper_grid,
                                                track_superblock_multi)
    banks, params_list, per = [], [], []
    for cfg, sig, iq, chans in specs:
        params = engine.make_track_params(cfg, sig)
        dops = engine.code_dopplers(cfg, sig, chans)
        ct, pt = engine.build_tables(cfg, sig, params, chans, dops)
        banks.append(BankInputs(
            torch.from_numpy(iq).cuda(), 0, torch.from_numpy(ct).cuda(),
            None if pt is None else torch.from_numpy(pt).cuda(),
            engine.init_channel_state(chans, sig.chip_rate_hz, "cuda",
                                      dopplers=dops,
                                      carrier_freq_hz=sig.carrier_freq_hz),
            len(iq) // 2))
        params_list.append(params)
        per.append(engine.superblock_epochs(cfg, sig))
    hyper, strides = _hyper_grid([sp[1] for sp in specs])
    n_hyper = int(span_ms) // hyper

    def apart():
        for b, p, s, n in zip(banks, params_list, strides, per):
            track_superblock_multi([b], [p], [s], n_hyper, [n])

    def together():
        track_superblock_multi(banks, params_list, strides, n_hyper, per)

    together()
    torch.cuda.synchronize()
    spans = []
    for fn in (apart, together, together, apart):
        first, last = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        first.record()
        fn()
        last.record()
        last.synchronize()
        spans.append(first.elapsed_time(last))
    log(f"[multi] streams on {card}: the three banks' superblocks over "
        f"{span_ms:g} ms take {spans[0]:.3f} / {spans[3]:.3f} ms of the "
        f"card one bank after another and {spans[1]:.3f} / {spans[2]:.3f} "
        f"ms on three streams at once (CUDA events, records on the card; "
        f"together / apart {min(spans[1:3]) / min(spans[0], spans[3]):.3f})")
    return spans


# phase 15: bds_b1c at 4.096 Msps, where the 0.06-chip spacing is 0.24
# samples (the gather path); B1C_SCENE's Dopplers, 47 dB-Hz
B1C_GATHER = dict(sampling_freq=4.096e6)
B1C_GATHER_SCENE = ("bds_b1c", B1C_GATHER, list(range(19, 34)), 2.5, 47.0,
                    B1C_SCENE[5])
GATHER_EPOCHS = 100     # epochs of the card's step held against the CPU's


def _gather_card_vs_cpu(tag, cfg, iq, channels):
    """``GATHER_EPOCHS`` epochs of the gather step on the card, each also
    run on the CPU from the card's state: per output field the elements
    that differ and the largest difference.  Block sizes, ``abs_sample``
    and the state the step started from must be equal; the sums within
    KERNEL_RTOL (the card's batched product and f32 cos/sin against the
    CPU's)."""
    import warnings
    import torch
    from cusdr_tpu_torch.signals.defs import get_signal
    from cusdr_tpu_torch.tracking import engine
    sig = get_signal(cfg.signal)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        params = engine.make_track_params(cfg, sig)
    dops = engine.code_dopplers(cfg, sig, channels)
    ct, pt = engine.build_element_tables(cfg, sig, params, channels)
    on = {d: [torch.from_numpy(x).to(d) for x in (iq, ct, pt)]
          for d in ("cpu", "cuda")}
    state = engine.init_channel_state(channels, sig.chip_rate_hz, "cuda",
                                      dopplers=dops,
                                      carrier_freq_hz=sig.carrier_freq_hz)
    end = len(iq) // 2
    differ = {f: [0, 0.0] for f in engine.TrackOutputs._fields}
    scale = 0.0
    for _ in range(GATHER_EPOCHS):
        x, t, p = on["cuda"]
        new, got = engine.track_superblock(x, 0, t, p, state, params, 1, end)
        x, t, p = on["cpu"]
        _, want = engine.track_superblock(
            x, 0, t, p, engine.ChannelState(*(v.cpu() for v in state)),
            params, 1, end)
        for f in differ:
            a = getattr(got, f).cpu().double()
            b = getattr(want, f).double()
            d = (a - b).abs()
            differ[f][0] += int((d > 0).sum())
            differ[f][1] = max(differ[f][1], float(d.max()))
        scale = max(scale, float(want.i_p.abs().max()),
                    float(want.pilot_ip.abs().max()))
        state = new
    exact = ("abs_sample", "blksize", "carr_freq", "code_freq",
             "rem_code_phase", "rem_carr_phase")
    sums = ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l", "pilot_ip", "pilot_qp")
    bad = [f for f in exact if differ[f][0]]
    tol = KERNEL_RTOL * (scale + 1.0)
    bad += [f for f in sums if differ[f][1] > tol]
    shown = {f: (n, float(f"{m:.3g}")) for f, (n, m) in differ.items() if n}
    log(f"[{tag}] gather step, card against CPU from the same state, "
        f"{GATHER_EPOCHS} epochs x {len(channels)} channels: differing "
        f"elements and largest difference per field {shown or 'none'}; "
        f"sums held to {tol:.3g}")
    if bad:
        raise AssertionError(f"[{tag}] card against CPU: {bad}")
    return shown


def gather_path(card: str, made):
    """Phase 15: ``Receiver.run`` at bds_b1c with ``sampling_freq`` 4.096
    Msps (15 channels) in NB and WB mode on the gather path: every SV
    acquired, every channel locked, no tracking kernel of ops/ launched
    (acquisition's one fine search only); the card's step against the
    CPU's; then ``time_blocks=2`` on the per-block gather
    path, locked over each block's tail."""
    import warnings
    import torch
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.ops.correlator import LAUNCHES, reset_launches
    from cusdr_tpu_torch.parallel.timeblocks import track_time_parallel
    from cusdr_tpu_torch.receiver import Receiver
    from cusdr_tpu_torch.signals.defs import get_signal
    svs, iq, made_s = made
    sig = get_signal("bds_b1c")
    log(f"[gather] scene: {len(svs)} SVs at {svs[0].cn0_dbhz:g} dB-Hz, "
        f"{len(iq) // 2} samples at 4.096 Msps, made in {made_s:.1f} s")
    out = {}
    for flag, mode in ((1, "NB"), (2, "WB")):
        tag = f"gather-{mode.lower()}"
        cfg = get_config("bds_b1c", pilot_trk_flag=flag, **B1C_GATHER)
        torch.cuda.synchronize()
        reset_launches()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res = Receiver(cfg, "cuda").run(iq)
        if {k: v for k, v in LAUNCHES.items() if v} != {"fine_search": 1}:
            raise AssertionError(f"[{tag}] kernels launched other than "
                                 f"acquisition's one fine search: "
                                 f"{dict(LAUNCHES)}")
        n_ep, snr, fr_err, _ = check_main(cfg, svs, res, None,
                                          tail_epochs=100, pilot=True)
        rt = n_ep * sig.code_period_ms * 1e-3 / res.timings["tracking_s"]
        log(f"[{tag}] on {card}: {len(res.channels)} channels acquired in "
            f"{res.timings['acquisition_s']:.3f} s; {n_ep} epochs of 10 ms "
            f"tracked in {res.timings['tracking_s']:.3f} s = {rt:.3f}x real "
            f"time ({res.timings['tracking_s'] / n_ep * 1e3:.3f} ms per "
            f"epoch), 0 tracking kernel launches; lowest prompt SNR "
            f"(data, pilot) {[round(float(x.min()), 1) for x in snr]}, carrier error max "
            f"{abs(fr_err).max():.2f} Hz")
        shown = _gather_card_vs_cpu(tag, cfg, iq, res.channels)
        tb = cfg.replace(time_blocks=2)
        n_tp = n_ep // 2 * 2
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            trk = track_time_parallel(tb, sig, iq, res.channels, n_tp, 2,
                                      device="cuda")
        tp_s = time.perf_counter() - t0
        if any(LAUNCHES.values()):
            raise AssertionError(f"[{tag}] kernels launched with time "
                                 f"blocks: {dict(LAUNCHES)}")
        worst = _block_tails_locked(tag, trk, min(50, n_tp // 4),
                                    pilot=True)
        tp_rt = n_tp * sig.code_period_ms * 1e-3 / tp_s
        log(f"[{tag}] time_blocks=2, per-block gather path on {card}: "
            f"{n_tp} epochs x {tb.handoff_iters + 1} passes in {tp_s:.3f} "
            f"s = {tp_rt:.3f}x real time, 0 kernel launches; lowest "
            f"block-tail prompt SNR {worst:.1f}")
        out[mode] = dict(realtime=rt, tracking_s=res.timings["tracking_s"],
                         epochs=n_ep, time_blocks_realtime=tp_rt,
                         card_vs_cpu=shown)
    return out


# Runs ``python argv[2:]`` as its own child and writes that child's peak
# resident kilobytes (its rusage's ru_maxrss) into the file argv[1]; exits
# with its exit code.  A process forked from the smoke itself would report
# the smoke's resident memory as its own peak (it inherits it at fork and
# keeps it across exec), so the CLI is forked from this small one.
_PEAK_RSS_LAUNCHER = """\
import os, sys
pid = os.fork()
if pid == 0:
    os.execv(sys.executable, [sys.executable] + sys.argv[2:])
_, status, usage = os.wait4(pid, 0)
with open(sys.argv[1], "w") as out:
    out.write(str(usage.ru_maxrss))
sys.exit(os.waitstatus_to_exitcode(status))
"""


def _cli(args, timeout=600):
    """``python -m cusdr_tpu_torch`` with ``args`` from the checkout;
    raises unless it exits 0 within ``timeout`` seconds.  Returns (its
    standard output, wall seconds, its peak resident MB)."""
    import os
    import signal
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        peak = Path(tmp) / "peak_kb"
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-c", _PEAK_RSS_LAUNCHER, str(peak), "-m",
             "cusdr_tpu_torch", *args], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True)
        try:
            text, errors = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            # the launcher and the CLI it forked
            os.killpg(proc.pid, signal.SIGKILL)
            text, errors = proc.communicate()
        sec = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"[cli] {' '.join(args[:1])} exited "
                                 f"{proc.returncode} after {sec:.1f} s:\n"
                                 f"{text[-3000:]}\n{errors[-3000:]}")
        # ru_maxrss counts kilobytes on Linux
        return text, sec, int(peak.read_text()) / 1024


def _npz_differ(a, b):
    """Fields of two .npz files that differ (or that one lacks)."""
    import numpy as np
    a, b = np.load(a), np.load(b)
    return sorted(set(a.files) ^ set(b.files)) + [
        k for k in a.files if k in b.files
        and not np.array_equal(a[k], b[k], equal_nan=True)]


def cli_path(card: str, scenes):
    """Phase 16: the CLI as subprocesses on phase 5's 40 s PVT record:
    ``run --out D --no-plots --timing`` at the preset's defaults (three
    checkpoints, the timing table; tracking and fixes equal, element for
    element, to ``Receiver(cfg).run()`` in this process on the same file
    and config, and within phase 5's bounds), the same with
    ``--skip-acquisition D/acqResults.npz`` (the same tracking outputs),
    then ``run-multi`` on two 1.3 s files cut from the records of phases
    4 and 6 at their presets."""
    import tempfile
    import numpy as np
    from cusdr_tpu_torch import checkpoint, get_config
    from cusdr_tpu_torch.receiver import Receiver
    scn, samples, _ = scenes["pvt"]
    cfg = _pvt_config()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        rec = tmp / "l1_pvt.bin"
        samples.tofile(rec)
        run = ["run", "--signal", "gps_l1ca", "--file", str(rec), "--fs",
               str(cfg.sampling_freq), "--if-freq", str(cfg.if_freq),
               "--ms", str(cfg.ms_to_process), "--no-plots", "--timing"]
        text, run_s, _ = _cli(run + ["--out", str(tmp / "d")])
        files = sorted(p.name for p in (tmp / "d").iterdir())
        if files != ["acqResults.npz", "navResults.npz", "trkResults.npz"] \
                or "TOTAL" not in text:
            raise AssertionError(f"[cli] run wrote {files}:\n{text}")
        # the config the CLI builds from those flags, run in this process
        n_ep = np.load(tmp / "d" / "trkResults.npz")["i_p"].shape[1]
        res = Receiver(get_config(
            "gps_l1ca", file_name=str(rec), sampling_freq=cfg.sampling_freq,
            if_freq=cfg.if_freq, ms_to_process=cfg.ms_to_process)).run(
                n_epochs=n_ep)
        if res.nav is None:
            raise AssertionError("[cli] Receiver.run on the CLI's file "
                                 "gave no fix")
        checkpoint.save_tracking(tmp / "rx_trk.npz", res.track)
        checkpoint.save_navigation(tmp / "rx_nav.npz", res.nav)
        differ = (_npz_differ(tmp / "d" / "trkResults.npz",
                              tmp / "rx_trk.npz")
                  + _npz_differ(tmp / "d" / "navResults.npz",
                                tmp / "rx_nav.npz"))
        if differ:
            raise AssertionError(f"[cli] run and Receiver.run differ in "
                                 f"{differ}")
        nav = np.load(tmp / "d" / "navResults.npz")
        err = _fix_errors(scn, nav["X"], nav["Y"], nav["Z"])
        # the test_e2e_l1ca bounds, though the preset models a troposphere
        # the scene lacks (phase 5 runs with the correction off)
        _hold_fixes("[cli]", "test_e2e_l1ca", err, 60, 15.0, 50.0)
        log(f"[cli] run on {card}: {len(err)} fixes, equal to "
            f"Receiver.run's in this process (tracking and navigation, "
            f"every element); 3-D error mean {err.mean():.2f} m, max "
            f"{err.max():.2f} m with the troposphere modelled; {files} "
            f"written; {run_s:.1f} s for the process")
        for line in text.splitlines():
            if line.startswith(("Stage", "acquisition ", "tracking ",
                                "navigation ", "TOTAL")):
                log(f"[cli]   {line}")
        text, resume_s, _ = _cli(run + ["--out", str(tmp / "e"),
                                        "--skip-acquisition",
                                        str(tmp / "d" / "acqResults.npz")])
        first = np.load(tmp / "d" / "trkResults.npz")
        again = np.load(tmp / "e" / "trkResults.npz")
        differ = [k for k in first.files
                  if not np.array_equal(first[k], again[k], equal_nan=True)]
        if "acquisition reused" not in text or differ \
                or first.files != again.files:
            raise AssertionError(f"[cli] resumed run: fields {differ} "
                                 f"differ\n{text}")
        log(f"[cli] run --skip-acquisition on {card}: the same "
            f"{len(first.files)} tracking fields, every element equal; "
            f"{resume_s:.1f} s for the process")
        sets = []
        for signal, name in (("gps_l1ca", "main"), ("gal_e5a", "e5a")):
            fs = get_config(signal).sampling_freq
            path = tmp / f"{signal}.bin"
            scenes[name][1][:2 * int(1.3 * fs)].tofile(path)
            sets += ["--set", f"{signal}={path}"]
        text, multi_s, _ = _cli(["run-multi", *sets, "--ms", "1000",
                                 "--out", str(tmp / "m")])
        for signal in ("gps_l1ca", "gal_e5a"):
            trk = np.load(tmp / "m" / f"trk_{signal}.npz")
            if trk["i_p"].shape[1] != 1000 or not (trk["blksize"] > 0).all():
                raise AssertionError(f"[cli] run-multi {signal}: "
                                     f"{trk['i_p'].shape}\n{text}")
        log(f"[cli] run-multi on {card}: trk_gps_l1ca.npz and "
            f"trk_gal_e5a.npz, 1000 epochs each, every channel to the end; "
            f"{multi_s:.1f} s for the process")
        for line in text.strip().splitlines():
            log(f"[cli]   {line}")


# phase 17: multi-device on one card.  The shards of every mesh below are
# entries of the one card, cuda:0; two ranks there are two CUDA contexts
# the card time-slices, so phase 17 shows correctness, not scaling.
MESH_EPOCHS = 250        # (a): one superblock of the main record
MESH_RANK_TIMEOUT_S = 300


def _mesh_step(card, made):
    """Phase 17 (a): one 250-epoch superblock of the main record from the
    SVs' truth through ``tracking_step_sharded`` on a 2-entry 'ch' mesh of
    the card (two 6-row banks, one superblock-kernel launch each) against
    ``track_superblock`` on the whole 12-row bank, and against the eager
    loop (``track_superblock_epochs``, the kernel's plain version) on each
    shard's own rows, tables and state; the kernel takes a cluster of 8
    blocks a row at 6 and at 12 rows.  The card's time of the two shard
    launches against the whole bank's one: CUDA events over back-to-back
    wrapper calls on the packed states, in turns.  Returns the sharded
    run's launches."""
    import torch
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.ops.correlator import (LAUNCHES, cluster_size,
                                                reset_launches,
                                                track_superblock_bank)
    from cusdr_tpu_torch.parallel import (make_mesh, shard_channel_bank,
                                          tracking_step_sharded)
    from cusdr_tpu_torch.signals.defs import get_signal
    from cusdr_tpu_torch.tracking.engine import (UP_MARGIN, ChannelState,
                                                 TrackOutputs, build_tables,
                                                 code_dopplers,
                                                 init_channel_state,
                                                 make_track_params,
                                                 pack_state,
                                                 track_superblock,
                                                 track_superblock_epochs)
    cfg = get_config("gps_l1ca")
    sig = get_signal("gps_l1ca")
    svs, iq, _ = made
    channels = _truth_channels(cfg, svs)
    params = make_track_params(cfg, sig)
    dops = code_dopplers(cfg, sig, channels)
    ct, pt = build_tables(cfg, sig, params, channels, dops)
    tables = torch.from_numpy(ct).to("cuda")
    state = init_channel_state(channels, sig.chip_rate_hz, "cuda",
                               dopplers=dops,
                               carrier_freq_hz=sig.carrier_freq_hz)
    rec = torch.from_numpy(iq).to("cuda")
    reset_launches()
    want = track_superblock(rec, 0, tables, None, state, params,
                            MESH_EPOCHS)
    torch.cuda.synchronize()
    _only("mesh-step whole", dict(LAUNCHES), "track_superblock", 1)
    mesh = make_mesh(device=["cuda:0", "cuda:0"])
    bank = shard_channel_bank(state, tables, None, mesh)
    reset_launches()
    got = tracking_step_sharded(rec, 0, bank, params, MESH_EPOCHS)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    _only("mesh-step", launches, "track_superblock", 2)
    n_diff, err32 = _hold_tracks("mesh-step", got, want)
    # the plain version shard by shard, joined in channel order
    plain = [track_superblock_epochs(rec, 0, sct, spt, st, params,
                                     MESH_EPOCHS)
             for _, st, sct, spt in bank.shards]
    plain = (ChannelState(*(torch.cat(x)
                            for x in zip(*(p[0] for p in plain)))),
             TrackOutputs(*(torch.cat(x, 1)
                            for x in zip(*(p[1] for p in plain)))))
    n_plain, err_plain = _hold_tracks("mesh-step eager", got, plain)
    ms = _in_turns(
        lambda: track_superblock(rec, 0, tables, None, state, params,
                                 MESH_EPOCHS),
        lambda: tracking_step_sharded(rec, 0, bank, params, MESH_EPOCHS))

    def wrapper_calls(banks):
        packed = [(t, pack_state(st),
                   torch.full((st.carr_freq.shape[0],), rec.numel() // 2,
                              dtype=torch.int64, device="cuda"))
                  for t, st in banks]

        def fn():
            for t, pk, end in packed:
                track_superblock_bank(rec, 0, t, None, *pk, end,
                                      MESH_EPOCHS, params,
                                      up_margin=UP_MARGIN)
        return fn

    whole = wrapper_calls([(tables, state)])
    shards = wrapper_calls([(sct, st) for _, st, sct, _ in bank.shards])
    w1, s1, s2, w2 = (_timed(f, 5) for f in (whole, shards, shards, whole))
    log(f"[mesh-step] {card}: {len(channels)} channels x {MESH_EPOCHS} "
        f"epochs over a 2-entry 'ch' mesh of cuda:0 (6 rows a shard, "
        f"cluster {cluster_size(6)}; the whole bank cluster "
        f"{cluster_size(12)}): {launches['track_superblock']} "
        f"track_superblock launches; {n_diff} elements differ from the "
        f"whole bank, f32 by at most {err32:.3g}; {n_plain} from the eager "
        f"loop on the shards, f32 by at most {err_plain:.3g}; card time "
        f"per superblock (CUDA events over 5 back-to-back calls, in "
        f"turns): the whole bank's launch {w1:.4f}, {w2:.4f} ms, the two "
        f"shards' launches {s1:.4f}, {s2:.4f} ms; wall per call, in turns "
        f"(whole, sharded, sharded, whole; the sharded joined on the "
        f"card): {', '.join(f'{x:.2f}' for x in ms)} ms")
    return launches["track_superblock"]


def _in_turns(plain, other):
    """Wall ms of ``plain``, ``other``, ``other``, ``plain``, each ended
    with the card synchronised."""
    import torch
    out = []
    for fn in (plain, other, other, plain):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _mesh_pcps(card, made):
    """Phase 17 (b): the preset's search (32 PRNs x 29 bins x 20 x 1 ms)
    on the main record's first slabs through ``pcps_sharded`` on 2 'ch'
    shards of the card, against the unsharded ``_pcps_cdma_kernel`` on
    the same slabs: code phase and bin exact, peak rtol 1e-5."""
    import numpy as np
    import torch
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.acquisition.pcps import _pcps_cdma_kernel
    from cusdr_tpu_torch.parallel import make_mesh, pcps_sharded
    from cusdr_tpu_torch.signals.defs import get_signal, sample_code
    cfg = get_config("gps_l1ca")
    sig = get_signal("gps_l1ca")
    _, iq, _ = made
    # the slabs and code spectra as acquisition.pcps.acquire makes them
    spc, noncoh = cfg.samples_per_code, cfg.acq_non_coh_time
    win_len = 2 * spc
    nfft = 1 << (win_len - 1).bit_length()
    x = (iq[0:2 * (noncoh + 1) * spc:2].astype(np.float32)
         + 1j * iq[1:2 * (noncoh + 1) * spc:2].astype(np.float32))
    slabs = np.zeros((noncoh, nfft), np.complex64)
    slabs[:, :win_len] = x[np.arange(noncoh)[:, None] * spc
                           + np.arange(win_len)[None, :]]
    prns = list(cfg.acq_satellite_list)
    cfc = np.zeros((len(prns), 1, nfft), np.complex64)
    for i, prn in enumerate(prns):
        padded = np.zeros(nfft, np.float32)
        padded[:spc] = sample_code(sig.data_code(prn), sig.elements_per_chip,
                                   sig.chip_rate_hz, cfg.sampling_freq, spc)
        cfc[i, 0] = np.conj(np.fft.fft(padded))
    f_grid = (cfg.if_freq + cfg.acq_search_band - cfg.acq_search_step
              * np.arange(cfg.num_freq_bins)).astype(np.float32)
    args = (torch.from_numpy(slabs).to("cuda"),
            torch.from_numpy(cfc).to("cuda"), torch.ones(1, device="cuda"),
            torch.from_numpy(f_grid).to("cuda"),
            np.float32(1.0 / cfg.sampling_freq))
    mesh = make_mesh(device=["cuda:0", "cuda:0"])
    want = _pcps_cdma_kernel(*args, noncoh, 1, 2 * spc)
    got = pcps_sharded(*args, n_comp=1, search_len=2 * spc, mesh=mesh)
    ms = _in_turns(lambda: _pcps_cdma_kernel(*args, noncoh, 1, 2 * spc),
                   lambda: pcps_sharded(*args, n_comp=1, search_len=2 * spc,
                                        mesh=mesh))
    peak, b, ph, second, floor = (x.cpu().numpy() for x in got)
    w = [x.cpu().numpy() for x in want]
    if not (np.array_equal(b, w[1]) and np.array_equal(ph, w[2])):
        raise AssertionError(f"[mesh-pcps] bins {b} / {w[1]}, code phases "
                             f"{ph} / {w[2]}")
    for name, g, r in (("peak", peak, w[0]), ("second", second, w[3]),
                       ("floor", floor, w[4])):
        if not np.allclose(g, r, rtol=1e-5, atol=0):
            raise AssertionError(f"[mesh-pcps] {name}: {g} against {r}")
    # acquisition's GLRT metric (acquisition.pcps.acquire) detects every
    # SV of the scene, at its true code phase within half a chip
    metric = (np.sqrt(np.pi) / 2.0) * peak / np.maximum(floor, 1e-12)
    found = {p: int(ph[i]) for i, p in enumerate(prns)
             if metric[i] > cfg.acq_threshold}
    svs = made[0]
    missed = [sv.prn for sv in svs if sv.prn not in found
              or abs((found[sv.prn] - sv.code_phase + spc / 2) % spc
                     - spc / 2)
              > 0.5 * cfg.sampling_freq / cfg.code_freq_basis]
    if missed:
        raise AssertionError(f"[mesh-pcps] SVs not found at their code "
                             f"phases: {missed} (found {found})")
    log(f"[mesh-pcps] {card}: {len(prns)} PRNs x {len(f_grid)} bins x "
        f"{noncoh} ms over 2 'ch' shards of cuda:0: wall per call, in "
        f"turns (unsharded, sharded, sharded, unsharded) "
        f"{', '.join(f'{x:.1f}' for x in ms)} ms; bins and code phases "
        f"equal, peaks within rtol "
        f"{np.max(np.abs(peak - w[0]) / np.abs(w[0])):.2g}; all "
        f"{len(svs)} SVs detected at their code phases ({len(found)} "
        f"PRNs above the threshold)")


def _mesh_time_blocks(card, made):
    """Phase 17 (c): ``track_time_parallel`` on the main record from the
    SVs' truth with ``time_blocks=8`` over a 1x2 ch x tb mesh of cuda:0
    (48 rows a shard: two blocks a row, per-row ends) against the flat
    bank on the card (96 rows: one block a row), and against the eager
    loop, the kernel's plain version, on the same mesh
    (``epoch_loop=True``: each shard's same block buffers, per-row ends
    and handoff), in the same call.  Returns (the
    mesh run's superblock-kernel launches, its result, its real-time
    factor, the flat bank's)."""
    import torch
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.ops.correlator import (LAUNCHES, cluster_size,
                                                reset_launches)
    from cusdr_tpu_torch.parallel.mesh import Mesh
    from cusdr_tpu_torch.parallel.timeblocks import track_time_parallel
    from cusdr_tpu_torch.signals.defs import get_signal
    cfg = get_config("gps_l1ca", time_blocks=TIME_BLOCKS)
    sig = get_signal("gps_l1ca")
    svs, iq, _ = made
    channels = _truth_channels(cfg, svs)
    n_ep = _mesh_epochs(cfg, iq, channels)
    passes = cfg.handoff_iters + 1
    rec_s = n_ep * sig.code_period_ms * 1e-3
    mesh = Mesh([["cuda:0", "cuda:0"]], ("ch", "tb"))
    runs = {}
    for name, kw, want in (("flat", dict(device="cuda"), passes),
                           ("mesh", dict(mesh=mesh), 2 * passes)):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        res = track_time_parallel(cfg, sig, iq, channels, n_ep, TIME_BLOCKS,
                                  **kw)
        sec = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        _only(f"mesh-tb {name}", launches, "track_superblock", want)
        runs[name] = (res, sec, launches["track_superblock"])
    (flat, flat_s, _), (got, sec, n_launch) = runs["flat"], runs["mesh"]
    n_diff, err32 = _hold_tracks("mesh-tb", got, flat)
    # the plain version on the same mesh: each shard's eager loop over the
    # same block buffers, per-row ends and handoff
    t0 = time.perf_counter()
    plain = track_time_parallel(cfg, sig, iq, channels, n_ep, TIME_BLOCKS,
                                mesh=mesh, epoch_loop=True)
    plain_s = time.perf_counter() - t0
    n_plain, err_plain = _hold_tracks("mesh-tb eager", got, plain)
    worst = _block_tails_locked("mesh-tb", got, 200)
    log(f"[mesh-tb] {card}: {TIME_BLOCKS} blocks x {len(channels)} channels "
        f"x {n_ep // TIME_BLOCKS} epochs x {passes} passes over a 1x2 ch x "
        f"tb mesh of cuda:0 ({TIME_BLOCKS // 2 * len(channels)} rows a "
        f"shard, cluster {cluster_size(48)}; the flat 96-row bank cluster "
        f"{cluster_size(96)}): {n_launch} track_superblock launches (2 "
        f"shards x {passes} passes) in {sec:.3f} s = {rec_s / sec:.3f}x "
        f"real time, against {flat_s:.3f} s = {rec_s / flat_s:.3f}x for the "
        f"flat bank in this call; {n_diff} elements differ from the flat "
        f"bank, f32 by at most {err32:.3g}; {n_plain} from the eager loop "
        f"on the same mesh ({plain_s:.3f} s), f32 by at most "
        f"{err_plain:.3g}; lowest block-tail "
        f"mean|I_P|/std(Q_P) {worst:.1f}")
    return n_launch, got, rec_s / sec, rec_s / flat_s


def _mesh_epochs(cfg, iq, channels):
    """The epochs ``Receiver.track`` takes from the record with
    ``cfg.time_blocks``: all it holds, down to a block multiple."""
    spc = cfg.samples_per_code
    n = (len(iq) // 2 - max(ch[2] for ch in channels) - 2 * spc) // spc
    return n // cfg.time_blocks * cfg.time_blocks


def mesh_rank(rank, port, rec_path, out_path, channels):
    """Phase 17 (d), one rank (a spawned process): join a two-process gloo
    group, build the 2x1 ch x tb mesh (one cuda:0 entry each, 'ch' across
    the processes), track the record time-parallel over it and write the
    stitched result and this rank's superblock-kernel launches."""
    import numpy as np
    import torch.distributed as dist
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.ops.correlator import LAUNCHES, reset_launches
    from cusdr_tpu_torch.parallel.distributed import (init_distributed,
                                                      make_mesh_2d)
    from cusdr_tpu_torch.parallel.timeblocks import track_time_parallel
    from cusdr_tpu_torch.signals.defs import get_signal
    from cusdr_tpu_torch.tracking.engine import TrackOutputs
    init_distributed(f"localhost:{port}", num_processes=2, process_id=rank,
                     local_device_ids=[0])
    try:
        mesh = make_mesh_2d(n_ch=2, n_tb=1, device="cuda")
        if mesh.ranks.tolist() != [[0], [1]]:
            raise AssertionError(f"rank {rank}: {mesh!r}")
        cfg = get_config("gps_l1ca", time_blocks=TIME_BLOCKS)
        iq = np.fromfile(rec_path, np.int8)
        reset_launches()
        t0 = time.perf_counter()
        res = track_time_parallel(cfg, get_signal("gps_l1ca"), iq, channels,
                                  _mesh_epochs(cfg, iq, channels),
                                  TIME_BLOCKS, mesh=mesh)
        sec = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    np.savez(out_path, status=np.asarray(res.status), seconds=sec,
             launches=LAUNCHES["track_superblock"],
             others=sum(LAUNCHES.values()) - LAUNCHES["track_superblock"],
             active_until=res.active_until,
             **{f: getattr(res, f) for f in TrackOutputs._fields})


def _mesh_processes(card, made, single):
    """Phase 17 (d): two spawned ranks, gloo, both on cuda:0, over a 2x1
    ch x tb mesh: each rank's stitched result equal to phase (c)'s
    single-process result within its tolerances, and the two ranks'
    results equal.  Returns each rank's superblock-kernel launches."""
    import socket
    import tempfile
    import numpy as np
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.tracking.engine import TrackResults
    cfg = get_config("gps_l1ca", time_blocks=TIME_BLOCKS)
    svs, iq, _ = made
    channels = _truth_channels(cfg, svs)
    ctx = multiprocessing.get_context("spawn")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        rec_path = Path(tmp) / "main_record.bin"
        iq.tofile(rec_path)
        outs = [Path(tmp) / f"rank{r}.npz" for r in range(2)]
        t0 = time.perf_counter()
        procs = [ctx.Process(target=mesh_rank,
                             args=(r, port, str(rec_path), str(outs[r]),
                                   channels)) for r in range(2)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(MESH_RANK_TIMEOUT_S)
        finally:
            hung = [p for p in procs if p.is_alive()]
            for p in hung:
                p.kill()
                p.join()
        wall = time.perf_counter() - t0
        if hung or any(p.exitcode for p in procs):
            raise AssertionError(
                f"[mesh-ranks] exit codes {[p.exitcode for p in procs]}"
                f"{' (killed at the timeout)' if hung else ''}")
        ranks = [dict(np.load(o)) for o in outs]
    passes = cfg.handoff_iters + 1
    results = []
    for r, got in enumerate(ranks):
        if got["launches"] != passes or got["others"]:
            raise AssertionError(f"[mesh-ranks] rank {r}: {got['launches']} "
                                 f"track_superblock launches ({passes} "
                                 f"expected), {got['others']} of others")
        res = TrackResults([ch[0] for ch in channels],
                           {f: got[f] for f in got
                            if f not in ("status", "seconds", "launches",
                                         "others", "active_until")}, cfg)
        if not (np.array_equal(res.active_until, got["active_until"])
                and list(res.status) == list(got["status"])):
            raise AssertionError(f"[mesh-ranks] rank {r}: status "
                                 f"{got['status']}")
        results.append(res)
    differ = {f: int((ranks[0][f] != ranks[1][f]).sum()) for f in ranks[0]
              if f not in ("seconds", "launches", "others")}
    if any(differ.values()):
        raise AssertionError(f"[mesh-ranks] the ranks' results differ: "
                             f"{differ}")
    n_diff, err32 = _hold_tracks("mesh-ranks", results[0], single)
    log(f"[mesh-ranks] {card}: 2 ranks (spawned, gloo, both on cuda:0) over "
        f"a 2x1 ch x tb mesh, {TIME_BLOCKS} blocks x 6 channels a rank: "
        f"{int(ranks[0]['launches'])} track_superblock launches a rank, "
        f"tracking {float(ranks[0]['seconds']):.3f} / "
        f"{float(ranks[1]['seconds']):.3f} s, {wall:.1f} s for the two "
        f"processes; the ranks' results equal; {n_diff} elements differ "
        f"from phase (c)'s single-process mesh, f32 by at most {err32:.3g}")
    return [int(g["launches"]) for g in ranks]


def mesh_path(card: str, made, flat_rt):
    """Phase 17: multi-device on one card, (a)-(d).  Returns the
    superblock-kernel launches of (a) and of (c), the main path of the
    mesh."""
    t0 = time.perf_counter()
    n_step = _mesh_step(card, made)
    _mesh_pcps(card, made)
    n_tb, single, rt, rt_flat = _mesh_time_blocks(card, made)
    log(f"[mesh-tb] real-time factors on {card}: the 1x2 mesh {rt:.3f}x, "
        f"the flat bank {rt_flat:.3f}x in phase 17, {flat_rt:.3f}x in "
        f"phase 9 (acquired channels)")
    _mesh_processes(card, made, single)
    log(f"[mesh] phase 17 in {time.perf_counter() - t0:.1f} s")
    return n_step, n_tb


# phase 18: the six presets no other phase runs as shipped, each through
# ``Receiver.run`` at full width (18 Msps, the preset's channels and PCPS
# grid): (preset, PRNs, seconds, C/N0 [dB-Hz], the superblock kernel of its
# bank, the last epochs over which lock is held).  At 45 dB-Hz the GLRT
# thresholds of gps_l5c (4.5 over 25 x 1 ms), gal_e5b (4.5 over 15 x 1 ms),
# bds_b2a (5.0 over 15 x 1 ms) and gal_e1c (10.0 over one 4 ms period)
# leave most SVs below them (metrics 3.3-4.6, and 6.8-10.8 at gal_e1c), in
# the reference as in the port (ROADMAP.md Queue C), as at gal_e5a in
# phase 6: these four run at 50 dB-Hz.  The BeiDou PRNs are MEO/IGSO ones
# (6-58), whose D1 data carries the NH20 code the scene puts on every SV.
# At bds_b3i the fine stage can leave an SV far off (PRN 9 acquired 182 Hz
# off in a 1.3 s scene of these SVs, where the 15 Hz PLL settles 167 Hz
# off, in the reference as in the port: ROADMAP.md Queue C); this scene,
# checked in both packages on the CPU, has every SV within 25 Hz.
PRESET_SCENES = (
    ("gps_l5c", [1, 3, 6, 8, 11, 13, 17, 19, 22, 24, 28, 31], 3.0, 50.0,
     "track_superblock", 500),
    ("gal_e1c", [1, 3, 5, 7, 9, 11, 13, 19, 21, 24, 26, 30], 3.0, 50.0,
     "track_superblock_pilot", 200),
    ("gal_e5b", [1, 3, 5, 7, 9, 11, 13, 19, 21, 24, 26, 30], 3.0, 50.0,
     "track_superblock_pilot", 500),
    ("bds_b1i", [6, 9, 12, 15, 19, 22, 25, 28, 33, 37, 41, 46], 3.0, 45.0,
     "track_superblock", 500),
    ("bds_b2a", [19, 21, 23, 25, 27, 29, 32, 34, 36, 38, 40, 42], 3.0, 50.0,
     "track_superblock", 500),
    ("bds_b3i", [6, 9, 12, 14, 16, 19, 22, 25, 27, 30, 33, 37, 41, 45, 46],
     2.5, 45.0, "track_superblock", 500),
)


def preset_paths(card: str, scenes):
    """Phase 18: ``Receiver(get_config(preset), "cuda").run`` on each
    preset of ``PRESET_SCENES`` as shipped: every SV acquired within 2
    samples of its code phase (as tests/test_multisignal.py holds every
    preset) and half a coarse step of its carrier, every
    channel locked over the tail (data prompt, and the pilot prompt where
    the preset tracks one), one superblock-kernel launch per superblock and
    no other kernel.  Returns {preset: launches of its superblock
    kernel}."""
    from cusdr_tpu_torch import get_config
    t0 = time.perf_counter()
    launches = {}
    for preset, _, _, _, variant, tail in PRESET_SCENES:
        cfg = get_config(preset)
        launches[preset], _ = run_path(
            card, preset, cfg, scenes[preset], variant,
            pilot=cfg.pilot_trk_flag > 0, tail_epochs=tail,
            acq_carr_tol_hz=cfg.acq_search_step / 2, acq_code_tol=2.0)
    log(f"[presets] phase 18 in {time.perf_counter() - t0:.1f} s")
    return launches


# phase 19: the scene of tests/test_e2e_b1i.py (40 s, 4.096 Msps, 6 MEO
# SVs at 46 dB-Hz, D1 under NH20), from the port's copies of its helpers
def _b1i_config():
    from cusdr_tpu_torch import get_config
    return get_config("bds_b1i", sampling_freq=4.096e6, if_freq=7000.0,
                      acq_satellite_list=tuple(range(6, 38)),
                      acq_search_step=250.0, acq_non_coh_time=8,
                      use_trop_corr=False, ms_to_process=40_000)


def _bds_eph(prn, toe, *, m0, omega0):
    """D1-named ephemeris on a BDS MEO orbit (~27 906 km), as
    tests/test_e2e_b1i.py builds it."""
    from cusdr_tpu_torch.io.scenario import make_gps_eph
    g = make_gps_eph(prn, toe, m0=m0, omega0=omega0)
    return dict(
        SatH1=0, IODC=prn, URAI=0, WN=810, IODE=prn,
        t_oc=toe, t_oe=toe, T_GD_1=g["T_GD"],
        alpha0=0.0, alpha1=0.0, alpha2=0.0, alpha3=0.0,
        beta0=0.0, beta1=0.0, beta2=0.0, beta3=0.0,
        a0=g["a_f0"], a1=g["a_f1"], a2=0.0,
        deltan=g["deltan"], C_uc=g["C_uc"], M_0=g["M_0"], e=g["e"],
        C_us=g["C_us"], C_rc=g["C_rc"], C_rs=g["C_rs"],
        sqrtA=5282.62 + (g["sqrtA"] - 5153.65),
        i_0=g["i_0"], C_ic=g["C_ic"], omegaDot=g["omegaDot"],
        C_is=g["C_is"], iDot=g["iDot"], omega_0=g["omega_0"],
        omega=g["omega"],
        # solver-facing aliases (nav/dispatch normalization)
        a_f0=g["a_f0"], a_f1=g["a_f1"], a_f2=0.0, T_GD=g["T_GD"])


def _bds_satpos(t, eph):
    from cusdr_tpu_torch.constants import BDS_GM, BDS_OMEGA_E_DOT
    from cusdr_tpu_torch.orbits.kepler import sat_pos_kepler
    return sat_pos_kepler(t, eph, gm=BDS_GM, omega_e_dot=BDS_OMEGA_E_DOT)


def _d1_stream(eph, frame_t0):
    """±1 D1 bits of four frames (120 s) from signal time frame_t0."""
    import numpy as np
    from cusdr_tpu_torch.nav import bds_d1
    toe_raw = int(round(eph["t_oe"] / 8.0))
    e = dict(eph, t_oe_msb=toe_raw >> 15, t_oe_lsb=toe_raw & 0x7FFF)
    frames = [bds_d1.encode_subframe(i + 1, e,
                                     int(frame_t0) + 30 * f + 6 * i)
              for f in range(4) for i in range(5)]
    return 2 * np.concatenate(frames).astype(np.int8) - 1


def b1i_scene_job():
    """The B1I PVT scene, made in a worker process of the scene pool.
    Returns (scenario, int8 I/Q, seconds it took)."""
    from cusdr_tpu_torch.io.scenario import make_generic_scenario
    from cusdr_tpu_torch.io.synth import quantize_iq_int8, synthesize_if
    from cusdr_tpu_torch.signals.defs import get_signal
    cfg = _b1i_config()
    sig = get_signal("bds_b1i")
    t0 = time.perf_counter()
    scn = make_generic_scenario(
        cfg, sig, eph_factory=_bds_eph, satpos_fn=_bds_satpos,
        # a D1 frame: five 6 s subframes
        nav_stream_fn=_d1_stream, frame_period_s=30.0, n_svs=6,
        duration_s=40.0, cn0_dbhz=46.0, prn_pool=range(6, 38))
    samples = quantize_iq_int8(
        synthesize_if(cfg, sig, scn.svs, num_ms=40_500, seed=9))
    return scn, samples, time.perf_counter() - t0


# tests/test_e2e_b1i.py's keys of the decoded ephemeris, held to truth at
# rel 1e-6 (and 1e-9 absolute)
B1I_EPH_KEYS = ("e", "sqrtA", "M_0", "omega_0", "i_0", "omega", "t_oe")


def pvt_b1i(card: str, made):
    """Phase 19: PVT on a non-GPS signal, the B1I scene through
    ``Receiver.run`` on the card (at 4.096 Msps the E-L spacing is about a
    sample: the superblock kernel, not the gather path): one launch per
    superblock, fixes within tests/test_e2e_b1i.py's bounds, channel 0's
    decoded D1 ephemeris equal to truth at rel 1e-6.  Returns the
    superblock-kernel launches."""
    from cusdr_tpu_torch.nav.dispatch import decode_channel
    from cusdr_tpu_torch.signals.defs import get_signal
    cfg = _b1i_config()
    scn, samples, made_s = made
    log(f"[pvt-b1i] scene: 6 SVs, {len(samples) // 2} samples at "
        f"{cfg.sampling_freq / 1e6:g} Msps, made in {made_s:.1f} s")
    res = _run_sequential("pvt-b1i", cfg, samples, "track_superblock")
    _check_fixes("pvt-b1i", card, scn, res, "test_e2e_b1i", 5, 20.0, 60.0)
    eph, _, sow = decode_channel(res.track, 0, cfg, get_signal("bds_b1i"))
    prn = res.track.prns[0]
    if eph is None:
        raise AssertionError(f"[pvt-b1i] PRN {prn}: no ephemeris decoded")
    truth = scn.eph_by_prn[prn]
    off = {k: (eph[k], truth[k]) for k in B1I_EPH_KEYS
           if abs(eph[k] - truth[k]) > 1e-6 * abs(truth[k]) + 1e-9}
    if off:
        raise AssertionError(f"[pvt-b1i] PRN {prn}: decoded ephemeris "
                             f"against truth: {off}")
    n = _superblocks(cfg, res.track.i_p.shape[1])
    log(f"[pvt-b1i] on {card}: channel 0 (PRN {prn}) decoded D1 ephemeris "
        f"equal to truth at rel 1e-6 in {', '.join(B1I_EPH_KEYS)} (SOW "
        f"{sow:g}); {n} track_superblock launches (one per superblock)")
    return n


# phase 20: gps_l1ca at the preset's own size.  make_gps_scenario's
# default sky (8 SVs above its 15 degree mask) over the preset's 60 s at 18
# Msps, 60.5 s of samples so that ``Receiver.run`` tracks past the CLI's
# 60 000 epochs, and LNAV frames over the whole record.  The interleaved
# int8 record holds 2.178e9 elements: past 2^31 from sample 1.0737e9
# (59.65 s), and as int16 its bytes from 29.8 s.
FULL_SECONDS = 60.0
FULL_RECORD_MS = 60_500
FULL_SVS = 8
FULL_CN0 = 46.0
FULL_NAV_FRAMES = 4
FULL_SEED = 20
FULL_FIXES = 100        # from 60 s; test_e2e_l1ca asks 60 of its 40 s
# one block count per cluster class of the scene's 8 channels: the flat
# bank of 16, 32, 40, 64 and 72 rows (cluster_size 8, 4, 2, 2, 1); the
# per-block path (staged windows) at 4 and 8
FULL_FLAT_BLOCKS = (2, 4, 5, 8, 9)
FULL_STAGED_BLOCKS = (4, 8)
CARD_CHUNK = 1 << 24    # samples per chunk of the card synthesizer


def full_scene():
    """Phase 20's configuration (the gps_l1ca preset as shipped) and
    scenario."""
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.io.scenario import make_gps_scenario
    from cusdr_tpu_torch.signals.defs import get_signal
    cfg = get_config("gps_l1ca")
    return cfg, make_gps_scenario(
        cfg, get_signal("gps_l1ca"), n_svs=FULL_SVS,
        duration_s=FULL_SECONDS, cn0_dbhz=FULL_CN0,
        nav_frames=FULL_NAV_FRAMES)


def card_if(cfg, sig, svs, n0, n, device, *, noise_std=4.0, generator=None,
            chunk=CARD_CHUNK):
    """The signal model of cusdr_tpu_torch/io/synth.py's ``synthesize_if``
    (data-only CDMA SVs, nav bits, Doppler rate), evaluated by
    torch on ``device`` for samples [n0, n0 + n) of the record, ``chunk``
    samples at a time from n0.  Yields (first sample, I, Q), f32 tensors.

    As there: sample times, code and carrier phases in f64, the carrier
    phase reduced mod 2 pi before its f32 cos and sin, each SV's amplitude
    times its code in f64, rounded to f32 and added in SV order.  Noise,
    N(0, ``noise_std``) per component, is drawn from ``generator``
    (torch.randn, so not synthesize_if's numbers); with no generator there
    is none, at the same amplitudes."""
    import numpy as np
    import torch
    if (sig.pilot_code is not None or sig.data_secondary is not None
            or sig.fdma):
        raise ValueError(f"{sig.name}: the card synthesizer models "
                         "data-only CDMA signals without a secondary code")
    dev = torch.device(device)
    fs = cfg.sampling_freq
    two_pi = 2 * np.pi
    nav_symbol_chips = sig.nav_symbol_ms * 1e-3 * sig.chip_rate_hz
    models = []
    for sv in svs:
        if sv.stop_ms is not None:
            raise ValueError("the card synthesizer models no stop_ms")
        code_freq = sig.chip_rate_hz * (1.0 + sv.doppler_hz
                                        / sig.carrier_freq_hz)
        elems = sig.data_code(sv.prn)
        models.append(dict(
            sv=sv,
            amp=float(np.sqrt(10 ** (sv.cn0_dbhz / 10.0) * 2
                              * noise_std ** 2 / fs)),
            step=code_freq / fs, carrier_hz=cfg.if_freq + sv.doppler_hz,
            epc=len(elems) // sig.code_length_chips,
            elems=torch.as_tensor(elems, device=dev).float(),
            bits=None if sv.nav_bits is None
            else torch.as_tensor(sv.nav_bits, device=dev)))
    for a in range(n0, n0 + n, chunk):
        b = min(a + chunk, n0 + n)
        idx = torch.arange(a, b, dtype=torch.float64, device=dev)
        t = idx / fs
        if generator is None:
            acc_i = torch.zeros(b - a, dtype=torch.float32, device=dev)
            acc_q = torch.zeros_like(acc_i)
        else:
            acc_i, acc_q = noise_std * torch.randn(
                (2, b - a), generator=generator, device=dev)
        for m in models:
            sv = m["sv"]
            chip = (idx - sv.code_phase) * m["step"]
            if sv.doppler_rate != 0.0:
                chip = chip + (0.5 * sig.chip_rate_hz * sv.doppler_rate
                               / sig.carrier_freq_hz) * t * t
            chip = chip.clamp_min(0.0)
            theta = (two_pi * m["carrier_hz"]) * t + sv.carrier_phase
            if sv.doppler_rate != 0.0:
                theta = theta + (np.pi * sv.doppler_rate) * t * t
            # numpy's mod: fmod, then the divisor's sign
            theta = torch.fmod(theta, two_pi)
            theta32 = torch.where(theta < 0, theta + two_pi, theta).float()
            elem = torch.floor(chip * m["epc"]).long()
            vals = m["elems"][elem % len(m["elems"])]
            if m["bits"] is not None:
                bit = torch.floor(chip / nav_symbol_chips).long().clamp(
                    0, len(m["bits"]) - 1)
                vals = vals * m["bits"][bit]
            base = vals.double() * m["amp"]
            acc_i += (base * torch.cos(theta32).double()).float()
            acc_q += (base * torch.sin(theta32).double()).float()
        yield a, acc_i, acc_q


def card_quantize(i, q):
    """``io/synth.quantize_iq_int8`` of I + jQ: rounded half to even,
    clipped to +-127, interleaved int8."""
    import torch
    return torch.stack([x.round().clamp(-127, 127) for x in (i, q)],
                       dim=1).to(torch.int8).reshape(-1)


def card_record(cfg, sig, svs, num_ms, seed, device="cuda"):
    """``num_ms`` of the scene as an interleaved int8 record (a host numpy
    array), synthesized on ``device`` by ``card_if`` with noise from a
    generator seeded with ``seed``."""
    import numpy as np
    import torch
    n = int(round(num_ms * cfg.sampling_freq * 1e-3))
    out = np.empty(2 * n, np.int8)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for a, i, q in card_if(cfg, sig, svs, 0, n, device, generator=gen):
        out[2 * a:2 * (a + len(i))] = card_quantize(i, q).cpu().numpy()
    return out


def _first_code_start(cfg, sig, sv):
    """The sample at which ``sv``'s first whole code period starts, the
    code phase acquisition finds, for an SV whose ``code_phase`` counts
    from the start of its nav frame, far before sample 0, as
    make_gps_scenario's do."""
    step = sig.chip_rate_hz * (1.0 + sv.doppler_hz
                               / sig.carrier_freq_hz) / cfg.sampling_freq
    return (sv.code_phase * step) % sig.code_length_chips / step


def _full_cli(card, cfg, scn, rec, tmp):
    """Phase 20 (b): ``run --no-plots --timing`` on the record file at the
    preset as shipped, then again with ``--skip-acquisition``."""
    import numpy as np
    from cusdr_tpu_torch import checkpoint
    run = ["run", "--signal", "gps_l1ca", "--file", str(rec), "--no-plots",
           "--timing"]
    text, sec, rss = _cli(run + ["--out", str(tmp / "d")])
    trk = checkpoint.load_tracking(tmp / "d" / "trkResults.npz", cfg)
    missing = {sv.prn for sv in scn.svs} - set(trk.prns)
    if missing:
        raise AssertionError(f"[full-cli] SVs not acquired: {missing}\n"
                             f"{text}")
    worst = _block_tails_locked("full-cli", trk, 500)
    nav = np.load(tmp / "d" / "navResults.npz")
    err = _fix_errors(scn, nav["X"], nav["Y"], nav["Z"])
    log(f"[full-cli] run on {card}: {len(trk.prns)} channels (PRN "
        f"{trk.prns}) x {trk.i_p.shape[1]} epochs, every one locked "
        f"(lowest mean|I_P|/std(Q_P) over the last 500 epochs "
        f"{worst:.1f}); {len(err)} fixes, 3-D error mean {err.mean():.2f} "
        f"m, max {err.max():.2f} m with the preset's troposphere "
        f"correction; {sec:.1f} s for the process, peak resident "
        f"{rss:.0f} MB")
    for line in text.splitlines():
        if line.startswith(("Stage", "acquisition ", "tracking ",
                            "navigation ", "TOTAL")):
            log(f"[full-cli]   {line}")
    _hold_fixes("[full-cli]", "test_e2e_l1ca", err, FULL_FIXES, 15.0, 50.0)
    text, resume_s, resume_rss = _cli(
        run + ["--out", str(tmp / "e"), "--skip-acquisition",
               str(tmp / "d" / "acqResults.npz")])
    differ = _npz_differ(tmp / "d" / "trkResults.npz",
                         tmp / "e" / "trkResults.npz")
    if "acquisition reused" not in text or differ:
        raise AssertionError(f"[full-cli] resumed run: fields {differ} "
                             f"differ\n{text}")
    log(f"[full-cli] run --skip-acquisition on {card}: trkResults.npz "
        f"equal in every field and element; {resume_s:.1f} s for the "
        f"process, peak resident {resume_rss:.0f} MB")


def full_size_path(card: str):
    """Phase 20: the gps_l1ca main path at the preset's own size.
    (a) ``full_scene`` synthesized on the card (``card_record``) and
    written to a file; (b) ``_full_cli``; (c) ``Receiver(cfg).run`` on the
    int8 record in this process with the troposphere correction off (the
    scene models none): every SV acquired, every channel locked, one
    superblock-kernel launch per superblock, fixes within the bounds; then
    the record x 64 as int16 (data_type "int16"): channels, states, block
    sizes and fixes equal, sums 64 times; (d) the flat time-parallel bank
    at ``FULL_FLAT_BLOCKS`` through ``Receiver.run`` and the per-block
    path at ``FULL_STAGED_BLOCKS``: each block's tail locked, prompt signs
    as (c)'s, fixes within the bounds, one launch per pass.  Returns the
    launches of (c)'s int8 and int16 runs, {blocks: flat launches}, the
    per-block runs' staged launches and (c)'s (config, int8 record,
    channels)."""
    import dataclasses
    import tempfile
    import types
    import numpy as np
    import torch
    from cusdr_tpu_torch.ops.correlator import (LAUNCHES, cluster_size,
                                                reset_launches)
    from cusdr_tpu_torch.parallel.timeblocks import track_time_parallel
    from cusdr_tpu_torch.receiver import Receiver, nav_solve
    from cusdr_tpu_torch.signals.defs import get_signal
    t_phase = time.perf_counter()
    preset, scn = full_scene()
    sig = get_signal("gps_l1ca")
    t0 = time.perf_counter()
    iq8 = card_record(preset, sig, scn.svs, FULL_RECORD_MS, FULL_SEED)
    made_s = time.perf_counter() - t0
    n_samp = len(iq8) // 2
    log(f"[full] scene: {FULL_SVS} SVs (PRN "
        f"{[sv.prn for sv in scn.svs]}) at {FULL_CN0:g} dB-Hz, "
        f"{n_samp} samples at {preset.sampling_freq / 1e6:g} Msps "
        f"({len(iq8)} int8 elements, past 2^31 from sample "
        f"{2 ** 30}), synthesized on the card in {made_s:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        rec = tmp / "gps_l1ca_60s.bin"
        t0 = time.perf_counter()
        iq8.tofile(rec)
        log(f"[full] {rec.stat().st_size} bytes written in "
            f"{time.perf_counter() - t0:.1f} s")
        _full_cli(card, preset, scn, rec, tmp)

    # (c) in this process, sequential
    cfg = preset.replace(use_trop_corr=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    seq = Receiver(cfg).run(iq8)
    n_ep = seq.track.i_p.shape[1]
    n_sb = _superblocks(cfg, n_ep)
    _only("full", dict(LAUNCHES), "track_superblock", n_sb, fine=1)
    launches = LAUNCHES["track_superblock"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    acq_err = _check_acquired(cfg, [
        dataclasses.replace(sv, code_phase=_first_code_start(cfg, sig, sv))
        for sv in scn.svs], seq.channels)
    worst = _block_tails_locked("full", seq.track, 500)
    _check_fixes("full", card, scn, seq, "test_e2e_l1ca", FULL_FIXES, 15.0,
                 50.0)
    tm = seq.timings
    total = sum(tm.values())
    rec_s = n_samp / cfg.sampling_freq
    log(f"[full] Receiver.run on {card}: {len(seq.channels)} channels x "
        f"{n_ep} epochs; acquisition {tm['acquisition_s']:.3f} s (carrier "
        f"at most {np.abs(acq_err).max():.1f} Hz off), tracking "
        f"{tm['tracking_s']:.3f} s = {n_ep * 1e-3 / tm['tracking_s']:.3f}x "
        f"real time, navigation {tm['navigation_s']:.3f} s; end to end "
        f"{total:.3f} s = {rec_s / total:.3f}x real time; {n_sb} "
        f"track_superblock launches (one per superblock); lowest "
        f"mean|I_P|/std(Q_P) over the last 500 epochs {worst:.1f}; card "
        f"peak {peak:.0f} MiB allocated")

    iq16 = np.multiply(iq8, INT16_SCALE, dtype=np.int16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res16 = Receiver(cfg.replace(data_type="int16")).run(iq16)
    del iq16
    _only("full-int16", dict(LAUNCHES), "track_superblock[int16]", n_sb,
          fine=1)
    launches16 = LAUNCHES["track_superblock[int16]"]
    peak16 = torch.cuda.max_memory_allocated() / 2 ** 20
    if res16.channels != seq.channels:
        raise AssertionError(f"[full-int16] acquired {res16.channels}, "
                             f"the int8 record {seq.channels}")
    _int16_differs("full-int16", res16.track, seq.track)
    nav_differ = [f for f in ("X", "Y", "Z", "dt", "curr_meas_sample")
                  if not np.array_equal(getattr(res16.nav, f),
                                        getattr(seq.nav, f))]
    if nav_differ:
        raise AssertionError(f"[full-int16] fixes differ in {nav_differ}")
    tm16 = res16.timings
    log(f"[full-int16] Receiver.run on {card}, the record x {INT16_SCALE} "
        f"as int16: channels, states, block sizes and {len(seq.nav.X)} "
        f"fixes equal to the int8 run's, sums {INT16_SCALE} times, 0 "
        f"elements differ; tracking {tm16['tracking_s']:.3f} s = "
        f"{n_ep * 1e-3 / tm16['tracking_s']:.3f}x real time (int8 "
        f"{n_ep * 1e-3 / tm['tracking_s']:.3f}x); {n_sb} "
        f"track_superblock[int16] launches; card peak {peak16:.0f} MiB")

    # (d) time-parallel
    passes = cfg.handoff_iters + 1
    n_ch = len(seq.channels)
    flat, classes = {}, set()
    for n_blocks in FULL_FLAT_BLOCKS:
        tag = f"full-tb{n_blocks}"
        cluster = cluster_size(n_blocks * n_ch)
        classes.add(cluster)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        res = Receiver(cfg.replace(time_blocks=n_blocks)).run(iq8)
        _only(tag, dict(LAUNCHES), "track_superblock", passes, fine=1)
        flat[n_blocks] = LAUNCHES["track_superblock"]
        _time_parallel_full(card, tag, scn, res, seq,
                            f"flat bank of {n_blocks * n_ch} rows, a "
                            f"cluster of {cluster}", passes)
        log(f"[{tag}] card peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB")
    if classes != {1, 2, 4, 8}:
        raise AssertionError(f"[full] the flat banks ran clusters of "
                             f"{sorted(classes)}, not one of each class")
    spc = cfg.samples_per_code
    max_phase = max(ch[2] for ch in seq.channels)
    staged = 0
    for n_blocks in FULL_STAGED_BLOCKS:
        tag = f"full-blocks{n_blocks}"
        tb = cfg.replace(time_blocks=n_blocks)
        n_tp = (n_samp - max_phase - 2 * spc) // spc // n_blocks * n_blocks
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        trk = track_time_parallel(tb, sig, iq8, seq.channels, n_tp,
                                  n_blocks, device="cuda",
                                  fetch_in_kernel=False)
        trk_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        nav = nav_solve(tb, sig, trk)
        nav_s = time.perf_counter() - t0
        _only(tag, dict(LAUNCHES), "track_superblock_staged", passes)
        staged += LAUNCHES["track_superblock_staged"]
        res = types.SimpleNamespace(
            channels=seq.channels, track=trk, nav=nav,
            timings=dict(tracking_s=trk_s, navigation_s=nav_s))
        _time_parallel_full(card, tag, scn, res, seq,
                            f"per-block path, {n_blocks * n_ch} rows, "
                            f"staged windows", passes)
    log(f"[full] phase 20 in {time.perf_counter() - t_phase:.1f} s")
    return launches, launches16, flat, staged, (cfg, iq8, seq.channels)


def _time_parallel_full(card, tag, scn, res, seq, what, passes):
    """Phase 20 (d), one run: every block's tail locked, prompt signs as
    the sequential run ``seq``'s, fixes within the bounds."""
    trk = res.track
    n_ep = trk.i_p.shape[1]
    worst = _block_tails_locked(tag, trk, 200)
    share = _signs_as_sequential(tag, trk, seq.track)
    _check_fixes(tag, card, scn, res, "test_e2e_l1ca", FULL_FIXES, 15.0,
                 50.0)
    log(f"[{tag}] {what} on {card}: {trk.n_blocks} blocks x "
        f"{trk.epochs_per_block} epochs x {passes} passes in "
        f"{res.timings['tracking_s']:.3f} s = "
        f"{n_ep * 1e-3 / res.timings['tracking_s']:.3f}x real time; lowest "
        f"block-tail mean|I_P|/std(Q_P) {worst:.1f}; lowest per-block sign "
        f"agreement with the sequential run {share:.4f}")


# phase 21: the loops in turns on each record, and the superblock length
# of the run that shakes out the staging ring's reuse (400 superblocks of
# phase 4's record)
PIPE_TURNS = ("sync", "pipelined", "pipelined", "sync")
PIPE_SHORT_MS = 10


def sync_track(cfg, sig, samples_iq, channels, device, n_epochs=None):
    """Phase 21's yardstick: ``engine.track`` with the lock gate off, as a
    synchronous loop.  The same window plan (``engine.superblock_windows``)
    and, per superblock, a fresh buffer (``engine.stage_superblock``)
    copied to the card by a blocking ``.to(device)``, one
    ``engine.track_superblock`` call and a synchronisation before its
    outputs are read.  Returns a TrackResults."""
    import numpy as np
    import torch
    from cusdr_tpu_torch.runtime.profiling import span
    from cusdr_tpu_torch.tracking import engine
    device = torch.device(device)
    params = engine.make_track_params(cfg, sig)
    samples_iq = np.ascontiguousarray(samples_iq)
    spc = cfg.samples_per_code
    total = len(samples_iq) // 2
    max_phase = max(ch[2] for ch in channels)
    if n_epochs is None:
        n_epochs = int((total - max_phase - 2 * spc) // spc)
    dops = engine.code_dopplers(cfg, sig, channels)
    ctabs, ptabs = engine.build_tables(cfg, sig, params, channels, dops)
    tables = torch.from_numpy(ctabs).to(device)
    ptables = None if ptabs is None else torch.from_numpy(ptabs).to(device)
    state = engine.init_channel_state(channels, sig.chip_rate_hz, device,
                                      dopplers=dops,
                                      carrier_freq_hz=sig.carrier_freq_hz)
    chunks = []
    for cur, sb_start, buf_len in engine.superblock_windows(
            n_epochs, min(n_epochs, engine.superblock_epochs(cfg, sig)),
            spc, min(ch[2] for ch in channels), max_phase, params.blk):
        iq = torch.from_numpy(engine.stage_superblock(
            samples_iq, sb_start, buf_len)).to(device)
        with span("trk.launch"):
            state, outs = engine.track_superblock(
                iq, sb_start, tables, ptables, state, params, cur, total)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        chunks.append([x.cpu().numpy() for x in outs])
    with span("trk.results"):
        merged = {name: np.concatenate([c[i] for c in chunks], axis=0).T
                  for i, name in enumerate(engine.TrackOutputs._fields)}
        return engine.TrackResults([ch[0] for ch in channels], merged, cfg)


def _profiled_track(loop):
    """One run of ``loop`` (``track`` or ``sync_track`` on the card) in
    the "tracking" stage of a ``StageTimer`` under a ``torch.profiler``
    session of CPU activity, so that the spans add to the stage.  Returns
    (its result, dict of ``seconds`` (the stage's host seconds),
    ``results_s`` (the ``trk.results`` span's: the merge and
    ``TrackResults``) and ``superblocks`` (``trk.launch``'s calls))."""
    from torch.profiler import ProfilerActivity, profile
    from cusdr_tpu_torch.runtime.profiling import StageTimer
    timer = StageTimer(device="cuda")
    with profile(activities=[ProfilerActivity.CPU]):
        with timer.stage("tracking"):
            res = loop()
    rec = timer.stages["tracking"]
    return res, dict(seconds=rec.seconds,
                     results_s=rec.spans["trk.results"].seconds,
                     superblocks=rec.spans["trk.launch"].calls)


def pipeline_path(card: str, made, seq_res, full):
    """Phase 21: ``Receiver.track`` (``engine.track``'s pipelined loop)
    against ``sync_track`` with the lock gate off, on phase 4's record,
    phase 20's 60 s record as int8 and as int16 x 64, and phase 4's record
    at ``superblock_ms`` = ``PIPE_SHORT_MS`` (400 superblocks, the ring's
    two slots reused 200 times each): the loops run in turns
    (``PIPE_TURNS``), every field of every run equal, element for element,
    to the first synchronous run's.  Prints each run's tracking seconds,
    real-time factor and host milliseconds per superblock; returns {case:
    {loop: [per-turn numbers]}}."""
    import numpy as np
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.receiver import Receiver
    from cusdr_tpu_torch.signals.defs import get_signal
    t_phase = time.perf_counter()
    main = get_config("gps_l1ca").replace(lock_detect=False)
    full_cfg, iq8, full_channels = full
    full_cfg = full_cfg.replace(lock_detect=False)
    cases = (("main", main, made[1], seq_res.channels),
             (f"main-{PIPE_SHORT_MS}ms",
              main.replace(superblock_ms=PIPE_SHORT_MS), made[1],
              seq_res.channels),
             ("full", full_cfg, iq8, full_channels),
             ("full-int16", full_cfg.replace(data_type="int16"), None,
              full_channels))
    out = {}
    for tag, cfg, iq, channels in cases:
        if iq is None:
            iq = np.multiply(iq8, INT16_SCALE, dtype=np.int16)
        sig = get_signal(cfg.signal)
        rx = Receiver(cfg, "cuda")
        loops = dict(
            sync=lambda: sync_track(cfg, sig, iq, channels, "cuda"),
            pipelined=lambda: rx.track(iq, channels))
        want, rows = None, {"sync": [], "pipelined": []}
        for loop in PIPE_TURNS:
            res, run = _profiled_track(loops[loop])
            if want is None:
                want = res
            n_diff, _, worst, beyond = _compare_tracks(res, want)
            if n_diff:
                raise AssertionError(
                    f"[pipeline-{tag}] the {loop} loop differs from the "
                    f"synchronous one in {n_diff} elements: {worst}, "
                    f"{beyond}")
            n_ep, sec, n_sb = (res.i_p.shape[1], run["seconds"],
                               run["superblocks"])
            rows[loop].append(dict(
                run, realtime=n_ep * sig.code_period_ms * 1e-3 / sec,
                host_ms_per_superblock=sec * 1e3 / n_sb,
                loop_ms_per_superblock=(sec - run["results_s"]) * 1e3
                / n_sb))
        out[tag] = rows
        del iq, loops

        def fmt(loop, key, spec):
            return " / ".join(format(r[key], spec) for r in rows[loop])

        log(f"[pipeline-{tag}] on {card}: {len(channels)} channels x "
            f"{n_ep} epochs in {n_sb} superblocks; the pipelined loop equal "
            f"to the synchronous one in every field, element for element "
            f"({len(PIPE_TURNS)} runs in turns: {', '.join(PIPE_TURNS)}); "
            f"tracking s sync {fmt('sync', 'seconds', '.3f')}, pipelined "
            f"{fmt('pipelined', 'seconds', '.3f')}; real time sync "
            f"{fmt('sync', 'realtime', '.2f')}x, pipelined "
            f"{fmt('pipelined', 'realtime', '.2f')}x; host ms per "
            f"superblock sync {fmt('sync', 'host_ms_per_superblock', '.3f')}"
            f", pipelined "
            f"{fmt('pipelined', 'host_ms_per_superblock', '.3f')}, of "
            f"which the loop (less TrackResults: sync "
            f"{fmt('sync', 'results_s', '.3f')}, pipelined "
            f"{fmt('pipelined', 'results_s', '.3f')} s) sync "
            f"{fmt('sync', 'loop_ms_per_superblock', '.3f')}, pipelined "
            f"{fmt('pipelined', 'loop_ms_per_superblock', '.3f')}")
    log(f"[pipeline] phase 21 in {time.perf_counter() - t_phase:.1f} s")
    return out


def _kernel_json(name, launches, checks):
    """One kernel's entry of the JSON line: ``ms`` / ``plain_ms`` /
    ``bound_ms`` at the first shape listed for it (its path's, the preset's
    tap mode), every shape and tap mode under ``shapes``."""
    first = checks[0]["rows"][True]
    profiler, events = ("torch.profiler device time",
                        "CUDA events per wrapper call")
    ms, plain_ms = first["device_ms"], first["plain_device_ms"]
    if "events_ms" in first:
        # the ramp kernel: both by CUDA events over back-to-back launches
        ms, plain_ms = first["events_ms"], first["plain_events_ms"]
        ms_from = ("CUDA events over back-to-back launches in a CUDA "
                   "graph, the plan's cluster size (ragged rows); plain_ms "
                   "the same way")
    elif "cluster" in first:
        # the superblock kernel is timed with CUDA events (a trace of
        # launches this few can come back empty); the eager loop by its
        # trace, or by its wall time where that held no device time
        plain_from = profiler
        if plain_ms is None:
            plain_ms, plain_from = first["plain_wrapper_ms"], events
        ms_from = ("CUDA events over back-to-back launches; plain_ms: "
                   + plain_from)
    elif ms is not None and plain_ms is not None:
        ms_from = profiler
    else:
        # a trace held no device time: wall time per wrapper call for both
        ms, plain_ms, ms_from = (first["wrapper_ms"],
                                 first["plain_wrapper_ms"], events)
    shapes = [dict(shape=(f"{c['label']}: {c['n_ch']} x {c['blk']}, "
                          f"k={c['k']}, interp_taps={interp}"),
                   max_abs_err=r["err"], tol=r["tol"],
                   ms=r["device_ms"], plain_ms=r["plain_device_ms"],
                   wrapper_ms=r["wrapper_ms"],
                   plain_wrapper_ms=r["plain_wrapper_ms"],
                   bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                   bytes=r["bytes"], operations=r["ops"],
                   # phases 3e, 3f: blocks per row, elements that differ
                   # from the eager loop's, and both with one block per
                   # row; 3f: slow-path epochs and the fetch superblock
                   # kernel's time on the same bank
                   **{key: r[key] for key in (
                       "cluster", "n_diff", "n_diff_one_block",
                       "device_ms_one_block", "slow_epochs",
                       "slow_epochs_one_block", "fetch_ms",
                       "fetch_ms_one_block", "ramp_cluster", "events_ms",
                       "events_ms_repeats", "plain_events_ms", "floor_ms",
                       "windows_ms", "ragged_bound_ms", "ragged_bound_by",
                       "ragged_bytes", "ragged_ops", "ragged_max_abs_err",
                       "ragged_tol", "ramp_plan", "layout_ms",
                       "carrier_max_abs_err", "carrier_samples")
                      if key in r})
              for c in checks for interp, r in c["rows"].items()]
    source, replaces, _ = KERNELS[name]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(max(s["max_abs_err"],
                               s.get("ragged_max_abs_err", 0.0))
                           for s in shapes),
        "ms": ms, "plain_ms": plain_ms,
        # the ramp's ms are taken on phase 3c's ragged rows: so its bound
        "bound_ms": first.get("ragged_bound_ms", first["bound_ms"]),
        "bound_by": first.get("ragged_bound_by", first["bound_by"]),
        # no single PyTorch call computes these sums
        "library_ms": None,
        "ms_from": ms_from,
        "wrapper_ms": first["wrapper_ms"],
        "plain_wrapper_ms": first["plain_wrapper_ms"],
        "shapes": shapes}


def _fine_json(launches, shapes):
    """F1's entry of the JSON line: ``ms`` / ``plain_ms`` / ``bound_ms``
    at the first of FINE_SHAPES, every shape under ``shapes``."""
    first = shapes[0]
    return {
        "name": "fine_search", "route": "cuda", "source": _CSRC + "fine.cu",
        # the reference's fine stage is left to XLA: no Pallas kernel
        "replaces": None, "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": first["ms"], "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
        "library_ms": None,
        "ms_from": ("CUDA events over back-to-back launches; plain_ms the "
                    "same way"),
        "shapes": shapes}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    if not (ROOT / "cusdr_tpu_torch" / "ops" / "csrc").is_dir():
        print(f"chip_smoke: no cusdr_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    # the scenes of phases 3e-19 (up to a few minutes of numpy each) are
    # made in worker processes, one each, while phases 1-3c run; all are
    # finished before phase 3e, so no scene work overlaps a receiver run
    jobs = dict(pvt=(pvt_scene_job,), l5=(l5_scene_job,),
                b1i_pvt=(b1i_scene_job,), main=(scene_job, *MAIN_SCENE),
                b1c_gather=(scene_job, *B1C_GATHER_SCENE),
                e5a=(scene_job, *E5A_SCENE), b1c=(scene_job, *B1C_SCENE),
                glo_l1=(scene_job, *GLO_L1_SCENE),
                l2c_preset=(l2c_preset_scene_job,),
                glo_l2=(scene_job, *GLO_L2_SCENE), l2c=(l2c_scene_job,),
                **{preset: (scene_job, preset, {}, prns, sec, cn0)
                   for preset, prns, sec, cn0, _, _ in PRESET_SCENES})
    pool = ProcessPoolExecutor(
        max_workers=len(jobs),
        mp_context=multiprocessing.get_context("spawn"))
    try:
        jobs = {name: pool.submit(*job) for name, job in jobs.items()}
        smi = environment()
        build()
        checks = {}
        for shape in SHAPES:
            checks.setdefault(shape[0], []).append(kernel_check(*shape))
        for c in checks["correlate_windows_ramp"]:
            c["rows"][True].update(ramp_layout(c["label"], c["n_ch"],
                                               c["blk"], c["k"]))
        fine = fine_check(smi)
        t0 = time.perf_counter()
        scenes = {name: job.result() for name, job in jobs.items()}
        log(f"[scenes] waited {time.perf_counter() - t0:.1f} s for the "
            "scenes of phases 3e-19")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    # host-bound measurements run with no scene work beside them
    tool = perf_tool(smi)
    launches = {r["name"]: r["loop_launches"] for r in tool}
    checks.update(superblock_checks(scenes))
    checks.update(superblock_checks(scenes, staged=True))
    from cusdr_tpu_torch import get_config
    b1c_cfg = get_config("bds_b1c", **B1C_WB)
    launches["track_superblock"], seq_res = main_path(smi, scenes["main"])
    # acquisition's fine search in the main path's run (counts reset just
    # before it; run_path held it to one launch)
    from cusdr_tpu_torch.ops.correlator import LAUNCHES
    launches["fine_search"] = LAUNCHES["fine_search"]
    launches["correlate_bank"] = eager_track(
        smi, "main", get_config("gps_l1ca"), scenes["main"], seq_res,
        "correlate_bank", 1000)
    pvt(smi, scenes["pvt"])
    launches["track_superblock_pilot"], e5a_res = pilot_path(
        smi, scenes["e5a"])
    launches["correlate_bank_pilot"] = eager_track(
        smi, "e5a", get_config("gal_e5a"), scenes["e5a"], e5a_res,
        "correlate_bank_pilot", 1000)
    launches["track_superblock_dual_pilot"], b1c_res = dual_pilot_path(
        smi, scenes["b1c"])
    launches["correlate_bank_dual_pilot"] = eager_track(
        smi, "b1c-wb", b1c_cfg, scenes["b1c"], b1c_res,
        "correlate_bank_dual_pilot", 100)
    pvt_pilot(smi, scenes["l5"])
    (tp_bank, launches["track_superblock_staged"],
     launches["correlate_windows"], tp_rt) = time_parallel_path(
        smi, scenes["main"], seq_res)
    (launches["track_superblock_staged_pilot"],
     launches["correlate_windows_pilot"]) = staged_pilot_path(
        smi, "e5a-blocks", get_config("gal_e5a"), scenes["e5a"], e5a_res,
        "track_superblock_staged_pilot", epb=500, tail=200)
    (launches["track_superblock_staged_dual_pilot"],
     launches["correlate_windows_dual_pilot"]) = staged_pilot_path(
        smi, "b1c-wb-blocks", b1c_cfg, scenes["b1c"], b1c_res,
        "track_superblock_staged_dual_pilot", epb=100, tail=50)
    pvt_time_parallel(smi, scenes["pvt"])
    l2c_launches = l2c_path(smi, scenes["l2c_preset"])
    glo_launches = glonass_path(smi, scenes["glo_l1"], scenes["glo_l2"])
    launches.update(int16_path(smi, scenes["main"], seq_res))
    multi_launches = multi_signal_path(smi, scenes)
    gather = gather_path(smi, scenes["b1c_gather"])
    cli_path(smi, scenes)
    mesh_step, mesh_tb = mesh_path(smi, scenes["main"], tp_rt)
    preset_launches = preset_paths(smi, scenes)
    b1i_launches = pvt_b1i(smi, scenes["b1i_pvt"])
    full_seq, full_int16, full_flat, full_staged, full = full_size_path(
        smi)
    pipeline = pipeline_path(smi, scenes["main"], seq_res, full)
    del full
    missing = [name for name in checks if not launches.get(name)]
    if missing:
        raise AssertionError(f"kernels never launched on their path: "
                             f"{missing}")
    log(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    kernels = [_kernel_json(name, launches[name], checks[name])
               for name in checks]
    kernels.append(_fine_json(launches["fine_search"], fine))
    for entry in kernels:
        if entry["name"] == "track_superblock":
            # the same kernel on the other presets' paths
            entry["launches_time_parallel"] = tp_bank
            entry["launches_gps_l2c"] = l2c_launches
            entry["launches_glo_l1"] = glo_launches[0]
            entry["launches_glo_l2_time_parallel"] = glo_launches[1]
            # phase 17: time blocks over a 1x2 mesh of the card (shards x
            # passes), and the sharded tracking step (one per shard)
            entry["launches_mesh"] = mesh_tb
            entry["launches_mesh_step"] = mesh_step
            # phase 19: the B1I PVT scene
            entry["launches_bds_b1i_pvt"] = b1i_launches
            # phase 20: the 60 s record in this process, sequential, and
            # the flat bank by time blocks (passes)
            entry["launches_full_size"] = full_seq
            entry["launches_full_size_flat"] = {
                str(b): n for b, n in full_flat.items()}
        elif entry["name"] == "track_superblock[int16]":
            entry["launches_full_size"] = full_int16
        elif entry["name"] == "track_superblock_staged":
            entry["launches_glo_l2_per_block"] = glo_launches[2]
            # phase 20: the per-block runs of the 60 s record
            entry["launches_full_size_per_block"] = full_staged
        for preset, _, _, _, variant, _ in PRESET_SCENES:
            if entry["name"] == variant:
                # phase 18: the preset as shipped
                entry[f"launches_{preset}"] = preset_launches[preset]
        if entry["name"] in multi_launches[0]:
            # phase 14: the bank's launches in track_multi and run_multi
            entry["launches_track_multi"] = multi_launches[0][entry["name"]]
            entry["launches_run_multi"] = multi_launches[1][entry["name"]]
    print(json.dumps({"perf_correlator": tool, "gather_path": gather,
                      "multi_stream_spans_ms": multi_launches[2],
                      "pipeline": pipeline}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
