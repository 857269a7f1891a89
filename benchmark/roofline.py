"""The least time an H100 could take for the superblock kernel's work on a
record, from the record's shapes: the larger of the bytes the work must
move over the card's memory rate and its float32 operations over the
card's float32 peak (NVIDIA's H100 SXM data sheet: 3.35 TB/s of HBM3, 67
TFLOP/s of float32 outside the tensor cores, at a 700 W power limit).

Copied from chip_smoke.py's ``superblock_bound``, less its term of 4
operations per carrier factor (``4 * ((blk + 127) // 128 + 128)`` per
epoch): that term counts the u.v factorisation of the carrier in one
implementation of the kernel, not work the receiver needs.

Bytes, each input read once and each output written once: 2 per I/Q
sample of the record that the windows cover (4 for int16), the replica
tables once, the loop state in and out (12 f64, an int64, an int32 and a
flag per row, and the record's end) and 96 per row and epoch of outputs
(12 f32, 4 f64, 2 int64).  Operations per valid sample of every row: 6 to
make the carrier, 6 to wipe it off, and per replica bank (data, and each
pilot) 12 for the six products and sums and 9 for three interpolated taps;
and about 150 per valid epoch for the window geometry, discriminators and
loop filters."""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
UP_MARGIN = 1024


def superblock_work(*, rows: int, epochs: int, valid_epochs: int,
                    valid_samples: int, span: int, blk: int, pilots: int,
                    interp: bool = True, sample_bytes: int = 2):
    """(bytes, operations) of tracking ``rows`` channels through ``epochs``
    epochs of which ``valid_epochs`` (row-epochs) hold ``valid_samples``
    samples, the windows covering ``span`` samples of the record, on
    replica tables of blk + 2 * UP_MARGIN samples per bank."""
    banks = 1 + pilots
    table_bytes = rows * banks * (blk + 2 * UP_MARGIN)
    n_bytes = (sample_bytes * span + table_bytes + rows * (2 * 109 + 8)
               + epochs * rows * 96)
    ops = (valid_samples * (12 + banks * (12 + (9 if interp else 0)))
           + valid_epochs * 150)
    return n_bytes, ops


def bound_s(n_bytes: float, ops: float):
    """(seconds, "bytes" or "operations"): the least time and what sets
    it."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
