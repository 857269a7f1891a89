"""cusdr_tpu_torch — the GNSS receiver ported to PyTorch and CUDA.

The PyTorch counterpart of ``cusdr_tpu`` (the JAX reference, which stays
as it is).  It imports ``torch`` and never ``jax`` or the reference
package: the numpy layers (config, constants, signals, io, nav, orbits,
pvt, geodesy, plotting and the native ingest loader of runtime) are its own
copies of the reference's; tracking (sequential and time-parallel, the
fast sliced-replica path and, for a correlator spacing under half a
sample, the per-epoch gather path), acquisition (CDMA, FDMA and the
circular-shift search with the L2C CL period search), the receiver
pipeline, concurrent multi-signal tracking (``tracking.multi``,
``receiver.run_multi``) and the CLI with its outputs (``checkpoint``: the
reference's .npz checkpoints and resume; plots; ``runtime.profiling``'s
stage timer and device trace) are ported for all twelve presets at any
rate, on int8 or int16 records; everything the reference does on one
device.  The correlators are CUDA kernels in four sources,
``ops/csrc/superblock.cu`` (one launch tracks a channel bank through a
superblock of epochs), ``ops/csrc/superblock_staged.cu`` (the same with
each epoch's windows staged into shared memory),
``ops/csrc/correlator.cu`` (one epoch, windows fetched in the kernel) and
``ops/csrc/correlator_staged.cu`` (one epoch, staged windows).

The entry points (``Receiver``, ``run_multi``, ``track_multi``, ``python
-m cusdr_tpu_torch run`` and ``run-multi``) run on the card unless the
caller names another device; ``"cuda"`` without a card raises, and nothing
falls back to the CPU.
"""

__version__ = "0.1.0"

import torch as _torch

from .config import PRESETS, ReceiverConfig, get_config  # noqa: F401


def resolve_device(device) -> _torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    CUDA device is present (the port never falls back to the CPU)."""
    dev = _torch.device(device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is False")
    return dev
