"""cusdr_tpu_torch — the GNSS receiver ported to PyTorch and CUDA.

The PyTorch counterpart of ``cusdr_tpu`` (the JAX reference, which stays
as it is).  It imports ``torch`` and never ``jax`` or the reference
package: the numpy layers (config, constants, signals, io, nav, orbits,
pvt, geodesy and the native ingest loader of runtime) are its own verbatim
copies of the reference's; tracking (sequential and time-parallel),
acquisition and the receiver pipeline are ported; the epoch correlators are
CUDA kernels in two sources, ``ops/csrc/correlator.cu`` (windows fetched
in the kernel) and ``ops/csrc/correlator_staged.cu`` (staged windows).

Every entry point takes an explicit ``device``; nothing picks one for the
caller.
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
