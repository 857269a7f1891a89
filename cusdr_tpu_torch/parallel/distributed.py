"""Multi-process runtime on ``torch.distributed``.

Counterpart of cusdr_tpu/parallel/distributed.py.  Every process runs the
same program; ``init_distributed`` joins them into one gloo process group,
and ``make_mesh_2d`` builds a (ch x tb) mesh over every process's devices:
'ch' across processes (channel-bank tracking needs no collective between
channels, so only the joined results cross) and 'tb' over each process's
own devices (the time blocks' ring handoff).  Each process builds only its
own shards' inputs from the record it holds (owner computes), so IF sample
blocks never cross processes.

What crosses processes is small: the [B, C] loop states of the ring
handoff and the [B, E, C] outputs for the stitch.  It goes over gloo as
host tensors (parallel/mesh.py ``gather_shards``), which also lets several
processes share one card; NCCL would keep it on the cards, but refuses
two ranks on one card.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from .mesh import Mesh

# the devices this process owns, as init_distributed was given them (the
# process group itself is torch.distributed's own process-wide state)
_LOCAL_DEVICE_IDS: Optional[list] = None


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids: Optional[Sequence[int]] = None
                     ) -> None:
    """Join this process into a gloo process group of ``num_processes``.

    Arguments default to the CUSDR_COORDINATOR ("host:port") /
    CUSDR_NUM_PROCS / CUSDR_PROC_ID environment variables; all three are
    needed.  ``local_device_ids`` names the devices this process owns
    (card indices; for a mesh of ``"cpu"`` entries, one entry each), by
    default every card it sees, or one host entry.  Call once per process,
    before building a mesh."""
    import torch.distributed as dist
    global _LOCAL_DEVICE_IDS
    addr = coordinator_address or os.environ.get("CUSDR_COORDINATOR")
    n = num_processes if num_processes is not None else \
        os.environ.get("CUSDR_NUM_PROCS")
    pid = process_id if process_id is not None else \
        os.environ.get("CUSDR_PROC_ID")
    if addr is None or n is None or pid is None:
        raise ValueError("init_distributed needs the coordinator address, "
                         "the number of processes and this process's id "
                         "(arguments or CUSDR_COORDINATOR, CUSDR_NUM_PROCS, "
                         "CUSDR_PROC_ID)")
    dist.init_process_group("gloo", init_method=f"tcp://{addr}",
                            world_size=int(n), rank=int(pid))
    _LOCAL_DEVICE_IDS = (None if local_device_ids is None
                         else [int(i) for i in local_device_ids])


def _local_devices(device) -> list:
    """This process's mesh entries on ``device``'s type."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * len(_LOCAL_DEVICE_IDS or [0])
    ids = (_LOCAL_DEVICE_IDS if _LOCAL_DEVICE_IDS is not None
           else range(torch.cuda.device_count()))
    devs = [torch.device("cuda", i) for i in ids]
    for d in devs:
        if d.index >= torch.cuda.device_count():
            raise ValueError(f"{d} requested, {torch.cuda.device_count()} "
                             "CUDA devices present")
    return devs


def make_mesh_2d(n_ch: Optional[int] = None, n_tb: Optional[int] = None,
                 device="cuda") -> Mesh:
    """A 2-D (ch x tb) mesh over every process's devices, in rank order.

    Default factorization: 'ch' spans the processes, 'tb' each process's
    devices.  Works in one process too (without ``init_distributed``),
    where n_ch defaults to 1.  Each process's devices are gathered with
    ``all_gather_object``; a remote entry names the other process's
    device and is never used here."""
    import torch.distributed as dist
    local = [str(d) for d in _local_devices(device)]
    if dist.is_initialized():
        world, group = dist.get_world_size(), dist.group.WORLD
        every = [None] * world
        dist.all_gather_object(every, local)
    else:
        world, group, every = 1, None, [local]
    devs = [d for ds in every for d in ds]
    ranks = [r for r, ds in enumerate(every) for _ in ds]
    if n_ch is None:
        n_ch = max(world, 1)
    if n_tb is None:
        n_tb = len(devs) // n_ch
    if n_tb < 1:
        raise ValueError(f"n_ch={n_ch} exceeds the {len(devs)} available "
                         f"devices (derived n_tb=0 would build an empty "
                         f"mesh)")
    if n_ch * n_tb > len(devs):
        raise ValueError(f"mesh {n_ch}x{n_tb} needs {n_ch * n_tb} devices, "
                         f"have {len(devs)}")
    n = n_ch * n_tb
    return Mesh(np.asarray(devs[:n], object).reshape(n_ch, n_tb),
                ("ch", "tb"), np.asarray(ranks[:n]).reshape(n_ch, n_tb),
                group if world > 1 else None)
