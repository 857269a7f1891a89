"""Device meshes for channel-bank tracking and PRN-parallel acquisition.

Counterpart of cusdr_tpu/parallel/mesh.py.  The receiver's parallel axes
become mesh axes:

  * channel-bank sharding ('ch'): each shard tracks its own rows of the
    channel bank over a copy of the record; tracking needs no collective
    inside a superblock, and the shards' states and outputs are joined in
    channel order afterwards.
  * PRN sharding in acquisition ('ch'): each shard correlates its own
    PRNs against the Doppler-mixed signal spectrum, which is computed once
    per device and shared.
  * time blocks ('tb', parallel/timeblocks.py): each shard tracks its own
    blocks; block k+1 restarts from block k's final state across shards.

PyTorch tensors carry no sharding, so ``Mesh`` is an explicit table: a
``torch.device`` per entry, shaped by the axes, and the process that owns
each entry.  Entries may repeat a device: n ``"cpu"`` entries stand where
the reference's tests use XLA's virtual host devices, and two ``cuda:0``
entries run two shards on one card.  A shard runs on its entry's device;
what crosses shards (loop states, outputs) is small and is joined on the
mesh's first local device, or all-gathered on the host over the mesh's
gloo process group when the mesh spans processes
(parallel/distributed.py).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..acquisition.pcps import _corr_peak, _mixed_fft
from ..tracking.engine import (ChannelState, TrackOutputs, TrackParams,
                               track_superblock)


class Mesh:
    """A grid of devices with named axes.

    devices: ``torch.device`` (or names) shaped by the axes; ranks: the
    process that owns each entry (default: all this process's); group: the
    ``torch.distributed`` process group the ranks belong to, None within
    one process."""

    def __init__(self, devices, axis_names: Sequence[str], ranks=None,
                 group=None):
        flat = [torch.device(d) for d in np.asarray(devices,
                                                    dtype=object).flat]
        # "cuda" names the current card
        flat = [torch.device("cuda", torch.cuda.current_device())
                if d.type == "cuda" and d.index is None else d for d in flat]
        shape = np.shape(np.asarray(devices, dtype=object))
        self.axis_names = tuple(axis_names)
        if len(shape) != len(self.axis_names):
            raise ValueError(f"devices of shape {shape} for axes "
                             f"{self.axis_names}")
        self.devices = np.empty(len(flat), object)
        self.devices[:] = flat
        self.devices = self.devices.reshape(shape)
        self.ranks = (np.zeros(shape, np.int64) if ranks is None
                      else np.asarray(ranks, np.int64).reshape(shape))
        self.group = group

    def __repr__(self):
        return (f"Mesh({dict(zip(self.axis_names, self.devices.shape))}, "
                f"devices={[str(d) for d in self.devices.flat]}, "
                f"ranks={self.ranks.ravel().tolist()})")

    def axis_size(self, axis: str) -> int:
        """Entries along ``axis``; 1 for an axis the mesh does not have."""
        if axis not in self.axis_names:
            return 1
        return self.devices.shape[self.axis_names.index(axis)]

    @property
    def rank(self) -> int:
        """This process's rank in the mesh's group."""
        if self.group is None:
            return 0
        import torch.distributed as dist
        return dist.get_rank(self.group)

    @property
    def spans_processes(self) -> bool:
        return len(np.unique(self.ranks)) > 1

    @property
    def home(self) -> torch.device:
        """The first entry's device that this process owns: where joined
        states and outputs are returned."""
        mine = self.devices[self.ranks == self.rank]
        if not len(mine):
            raise ValueError(f"rank {self.rank} owns no entry of {self!r}")
        return mine[0]


class Shard(NamedTuple):
    """One shard of a plan: its key (an index per sharded axis), the
    device it runs on and the rank that owns it."""
    key: Tuple[int, ...]
    device: torch.device
    rank: int


def shard_plan(mesh: Mesh, axes: Sequence[str]) -> List[Shard]:
    """One shard per index along ``axes``, in row-major order of the keys;
    the mesh's other axes replicate, and each shard takes the entry at
    index 0 along them."""
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"the mesh has no {a!r} axis: "
                             f"{mesh.axis_names}")
    pos = [mesh.axis_names.index(a) for a in axes]
    plan = []
    for idx in np.ndindex(mesh.devices.shape):
        if any(i for p, i in enumerate(idx) if p not in pos):
            continue
        plan.append(Shard(tuple(idx[p] for p in pos), mesh.devices[idx],
                          int(mesh.ranks[idx])))
    return sorted(plan, key=lambda s: s.key)


def local_shards(mesh: Mesh, plan: List[Shard]) -> List[Shard]:
    """The shards of ``plan`` this process runs."""
    return [s for s in plan if s.rank == mesh.rank]


def check_divides(n: int, mesh: Mesh, axis: str, what: str) -> int:
    """``n`` split over ``axis``: the size of a shard.  Raises a
    ValueError when the axis does not divide ``n`` (before any collective,
    so a bad mesh raises on every rank alike)."""
    k = mesh.axis_size(axis)
    if n % k:
        raise ValueError(f"the {axis!r} axis of size {k} does not divide "
                         f"{n} {what}")
    return n // k


def gather_shards(mesh: Mesh, plan: List[Shard],
                  parts: Dict[tuple, tuple]) -> Dict[tuple, tuple]:
    """Every shard's tensors on every process.

    parts: this process's shards' results, a tuple of tensors per key.
    Within one process that is every shard, returned as it is.  Across
    processes each leaf is all-gathered over the mesh's group as host
    tensors of equal shape (every rank runs as many shards, of equal
    shapes, since the axes divide the work evenly); other ranks' leaves
    come back on the host."""
    if not mesh.spans_processes:
        return parts
    import torch.distributed as dist
    world = dist.get_world_size(mesh.group)
    keys = [[s.key for s in plan if s.rank == r] for r in range(world)]
    if len({len(k) for k in keys}) != 1:
        raise ValueError(f"the ranks run {[len(k) for k in keys]} shards; "
                         "a gather needs as many on every rank")
    mine = keys[mesh.rank]
    out = {k: [] for ks in keys for k in ks}
    for j in range(len(parts[mine[0]])):
        local = torch.stack([parts[k][j].cpu() for k in mine])
        got = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(got, local, group=mesh.group)
        for r in range(world):
            for i, k in enumerate(keys[r]):
                out[k].append(parts[k][j] if r == mesh.rank else got[r][i])
    return {k: tuple(v) for k, v in out.items()}


def join(parts: Dict[tuple, tuple], dims: Sequence[int], device) -> list:
    """Concatenate a grid of shards, leaf by leaf: ``parts`` maps index
    tuples to tuples of tensors; the last key index runs along
    ``dims[-1]``, the one before along ``dims[-2]``.  Returns a new tensor
    per leaf, on ``device``."""
    def level(j, prefix, depth):
        ks = sorted({k[depth] for k in parts if k[:depth] == prefix})
        if depth == len(dims) - 1:
            return torch.cat([parts[prefix + (i,)][j].to(device)
                              for i in ks], dims[depth])
        return torch.cat([level(j, prefix + (i,), depth + 1) for i in ks],
                         dims[depth])
    return [level(j, (), 0) for j in range(len(next(iter(parts.values()))))]


def make_mesh(n_devices: Optional[int] = None, axis: str = "ch",
              device="cuda") -> Mesh:
    """A one-axis mesh of this process's devices.

    device: ``"cuda"`` (n_devices defaults to ``torch.cuda.device_count()``
    and may not exceed it), ``"cpu"`` (n entries of the host, default 1),
    or an explicit sequence of devices (which may repeat one)."""
    if isinstance(device, (list, tuple)):
        devs = [resolve_device(d) for d in device]
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(f"n_devices={n_devices} for {len(devs)} "
                             "devices")
    else:
        dev = resolve_device(device)
        n_have = torch.cuda.device_count() if dev.type == "cuda" else None
        n = n_devices if n_devices is not None else (n_have or 1)
        if dev.type == "cuda":
            devs = [torch.device("cuda", i) for i in range(n)]
        else:
            devs = [dev] * n
    if not devs:
        raise ValueError("a mesh needs at least one device")
    for d in devs:
        if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
            raise ValueError(f"{d} requested, {torch.cuda.device_count()} "
                             "CUDA devices present")
    return Mesh(devs, (axis,))


class ShardedBank(NamedTuple):
    """A channel bank split over a mesh's 'ch' axis: the plan of its
    shards, and this process's, each (shard, state, code_tables,
    pilot_tables) on its device."""
    mesh: Mesh
    plan: List[Shard]
    shards: list


def shard_channel_bank(state: ChannelState, code_tables: torch.Tensor,
                       pilot_tables: Optional[torch.Tensor],
                       mesh: Mesh) -> ShardedBank:
    """Place each local shard's rows of the channel state and of the
    replica tables (one row per channel) on the shard's device."""
    n = state.carr_freq.shape[0]
    c_loc = check_divides(n, mesh, "ch", "channels")
    for t in (code_tables, pilot_tables):
        if t is not None and t.shape[0] != n:
            raise ValueError(f"tables of {t.shape[0]} rows for {n} "
                             "channels")
    plan = shard_plan(mesh, ("ch",))
    shards = []
    for s in local_shards(mesh, plan):
        rows = slice(s.key[0] * c_loc, (s.key[0] + 1) * c_loc)
        shards.append((s, ChannelState(*(x[rows].to(s.device, copy=True)
                                         for x in state)),
                       code_tables[rows].to(s.device, copy=True),
                       None if pilot_tables is None else
                       pilot_tables[rows].to(s.device, copy=True)))
    return ShardedBank(mesh, plan, shards)


def _on_devices(x: torch.Tensor, devices) -> dict:
    """One copy of ``x`` per distinct device (``x`` itself where it
    lies)."""
    return {d: x.to(d) for d in dict.fromkeys(devices)}


def tracking_step_sharded(samples_iq: torch.Tensor, sb_start: int,
                          bank: ShardedBank, params: TrackParams,
                          n_epochs: int):
    """``engine.track_superblock`` with the channel axis sharded: the
    record is copied once to each distinct device, each local shard tracks
    its rows (on a card one launch of the superblock kernel per shard),
    and the states and outputs come back whole, in channel order, on every
    process, on the mesh's first local device.  Returns (ChannelState [C],
    TrackOutputs [n_epochs, C])."""
    mesh = bank.mesh
    recs = _on_devices(samples_iq, [s.device for s, *_ in bank.shards])
    parts = {}
    for s, state, ct, pt in bank.shards:
        st, outs = track_superblock(recs[s.device], sb_start, ct, pt, state,
                                    params, n_epochs)
        parts[s.key] = (*st, *outs)
    parts = gather_shards(mesh, bank.plan, parts)
    n_st = len(ChannelState._fields)
    return (ChannelState(*join({k: v[:n_st] for k, v in parts.items()},
                               (0,), mesh.home)),
            TrackOutputs(*join({k: v[n_st:] for k, v in parts.items()},
                               (1,), mesh.home)))


def pcps_sharded(slabs: torch.Tensor, code_fft_conj: torch.Tensor,
                 weights: torch.Tensor, f_grid: torch.Tensor, ts,
                 n_comp: int, search_len: Optional[int] = None, *,
                 mesh: Mesh):
    """PRN-parallel PCPS: the PRN axis split over 'ch'.

    slabs: complex64 [n_noncoh, nfft]; code_fft_conj: complex64 [n_prn,
    n_comp, nfft]; weights: f32 [n_comp]; f_grid: f32 [n_bins].  The
    Doppler-mixed spectrum (``acquisition.pcps._mixed_fft``) is computed
    once per distinct device and each local shard correlates its PRNs
    (``_corr_peak``).  Returns (peak, bin, phase, second, floor), each
    [n_prn], on every process, on the mesh's first local device."""
    n_loc = check_divides(code_fft_conj.shape[0], mesh, "ch", "PRNs")
    plan = shard_plan(mesh, ("ch",))
    mine = local_shards(mesh, plan)
    devs = [s.device for s in mine]
    mfs = {d: _mixed_fft(slabs.to(d), f_grid.to(d), ts)
           for d in dict.fromkeys(devs)}
    wts = _on_devices(weights, devs)
    parts = {}
    for s in mine:
        cfc = code_fft_conj[s.key[0] * n_loc:(s.key[0] + 1) * n_loc]
        per_prn = [_corr_peak(mfs[s.device], c.to(s.device),
                              wts[s.device], n_comp, search_len)
                   for c in cfc]
        parts[s.key] = tuple(torch.stack(x) for x in zip(*per_prn))
    return tuple(join(gather_shards(mesh, plan, parts), (0,), mesh.home))
