"""Parallel axes of the receiver: device meshes ('ch' for channels and
PRNs, 'tb' for time blocks), the multi-process runtime, and time-block
parallel tracking (``timeblocks.track_time_parallel``)."""

from .mesh import (Mesh, make_mesh, shard_channel_bank,  # noqa: F401
                   pcps_sharded, tracking_step_sharded)
