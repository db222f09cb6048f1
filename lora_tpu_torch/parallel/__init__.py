"""Multi-device scale-out: the mesh, channel sharding, time sharding.

Channel-parallel decoding over a mesh of shards, overlap-save time
sharding of one long stream with a halo from the right neighbour, and
the two wideband forms: time sharding of a capture (each shard
channelizes its own block) and subband sharding (a coarse filterbank per
time shard, one band exchange, a fine filterbank per band). A mesh's
shards live in this process (any list of devices, a device may repeat)
or one a rank of a ``torch.distributed`` process group.
"""

from .sharding import (  # noqa: F401
    Mesh,
    make_mesh,
    channel_sharded_process,
    time_sharded_process,
    wideband_time_sharded_process,
    wideband_subband_sharded_process,
    subband_channel_freq,
)
