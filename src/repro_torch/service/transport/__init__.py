"""repro_torch.service.transport — shard stores behind a process/RPC boundary.

The writer seam of the sharded service, made remote (docs/SHARDING.md):

* ``protocol``     — length-prefixed, versioned binary frames covering the
                     full writer-seam op set (put_blocks, put_recipe,
                     put_manifest, release, stat, get_blocks, gc_mark/sweep,
                     ping/shutdown) with typed error propagation;
* ``shard_server`` — a standalone, torch-free process wrapping one owner-local
                     ``DirBlockStore`` (``python -m
                     repro_torch.service.transport.shard_server --root ... --port ...``);
* ``client``       — ``RemoteShardClient`` (the store surface over RPC) and
                     ``ShardServerProcess`` (spawn/stop/kill lifecycle).

Everything here is stdlib + numpy, copied from the reference's
``repro/service/transport/``; wire version 4 is byte-identical, so a
client of either package talks to a server of either.
"""
from .client import (  # noqa: F401
    RemoteShardClient,
    ShardServerProcess,
    spawn_shard_servers,
)
from .protocol import (  # noqa: F401
    OP_NAMES,
    VERSION,
    ProtocolError,
    ShardTransportError,
)
