from pwn_vocoder.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
