"""Device mesh & sharding layer (SURVEY.md §2c/§2d, layer T1).

Replaces the reference's parallelism substrate — tensorpack
`SyncMultiGPUTrainerReplicated` + NCCL allreduce, single process, no
multi-node support [R] — with the JAX sharding stack:

* one `jax.sharding.Mesh` over ALL devices of ALL hosts with axes
  `("data", "model")`;
* utterance batches sharded on `data` (DP): gradients are synced by an
  XLA-inserted all-reduce — the `psum` of BASELINE.json config[3];
* channel dimensions of the dilated stack optionally sharded on `model`
  (TP) for the large-student stretch config;
* multi-host bring-up via `jax.distributed.initialize()` (call
  `ensure_distributed()` once at entry).

Everything works identically on the CPU-simulated 8-device mesh
(`--xla_force_host_platform_device_count=8`) used by tests and by
`__graft_entry__.dryrun_multichip`.
"""

from __future__ import annotations

import os
from typing import Any, Iterable

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pwn_vocoder.config import MeshConfig


_distributed_initialized = False


def ensure_distributed() -> None:
    """Initialize the multi-host process group when launched on a pod slice.

    Safe no-op for single-process runs.  Reference equivalent: none — the
    reference was single-process only (SURVEY.md §2d).

    The decision is made from env vars ALONE: `jax.distributed.initialize`
    must run before anything touches the XLA backend, and even an innocent
    `jax.process_count()` probe initializes it (which both makes
    `initialize()` raise and pins the pre-init answer at 1).  A module flag
    tracks "already initialized" instead of querying the backend.
    """
    global _distributed_initialized
    if _distributed_initialized:
        return
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    if coord and nproc and int(nproc) > 1:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(nproc),
            process_id=int(os.environ.get("JAX_PROCESS_ID", "0")),
        )
        _distributed_initialized = True


def make_mesh(
    cfg: MeshConfig | None = None, devices: Iterable[Any] | None = None
) -> Mesh:
    """Build the ("data", "model") mesh.

    data=-1 means all remaining devices; the model axis is innermost.
    """
    cfg = cfg or MeshConfig()
    devs = list(devices) if devices is not None else jax.devices()
    n = len(devs)
    model = max(1, cfg.model)
    if n % model:
        raise ValueError(f"{n} devices not divisible by model={model}")
    data = cfg.data if cfg.data > 0 else n // model
    if data * model != n:
        raise ValueError(
            f"mesh {data}x{model} does not cover {n} devices"
        )
    arr = np.asarray(devs).reshape(data, model)
    return Mesh(arr, ("data", "model"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading (batch) axis over `data`, everything else replicated."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """Place a host-global numpy batch onto the mesh, sharded on `data`.

    Single-process path: `jax.device_put` splits the array across local
    devices.  Multi-host path: each process holds its per-host slice of
    the global batch and we assemble a global array from local shards
    (grain-style per-host sharding — SURVEY.md §5 "Multi-host input").
    """
    sharding = batch_sharding(mesh)

    def put(x):
        if jax.process_count() == 1:
            return jax.device_put(x, sharding)
        global_shape = (x.shape[0] * jax.process_count(),) + x.shape[1:]
        return jax.make_array_from_process_local_data(
            sharding, x, global_shape
        )

    return jax.tree.map(put, batch)
