"""Checkpoint writer contract: round trip of every dtype the states hold,
max_to_keep, atomic commits (a partial write is never a checkpoint),
restore into a template's shardings, and fail-fast restores."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from pwn_vocoder.config import MeshConfig, get_config
from pwn_vocoder.parallel import make_mesh
from pwn_vocoder.training.common import create_train_state
from pwn_vocoder.utils.checkpoint import CheckpointManager


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32",
                                   "uint32"])
def test_checkpoint_roundtrip_dtypes(tmp_path, dtype):
    x = (np.arange(24).reshape(2, 3, 4) - 5).astype(jnp.dtype(dtype))
    tree = {"x": jnp.asarray(x), "scalar": jnp.asarray(7, jnp.int32)}
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(1, tree)
    out, step = mngr.restore(jax.eval_shape(lambda: tree))
    assert step == 1
    assert out["x"].dtype == jnp.dtype(dtype)
    np.testing.assert_array_equal(np.asarray(out["x"]), x)
    assert int(out["scalar"]) == 7


def test_checkpoint_train_state_roundtrip(tmp_path):
    cfg = get_config("tiny_teacher").train
    state = create_train_state({"w": jnp.ones((3, 2))}, cfg,
                               rng=jax.random.PRNGKey(5))
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(4, state)
    template = jax.eval_shape(lambda: state)
    out, _ = mngr.restore(template)
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert type(out) is type(state)


def test_checkpoint_max_to_keep(tmp_path):
    mngr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3, 4):
        mngr.save(step, {"w": jnp.full((2,), float(step))})
    assert mngr.all_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["3", "4"]
    out, step = mngr.restore({"w": jnp.zeros(2)})
    assert step == 4 and float(out["w"][0]) == 4.0


def test_checkpoint_partial_write_is_not_a_checkpoint(tmp_path):
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(2, {"w": jnp.ones(2)})
    # a killed save leaves its hidden partial dir; a step dir without a
    # manifest is not committed either
    os.makedirs(tmp_path / ".5.partial")
    os.makedirs(tmp_path / "6")
    assert mngr.latest_step() == 2
    assert mngr.all_steps() == [2]
    mngr.save(5, {"w": jnp.zeros(2)})  # replaces the stale partial
    assert mngr.all_steps() == [2, 5]
    assert not os.path.exists(tmp_path / ".5.partial")


@pytest.mark.distributed
def test_checkpoint_restores_into_template_sharding(tmp_path):
    mesh = make_mesh(MeshConfig(data=8, model=1))
    sharding = NamedSharding(mesh, P("data"))
    w = np.arange(32.0, dtype=np.float32).reshape(8, 4)
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(1, {"w": jax.device_put(w, sharding)})
    template = {"w": jax.ShapeDtypeStruct((8, 4), jnp.float32,
                                          sharding=sharding)}
    out, _ = mngr.restore(template)
    assert out["w"].sharding == sharding
    assert len(out["w"].addressable_shards) == 8
    np.testing.assert_array_equal(np.asarray(out["w"]), w)


def test_checkpoint_restore_fails_fast(tmp_path):
    mngr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mngr.restore({"w": jnp.zeros(2)})
    mngr.save(1, {"w": jnp.zeros(2)})
    with pytest.raises(FileNotFoundError):
        mngr.restore({"w": jnp.zeros(2)}, step=9)
    with pytest.raises(ValueError, match="does not match the template"):
        mngr.restore({"v": jnp.zeros(2)})
    with pytest.raises(ValueError, match="template wants"):
        mngr.restore({"w": jnp.zeros(3)})
    with pytest.raises(ValueError, match="template wants"):
        mngr.restore({"w": jnp.zeros(2, jnp.int32)})
    with open(tmp_path / "1" / "manifest.json") as f:
        assert json.load(f)["leaves"][0]["path"] == "['w']"
