"""The train state is a plain pytree: it passes through jit, buffer
donation and sharding as its five fields, and `apply_gradients` is one
optax update."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from pwn_vocoder.config import MeshConfig, get_config, override
from pwn_vocoder.parallel import make_mesh
from pwn_vocoder.training.common import (
    TrainState,
    create_train_state,
    make_optimizer,
)

CFG = get_config("tiny_teacher").train


def _params():
    return {"layer_0": {"w_res": jnp.arange(8.0).reshape(4, 2),
                        "b_res": jnp.ones(2)}}


def test_train_state_fields_are_leaves():
    state = create_train_state(_params(), CFG)
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(state)[0]]
    assert any(p.startswith(".params") for p in paths)
    assert any(p.startswith(".opt_state") for p in paths)
    assert ".step" in paths and ".rng" in paths
    # ema_params None contributes no leaf (tree unchanged when off)
    assert not any(p.startswith(".ema_params") for p in paths)
    with_ema = create_train_state(
        _params(), override(get_config("tiny_teacher"),
                            "train.ema_decay", 0.9).train)
    n = len(jax.tree.leaves(state))
    assert len(jax.tree.leaves(with_ema)) == n + 2
    leaves, treedef = jax.tree.flatten(state)
    assert isinstance(jax.tree.unflatten(treedef, leaves), TrainState)


def test_apply_gradients_is_one_optax_update():
    tx = make_optimizer(CFG)
    state = create_train_state(_params(), CFG)
    grads = jax.tree.map(jnp.ones_like, state.params)
    new = jax.jit(lambda s, g: s.apply_gradients(g, tx))(state, grads)
    updates, _ = tx.update(grads, tx.init(state.params), state.params)
    want = optax.apply_updates(state.params, updates)
    assert int(new.step) == 1
    for a, b in zip(jax.tree.leaves(new.params), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6)
    assert new.rng is state.rng or np.array_equal(new.rng, state.rng)


def test_train_state_donation():
    tx = make_optimizer(CFG)
    state = create_train_state(_params(), CFG)
    old = jax.tree.leaves(state.params)[0]
    step = jax.jit(
        lambda s: s.apply_gradients(
            jax.tree.map(jnp.ones_like, s.params), tx),
        donate_argnums=(0,))
    new = step(state)
    assert int(new.step) == 1
    assert old.is_deleted()
    assert np.isfinite(np.asarray(jax.tree.leaves(new.params)[0])).all()


@pytest.mark.distributed
def test_train_state_sharding_rules():
    """TP placement: gate params split over `model`, the rest (and the
    scalar step/rng) replicated — and a jitted update keeps them."""
    from pwn_vocoder.parallel.tp import shard_state

    mesh = make_mesh(MeshConfig(data=4, model=2))
    state = shard_state(create_train_state(_params(), CFG), mesh)
    w = state.params["layer_0"]["w_res"]
    assert w.sharding.is_equivalent_to(
        NamedSharding(mesh, P("model", None)), w.ndim)
    mu = state.opt_state[1][0].mu["layer_0"]["w_res"]
    assert mu.sharding.is_equivalent_to(w.sharding, w.ndim)
    assert state.step.sharding.is_fully_replicated
    tx = make_optimizer(CFG)
    new = jax.jit(lambda s: s.apply_gradients(
        jax.tree.map(jnp.ones_like, s.params), tx))(state)
    assert new.params["layer_0"]["w_res"].sharding.is_equivalent_to(
        w.sharding, w.ndim)
