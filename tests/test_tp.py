"""Tensor-parallel (model-axis) tests on the CPU mesh (SURVEY.md §4:
"sharded-stack (TP) forward ≡ replicated forward")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from pwn_vocoder.config import MeshConfig, get_config, override
from pwn_vocoder.data import SyntheticTones, make_train_iterator
from pwn_vocoder.models.teacher import init_teacher
from pwn_vocoder.parallel import make_mesh, shard_batch
from pwn_vocoder.parallel.tp import (
    param_spec,
    shard_state,
    state_shardings,
    validate_tp,
)
from pwn_vocoder.training import make_teacher_train_step
from pwn_vocoder.training.common import create_train_state
from pwn_vocoder.training.teacher import prepare_batch

CFG = override(get_config("tiny_teacher"), "train.crop_samples", 1024)


def test_param_spec_rules():
    from jax.tree_util import DictKey

    layer_path = (DictKey("stack"), DictKey("layer_3"),
                  DictKey("w_dilated"))
    assert param_spec(layer_path) == P(None, None, "model")
    head_path = (DictKey("stack"), DictKey("head1"), DictKey("kernel"))
    assert param_spec(head_path) == P()
    res_path = (DictKey("stack"), DictKey("layer_0"), DictKey("w_res"))
    assert param_spec(res_path) == P("model", None)


def test_validate_tp():
    mesh = make_mesh(MeshConfig(data=4, model=2))
    validate_tp(128, mesh)
    with pytest.raises(ValueError):
        validate_tp(6, mesh)


def test_tp_forward_and_grads_match_replicated(rng):
    """(4 data x 2 model) sharded stack ≡ single-device computation."""
    model, variables = init_teacher(CFG, jax.random.PRNGKey(0))
    ds = SyntheticTones(16, 2000, CFG.dsp.sample_rate)
    wav = jnp.asarray(next(make_train_iterator(ds, CFG, 8, seed=3)))
    mesh = make_mesh(MeshConfig(data=4, model=2))
    validate_tp(CFG.teacher.gate_channels, mesh)

    def grad_fn(params, wav):
        x, mel = prepare_batch(wav, CFG)

        def loss_fn(p):
            return model.apply({"params": p}, x, mel, method="loss")

        return jax.value_and_grad(loss_fn)(params)

    # TP placement: params sharded per the Megatron rules
    shardings = state_shardings(variables["params"], mesh)
    sharded_params = jax.device_put(variables["params"], shardings)
    # a gate-channel-sharded leaf really is distributed
    w = sharded_params["stack"]["layer_0"]["w_dilated"]
    assert len(w.sharding.spec) == 3 and w.sharding.spec[2] == "model"

    l1, g1 = jax.jit(grad_fn)(sharded_params, shard_batch(mesh, wav))
    l2, g2 = jax.jit(grad_fn)(variables["params"], wav)
    np.testing.assert_allclose(float(l1), float(l2), rtol=2e-5)
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-3, atol=2e-5
        )


def test_tp_train_step_runs(rng):
    """End-to-end TP+DP train step descends with sharded state."""
    model, variables = init_teacher(CFG, jax.random.PRNGKey(0))
    mesh = make_mesh(MeshConfig(data=4, model=2))
    state = create_train_state(variables["params"], CFG.train)
    state = shard_state(state, mesh)
    step = make_teacher_train_step(model, CFG, mesh=mesh)
    ds = SyntheticTones(16, 2000, CFG.dsp.sample_rate)
    wav = shard_batch(mesh, next(make_train_iterator(ds, CFG, 8, seed=3)))
    losses = []
    for _ in range(6):
        state, m = step(state, wav)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert min(losses[3:]) < losses[0]
    # state placement preserved across steps (no silent re-replication)
    w = state.params["stack"]["layer_0"]["w_dilated"]
    assert w.sharding.spec[2] == "model"


def test_tp_training_loop_end_to_end(tmp_path):
    """config[4]-style TP training through the real loop: state gets
    placed per the TP rules and descends (CPU 4x2 mesh)."""
    from pwn_vocoder.training.loop import run_teacher_training

    cfg = CFG
    for k, v in {
        "train.global_batch_size": 4,
        "train.checkpoint_every": 100,
        "train.log_every": 1,
        "mesh.data": 4,
        "mesh.model": 2,
    }.items():
        cfg = override(cfg, k, v)
    res = run_teacher_training(cfg, workdir=str(tmp_path / "tp"),
                               num_steps=3)
    assert res.steps_run == 3
    assert np.isfinite(res.final_metrics["loss"])
    w = res.state.params["stack"]["layer_0"]["w_dilated"]
    assert w.sharding.spec[2] == "model"


def test_batch_sharded_generate_matches_unsharded(rng):
    """shard_map batch-sharded synthesis over the full (data x model)
    mesh == unsharded generate, with TP-sharded params re-gathered at
    the jit boundary (VERDICT r1 item 1)."""
    from pwn_vocoder.models.student import init_student
    from pwn_vocoder.parallel.tp import make_batch_sharded_generate

    cfg = get_config("tiny_teacher")
    model, variables = init_student(cfg, jax.random.PRNGKey(0))
    mesh = make_mesh(MeshConfig(data=4, model=2))
    B, F = 8, 64
    mel = jnp.asarray(
        rng.uniform(0, 1, (B, F, cfg.dsp.n_mels)).astype(np.float32)
    )
    key = jax.random.PRNGKey(7)
    ref = jax.jit(
        lambda v, k, m: model.apply(v, k, m, method="generate")
    )(variables, key, mel)

    gen = make_batch_sharded_generate(cfg, mesh=mesh)
    out = gen(variables, key, mel)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)

    # and with the params actually TP-sharded (storage layout of
    # config[4]): GSPMD must re-gather them transparently
    sharded_vars = shard_state(variables, mesh)
    out2 = gen(sharded_vars, key, mel)
    np.testing.assert_allclose(np.asarray(out2), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)

    with pytest.raises(ValueError, match="divisible"):
        gen(variables, key, mel[:3])
