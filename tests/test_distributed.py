"""Distributed tests on the 8-device CPU mesh (SURVEY.md §4 row
"Distributed"): sharded-step gradients ≡ single-device gradients on the
same global batch; mesh construction invariants."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pwn_vocoder.config import MeshConfig, get_config, override
from pwn_vocoder.data import SyntheticTones, make_train_iterator
from pwn_vocoder.models.teacher import init_teacher
from pwn_vocoder.parallel import make_mesh, shard_batch
from pwn_vocoder.training import make_teacher_train_step
from pwn_vocoder.training.common import create_train_state

CFG = override(get_config("tiny_teacher"), "train.crop_samples", 1024)


def test_mesh_shapes():
    mesh = make_mesh(MeshConfig(data=-1, model=1))
    assert mesh.devices.shape == (8, 1)
    assert mesh.axis_names == ("data", "model")
    mesh2 = make_mesh(MeshConfig(data=4, model=2))
    assert mesh2.devices.shape == (4, 2)
    with pytest.raises(ValueError):
        make_mesh(MeshConfig(data=3, model=1))


def test_dp_grads_match_single_device(rng):
    """The core DP-sync claim: psum-synced gradients on the 8-way sharded
    batch equal gradients of the unsharded global batch (bitwise-tolerant).
    Gradients are compared directly — comparing params after adam would
    amplify ~1e-7 reduction-order noise wherever v ~ 0."""
    from pwn_vocoder.parallel.mesh import batch_sharding, replicated
    from pwn_vocoder.training.teacher import prepare_batch

    model, variables = init_teacher(CFG, jax.random.PRNGKey(0))
    ds = SyntheticTones(16, 2000, CFG.dsp.sample_rate)
    wav = jnp.asarray(next(make_train_iterator(ds, CFG, 8, seed=3)))
    mesh = make_mesh(MeshConfig(data=8, model=1))

    def grad_fn(params, wav):
        x, mel = prepare_batch(wav, CFG)

        def loss_fn(p):
            return model.apply({"params": p}, x, mel, method="loss")

        return jax.value_and_grad(loss_fn)(params)

    rep = replicated(mesh)
    sharded = jax.jit(
        grad_fn, in_shardings=(rep, batch_sharding(mesh)),
        out_shardings=(rep, rep),
    )
    single = jax.jit(grad_fn)

    l1, g1 = sharded(variables["params"], shard_batch(mesh, wav))
    l2, g2 = single(variables["params"], wav)
    np.testing.assert_allclose(float(l1), float(l2), rtol=2e-5)
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-5
        )


def test_dp_train_step_runs_sharded(rng):
    """End-to-end sharded train step executes and descends."""
    model, variables = init_teacher(CFG, jax.random.PRNGKey(0))
    ds = SyntheticTones(16, 2000, CFG.dsp.sample_rate)
    wav = jnp.asarray(next(make_train_iterator(ds, CFG, 8, seed=3)))
    mesh = make_mesh(MeshConfig(data=8, model=1))
    step = make_teacher_train_step(model, CFG, mesh=mesh)
    state = create_train_state(variables["params"], CFG.train)
    wav_sharded = shard_batch(mesh, wav)
    losses = []
    for _ in range(6):
        state, m = step(state, wav_sharded)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert min(losses[3:]) < losses[0]


def test_batch_sharding_places_shards(rng):
    mesh = make_mesh(MeshConfig(data=8, model=1))
    wav = np.zeros((8, 256), np.float32)
    arr = shard_batch(mesh, wav)
    assert len(arr.addressable_shards) == 8
    assert arr.addressable_shards[0].data.shape == (1, 256)


def test_measure_scaling_table(rng):
    """Scaling table runs over the CPU sim mesh and reports efficiency
    rows for each power-of-two device count."""
    from pwn_vocoder.benchmarks import measure_scaling
    from pwn_vocoder.config import get_config, override

    cfg = get_config("tiny_teacher")
    for k, v in {"train.crop_samples": 1024,
                 "train.global_batch_size": 8}.items():
        cfg = override(cfg, k, v)
    rows = measure_scaling(cfg, reps=2)
    assert [r["devices"] for r in rows] == [1, 2, 4, 8]
    assert rows[0]["efficiency"] == 1.0
    for r in rows:
        # weak scaling: global batch grows with the device count
        assert r["batch"] == 8 * r["devices"]
        assert r["utt_per_s"] > 0 and np.isfinite(r["efficiency"])


def test_teacher_factory_dp_step_matches_single_device(rng):
    """make_teacher_train_step's shard_map DP branch (per-device grads,
    pmean'd) ≡ the mesh=None jit on the same global batch — loss and
    updated params."""
    model, variables = init_teacher(CFG, jax.random.PRNGKey(0))
    ds = SyntheticTones(16, 2000, CFG.dsp.sample_rate)
    wav = jnp.asarray(next(make_train_iterator(ds, CFG, 8, seed=3)))
    mesh = make_mesh(MeshConfig(data=8, model=1))

    step_dp = make_teacher_train_step(model, CFG, mesh=mesh)
    step_1d = make_teacher_train_step(model, CFG)
    # the train steps donate the state: give each its own buffers
    s_dp = create_train_state(
        jax.tree.map(jnp.array, variables["params"]), CFG.train
    )
    s_1d = create_train_state(
        jax.tree.map(jnp.array, variables["params"]), CFG.train
    )
    # Compare the LOSS TRAJECTORY, not post-adam params: adam's
    # 1/(sqrt(v)+eps) flips ~0-gradient elements by a full +-lr on
    # ~1e-7 reduction-order noise, but those elements barely move the
    # loss — while a genuinely wrong gradient sync diverges the losses
    # within a step or two.
    wav_sh = shard_batch(mesh, wav)
    for i in range(3):
        s_dp, m_dp = step_dp(s_dp, wav_sh)
        s_1d, m_1d = step_1d(s_1d, wav)
        np.testing.assert_allclose(
            float(m_dp["loss"]), float(m_1d["loss"]),
            rtol=2e-5 if i == 0 else 1e-3,
        )


def test_stochastic_dp_steps_descend_sharded(rng):
    """Distill + direct-student shard_map DP steps run sharded and
    descend (per-shard keys fold in the data-axis index, so exact
    single-device equality is not expected for these stochastic
    losses)."""
    from pwn_vocoder.models.student import init_student
    from pwn_vocoder.training import make_distill_train_step
    from pwn_vocoder.training.student_direct import (
        make_student_direct_train_step,
    )

    mesh = make_mesh(MeshConfig(data=8, model=1))
    teacher, t_vars = init_teacher(CFG, jax.random.PRNGKey(0))
    student, s_vars = init_student(CFG, jax.random.PRNGKey(1),
                                   use_scan=False)
    ds = SyntheticTones(16, 2000, CFG.dsp.sample_rate)
    wav = shard_batch(
        mesh, jnp.asarray(next(make_train_iterator(ds, CFG, 8, seed=3)))
    )

    d_step = make_distill_train_step(student, teacher, CFG, mesh=mesh)
    s_step = make_student_direct_train_step(student, CFG, mesh=mesh)
    for run in (
        lambda st: d_step(st, t_vars["params"], wav),
        lambda st: s_step(st, wav),
    ):
        state = create_train_state(
            jax.tree.map(jnp.array, s_vars["params"]), CFG.train,
            rng=jax.random.PRNGKey(7),
        )
        losses = []
        for _ in range(12):
            state, m = run(state)
            losses.append(float(m["loss"]))
        assert all(np.isfinite(losses))
        # per-shard MC keys make single-step losses noisy: compare the
        # mean of the last third against the first third
        assert np.mean(losses[-4:]) < np.mean(losses[:4])
