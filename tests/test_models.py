"""Teacher/Student model tests: shapes, causality, IAF log-det correctness
(SURVEY.md §4: "causal conv = zero future leakage", "IAF invertibility")."""

import jax
import jax.numpy as jnp
import numpy as np

from pwn_vocoder.config import get_config
from pwn_vocoder.models.student import init_student
from pwn_vocoder.models.teacher import init_teacher

CFG = get_config("tiny_teacher")
HOP = CFG.dsp.hop_length


def _data(rng, B=2, frames=6):
    T = frames * HOP
    wav = jnp.asarray(
        rng.uniform(-0.5, 0.5, (B, T)).astype(np.float32)
    )
    mel = jnp.asarray(
        rng.uniform(0, 1, (B, frames, CFG.dsp.n_mels)).astype(np.float32)
    )
    return wav, mel


def test_teacher_shapes(rng):
    model, variables = init_teacher(CFG, jax.random.PRNGKey(0))
    wav, mel = _data(rng)
    params = model.apply(variables, wav, mel)
    K = CFG.teacher.n_mixtures
    assert params.shape == (2, wav.shape[1], 3 * K)
    assert params.dtype == jnp.float32
    loss = model.apply(variables, wav, mel, method="loss")
    assert np.isfinite(float(loss))


def test_teacher_causality(rng):
    """MoL params at step t depend only on wav[<t]: perturbing wav[t0:]
    leaves params[:, :t0+1] unchanged."""
    model, variables = init_teacher(CFG, jax.random.PRNGKey(0))
    wav, mel = _data(rng, B=1)
    t0 = wav.shape[1] // 2
    p1 = model.apply(variables, wav, mel)
    p2 = model.apply(variables, wav.at[:, t0:].add(0.3), mel)
    np.testing.assert_allclose(
        np.asarray(p1[:, : t0 + 1]), np.asarray(p2[:, : t0 + 1]),
        rtol=1e-5, atol=1e-6,
    )
    assert not np.allclose(np.asarray(p1[:, t0 + 1 :]),
                           np.asarray(p2[:, t0 + 1 :]))


def test_teacher_loss_improves_with_sgd(rng):
    """One gradient step on a fixed batch decreases the NLL (SURVEY.md §4
    integration row: 'one train step decreases NLL')."""
    model, variables = init_teacher(CFG, jax.random.PRNGKey(0))
    wav, mel = _data(rng, B=1, frames=4)

    def loss_fn(v):
        return model.apply(v, wav, mel, method="loss")

    l0, grads = jax.value_and_grad(loss_fn)(variables)
    v1 = jax.tree.map(lambda p, g: p - 5e-4 * g, variables, grads)
    l1 = loss_fn(v1)
    assert float(l1) < float(l0)


def test_student_shapes_and_logdet(rng):
    model, variables = init_student(CFG, jax.random.PRNGKey(0))
    wav, mel = _data(rng)
    z = jnp.asarray(rng.standard_normal(wav.shape).astype(np.float32))
    out = model.apply(variables, z, mel)
    assert out.wav.shape == z.shape
    assert out.log_det.shape == z.shape
    assert np.isfinite(np.asarray(out.log_p_student)).all()


def test_student_causality(rng):
    """x[t] depends on z[<=t] only: perturbing z[t0:] leaves x[:, :t0]
    unchanged (strictly-causal flows; z[t] itself passes through at t)."""
    model, variables = init_student(CFG, jax.random.PRNGKey(0))
    wav, mel = _data(rng, B=1)
    z = jnp.asarray(rng.standard_normal(wav.shape).astype(np.float32))
    t0 = z.shape[1] // 2
    o1 = model.apply(variables, z, mel)
    o2 = model.apply(variables, z.at[:, t0:].add(1.0), mel)
    np.testing.assert_allclose(np.asarray(o1.wav[:, :t0]),
                               np.asarray(o2.wav[:, :t0]),
                               rtol=1e-5, atol=1e-6)


def test_student_logdet_is_true_jacobian(rng):
    """For a triangular flow, log|det dx/dz| must equal sum log_s.  Check
    against autodiff jacobian diag on a short sequence."""
    short = get_config("tiny_teacher")
    model, variables = init_student(short, jax.random.PRNGKey(0))
    T = 2 * HOP
    z = jnp.asarray(rng.standard_normal((1, T)).astype(np.float32))
    mel = jnp.asarray(
        rng.uniform(0, 1, (1, 2, short.dsp.n_mels)).astype(np.float32)
    )

    def fwd(zz):
        # unclipped output: use log_det path directly
        return model.apply(variables, zz[None], mel).wav[0]

    out = model.apply(variables, z, mel)
    # Jacobian is lower-triangular; diag entries = prod_i s_i at each t
    jac = jax.jacfwd(fwd)(z[0])
    diag = jnp.diagonal(jac)
    mask = jnp.abs(out.wav[0]) < 0.999  # clip kills gradient at the rails
    got = jnp.log(jnp.abs(diag)) * mask
    want = out.log_det[0] * mask
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-3, atol=1e-4)
    # strictly triangular: no dependence above the diagonal
    upper = jnp.triu(jac, k=1)
    np.testing.assert_allclose(np.asarray(upper), 0.0, atol=1e-6)


def test_student_generate_parallel(rng):
    model, variables = init_student(CFG, jax.random.PRNGKey(0))
    _, mel = _data(rng, B=1, frames=4)
    wav = model.apply(variables, jax.random.PRNGKey(3), mel,
                      method="generate")
    assert wav.shape == (1, 4 * HOP)
    assert float(jnp.max(jnp.abs(wav))) <= 1.0


def test_scan_stack_matches_unrolled_reference(rng):
    """The production lax.scan wide-GEMM stack must equal the unrolled
    per-layer reference compute (gated_layer_xla) on the same params."""
    from pwn_vocoder.models.modules import (
        ParamInit,
        gated_layer_xla,
        init_stack,
        wavenet_stack,
    )
    from pwn_vocoder.ops.conv import causal_conv1d

    dilations = (1, 2, 4, 8, 16)
    p = init_stack(ParamInit(jax.random.PRNGKey(0)), len(dilations),
                   residual_channels=8, gate_channels=16, skip_channels=8,
                   cond_dim=5, out_dim=3)
    x = jnp.asarray(rng.standard_normal((2, 100, 1)).astype(np.float32))
    cond = jnp.asarray(rng.standard_normal((2, 100, 5)).astype(np.float32))
    got = wavenet_stack(p, x, cond, dilations, jnp.float32, use_scan=True)

    # manual unrolled reference with the same param tree
    h = causal_conv1d(x, p["front"]["kernel"], 1, p["front"]["bias"])
    skip_total = jnp.zeros((2, 100, 8))
    for i, d in enumerate(dilations):
        h, skip = gated_layer_xla(h, cond, p[f"layer_{i}"], d, jnp.float32)
        skip_total = skip_total + skip
    hh = jax.nn.relu(skip_total)
    hh = jax.nn.relu(
        causal_conv1d(hh, p["head1"]["kernel"], 1, p["head1"]["bias"])
    )
    want = causal_conv1d(hh, p["head2"]["kernel"], 1, p["head2"]["bias"])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
