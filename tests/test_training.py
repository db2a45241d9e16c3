"""Training-step tests: teacher NLL descent, distillation loss descent,
metrics plumbing (SURVEY.md §4 integration rows)."""

import jax
import pytest
import jax.numpy as jnp
import numpy as np

from pwn_vocoder.config import get_config, override
from pwn_vocoder.data import SyntheticTones, make_train_iterator
from pwn_vocoder.models.student import init_student
from pwn_vocoder.models.teacher import init_teacher
from pwn_vocoder.training import (
    make_distill_train_step,
    make_teacher_train_step,
)
from pwn_vocoder.training.common import create_train_state

CFG = override(get_config("tiny_teacher"), "train.crop_samples", 2048)


def _batch(rng, B=2):
    ds = SyntheticTones(8, 4000, CFG.dsp.sample_rate)
    it = make_train_iterator(ds, CFG, B, seed=1)
    return jnp.asarray(next(it))


def test_teacher_train_step_descends(rng):
    model, variables = init_teacher(CFG, jax.random.PRNGKey(0))
    state = create_train_state(variables["params"], CFG.train)
    step = make_teacher_train_step(model, CFG)
    wav = _batch(rng)
    losses = []
    for _ in range(8):
        state, metrics = step(state, wav)
        losses.append(float(metrics["loss"]))
        assert np.isfinite(losses[-1])
        assert np.isfinite(float(metrics["grad_norm"]))
    assert min(losses[4:]) < losses[0]
    assert int(state.step) == 8


def test_distill_train_step_descends(rng):
    teacher, t_vars = init_teacher(CFG, jax.random.PRNGKey(0))
    student, s_vars = init_student(CFG, jax.random.PRNGKey(1))
    state = create_train_state(
        s_vars["params"], CFG.train, rng=jax.random.PRNGKey(2)
    )
    step = make_distill_train_step(student, teacher, CFG)
    wav = _batch(rng)
    losses, kls, powers = [], [], []
    for _ in range(8):
        state, m = step(state, t_vars["params"], wav)
        losses.append(float(m["loss"]))
        kls.append(float(m["kl"]))
        powers.append(float(m["power_loss"]))
    assert all(np.isfinite(losses))
    # both loss terms must be reported separately (collapse debugging)
    assert kls[0] != powers[0]
    assert min(losses[4:]) < losses[0]


def test_multires_power_loss_and_kl_warmup(rng):
    """Multi-resolution STFT power loss + KL-weight warmup (quality
    levers for the speech-like corpus; config-gated, default-off).

    - spectral_power_loss over extra resolutions is finite, positive,
      and equals the mean of the per-resolution single losses;
    - kl_weight_at ramps linearly then saturates;
    - a distill train step under both options still descends."""
    from pwn_vocoder.training.distill import (
        kl_weight_at,
        make_distill_train_step,
        spectral_power_loss,
    )

    cfg = override(
        CFG, "distill.power_loss_resolutions",
        ((256, 64, 256), (1024, 256, 1024)),
    )
    cfg = override(cfg, "distill.kl_warmup_steps", 4)

    x = _batch(rng)
    y = jnp.roll(x, 17, axis=-1)
    multi = float(spectral_power_loss(x, y, cfg))
    singles = []
    for nf, hop, win in ((cfg.dsp.n_fft, cfg.dsp.hop_length,
                          cfg.dsp.win_length),
                         (256, 64, 256), (1024, 256, 1024)):
        c1 = override(override(override(
            CFG, "dsp.n_fft", nf), "dsp.hop_length", hop),
            "dsp.win_length", win)
        singles.append(float(spectral_power_loss(x, y, c1)))
    assert multi > 0 and np.isfinite(multi)
    np.testing.assert_allclose(multi, np.mean(singles), rtol=1e-5)

    w = [float(kl_weight_at(cfg, s)) for s in range(6)]
    np.testing.assert_allclose(w, [0.25, 0.5, 0.75, 1.0, 1.0, 1.0],
                               rtol=1e-6)
    assert float(kl_weight_at(cfg, None)) == cfg.distill.kl_weight

    teacher, t_vars = init_teacher(cfg, jax.random.PRNGKey(0))
    student, s_vars = init_student(cfg, jax.random.PRNGKey(1))
    state = create_train_state(
        s_vars["params"], cfg.train, rng=jax.random.PRNGKey(2)
    )
    step = make_distill_train_step(student, teacher, cfg)
    losses = []
    for _ in range(6):
        state, m = step(state, t_vars["params"], x)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert min(losses[3:]) < losses[1]


def test_ema_params_track_and_serve(rng, tmp_path):
    """train.ema_decay > 0: the state carries Polyak-averaged params
    that lag the live ones, serving_params returns them, and the
    checkpoint roundtrip preserves them (the PW recipe: train live,
    ship the average)."""
    from pwn_vocoder.training.common import serving_params, update_ema
    from pwn_vocoder.utils.checkpoint import CheckpointManager

    cfg = override(CFG, "train.ema_decay", 0.5)
    model, variables = init_teacher(cfg, jax.random.PRNGKey(0))
    # snapshot before stepping: the state (aliasing these buffers) is
    # donated into the jitted step
    init = [np.asarray(x) for x in jax.tree.leaves(variables["params"])]
    state = create_train_state(variables["params"], cfg.train)
    assert state.ema_params is not None
    step = make_teacher_train_step(model, cfg)
    wav = _batch(rng)
    for _ in range(3):
        state, _ = step(state, wav)

    p = jax.tree.leaves(state.params)
    e = [np.asarray(x) for x in jax.tree.leaves(state.ema_params)]
    assert any(
        not np.allclose(np.asarray(a), np.asarray(b)) for a, b in zip(p, e)
    )
    assert any(
        not np.allclose(np.asarray(a), np.asarray(b))
        for a, b in zip(e, init)
    )
    assert serving_params(state) is state.ema_params

    CheckpointManager(str(tmp_path / "ckpt")).save(int(state.step), state)
    _, fresh_vars = init_teacher(cfg, jax.random.PRNGKey(9))
    fresh = create_train_state(fresh_vars["params"], cfg.train)
    restored, _ = CheckpointManager(str(tmp_path / "ckpt")).restore(fresh)
    for a, b in zip(jax.tree.leaves(restored.ema_params), e):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # decay=0 keeps the tree shape unchanged (old checkpoints readable)
    off = create_train_state(fresh_vars["params"], CFG.train)
    assert off.ema_params is None
    assert serving_params(off) is off.params
    # update_ema math
    s2 = update_ema(state, 1.0)  # decay 1: ema unchanged
    for a, b in zip(jax.tree.leaves(s2.ema_params), e):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_nested_tuple_override_coercion():
    """CLI string form of power_loss_resolutions parses to nested
    tuples (config.py::_coerce literal_eval fallback)."""
    cfg = override(CFG, "distill.power_loss_resolutions",
                   "((512,128,512),(2048,512,2048))")
    assert cfg.distill.power_loss_resolutions == (
        (512, 128, 512), (2048, 512, 2048)
    )


def test_distill_teacher_params_frozen(rng):
    """Gradients must not flow into the teacher."""
    teacher, t_vars = init_teacher(CFG, jax.random.PRNGKey(0))
    student, s_vars = init_student(CFG, jax.random.PRNGKey(1))
    from pwn_vocoder.training.distill import distillation_losses
    from pwn_vocoder.training.teacher import prepare_batch

    wav = _batch(rng, B=1)
    x_ref, mel = prepare_batch(wav, CFG)

    def teacher_loss(tp):
        loss, _ = distillation_losses(
            student, teacher, s_vars["params"], tp, x_ref, mel,
            jax.random.PRNGKey(3), CFG,
        )
        return loss

    g = jax.grad(teacher_loss)(t_vars["params"])
    assert all(
        float(jnp.abs(x).max()) == 0.0 for x in jax.tree.leaves(g)
    )


def test_contrastive_distillation_term(rng):
    """Parallel WaveNet's contrastive conditioning term [PW]
    (VERDICT r4 next-item 2): the same student sample scored under
    batch-ROLLED mel; loss = klw*(kl - gamma*kl_mis) + power.

    - identity check: with two IDENTICAL batch rows the roll is a
      no-op, so contrastive_kl == kl exactly and the loss reduces to
      (1-gamma)*kl + power;
    - with distinct rows contrastive_kl != kl (mismatched teacher);
    - gamma=0 emits no contrastive_kl metric (goldens graph unchanged);
    - a train step under gamma=0.3 stays finite and descends."""
    from pwn_vocoder.training.distill import distillation_losses
    from pwn_vocoder.training.teacher import prepare_batch

    cfg = override(CFG, "distill.contrastive_weight", 0.3)
    teacher, t_vars = init_teacher(cfg, jax.random.PRNGKey(0))
    student, s_vars = init_student(cfg, jax.random.PRNGKey(1))

    wav = _batch(rng, B=2)
    same = jnp.concatenate([wav[:1], wav[:1]])  # roll == identity
    x_ref, mel = prepare_batch(same, cfg)
    loss, m = distillation_losses(
        student, teacher, s_vars["params"], t_vars["params"],
        x_ref, mel, jax.random.PRNGKey(3), cfg,
    )
    assert "contrastive_kl" in m
    np.testing.assert_allclose(
        float(m["contrastive_kl"]), float(m["kl"]), rtol=1e-5
    )
    np.testing.assert_allclose(
        float(loss),
        (1 - 0.3) * float(m["kl"]) + float(m["power_loss"]),
        rtol=1e-5,
    )

    x_ref2, mel2 = prepare_batch(wav, cfg)
    _, m2 = distillation_losses(
        student, teacher, s_vars["params"], t_vars["params"],
        x_ref2, mel2, jax.random.PRNGKey(3), cfg,
    )
    assert float(m2["contrastive_kl"]) != float(m2["kl"])

    _, m0 = distillation_losses(
        student, teacher, s_vars["params"], t_vars["params"],
        x_ref2, mel2, jax.random.PRNGKey(3), CFG,
    )
    assert "contrastive_kl" not in m0

    state = create_train_state(
        s_vars["params"], cfg.train, rng=jax.random.PRNGKey(2)
    )
    step = make_distill_train_step(student, teacher, cfg)
    losses = []
    for _ in range(12):
        state, mm = step(state, t_vars["params"], wav)
        losses.append(float(mm["loss"]))
        assert np.isfinite(losses[-1])
        assert np.isfinite(float(mm["contrastive_kl"]))
    # the -gamma*kl_mis term makes early steps non-monotone on a
    # random init; require eventual descent, not per-step descent
    assert min(losses) < losses[0]


@pytest.mark.slow
def test_overfit_single_clip_cpu(rng):
    """SURVEY.md §4 integration row: tiny teacher overfits one clip on
    CPU — NLL must drop substantially within ~80 steps."""
    cfg = override(get_config("tiny_teacher"), "train.crop_samples", 4096)
    model, variables = init_teacher(CFG, jax.random.PRNGKey(0))
    state = create_train_state(variables["params"], cfg.train)
    step = make_teacher_train_step(model, cfg)
    ds = SyntheticTones(1, 8000, cfg.dsp.sample_rate, seed=42)
    wav = jnp.asarray(ds[0][:4096])[None]
    first = None
    for i in range(80):
        state, m = step(state, wav)
        if first is None:
            first = float(m["loss"])
    last = float(m["loss"])
    assert first - last > 0.5, (first, last)


def test_student_generate_jit_nojit_allclose(rng):
    """SURVEY.md §4: generated waveform allclose across jit/nojit."""
    from pwn_vocoder.models.student import init_student

    model, variables = init_student(CFG, jax.random.PRNGKey(0))
    mel = jnp.asarray(
        rng.uniform(0, 1, (1, 4, CFG.dsp.n_mels)).astype(np.float32)
    )
    key = jax.random.PRNGKey(4)
    w_nojit = model.apply(variables, key, mel, method="generate")
    w_jit = jax.jit(
        lambda v, k, m: model.apply(v, k, m, method="generate")
    )(variables, key, mel)
    # jit fuses differently from op-by-op dispatch: ~5e-6 fp32 noise
    np.testing.assert_allclose(np.asarray(w_jit), np.asarray(w_nojit),
                               rtol=1e-4, atol=1e-5)


def test_student_direct_train_step_descends(rng):
    """Direct (teacher-free) student training: closed-form likelihood +
    power loss must descend (VERDICT r1 missing item 1)."""
    from pwn_vocoder.training.student_direct import (
        make_student_direct_train_step,
    )

    student, s_vars = init_student(CFG, jax.random.PRNGKey(1))
    state = create_train_state(
        s_vars["params"], CFG.train, rng=jax.random.PRNGKey(2)
    )
    step = make_student_direct_train_step(student, CFG)
    wav = _batch(rng)
    losses, mls, powers = [], [], []
    for _ in range(12):
        state, m = step(state, wav)
        losses.append(float(m["loss"]))
        mls.append(float(m["ml_nll"]))
        powers.append(float(m["power_loss"]))
    assert all(np.isfinite(losses))
    assert mls[0] != powers[0]  # both terms reported separately
    # noisy early transient (power term spikes around step 1-3) —
    # require descent over the tail
    assert min(losses[6:]) < losses[0]


def test_student_mu_total_affine_identity(rng):
    """StudentOutput.mu_total must satisfy the closed-form affine identity
    x = S*z0 + M (pre-clip), so Logistic(mu_total, exp(log_det)) is the
    exact per-timestep output conditional used by direct training."""
    from pwn_vocoder.ops import mol

    student, s_vars = init_student(CFG, jax.random.PRNGKey(1))
    z = mol.sample_logistic(jax.random.PRNGKey(5), (2, 1024))
    mel = jnp.zeros((2, 1024 // CFG.dsp.hop_length, CFG.dsp.n_mels))
    out = student.apply(s_vars, z, mel)
    x_pre_clip = z * jnp.exp(out.log_det) + out.mu_total
    np.testing.assert_allclose(
        np.asarray(out.wav), np.clip(np.asarray(x_pre_clip), -1, 1),
        rtol=1e-4, atol=1e-5,
    )
    # at x = x_S (unclipped), the conditional reduces to the closed-form
    # student density log p_base(z0) - sum log s
    lp = mol.logistic_log_density(x_pre_clip, out.mu_total, out.log_det)
    np.testing.assert_allclose(
        np.asarray(lp), np.asarray(out.log_p_student), rtol=1e-4, atol=1e-4
    )
