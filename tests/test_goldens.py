"""Frozen-golden allclose gate (BASELINE.json correctness gate; SURVEY.md
§0/§4 — reference TF implementation unavailable, goldens self-generated
from the §8 semantics by tools/make_goldens.py and frozen).

These tests fail if ANY semantic drift lands in: DSP (preemphasis, STFT,
mel filterbank, dB normalize), teacher forward (conv stack, MoL head), or
the student IAF transform.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pwn_vocoder.config import get_config
from pwn_vocoder.models.student import init_student
from pwn_vocoder.models.teacher import init_teacher
from pwn_vocoder.ops import mol
from pwn_vocoder.utils import dsp

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "tiny_v1.npz")


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def cfg():
    return get_config("tiny_teacher")


def test_golden_mel_allclose(g, cfg):
    wav = jnp.asarray(g["clip"])[None]
    x = jnp.clip(dsp.preemphasis(wav, cfg.dsp.preemphasis), -1, 1)
    mel = dsp.mel_spectrogram(x, cfg.dsp)[:, : 4096 // cfg.dsp.hop_length]
    np.testing.assert_allclose(
        np.asarray(mel[0]), g["mel"], rtol=1e-5, atol=1e-5
    )


def test_golden_teacher_allclose(g, cfg):
    wav = jnp.asarray(g["clip"])[None]
    x = jnp.clip(dsp.preemphasis(wav, cfg.dsp.preemphasis), -1, 1)
    mel = jnp.asarray(g["mel"])[None]
    teacher, t_vars = init_teacher(cfg, jax.random.PRNGKey(0))
    t_params = teacher.apply(t_vars, x, mel)
    np.testing.assert_allclose(
        np.asarray(t_params[0, :512]), g["teacher_mol"],
        rtol=1e-4, atol=1e-5,
    )
    nll = mol.discretized_mol_loss(
        x, t_params, log_scale_min=cfg.teacher.log_scale_min
    )
    np.testing.assert_allclose(float(nll), float(g["teacher_nll"]),
                               rtol=1e-5)


def test_golden_student_waveform_allclose(g, cfg):
    mel = jnp.asarray(g["mel"])[None]
    z = jnp.asarray(g["z"])[None]
    student, s_vars = init_student(cfg, jax.random.PRNGKey(1))
    out = student.apply(s_vars, z, mel)
    np.testing.assert_allclose(
        np.asarray(out.wav[0]), g["student_wav"], rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(out.log_det[0]), g["student_log_det"],
        rtol=1e-4, atol=1e-5,
    )


GOLDEN_GAUSS = os.path.join(
    os.path.dirname(__file__), "goldens", "tiny_gaussian_v1.npz"
)


@pytest.fixture(scope="module")
def gg():
    return np.load(GOLDEN_GAUSS)


@pytest.fixture(scope="module")
def cfg_gauss(cfg):
    from pwn_vocoder.config import override

    c = cfg
    for k, v in (("teacher.output", "gaussian"),
                 ("student.base", "gaussian")):
        c = override(c, k, v)
    return c


def test_golden_fixtures_share_clip_and_mel(g, gg):
    """The two fixture files must be generated from the identical
    clip/mel: tiny_gaussian_v1 duplicates them so a DSP change followed
    by a partial regeneration (--only-gaussian) cannot silently
    desynchronize the families (ADVICE r3)."""
    np.testing.assert_array_equal(g["clip"], gg["clip"])
    np.testing.assert_array_equal(g["mel"], gg["mel"])


def test_golden_gaussian_teacher_allclose(g, gg, cfg_gauss):
    """Pins the Gaussian/ClariNet family semantics (head params +
    continuous NLL) the way tiny_v1 pins MoL — same clip/mel/init keys
    (tools/make_goldens.py)."""
    from pwn_vocoder.ops import gaussian

    wav = jnp.asarray(g["clip"])[None]
    x = jnp.clip(dsp.preemphasis(wav, cfg_gauss.dsp.preemphasis), -1, 1)
    mel = jnp.asarray(g["mel"])[None]
    teacher, t_vars = init_teacher(cfg_gauss, jax.random.PRNGKey(0))
    t_params = teacher.apply(t_vars, x, mel)
    assert t_params.shape[-1] == 2  # (mean, log_scale) head
    np.testing.assert_allclose(
        np.asarray(t_params[0, :512]), gg["teacher_gauss"],
        rtol=1e-4, atol=1e-5,
    )
    nll = gaussian.gaussian_nll(
        x, t_params, log_scale_min=cfg_gauss.teacher.log_scale_min
    )
    np.testing.assert_allclose(float(nll), float(gg["teacher_nll"]),
                               rtol=1e-5)


def test_golden_gaussian_student_waveform_allclose(g, gg, cfg_gauss):
    mel = jnp.asarray(g["mel"])[None]
    z = jnp.asarray(gg["z"])[None]
    student, s_vars = init_student(cfg_gauss, jax.random.PRNGKey(1))
    out = student.apply(s_vars, z, mel)
    np.testing.assert_allclose(
        np.asarray(out.wav[0]), gg["student_wav"], rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(out.log_det[0]), gg["student_log_det"],
        rtol=1e-4, atol=1e-5,
    )


def test_eval_metrics_sane(g, cfg):
    from pwn_vocoder.evaluate import copy_synthesis_report

    clip = g["clip"]
    rep_same = copy_synthesis_report(cfg, clip, clip)
    assert rep_same["mel_l2"] < 1e-10
    assert rep_same["spectral_convergence"] < 1e-6
    noise = np.random.default_rng(0).standard_normal(len(clip)).astype(
        np.float32
    ) * 0.1
    rep_noise = copy_synthesis_report(cfg, clip, clip + noise)
    assert rep_noise["mel_l2"] > rep_same["mel_l2"]
    assert rep_noise["log_spectral_distance_db"] > 1.0


def test_voiced_metrics_isolate_silence_noise(cfg):
    """lsd_voiced ignores silent-frame noise; silence_noise_floor_db
    catches it (the r2 best-recipe failure mode)."""
    from pwn_vocoder.evaluate import voiced_metrics

    sr = cfg.dsp.sample_rate
    t = np.arange(sr, dtype=np.float32) / sr
    tone = (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    ref = np.concatenate([tone, np.zeros(sr, np.float32)])

    # generated: perfect tone, noisy silence
    noise = (0.02 * np.random.default_rng(0)
             .standard_normal(sr)).astype(np.float32)
    gen = np.concatenate([tone, noise])

    clean = voiced_metrics(cfg, ref, ref)
    noisy = voiced_metrics(cfg, ref, gen)
    assert 0.3 < noisy["voiced_fraction"] < 0.7
    # voiced half identical -> voiced LSD stays near zero
    assert noisy["lsd_voiced_db"] < 1.0
    # noise floor metric moves by ~the injected 0.02 RMS (-34 dBFS)
    assert noisy["silence_noise_floor_db"] > -40.0
    assert clean["silence_noise_floor_db"] < -70.0
