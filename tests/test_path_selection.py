"""Each call site runs one WaveNet-stack path, chosen in code: training
steps and the frozen teacher scored inside distillation run the unrolled
graph; every inference entry runs the scan."""

import jax
import numpy as np
import pytest

from pwn_vocoder.config import get_config, override
from pwn_vocoder.models import modules
from pwn_vocoder.models.student import init_student

CFG = override(get_config("tiny_teacher"), "train.crop_samples", 1024)


class _Built(Exception):
    """Raised by a patched step builder once it has seen its models."""


def _capture(monkeypatch, module, name, n_models):
    seen = {}

    def fake(*args, **kwargs):
        seen["models"] = args[:n_models]
        raise _Built

    monkeypatch.setattr(module, name, fake)
    return seen


def _teacher_train(monkeypatch, tmp_path):
    from pwn_vocoder.training import loop

    seen = _capture(monkeypatch, loop, "make_teacher_train_step", 1)
    with pytest.raises(_Built):
        loop.run_teacher_training(CFG, num_steps=1)
    return seen["models"]


def _distill(monkeypatch, tmp_path):
    from pwn_vocoder.models.teacher import init_teacher
    from pwn_vocoder.training import loop

    seen = _capture(monkeypatch, loop, "make_distill_train_step", 2)
    t_params = init_teacher(CFG, jax.random.PRNGKey(0))[1]["params"]
    with pytest.raises(_Built):
        loop.run_distillation(CFG, t_params, num_steps=1)
    return seen["models"]


def _direct(monkeypatch, tmp_path):
    from pwn_vocoder.training import loop, student_direct

    seen = _capture(monkeypatch, student_direct,
                    "make_student_direct_train_step", 1)
    with pytest.raises(_Built):
        loop.run_student_direct_training(CFG, num_steps=1)
    return seen["models"]


def _probe(monkeypatch, tmp_path):
    from pwn_vocoder.training import teacher_select

    seen = _capture(monkeypatch, teacher_select,
                    "make_distill_train_step", 2)
    with pytest.raises(_Built):
        teacher_select.probe_teacher_checkpoints(
            CFG, str(tmp_path), candidates=[1], probe_steps=1)
    return seen["models"]


@pytest.mark.parametrize("site,build,n", [
    ("teacher training", _teacher_train, 1),
    ("distillation (student, frozen teacher)", _distill, 2),
    ("direct student training", _direct, 1),
    ("teacher-selection probe (student, frozen teacher)", _probe, 2),
])
def test_training_sites_use_unrolled_stack(monkeypatch, tmp_path, site,
                                           build, n):
    models = build(monkeypatch, tmp_path)
    assert len(models) == n
    assert all(m.use_scan is False for m in models), site


@pytest.fixture
def recorded_paths(monkeypatch):
    """Names of the layer paths traced while the test runs."""
    calls = []
    for name in ("scan_layers", "unrolled_layers"):
        orig = getattr(modules, name)

        def rec(*args, _orig=orig, _name=name, **kwargs):
            calls.append(_name)
            return _orig(*args, **kwargs)

        monkeypatch.setattr(modules, name, rec)
    return calls


def _mel(frames, batch=1):
    return np.random.default_rng(0).uniform(
        0, 1, (batch, frames, CFG.dsp.n_mels)).astype(np.float32)


def _generate(cfg, params):
    from pwn_vocoder.generate import generate_student

    generate_student(cfg, params, _mel(4), jax.random.PRNGKey(1))


def _stream(cfg, params):
    from pwn_vocoder.generate import stream_student_chunks

    list(stream_student_chunks(cfg, params, _mel(64),
                               key=jax.random.PRNGKey(1), chunk_frames=8,
                               cover_tail=True))


def _vocode(cfg, params):
    from pwn_vocoder.generate import vocode_many

    vocode_many(cfg, params, [_mel(40)[0], _mel(5)[0]],
                jax.random.PRNGKey(1), batch_size=2, bucket_frames=8)


def _batched_window(cfg, params):
    from pwn_vocoder.generate import (
        _batched_stream_window_fn,
        _stream_geometry,
    )

    WF = _stream_geometry(cfg, 8)[4]
    fn = _batched_stream_window_fn(cfg, 8, 2)
    np.asarray(fn(params, _mel(WF, 2), np.zeros((2, 2), np.uint32),
                  np.zeros(2, np.int32), np.zeros(2, np.int32),
                  np.zeros(2, np.int32), np.ones(2, np.float32)))


@pytest.mark.parametrize("site", [_generate, _stream, _vocode,
                                  _batched_window])
def test_inference_sites_use_scan_stack(recorded_paths, site):
    # a config no other test uses, so the cached jits trace afresh here
    cfg = override(CFG, "train.seed", 4242)
    params = init_student(cfg, jax.random.PRNGKey(0))[1]["params"]
    site(cfg, params)
    assert recorded_paths and set(recorded_paths) == {"scan_layers"}
