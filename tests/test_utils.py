"""Utility-layer tests: metrics jsonl, checkpoint manager, config system
edge cases, audio I/O."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pwn_vocoder.config import get_config, override, to_dict
from pwn_vocoder.utils.audio_io import read_wav, write_wav
from pwn_vocoder.utils.checkpoint import CheckpointManager
from pwn_vocoder.utils.metrics import MetricsLogger


def test_metrics_logger_jsonl(tmp_path):
    path = str(tmp_path / "m.jsonl")
    logger = MetricsLogger(path, echo=False)
    logger.log(0, loss=1.5, note="warm")
    logger.log(10, loss=jnp.float32(0.25))
    logger.close()
    recs = [json.loads(line) for line in open(path)]
    assert recs[0]["step"] == 0 and recs[0]["loss"] == 1.5
    assert recs[0]["note"] == "warm"
    assert recs[1]["loss"] == 0.25
    assert "wall_s" in recs[1]


def test_checkpoint_manager_roundtrip(tmp_path):
    mngr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    state = {"w": jnp.arange(6.0).reshape(2, 3), "step": jnp.asarray(3)}
    mngr.save(3, jax.device_get(state))
    assert mngr.latest_step() == 3
    template = {"w": jnp.zeros((2, 3)), "step": jnp.asarray(0)}
    restored, step = mngr.restore(template)
    assert step == 3
    np.testing.assert_array_equal(np.asarray(restored["w"]),
                                  np.asarray(state["w"]))
    # max_to_keep prunes old steps
    mngr.save(4, jax.device_get(state))
    mngr.save(5, jax.device_get(state))
    assert mngr.latest_step() == 5
    assert mngr.all_steps() == [4, 5]

    empty = CheckpointManager(str(tmp_path / "nothing"))
    with pytest.raises(FileNotFoundError):
        empty.restore(template)


def test_config_round_trips_and_properties():
    cfg = get_config("teacher_lj")
    d = to_dict(cfg)
    assert d["teacher"]["n_blocks"] == 3
    assert cfg.teacher.n_layers == 24
    assert cfg.teacher.dilations[:9] == (1, 2, 4, 8, 16, 32, 64, 128, 1)
    assert cfg.teacher.receptive_field > 500
    assert cfg.dsp.fmax_hz == cfg.dsp.sample_rate / 2
    # tuple override coercion
    c2 = override(cfg, "teacher.upsample_strides", "(8,32)")
    assert c2.teacher.upsample_strides == (8, 32)
    with pytest.raises(KeyError):
        override(cfg, "teacher.not_a_field", 1)

    # the measured best-recipe preset (BASELINE.md r5) carries every
    # quality lever; student_iaf keeps the plain golden-pinned loss
    best = get_config("student_iaf_best")
    assert best.distill.contrastive_weight == 0.3
    assert best.distill.kl_warmup_steps == 1000
    assert len(best.distill.power_loss_resolutions) == 2
    assert best.train.ema_decay > 0
    assert best.train.keep_checkpoints == 10
    plain = get_config("student_iaf")
    assert plain.distill.contrastive_weight == 0.0
    assert plain.distill.power_loss_resolutions == ()


def test_audio_io_clipping_and_stereo(tmp_path):
    # overdriven audio is peak-normalized, not wrapped
    loud = np.sin(np.linspace(0, 60, 4000)).astype(np.float32) * 2.0
    p = str(tmp_path / "loud.wav")
    write_wav(p, loud, 16000)
    back, sr = read_wav(p)
    assert sr == 16000
    assert np.abs(back).max() <= 1.0
    # resampling path
    back2, sr2 = read_wav(p, target_sr=8000)
    assert sr2 == 8000 and abs(len(back2) - 2000) <= 2


def test_mesh_rejects_uncovered_devices():
    from pwn_vocoder.config import MeshConfig
    from pwn_vocoder.parallel import make_mesh

    with pytest.raises(ValueError):
        make_mesh(MeshConfig(data=2, model=2))  # 4 != 8 devices


def test_flops_model_and_peak_lookup():
    """Analytic FLOPs model (bench MFU): monotone in model size, and the
    peak table knows no CPU device kind."""
    import jax

    from pwn_vocoder.benchmarks import (
        peak_for,
        student_gen_flops_per_sample,
        teacher_fwd_flops_per_sample,
    )
    from pwn_vocoder.config import get_config

    tiny = teacher_fwd_flops_per_sample(get_config("tiny_teacher"))
    lj = teacher_fwd_flops_per_sample(get_config("teacher_lj"))
    assert 0 < tiny < lj
    s = student_gen_flops_per_sample(get_config("student_iaf"))
    big = student_gen_flops_per_sample(get_config("large_student_sharded"))
    assert 0 < s < big
    with pytest.raises(KeyError):
        peak_for(jax.devices()[0].device_kind)  # cpu test env


def test_persistent_compilation_cache_config(monkeypatch, tmp_path):
    """Entry-point cache rule: JAX_COMPILATION_CACHE_DIR, when set, is
    left to JAX untouched; otherwise the cache goes to <repo>/.jax_cache.
    """
    import os

    import jax

    import pwn_vocoder
    from pwn_vocoder.utils.compile_cache import (
        DEFAULT_CACHE_DIR,
        enable_compile_cache,
    )

    repo = os.path.dirname(os.path.dirname(os.path.abspath(
        pwn_vocoder.__file__)))
    assert DEFAULT_CACHE_DIR == os.path.join(repo, ".jax_cache")
    prior = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "x"))
        assert enable_compile_cache() == str(tmp_path / "x")
        assert jax.config.jax_compilation_cache_dir is None

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        assert enable_compile_cache() == DEFAULT_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == DEFAULT_CACHE_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", prior)
