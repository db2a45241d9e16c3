"""Distillability-aware teacher selection (training/teacher_select.py;
VERDICT r4 item 5): checkpoint ladder retention, probe mechanics,
EMA/live restore routing."""

import os
import sys

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
from loop_worker import micro_config  # noqa: E402

from pwn_vocoder.config import override  # noqa: E402


def _cfg():
    # batch divisible by the 8 virtual devices (conftest mesh)
    cfg = micro_config(global_batch=8, crop=512)
    for k, v in {
        "train.checkpoint_every": 2,
        "train.keep_checkpoints": 3,
        "train.ema_decay": 0.99,
        "student.n_flows": 2,
        "student.layers_per_flow": 3,
        "student.residual_channels": 16,
        "student.gate_channels": 32,
        "student.skip_channels": 16,
    }.items():
        cfg = override(cfg, k, v)
    return cfg


def test_ladder_probe_and_selection(tmp_path):
    from pwn_vocoder.training.loop import (
        load_teacher_params,
        run_teacher_training,
        teacher_checkpoint_steps,
    )
    from pwn_vocoder.training.teacher_select import (
        probe_teacher_checkpoints,
        select_teacher_step,
    )

    cfg = _cfg()
    wd = str(tmp_path / "teacher")
    run_teacher_training(cfg, workdir=wd, num_steps=6)

    # keep_checkpoints retains the ladder (every 2 steps, max 3)
    assert teacher_checkpoint_steps(wd) == [2, 4, 6]

    results = probe_teacher_checkpoints(cfg, wd, probe_steps=2)
    assert [r["teacher_step"] for r in results] == [2, 4, 6]
    assert all(np.isfinite(r["val_kl"]) for r in results)

    best = select_teacher_step(cfg, wd, probe_steps=2,
                               candidates=[2, 6])
    assert best in (2, 6)

    # step selection + EMA/live routing in the restore path
    _, p_ema, s = load_teacher_params(cfg, wd, step=4, prefer_ema=True)
    _, p_live, s2 = load_teacher_params(cfg, wd, step=4,
                                        prefer_ema=False)
    assert s == s2 == 4
    leaves_e = jax.tree.leaves(p_ema)
    leaves_l = jax.tree.leaves(p_live)
    assert any(
        not np.allclose(np.asarray(a), np.asarray(b))
        for a, b in zip(leaves_e, leaves_l)
    ), "EMA and live params should differ after optimizer steps"
