"""Distillability-aware teacher-checkpoint selection (VERDICT r4
next-item 5).

BASELINE.md r4 measured that teacher quality and distillability are
separate axes: a 40k-step teacher (better val NLL, 4.72 vs 5.64)
distilled to val KL ~1.0 where the 20k teacher reached 0.306 — a 3x
regression from picking "the best" teacher checkpoint.  The reference
had no notion of this [R]; this module makes the safe choice automatic:
distill a FRESH student for a few hundred steps against each retained
teacher checkpoint and pick the one with the lowest held-out
distillation KL.

The probe is cheap by construction: the distill step function takes the
frozen teacher params as an ARGUMENT, so all candidates share one
compiled step.

CLI: `distill-student <case> --teacher-step auto` (see cli.py).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import jax

from pwn_vocoder.config import Config
from pwn_vocoder.models.student import init_student
from pwn_vocoder.models.teacher import make_teacher
from pwn_vocoder.parallel import make_mesh, shard_batch
from pwn_vocoder.training.common import create_train_state
from pwn_vocoder.training.distill import (
    make_distill_eval_step,
    make_distill_train_step,
)


def probe_teacher_checkpoints(
    cfg: Config,
    teacher_workdir: str,
    teacher_cfg: Optional[Config] = None,
    data_dir: Optional[str] = None,
    probe_steps: int = 500,
    candidates: Optional[List[int]] = None,
    prefer_ema: bool = True,
) -> List[Dict[str, Any]]:
    """Short-distill every candidate teacher checkpoint; return per-step
    held-out metrics, ascending by teacher step.

    Each candidate gets an identically-seeded fresh student and the
    identical data stream, so the only varying factor is the teacher.
    """
    import os

    from pwn_vocoder.data import make_train_iterator
    from pwn_vocoder.data.pipeline import local_batch_size
    from pwn_vocoder.training.loop import (
        abstract_state_template,
        build_dataset,
        make_val_batch,
        teacher_checkpoint_steps,
    )

    tcfg = teacher_cfg or cfg
    if candidates is None:
        candidates = teacher_checkpoint_steps(teacher_workdir)
    if not candidates:
        raise FileNotFoundError(
            f"no teacher checkpoints under {teacher_workdir}"
        )

    mesh = make_mesh(cfg.mesh)
    # training-step paths, as in run_distillation
    teacher = make_teacher(tcfg, use_scan=False)
    student, s_vars = init_student(
        cfg, jax.random.PRNGKey(cfg.train.seed + 1), use_scan=False,
    )
    s_params0 = jax.device_get(s_vars["params"])
    step_fn = make_distill_train_step(student, teacher, cfg, mesh=mesh)
    eval_step = make_distill_eval_step(student, teacher, cfg, mesh=mesh)

    lbs = local_batch_size(cfg.train.global_batch_size)
    val_batch = make_val_batch(cfg, data_dir, lbs)
    dataset = build_dataset(cfg, data_dir)
    rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())

    # one abstract template + manager reused across candidate restores
    t_template = abstract_state_template(tcfg, "teacher")
    from pwn_vocoder.training.common import serving_params
    from pwn_vocoder.utils.checkpoint import CheckpointManager

    mngr = CheckpointManager(
        os.path.join(os.path.abspath(teacher_workdir), "ckpt_teacher")
    )

    results: List[Dict[str, Any]] = []
    for t_step in sorted(candidates):
        t_state, _ = mngr.restore(t_template, step=t_step)
        t_params = (serving_params(t_state) if prefer_ema
                    else t_state.params)
        t_params = jax.device_put(t_params, rep)
        state = create_train_state(
            s_params0, cfg.train,
            rng=jax.random.PRNGKey(cfg.train.seed + 2),
        )
        it = make_train_iterator(dataset, cfg, lbs,
                                 seed=cfg.train.seed, start_step=0)
        for _ in range(probe_steps):
            state, _m = step_fn(state, t_params, shard_batch(mesh, next(it)))
        val = {f"val_{k}": float(v)
               for k, v in eval_step(state.params, t_params,
                                     val_batch).items()}
        results.append({"teacher_step": int(t_step), **val})
        print(f"[teacher-probe] step {t_step}: "
              f"val_kl {val.get('val_kl', float('nan')):.4f} "
              f"val_power {val.get('val_power_loss', float('nan')):.4f}",
              flush=True)
    return results


def select_teacher_step(
    cfg: Config,
    teacher_workdir: str,
    teacher_cfg: Optional[Config] = None,
    data_dir: Optional[str] = None,
    probe_steps: int = 500,
    candidates: Optional[List[int]] = None,
    prefer_ema: bool = True,
    criterion: str = "val_loss",
) -> int:
    """The candidate teacher step with the lowest probe `criterion`.

    Default criterion is the TOTAL probe loss (KL + power at full
    weight), NOT the KL alone — measured r5 (BASELINE.md): an
    early/noisy teacher is the EASIEST to match in KL (probe val KL
    0.11 at teacher step 6k vs 0.92 at 20k) yet its distilled student
    inherits the teacher's noise floor (-6.4 dBFS vs the baseline's
    -37); the power term scores the student against the ground-truth
    waveform, which exposes exactly that failure.
    """
    results = probe_teacher_checkpoints(
        cfg, teacher_workdir, teacher_cfg=teacher_cfg, data_dir=data_dir,
        probe_steps=probe_steps, candidates=candidates,
        prefer_ema=prefer_ema,
    )
    best = min(results, key=lambda r: r.get(criterion, float("inf")))
    print(f"[teacher-probe] selected teacher step "
          f"{best['teacher_step']} ({criterion} "
          f"{best.get(criterion):.4f})", flush=True)
    return best["teacher_step"]
