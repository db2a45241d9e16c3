"""Worker for the LOOP-LEVEL multi-process test
(tests/test_multiprocess_loop.py; VERDICT r4 item 3).

Unlike tests/two_process_worker.py (one hand-rolled train step), this
drives the REAL `training/loop.py::run_teacher_training` orchestration —
per-host input partitioning, prefetch, multi-host checkpointing,
held-out eval, metrics logging — across two OS processes for hundreds of
steps, so a mid-run SIGKILL + resume exercises the production
failure-recovery path end to end.

argv: workdir num_steps global_batch crop_samples [mode teacher_workdir]
  mode: "teacher" (default) runs run_teacher_training; "distill" runs
  run_distillation against the frozen teacher checkpoint found in
  teacher_workdir (written beforehand by the launching test).
Env: JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID (+ 4
virtual CPU devices per process, set by the launching test).
"""

import sys


def micro_config(global_batch: int, crop: int):
    """A minutes-not-hours teacher+student for 200-step CPU loop runs:
    1 block x 3 layers, 16 ch (2 flows x 3 for the student).  Shapes
    still flow through the full pipeline (mel conditioning, upsampler,
    MoL head / IAF flows)."""
    from pwn_vocoder.config import get_config, override

    cfg = get_config("tiny_teacher")
    for k, v in {
        "teacher.n_blocks": 1,
        "teacher.layers_per_block": 3,
        "teacher.residual_channels": 16,
        "teacher.gate_channels": 32,
        "teacher.skip_channels": 16,
        "student.n_flows": 2,
        "student.layers_per_flow": 3,
        "student.residual_channels": 16,
        "student.gate_channels": 32,
        "student.skip_channels": 16,
        "train.crop_samples": crop,
        "train.global_batch_size": global_batch,
        "train.checkpoint_every": 50,
        "train.log_every": 10,
        "train.eval_sample_seconds": 0.02,
        "train.tensorboard": False,
    }.items():
        cfg = override(cfg, k, v)
    return cfg


def main() -> int:
    workdir, num_steps, global_batch, crop = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
    )
    mode = sys.argv[5] if len(sys.argv) > 5 else "teacher"

    import jax

    jax.config.update("jax_platforms", "cpu")

    from pwn_vocoder.parallel.mesh import ensure_distributed

    ensure_distributed()
    assert jax.process_count() == 2, jax.process_count()

    cfg = micro_config(global_batch, crop)
    if mode == "distill":
        from pwn_vocoder.training.loop import (
            load_teacher_params,
            run_distillation,
        )

        _, t_params, _ = load_teacher_params(cfg, sys.argv[6])
        res = run_distillation(cfg, t_params, workdir=workdir,
                               num_steps=num_steps)
    else:
        from pwn_vocoder.training.loop import run_teacher_training

        res = run_teacher_training(cfg, workdir=workdir,
                                   num_steps=num_steps)
    print(f"proc {jax.process_index()} done: steps_run={res.steps_run} "
          f"final_loss={res.final_metrics.get('loss'):.6f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
