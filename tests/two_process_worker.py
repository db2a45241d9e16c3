"""Worker for the REAL multi-process distributed test
(tests/test_multiprocess.py; SURVEY.md §2d / §4 "Distributed" row).

Launched twice with JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
JAX_PROCESS_ID set and 4 virtual CPU devices each.  Exercises the true
multi-host code paths that single-process tests cannot:
`ensure_distributed()` -> `jax.distributed.initialize`, the global
(8-device, 2-process) mesh, per-host corpus partitioning semantics, and
`shard_batch`'s `make_array_from_process_local_data` branch.

Phase 1: one DP teacher train step (gradients sync over Gloo).
Phase 2: TP forward+grads with the model axis SPANNING the processes
(the Megatron psum actually crossing a process boundary).

Writes (loss, per-leaf param means after the step, tp_loss, tp_gnorm)
to the npz given as argv[1] from process 0.
"""

import sys


def main() -> int:
    out_path = sys.argv[1]

    import jax

    jax.config.update("jax_platforms", "cpu")

    from pwn_vocoder.parallel.mesh import ensure_distributed

    ensure_distributed()  # must run before any backend-touching call
    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 8 and jax.local_device_count() == 4

    import numpy as np

    from pwn_vocoder.config import get_config, override
    from pwn_vocoder.data import SyntheticTones
    from pwn_vocoder.models.teacher import init_teacher
    from pwn_vocoder.parallel.mesh import make_mesh, shard_batch
    from pwn_vocoder.training.common import create_train_state
    from pwn_vocoder.training.teacher import make_teacher_train_step

    cfg = get_config("tiny_teacher")
    cfg = override(cfg, "train.crop_samples", 1024)
    cfg = override(cfg, "train.global_batch_size", 8)

    mesh = make_mesh(cfg.mesh)
    model, variables = init_teacher(
        cfg, jax.random.PRNGKey(0), use_scan=False
    )
    # host copy BEFORE the train step donates/deletes the buffers
    # (phase 2 below reuses the initial params)
    params0 = jax.tree.map(np.asarray, variables["params"])
    state = create_train_state(variables["params"], cfg.train)
    step_fn = make_teacher_train_step(model, cfg, mesh=mesh)

    # deterministic global batch; each process holds only its own half
    # (per-host partition, NOT duplication)
    ds = SyntheticTones(8, 2048, cfg.dsp.sample_rate, seed=123)
    full = np.stack([ds[i][:1024] for i in range(8)]).astype(np.float32)
    pid = jax.process_index()
    local = full[pid * 4 : (pid + 1) * 4]
    batch = shard_batch(mesh, local)
    assert batch.shape == (8, 1024), batch.shape  # global shape

    state, metrics = step_fn(state, batch)

    leaves = jax.tree.leaves(jax.device_get(state.params))
    means = np.array([np.float64(np.mean(x)) for x in leaves])

    # ---- phase 2: TP with the model axis SPANNING the two processes
    # (every single-process TP test keeps shards host-local; this is the
    # only place the Megatron psum actually crosses a process boundary)
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from pwn_vocoder.parallel.tp import state_shardings, validate_tp
    from pwn_vocoder.training.common import global_norm
    from pwn_vocoder.training.teacher import prepare_batch

    tp_mesh = Mesh(
        np.array(jax.devices()).reshape(1, 8), ("data", "model")
    )
    validate_tp(cfg.teacher.gate_channels, tp_mesh)
    shardings = state_shardings(params0, tp_mesh)
    rep = NamedSharding(tp_mesh, P())

    def put(x, sh):
        x = np.asarray(x)
        return jax.make_array_from_callback(
            x.shape, sh, lambda idx: x[idx]
        )

    tp_params = jax.tree.map(put, params0, shardings)
    wav_g = jax.make_array_from_callback(
        full.shape, rep, lambda idx: full[idx]
    )

    @jax.jit
    def tp_loss_gnorm(params, wav):
        x, mel = prepare_batch(wav, cfg)

        def loss_fn(p):
            return model.apply({"params": p}, x, mel, method="loss")

        loss, grads = jax.value_and_grad(loss_fn)(params)
        return loss, global_norm(grads)

    tp_loss, tp_gnorm = tp_loss_gnorm(tp_params, wav_g)
    tp_loss, tp_gnorm = float(tp_loss), float(tp_gnorm)

    if pid == 0:
        np.savez(out_path, loss=float(metrics["loss"]), means=means,
                 tp_loss=tp_loss, tp_gnorm=tp_gnorm)
    # every process must agree the step ran
    print(f"proc {pid} loss {float(metrics['loss']):.6f} "
          f"tp_loss {tp_loss:.6f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
