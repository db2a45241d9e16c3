"""TRUE multi-process distributed test (SURVEY.md §2d / §4 "Distributed"
row; VERDICT r1 missing item 2).

Launches TWO real OS processes, each with 4 virtual CPU devices, joined
via `jax.distributed.initialize` (through `ensure_distributed()`), and
runs one teacher train step on a global 8-utterance batch partitioned
per-host.  Gradients sync over actual cross-process Gloo collectives.
The result must match a single-process 8-device run on the concatenated
batch — proving `shard_batch`'s make_array_from_process_local_data
branch and the env-var bring-up path end to end.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = os.path.join(os.path.dirname(__file__), "two_process_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_step_matches_single_process(tmp_path):
    port = _free_port()
    out = str(tmp_path / "proc0.npz")
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
        procs.append(
            subprocess.Popen(
                [sys.executable, WORKER, out],
                env=env, cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
        )
    logs = []
    for p in procs:
        stdout, _ = p.communicate(timeout=300)
        logs.append(stdout)
    assert all(p.returncode == 0 for p in procs), "\n\n".join(logs)
    two_proc = np.load(out)

    # single-process reference: same global batch on this process's
    # 8 virtual devices (conftest), same code path
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
    state = create_train_state(variables["params"], cfg.train)
    step_fn = make_teacher_train_step(model, cfg, mesh=mesh)
    ds = SyntheticTones(8, 2048, cfg.dsp.sample_rate, seed=123)
    full = np.stack([ds[i][:1024] for i in range(8)]).astype(np.float32)

    # replicated reference for the worker's cross-process-TP phase
    # (same init params + batch, loss/grad-norm before any step)
    from pwn_vocoder.training.common import global_norm
    from pwn_vocoder.training.teacher import prepare_batch

    @jax.jit
    def loss_gnorm(params, wav):
        x, mel = prepare_batch(wav, cfg)

        def loss_fn(p):
            return model.apply({"params": p}, x, mel, method="loss")

        loss, grads = jax.value_and_grad(loss_fn)(params)
        return loss, global_norm(grads)

    ref_loss, ref_gnorm = map(
        float, loss_gnorm(variables["params"], jax.numpy.asarray(full))
    )

    state, metrics = step_fn(state, shard_batch(mesh, full))

    np.testing.assert_allclose(
        float(metrics["loss"]), float(two_proc["loss"]), rtol=1e-5
    )
    leaves = jax.tree.leaves(jax.device_get(state.params))
    means = np.array([np.float64(np.mean(x)) for x in leaves])
    np.testing.assert_allclose(means, two_proc["means"], rtol=1e-4,
                               atol=1e-7)

    # TP across the process boundary ≡ replicated single-process
    np.testing.assert_allclose(float(two_proc["tp_loss"]), ref_loss,
                               rtol=2e-5)
    np.testing.assert_allclose(float(two_proc["tp_gnorm"]), ref_gnorm,
                               rtol=2e-3)
