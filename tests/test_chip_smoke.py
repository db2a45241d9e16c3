"""chip_smoke.py off the GPU: it refuses to run (no result line), and its
phase helpers run end to end on tiny_teacher, on the CPU and on a CPU
mesh, with every reference comparison inside its tolerance."""

import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# global batch 8: the CLI's mesh spans all 8 CPU test devices
TINY = ["train.crop_samples=1024", "train.global_batch_size=8"]


def _load():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load()


def test_chip_smoke_exits_nonzero_without_gpu(capsys, monkeypatch):
    monkeypatch.setenv("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.75")
    assert cs.main([]) != 0
    assert cs.main(["--four-gpu"]) != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "needs a GPU" in out.err


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """Copied into a directory without the package, it fails and prints
    no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_compare_reports_and_rejects():
    ref = np.linspace(-1, 1, 100)
    err = cs.compare("x", ref * (1 + 1e-3), ref, 1e-2)
    assert err["rel_l2"] == pytest.approx(1e-3, rel=1e-6)
    assert err["max_abs"] == pytest.approx(1e-3, rel=1e-6)
    with pytest.raises(cs.PhaseFailure, match="rel_l2"):
        cs.compare("x", ref * 1.1, ref, 1e-2)
    with pytest.raises(cs.PhaseFailure, match="non-finite"):
        cs.compare("x", np.full(100, np.nan), ref, 1e-2)
    with pytest.raises(cs.PhaseFailure, match="shape"):
        cs.compare("x", ref[:50], ref, 1e-2)


def test_student_params_condition_only_flow_heads():
    from pwn_vocoder.config import get_config
    from pwn_vocoder.models.student import init_student

    cfg = get_config("tiny_teacher")
    base = init_student(cfg, jax.random.PRNGKey(3))[1]["params"]
    p = cs.student_params(cfg, 3)
    for name in p:
        for path, leaf in jax.tree_util.tree_flatten_with_path(p[name])[0]:
            want = base[name]
            for k in path:
                want = want[k.key]
            scale = 0.1 if (name.startswith("flow_") and jax.tree_util.keystr(
                path) == "['head2']['kernel']") else 1.0
            np.testing.assert_allclose(np.asarray(leaf),
                                       np.asarray(want) * scale, rtol=1e-6)


def test_phase_generation_on_tiny_teacher(tmp_path):
    out = cs.phase_generation("tiny_teacher", batch=2, seconds=0.25,
                              reps=1, trace_dir=str(tmp_path / "trace"))
    assert out["rel_l2"] <= cs.GEN_REL_L2_TOL
    assert out["samples"] == 31 * 128 and out["median_ms"] > 0
    assert "top_ops" in out  # no GPU plane on the CPU: an empty list


def test_top_ops_reduces_a_recorded_trace(tmp_path):
    from pwn_vocoder.utils.profiling import op_times_ns, xplane_files

    f = jax.jit(lambda x: jnp.tanh(x @ x).sum())
    x = jnp.ones((128, 128))
    f(x).block_until_ready()
    jax.profiler.start_trace(str(tmp_path))
    for _ in range(2):
        f(x).block_until_ready()
    jax.profiler.stop_trace()
    (path,) = xplane_files(str(tmp_path))
    host = op_times_ns(path, plane_prefix="/host:CPU")
    assert any("dot" in name and ns > 0 for name, ns in host.items())
    assert op_times_ns(path) == {}  # no GPU plane here
    total, ranked = cs.top_ops(str(tmp_path))
    assert total == 0.0 and ranked == []


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """phase_training's three CLI runs on tiny_teacher; the persistent
    compile cache stays off (JAX_COMPILATION_CACHE_DIR is left to JAX,
    which read it, unset, at import)."""
    wd = str(tmp_path_factory.mktemp("smoke"))
    prior = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    os.environ["JAX_COMPILATION_CACHE_DIR"] = os.path.join(wd, "cache")
    try:
        out = cs.phase_training(wd, "tiny_teacher", "tiny_teacher",
                                overrides=TINY)
    finally:
        if prior is None:
            del os.environ["JAX_COMPILATION_CACHE_DIR"]
        else:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = prior
    return wd, out


def test_phase_training_on_tiny_teacher(trained):
    wd, out = trained
    for k in ("teacher", "distill", "direct"):
        assert out[f"{k}_loss_rel_err"] <= cs.TRAIN_LOSS_REL_TOL
        assert out[f"{k}_step"]["median_ms"] > 0
    # 2 steps, then a resume from the step-2 checkpoint for a third
    assert sorted(os.listdir(os.path.join(wd, "teacher", "ckpt_teacher"))) \
        == ["1", "2", "3"]


def test_phase_serve_on_tiny_teacher(trained):
    wd, _ = trained
    out = cs.phase_serve("tiny_teacher", os.path.join(wd, "student"),
                         seconds=2.0, overrides=TINY)
    assert len(out["requests"]) == 4
    assert out["health"]["batch_rows"] > out["health"]["batch_calls"]


def test_phase_teacher_ar_on_tiny_teacher(trained):
    wd, _ = trained
    out = cs.phase_teacher_ar("tiny_teacher", os.path.join(wd, "teacher"),
                              batch=2, seconds=0.05,
                              overrides=cs.TRAIN_OVERRIDES + TINY)
    assert out["agree"] >= cs.AR_AGREE_MIN
    assert out["samples"] == 6 * 128


@pytest.mark.distributed
def test_phase_dp_grads_on_cpu_mesh():
    out = cs.phase_dp_grads("tiny_teacher", n_devices=4, global_batch=8,
                            overrides=TINY[:1])
    assert out["rel_l2"] <= cs.DP_GRAD_REL_L2_TOL


@pytest.mark.distributed
def test_phase_dp_steps_on_cpu_mesh(capsys):
    out = cs.phase_dp_steps("tiny_teacher", n_devices=4,
                            per_device_batch=1, steps=1, overrides=TINY[:1])
    assert out["global_batch"] == 4 and out["median_ms"] > 0
    assert "cut: global batch 1 -> 4" in capsys.readouterr().out


@pytest.mark.distributed
def test_phase_sharded_generation_on_cpu_mesh():
    out = cs.phase_sharded_generation("tiny_teacher", n_devices=4, batch=4,
                                      seconds=0.25)
    assert out["rel_l2"] <= cs.SHARDED_GEN_REL_L2_TOL
