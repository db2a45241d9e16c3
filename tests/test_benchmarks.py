"""Bench self-validation tests: the host-clock timer, the physical-bounds
gate, the device-kind peak table, and the refusal to measure anywhere but
on a GPU with a known peak."""

import importlib.util
import os
import time

import numpy as np
import pytest

from pwn_vocoder.benchmarks import (
    PEAKS,
    _plausibility_check,
    dp_equivalence_check,
    peak_for,
    run_bench,
    time_call,
)
from pwn_vocoder.config import get_config, override

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_plausibility_rejects_sub_floor_step():
    # 1 TFLOP of work in 1 us would be 1000 TFLOP/s >> any published peak
    err = _plausibility_check(
        step_ms=0.001, flops_per_step=1e12, peak_tflops=989.0
    )
    assert err is not None and "floor" in err
    # a zero step time is never a measurement
    assert _plausibility_check(0.0, 1e12, 989.0) is not None
    # a sane number passes: 1e12 FLOPs in 10 ms = 100 TFLOP/s < 989 peak
    assert _plausibility_check(10.0, 1e12, 989.0) is None
    # no peak given: only the positivity check applies
    assert _plausibility_check(10.0, 1e12, None) is None
    assert _plausibility_check(-1.0, 1e12, None) is not None


@pytest.mark.parametrize("kind,bf16,hbm", [
    ("NVIDIA H100 80GB HBM3", 989.0, 3.35),   # SXM5
    ("NVIDIA H100 PCIe", 756.0, 2.0),
])
def test_peak_table_knows_h100(kind, bf16, hbm):
    assert peak_for(kind) == {"bf16_tflops": bf16, "hbm_tb_per_s": hbm}


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H100", "nvidia h100 80gb hbm3",
                                  ""])
def test_peak_table_unknown_kind_raises(kind):
    """An unknown device is an error, never a guessed peak (no substring
    or case-insensitive matching)."""
    assert kind not in PEAKS
    with pytest.raises(KeyError, match="no published peak"):
        peak_for(kind)


def test_time_call_warms_up_then_takes_median():
    calls = []

    def run():
        calls.append(time.perf_counter())
        time.sleep(0.02 if len(calls) <= 2 else 0.005)
        return np.float32(len(calls))

    t = time_call(run, reps=5, warmup=2)
    assert len(calls) == 7  # 2 untimed warm-up calls + 5 timed
    assert t["reps"] == 5
    # the slow warm-up calls are excluded from the statistics
    assert 4.0 < t["median_ms"] < 15.0
    assert t["min_ms"] <= t["median_ms"] <= t["max_ms"] < 20.0


def test_time_call_waits_for_device_work():
    """The timed region ends in block_until_ready: a jitted computation
    is timed to completion, and its outputs pass through."""
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: (x @ x).sum())
    x = jnp.ones((256, 256))
    out = []
    t = time_call(lambda: out.append(f(x)) or out[-1], reps=3, warmup=1)
    assert len(out) == 4 and float(out[-1]) == 256.0 ** 3
    assert t["median_ms"] > 0.0


def test_run_bench_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        run_bench("tiny_teacher")


def test_bench_script_exits_nonzero_off_gpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "bench_script", os.path.join(REPO, "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    assert bench.main() != 0
    out = capsys.readouterr()
    assert out.out == ""  # no result line
    assert "needs a GPU" in out.err


@pytest.mark.distributed
def test_dp_equivalence_check_passes_on_sim_mesh():
    """The DP audit must itself pass on the 8-virtual-device mesh."""
    cfg = override(get_config("tiny_teacher"), "train.crop_samples", 1024)
    cfg = override(cfg, "train.global_batch_size", 8)
    out = dp_equivalence_check(cfg)
    assert out["pass"], out
    assert out["devices"] == 8
