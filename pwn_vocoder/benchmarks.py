"""Benchmark suite (SURVEY.md §6: primary metric = audio-seconds/s per
device for student IAF inference; secondary = training-step and teacher
AR sampling rates).

Timing: the host clock around work that ends in `block_until_ready`,
after warm-up calls that compile every shape the timed calls use; each
result is the median of `reps` timed calls, with the min and max beside
it.  Every rate is bound-checked against the analytic FLOPs floor at the
device's published peak (`_plausibility_check`).  The peak table is keyed
by `device_kind`; a device that is not in it is an error, and so is a
run that finds no GPU (`run_bench`).
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from pwn_vocoder.config import Config, get_config
from pwn_vocoder.data import SyntheticTones, make_train_iterator
from pwn_vocoder.models import sampling
from pwn_vocoder.models.student import init_student
from pwn_vocoder.models.teacher import init_teacher
from pwn_vocoder.training.common import create_train_state
from pwn_vocoder.training.teacher import prepare_batch

# Published dense (no sparsity) peaks, keyed by jax `device_kind`.
# Source: NVIDIA H100 Tensor Core GPU data sheet (SXM5 and PCIe parts).
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16_tflops": 989.0, "hbm_tb_per_s": 3.35},
    "NVIDIA H100 PCIe": {"bf16_tflops": 756.0, "hbm_tb_per_s": 2.0},
}


def peak_for(device_kind: str) -> Dict[str, float]:
    """Published peaks of `device_kind`; KeyError for an unknown device."""
    if device_kind not in PEAKS:
        raise KeyError(
            f"no published peak for device kind {device_kind!r} "
            f"(known: {sorted(PEAKS)})"
        )
    return PEAKS[device_kind]


def device_info() -> Dict[str, Any]:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def time_call(run: Callable[[], Any], reps: int = 10,
              warmup: int = 2) -> Dict[str, float]:
    """Median/min/max wall ms of `run()` (which returns the arrays its
    work produces), each call closed by `block_until_ready`."""
    for _ in range(warmup):
        jax.block_until_ready(run())
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        samples.append(time.perf_counter() - t0)
    ms = np.asarray(samples) * 1e3
    return {"median_ms": float(np.median(ms)), "min_ms": float(ms.min()),
            "max_ms": float(ms.max()), "reps": reps}


def _train_batch(cfg: Config, batch: int) -> jax.Array:
    ds = SyntheticTones(8, cfg.train.crop_samples, cfg.dsp.sample_rate)
    return jnp.asarray(next(make_train_iterator(ds, cfg, batch, seed=0)))


def measure_student_inference(
    cfg: Config, batch: int = 8, seconds: float = 2.0, reps: int = 10
) -> Dict[str, Any]:
    """Student parallel synthesis throughput: audio-seconds/s per device."""
    sr = cfg.dsp.sample_rate
    hop = cfg.dsp.hop_length
    frames = int(seconds * sr) // hop
    T = frames * hop
    model, variables = init_student(cfg, jax.random.PRNGKey(0))
    mel = jnp.asarray(
        np.random.default_rng(0)
        .uniform(0, 1, (batch, frames, cfg.dsp.n_mels))
        .astype(np.float32)
    )
    gen = jax.jit(lambda v, k, m: model.apply(v, k, m, method="generate"))
    key = jax.random.PRNGKey(1)
    t = time_call(lambda: gen(variables, key, mel), reps)
    return {"batch": batch, "samples": T, **t,
            "audio_sec_per_s_per_device":
                batch * T / sr / (t["median_ms"] / 1e3)}


def time_train_step(step, state, args, reps: int = 5,
                    warmup: int = 2) -> Dict[str, float]:
    """`time_call` of a donating `(state, *args) -> (state, metrics)`
    step, threading the state from call to call."""
    holder = [state]

    def run():
        holder[0], metrics = step(holder[0], *args)
        return metrics["loss"]

    return time_call(run, reps, warmup)


def measure_teacher_train(cfg: Config, reps: int = 5) -> Dict[str, Any]:
    """Teacher teacher-forcing training step: utterances/s."""
    from pwn_vocoder.training.teacher import make_teacher_train_step

    model, variables = init_teacher(cfg, jax.random.PRNGKey(0),
                                    use_scan=False)
    B = cfg.train.global_batch_size
    t = time_train_step(
        make_teacher_train_step(model, cfg),
        create_train_state(variables["params"], cfg.train),
        (_train_batch(cfg, B),), reps,
    )
    return {"batch": B, "crop_samples": cfg.train.crop_samples, **t,
            "utt_per_s": B / (t["median_ms"] / 1e3)}


def measure_distill_train(cfg: Config, reps: int = 5) -> Dict[str, Any]:
    """Distillation step (BASELINE config[3] workload): student fwd+bwd
    + frozen-teacher scoring per utterance batch."""
    from pwn_vocoder.training.distill import make_distill_train_step

    teacher, t_vars = init_teacher(cfg, jax.random.PRNGKey(0),
                                   use_scan=False)
    student, s_vars = init_student(cfg, jax.random.PRNGKey(1),
                                   use_scan=False)
    B = cfg.train.global_batch_size
    t = time_train_step(
        make_distill_train_step(student, teacher, cfg),
        create_train_state(s_vars["params"], cfg.train),
        (t_vars["params"], _train_batch(cfg, B)), reps,
    )
    return {"batch": B, "crop_samples": cfg.train.crop_samples, **t,
            "utt_per_s": B / (t["median_ms"] / 1e3)}


def measure_student_direct_train(cfg: Config,
                                 reps: int = 5) -> Dict[str, Any]:
    """Direct (teacher-free) student training step — the reference's WIP
    mode (SURVEY.md §2a low-confidence flag): IAF closed-form NLL +
    power loss."""
    from pwn_vocoder.training.student_direct import (
        make_student_direct_train_step,
    )

    student, s_vars = init_student(cfg, jax.random.PRNGKey(1),
                                   use_scan=False)
    B = cfg.train.global_batch_size
    t = time_train_step(
        make_student_direct_train_step(student, cfg),
        create_train_state(s_vars["params"], cfg.train),
        (_train_batch(cfg, B),), reps,
    )
    return {"batch": B, "crop_samples": cfg.train.crop_samples, **t,
            "utt_per_s": B / (t["median_ms"] / 1e3)}


def measure_teacher_ar_sampling(
    cfg: Config, batch: int = 8, seconds: float = 0.25, reps: int = 3
) -> Dict[str, Any]:
    """Teacher AR sampling through the conv-queue `lax.scan` sampler."""
    sr = cfg.dsp.sample_rate
    hop = cfg.dsp.hop_length
    frames = max(int(seconds * sr) // hop, 2)
    T = frames * hop
    model, variables = init_teacher(cfg, jax.random.PRNGKey(0))
    mel = jnp.asarray(
        np.random.default_rng(0)
        .uniform(0, 1, (batch, frames, cfg.dsp.n_mels))
        .astype(np.float32)
    )
    sample = jax.jit(
        lambda v, k, m: sampling.fast_sample(model, v, k, m)
    )
    key = jax.random.PRNGKey(1)
    t = time_call(lambda: sample(variables, key, mel), reps, warmup=1)
    return {"batch": batch, "samples": T, **t,
            "ar_us_per_step": t["median_ms"] * 1e3 / T,
            "ar_audio_sec_per_s": batch * T / sr / (t["median_ms"] / 1e3)}


# ---------------------------------------------------------------------------
# Analytic FLOPs model (SURVEY.md §6)
# ---------------------------------------------------------------------------


def _stack_macs_per_sample(C: int, G: int, S: int, M: int, L: int,
                           out_dim: int) -> float:
    """MACs per output timestep of one WaveNet stack (front 1x1 + L gated
    layers as two wide GEMMs + relu/1x1/1x1 head) — mirrors
    models/modules.py::gated_layer_xla exactly."""
    return (C                               # front 1x1 (1 -> C)
            + L * ((2 * C + M) * G          # gate GEMM [x|shift|cond]@w_in
                   + (G // 2) * (C + S))    # out GEMM z@[w_res|w_skip]
            + S * S + S * out_dim)          # head1 + head2


def _upsample_macs_per_sample(cfg: Config) -> float:
    """Transposed-conv mel upsampler MACs amortized per OUTPUT sample."""
    M = cfg.dsp.n_mels
    strides = list(cfg.teacher.upsample_strides)
    mult = cfg.teacher.upsample_kernel_mult
    total = 0.0
    for i, s in enumerate(strides):
        after = 1
        for s2 in strides[i + 1:]:
            after *= s2
        total += (s * mult) * M * M / after
    return total


def student_gen_flops_per_sample(cfg: Config) -> float:
    """Forward FLOPs per generated audio sample (all flows + upsampler)."""
    sc = cfg.student
    macs = cfg.student.n_flows * _stack_macs_per_sample(
        sc.residual_channels, sc.gate_channels, sc.skip_channels,
        cfg.dsp.n_mels, sc.layers_per_flow, out_dim=2,
    ) + _upsample_macs_per_sample(cfg)
    return 2.0 * macs


def teacher_fwd_flops_per_sample(cfg: Config) -> float:
    tc = cfg.teacher
    macs = _stack_macs_per_sample(
        tc.residual_channels, tc.gate_channels, tc.skip_channels,
        cfg.dsp.n_mels, tc.n_layers, out_dim=tc.head_dim,
    ) + _upsample_macs_per_sample(cfg)
    return 2.0 * macs


def _plausibility_check(step_ms: float, flops_per_step: float,
                        peak_tflops: float | None) -> Optional[str]:
    """Physical-bounds gate: a step cannot beat the published peak.

    Returns an error string for an impossible number, else None."""
    if step_ms <= 0.0:
        return f"non-positive step time ({step_ms} ms)"
    if peak_tflops is None:
        return None
    floor_ms = flops_per_step / (peak_tflops * 1e12) * 1e3
    if step_ms < floor_ms:
        return (f"step_ms {step_ms:.4f} below analytic FLOPs floor "
                f"{floor_ms:.4f} ms (would exceed {peak_tflops} TFLOP/s "
                "published peak) — measurement invalid")
    return None


def dp_equivalence_check(cfg: Config) -> Dict[str, Any]:
    """Pass/fail audit of the shard_map DP machinery: gradients from the
    per-device pmean path over ALL visible devices must equal the
    single-device gradients on the identical global batch."""
    from jax.sharding import Mesh, PartitionSpec as P

    devices = jax.devices()
    n = len(devices)
    model, variables = init_teacher(cfg, jax.random.PRNGKey(0),
                                    use_scan=False)
    params = variables["params"]
    B = max(cfg.train.global_batch_size, n)
    B -= B % n
    wav = _train_batch(cfg, B)

    def loss_grads(p, wav):
        x, mel = prepare_batch(wav, cfg)
        return jax.value_and_grad(
            lambda q: model.apply({"params": q}, x, mel, method="loss")
        )(p)

    ref_loss, ref_grads = jax.jit(loss_grads)(params, wav)

    mesh = Mesh(np.asarray(devices).reshape(n, 1), ("data", "model"))

    def dp(p, wav):
        loss, grads = loss_grads(p, wav)
        return jax.lax.pmean((loss, grads), "data")

    dp_loss, dp_grads = jax.jit(jax.shard_map(
        dp, mesh=mesh, in_specs=(P(), P("data")), out_specs=P(),
        check_vma=False,
    ))(params, wav)

    rel_errs = jax.tree.map(
        lambda a, b: float(
            jnp.max(jnp.abs(a - b)) / (jnp.max(jnp.abs(b)) + 1e-12)
        ),
        dp_grads, ref_grads,
    )
    max_rel = max(jax.tree.leaves(rel_errs))
    loss_rel = abs(float(dp_loss) - float(ref_loss)) / (
        abs(float(ref_loss)) + 1e-12
    )
    # tolerance matches tests/test_distributed.py: the per-shard pmean
    # changes fp32 reduction order, giving ~1e-4..1e-3 rel on grads
    ok = max_rel < 2e-3 and loss_rel < 1e-5
    return {"devices": n, "batch": B, "pass": bool(ok),
            "max_grad_rel_err": max_rel, "loss_rel_err": loss_rel,
            "note": "shard_map pmean grads vs single-device grads on the "
                    "identical global batch"}


def measure_scaling(cfg: Config, reps: int = 4):
    """DP weak-scaling table of the teacher loss+grad step over the
    locally visible devices (SURVEY.md §6 "measurement points: 1 device,
    1 host, N hosts"): per-device batch held at the 1-device global
    batch; ideal = flat step time, efficiency 1.0."""
    from jax.sharding import Mesh

    from pwn_vocoder.parallel.mesh import batch_sharding, replicated

    devices = jax.devices()
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devices)]
    model, variables = init_teacher(cfg, jax.random.PRNGKey(0),
                                    use_scan=False)

    @jax.jit
    def step(params, wav):
        x, mel = prepare_batch(wav, cfg)
        return jax.value_and_grad(
            lambda p: model.apply({"params": p}, x, mel, method="loss")
        )(params)

    rows = []
    for n in counts:
        mesh = Mesh(np.asarray(devices[:n]).reshape(n, 1),
                    ("data", "model"))
        B = cfg.train.global_batch_size * n
        wav = jax.device_put(_train_batch(cfg, B), batch_sharding(mesh))
        params = jax.device_put(variables["params"], replicated(mesh))
        t = time_call(lambda: step(params, wav), reps, warmup=1)
        rows.append({"devices": n, "batch": B, **t,
                     "utt_per_s": B / (t["median_ms"] / 1e3)})
    base = rows[0]["utt_per_s"]
    for r in rows:
        r["efficiency"] = round((r["utt_per_s"] / r["devices"]) / base, 3)
    return rows


def run_bench(case: str = "student_iaf", overrides=None) -> Dict[str, Any]:
    """Every cell of the suite on the local GPU(s); raises off a GPU or
    on a device kind without a published peak."""
    info = device_info()
    if info["platform"] != "gpu":
        raise RuntimeError(f"bench needs a GPU; JAX found {info}")
    peak = peak_for(info["kind"])["bf16_tflops"]
    cfg = get_config(case, **(overrides or {}))
    errors = []

    def rate(tag: str, res: Dict[str, Any], flops_per_call: float):
        """Achieved TFLOP/s and share of the bf16 peak, plausibility-
        gated."""
        bad = _plausibility_check(res["median_ms"], flops_per_call, peak)
        if bad:
            res["error"] = bad
            errors.append(f"{tag}: {bad}")
            return
        tflops = flops_per_call / (res["median_ms"] / 1e3) / 1e12
        res["achieved_tflops"] = tflops
        res["bf16_peak_share"] = tflops / peak

    def student_cell(tag: str, s_cfg: Config):
        res = measure_student_inference(s_cfg)
        rate(tag, res, student_gen_flops_per_sample(s_cfg)
             * res["batch"] * res["samples"])
        return res

    def train_cell(tag: str, res: Dict[str, Any], fwd_per_sample: float):
        # a training step ~= 3x the forward FLOPs
        rate(tag, res, 3.0 * fwd_per_sample * res["batch"]
             * res["crop_samples"])
        return res

    student = student_cell("student_infer", cfg)
    t_cfg = get_config("teacher_lj")
    s_cfg = get_config("student_iaf")
    detail: Dict[str, Any] = {
        "device": info,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "peak_bf16_tflops": peak,
        "student": student,
        "teacher_train": train_cell(
            "teacher_train", measure_teacher_train(t_cfg),
            teacher_fwd_flops_per_sample(t_cfg)),
        "distill_train": train_cell(
            "distill_train", measure_distill_train(s_cfg),
            student_gen_flops_per_sample(s_cfg)
            + teacher_fwd_flops_per_sample(s_cfg)),
        "student_direct_train": train_cell(
            "student_direct_train", measure_student_direct_train(s_cfg),
            student_gen_flops_per_sample(s_cfg)),
        "teacher_ar": measure_teacher_ar_sampling(t_cfg),
    }
    if case != "large_student_sharded":
        detail["student_config4"] = student_cell(
            "student_infer_config4", get_config("large_student_sharded"))
    if info["count"] > 1:
        detail["dp_equivalence"] = dp_equivalence_check(t_cfg)
        if not detail["dp_equivalence"]["pass"]:
            errors.append("dp_equivalence: sharded grads != single-device")
        detail["dp_scaling"] = measure_scaling(t_cfg)
    value = student["audio_sec_per_s_per_device"] \
        if "error" not in student else 0.0
    out = {
        "metric": "student_audio_sec_per_s_per_device",
        "value": value,
        "unit": "audio-sec/s/device (= x realtime)",
        # north-star target is >100x realtime per device (BASELINE.json)
        "vs_baseline": value / 100.0,
        "detail": detail,
    }
    if errors:
        out["error"] = "; ".join(errors)
    return out
