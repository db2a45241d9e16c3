#!/usr/bin/env python
"""GPU smoke test of the vocoder's main paths, through the entry points a
user calls, at the shipped presets' published widths.  Weights are random,
drawn from --seed; every output is compared with a float32 reference
(`--reference` below) and every phase's failure fails the run.

    python chip_smoke.py              # phases a-f on one GPU
    python chip_smoke.py --four-gpu   # phase g only, on four GPUs

Phases:
  a  device: platform, device_kind, count, nvidia-smi name and power
     limit, XLA_FLAGS
  b  student_iaf generation, batch 8 x 2 s at 22.05 kHz (generate entry)
  c  large_student_sharded generation, batch 8 x 2 s at 24 kHz (C=128,
     6 flows)
  d  training through the CLI at the presets' batch 8 x 16384:
     train-teacher teacher_lj, distill-student student_iaf from it,
     train-student student_iaf; each runs 2 steps, saves, then resumes
     from its checkpoint for a third step, and every step's logged loss
     is compared with the reference loss on the same params and batch
  e  serve student_iaf on the distilled workdir: 2 sequential and 2
     concurrent POST /synthesize requests plus GET /healthz
  f  teacher AR sampling: `generate --model teacher` for 0.1 s, then
     batch 8 x 0.1 s through the sampler
  g  (--four-gpu) multihost_dp data-parallel distillation over a 4x1
     ("data", "model") mesh — its gradients against one GPU's on one
     global batch, then steps at the preset's global batch — and
     large_student_sharded batch-sharded generation against one GPU

Reference: the same parameters and the same noise, computed in float32
(`compute_dtype` float32) under `jax.default_matmul_precision("highest")`,
so no TF32.  Each comparison prints its max-abs and relative-L2 error and
its tolerance.  Exits non-zero, printing no result, when JAX finds no GPU
or any phase fails; otherwise the last stdout line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Working files go to <repo>/runs/chip_smoke/.
"""

import argparse
import http.client
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Tolerances, each for bf16 compute (the presets' compute_dtype) against
# the fp32 reference:
# - generation: bf16 keeps 8 mantissa bits (~4e-3 relative rounding per
#   rounded value), accumulated over 10 gated layers per flow; on the
#   conditioned weights of `student_params` a CPU rehearsal at these
#   widths measured 1.3e-3 (C=64) and 1.7e-3 (C=128) relative-L2, and
#   1e-2 leaves room for another GEMM library's accumulation order.
GEN_REL_L2_TOL = 1e-2
# - training: the distillation and direct losses are dominated by the
#   spectral power term of the student's own sample, whose bf16 rounding
#   the untrained flow chain amplifies (CPU rehearsal at these widths:
#   up to 1.3e-2 relative; the teacher NLL agreed to 1.1e-3).
TRAIN_LOSS_REL_TOL = 0.05
# - teacher AR: the sampler's fp32 matmuls run in TF32 (~5e-4 relative
#   input rounding); a sample agrees within 1e-2 unless the Gumbel
#   mixture choice flips on a near-tie, which TF32 rounding makes rare.
AR_ABS_TOL = 1e-2
AR_AGREE_MIN = 0.99
# - four GPUs: the DP gradient runs in fp32 at "highest" on both sides,
#   so only the order of the 4-way mean differs.
DP_GRAD_REL_L2_TOL = 1e-4
# - batch-sharded generation: the same bf16 program on 2 rows per GPU
#   versus 8 rows on one, so only GEMM tiling (accumulation order) may
#   differ.
SHARDED_GEN_REL_L2_TOL = 1e-2


class PhaseFailure(Exception):
    """A comparison or check outside its tolerance."""


def card_lines():
    """nvidia-smi's `name, power.limit` line for each visible GPU."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def reference():
    """Context for the fp32 reference: full-precision matmuls."""
    import jax

    return jax.default_matmul_precision("highest")


def fp32(cfg):
    """`cfg` with teacher and student computing in float32."""
    from pwn_vocoder.config import override

    cfg = override(cfg, "teacher.compute_dtype", "float32")
    return override(cfg, "student.compute_dtype", "float32")


def compare(name, got, ref, rel_l2_tol):
    """Print and check the error of `got` against `ref`."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        raise PhaseFailure(f"{name}: shape {got.shape} != {ref.shape}")
    if not np.isfinite(got).all():
        raise PhaseFailure(f"{name}: non-finite output")
    max_abs = float(np.abs(got - ref).max())
    rel_l2 = float(np.linalg.norm(got - ref)
                   / max(np.linalg.norm(ref), 1e-12))
    print(f"  {name}: max_abs={max_abs:.3e} rel_l2={rel_l2:.3e} "
          f"(tol rel_l2 {rel_l2_tol:g})", flush=True)
    if not rel_l2 <= rel_l2_tol:
        raise PhaseFailure(f"{name}: rel_l2 {rel_l2:.3e} > {rel_l2_tol}")
    return {"max_abs": max_abs, "rel_l2": rel_l2}


def student_params(cfg, seed):
    """Student weights drawn from `seed`, with each flow's output
    projection (head2, which emits mu and log s) scaled by 0.1.

    Untrained flows composed at full scale form a map so sensitive that
    bf16 rounding alone moves the clipped output by 3-6% relative-L2
    (CPU rehearsal); at 0.1 each flow is a mild affine step and the
    comparison measures the compiled path's rounding, not the map's
    sensitivity."""
    import jax

    from pwn_vocoder.models.student import init_student

    params = init_student(cfg, jax.random.PRNGKey(seed))[1]["params"]
    for name, flow in params.items():
        if name.startswith("flow_"):
            flow["head2"]["kernel"] = flow["head2"]["kernel"] * 0.1
    return params


def synthetic_mels(cfg, batch, seconds, seed):
    """(batch, F, n_mels) host mels of synthetic tone clips."""
    from pwn_vocoder.data import SyntheticTones
    from pwn_vocoder.generate import mel_from_wav_host

    sr = cfg.dsp.sample_rate
    clips = SyntheticTones(batch, int(seconds * sr), sr, seed=seed)
    return np.stack([mel_from_wav_host(cfg, clips[i])
                     for i in range(batch)])


def top_ops(trace_dir, n=10):
    """The n device ops with the most time in a trace, with shares."""
    from pwn_vocoder.utils.profiling import op_times_ns, xplane_files

    totals = {}
    for path in xplane_files(trace_dir):
        for name, ns in op_times_ns(path).items():
            totals[name] = totals.get(name, 0.0) + ns
    total = sum(totals.values())
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
    return total, [(name, ns, ns / max(total, 1.0)) for name, ns in ranked]


# ---------------------------------------------------------------------------
# Phases b, c: student generation
# ---------------------------------------------------------------------------


def phase_generation(case, batch=8, seconds=2.0, seed=0, reps=5,
                     trace_dir=None):
    import jax

    from pwn_vocoder.benchmarks import time_call
    from pwn_vocoder.config import get_config
    from pwn_vocoder.generate import generate_student, generate_student_batch

    cfg = get_config(case)
    params = student_params(cfg, seed)
    mel = synthetic_mels(cfg, batch, seconds, seed)
    key = jax.random.PRNGKey(seed + 1)
    T = mel.shape[1] * cfg.dsp.hop_length

    t0 = time.perf_counter()
    wav = jax.block_until_ready(
        generate_student_batch(cfg, params, mel, key))
    first_s = time.perf_counter() - t0
    t = time_call(lambda: generate_student_batch(cfg, params, mel, key),
                  reps)
    rate = batch * T / cfg.dsp.sample_rate / (t["median_ms"] / 1e3)
    print(f"  {case}: batch {batch} x {T} samples, first call "
          f"{first_s:.2f} s, warm median {t['median_ms']:.3f} ms "
          f"(min {t['min_ms']:.3f}, max {t['max_ms']:.3f}) = "
          f"{rate:.1f} audio-s/s", flush=True)
    with reference():
        ref = generate_student_batch(fp32(cfg), params, mel, key)
    err = compare(f"{case} generation vs fp32 reference", wav, ref,
                  GEN_REL_L2_TOL)
    clipped = float(np.mean(np.abs(np.asarray(wav)) >= 1.0))
    print(f"  clipped share {clipped:.4f}", flush=True)
    row0 = generate_student(cfg, params, mel, key)
    if row0.shape != (T,) or not np.isfinite(row0).all():
        raise PhaseFailure(f"generate_student row: {row0.shape}")
    out = {"case": case, "batch": batch, "samples": T,
           "first_call_s": first_s, **t, "audio_sec_per_s": rate, **err}
    if trace_dir:
        # the profile is a reading, not a check: a tracer that cannot
        # start is reported and does not fail the phase
        try:
            jax.profiler.start_trace(trace_dir)
            for _ in range(3):
                jax.block_until_ready(
                    generate_student_batch(cfg, params, mel, key))
            jax.profiler.stop_trace()
        except Exception as e:  # noqa: BLE001
            print(f"  profile not taken: {e!r}", flush=True)
            return out
        total, ranked = top_ops(trace_dir)
        print(f"  top device ops of 3 traced calls "
              f"(sum {total / 1e6:.3f} ms):", flush=True)
        for name, ns, share in ranked:
            print(f"    {share:6.1%} {ns / 3e6:9.3f} ms/call  {name}",
                  flush=True)
        out["top_ops"] = [[name, ns / 3e6, share]
                          for name, ns, share in ranked]
    return out


# ---------------------------------------------------------------------------
# Phase d: training through the CLI
# ---------------------------------------------------------------------------

TRAIN_OVERRIDES = ["train.log_every=1", "train.checkpoint_every=1",
                   "train.keep_checkpoints=4",
                   "train.eval_sample_seconds=0.1"]


def _cli(args):
    from pwn_vocoder.cli import main

    print(f"  $ pwn_vocoder.cli {' '.join(args)}", flush=True)
    t0 = time.perf_counter()
    try:
        rc = main(args)
    except SystemExit as e:  # argparse errors exit
        rc = e.code
    if rc != 0:
        raise PhaseFailure(f"cli {args[0]} exited {rc}")
    return time.perf_counter() - t0


def _train_twice(args, overrides):
    """Run a training command for 2 steps, then resume it for a third:
    the second run restores the step-2 checkpoint."""
    s1 = _cli(args + ["--steps", "2"] + overrides)
    s2 = _cli(args + ["--steps", "3"] + overrides)
    return s1, s2


def _logged_losses(path):
    """step -> logged training loss (the last record of each step)."""
    losses = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if "loss" in rec:
                losses[rec["step"]] = rec["loss"]
    return losses


def _batches(cfg, n):
    """The first n batches of the CLI's (synthetic-corpus) stream."""
    from pwn_vocoder.data import make_train_iterator
    from pwn_vocoder.data.pipeline import local_batch_size
    from pwn_vocoder.training.loop import build_dataset

    it = make_train_iterator(
        build_dataset(cfg, None), cfg,
        local_batch_size(cfg.train.global_batch_size),
        seed=cfg.train.seed, start_step=0,
    )
    return [next(it) for _ in range(n)]


def _params_by_step(cfg, kind, workdir, init_params, steps):
    """{k: params before step k}: the seeded init for k=0, then the
    checkpoint each step saved."""
    from pwn_vocoder.training.loop import abstract_state_template
    from pwn_vocoder.utils.checkpoint import CheckpointManager

    mngr = CheckpointManager(os.path.join(workdir, f"ckpt_{kind}"))
    template = abstract_state_template(cfg, kind)
    out = {0: init_params}
    for k in range(1, steps):
        out[k] = mngr.restore(template, step=k)[0].params
    return out


def _sharded_mean(loss, wav, key, n_shards):
    """The loss the CLI's shard_map DP step logs: the mean over the
    `data` shards of each shard's loss on its rows, shard i drawing its
    noise from fold_in(key, i) (no key: a deterministic loss)."""
    import jax

    rows = wav.shape[0] // n_shards
    return sum(
        float(loss(wav[i * rows:(i + 1) * rows],
                   None if key is None else jax.random.fold_in(key, i)))
        for i in range(n_shards)
    ) / n_shards


def _check_losses(name, logged, ref):
    errs = []
    for k in sorted(ref):
        got = logged.get(k)
        if got is None or not np.isfinite(got):
            raise PhaseFailure(f"{name}: step {k} loss {got}")
        rel = abs(got - ref[k]) / max(abs(ref[k]), 1.0)
        errs.append(rel)
        print(f"  {name} step {k}: loss {got:.6f} reference "
              f"{ref[k]:.6f} rel {rel:.2e} (tol {TRAIN_LOSS_REL_TOL:g})",
              flush=True)
        if not rel <= TRAIN_LOSS_REL_TOL:
            raise PhaseFailure(f"{name} step {k}: rel {rel:.2e}")
    return max(errs)


def phase_training(workdir, teacher_case="teacher_lj",
                   student_case="student_iaf", overrides=(),
                   time_steps=True):
    import jax
    import jax.numpy as jnp

    from pwn_vocoder.benchmarks import time_train_step
    from pwn_vocoder.cli import _load_config
    from pwn_vocoder.models.student import init_student
    from pwn_vocoder.models.teacher import init_teacher, make_teacher
    from pwn_vocoder.parallel import make_mesh
    from pwn_vocoder.training.common import create_train_state
    from pwn_vocoder.training.distill import (
        distillation_losses,
        make_distill_train_step,
    )
    from pwn_vocoder.training.loop import load_teacher_params
    from pwn_vocoder.training.student_direct import (
        direct_student_losses,
        make_student_direct_train_step,
    )
    from pwn_vocoder.training.teacher import (
        make_teacher_train_step,
        prepare_batch,
    )

    overrides = TRAIN_OVERRIDES + list(overrides)
    wd_t = os.path.join(workdir, "teacher")
    wd_s = os.path.join(workdir, "student")
    wd_d = os.path.join(workdir, "direct")
    out = {}

    # -- teacher ---------------------------------------------------------
    out["teacher_cli_s"] = _train_twice(
        ["train-teacher", teacher_case, "--workdir", wd_t], overrides)
    tcfg = _load_config(teacher_case, overrides)
    tcfg32 = fp32(tcfg)
    t_init = init_teacher(tcfg, jax.random.PRNGKey(tcfg.train.seed))[1]
    params = _params_by_step(tcfg, "teacher", wd_t, t_init["params"], 3)
    batches = _batches(tcfg, 3)
    teacher32 = init_teacher(tcfg32, jax.random.PRNGKey(0),
                             use_scan=False)[0]
    n_shards = make_mesh(tcfg.mesh).shape["data"]
    with reference():
        loss = jax.jit(lambda p, wav: teacher32.apply(
            {"params": p}, *prepare_batch(wav, tcfg32), method="loss"))
        ref = {k: _sharded_mean(lambda w, _, p=params[k]: loss(p, w),
                                batches[k], None, n_shards)
               for k in range(3)}
    out["teacher_loss_rel_err"] = _check_losses("teacher", _logged_losses(
        os.path.join(wd_t, "metrics_teacher.jsonl")), ref)

    # -- distillation from that teacher ----------------------------------
    out["distill_cli_s"] = _train_twice(
        ["distill-student", student_case, "--teacher-workdir", wd_t,
         "--teacher-case", teacher_case, "--workdir", wd_s], overrides)
    scfg = _load_config(student_case, overrides)
    scfg32 = fp32(scfg)
    _, t_params, _ = load_teacher_params(tcfg, wd_t)
    s_init = init_student(scfg, jax.random.PRNGKey(scfg.train.seed + 1))[1]
    params = _params_by_step(scfg, "student", wd_s, s_init["params"], 3)
    batches = _batches(scfg, 3)
    student32 = init_student(scfg32, jax.random.PRNGKey(0),
                             use_scan=False)[0]
    d_teacher32 = init_teacher(fp32(tcfg), jax.random.PRNGKey(0),
                               use_scan=False)[0]
    rng = jax.random.PRNGKey(scfg.train.seed + 2)
    n_shards = make_mesh(scfg.mesh).shape["data"]

    def step_key(k):
        return jax.random.fold_in(rng, k)

    with reference():
        dloss = jax.jit(lambda p, tp, wav, key, k: distillation_losses(
            student32, d_teacher32, p, tp, *prepare_batch(wav, scfg32),
            key, scfg32, step=k)[0])
        ref = {k: _sharded_mean(
            lambda w, key, k=k: dloss(params[k], t_params, w, key, k),
            batches[k], step_key(k), n_shards) for k in range(3)}
    out["distill_loss_rel_err"] = _check_losses("distill", _logged_losses(
        os.path.join(wd_s, "metrics_student.jsonl")), ref)

    # -- direct (teacher-free) student training ---------------------------
    out["direct_cli_s"] = _train_twice(
        ["train-student", student_case, "--workdir", wd_d], overrides)
    params = _params_by_step(scfg, "student", wd_d, s_init["params"], 3)
    with reference():
        sloss = jax.jit(lambda p, wav, key: direct_student_losses(
            student32, p, *prepare_batch(wav, scfg32), key, scfg32)[0])
        ref = {k: _sharded_mean(
            lambda w, key, k=k: sloss(params[k], w, key),
            batches[k], step_key(k), n_shards) for k in range(3)}
    out["direct_loss_rel_err"] = _check_losses("direct", _logged_losses(
        os.path.join(wd_d, "metrics_student.jsonl")), ref)

    if time_steps:
        # warm step times of the CLI's own step functions (same mesh and
        # config, so the persistent compile cache serves them)
        mesh = make_mesh(tcfg.mesh)
        teacher, tv = init_teacher(tcfg, jax.random.PRNGKey(0),
                                   use_scan=False)
        student, sv = init_student(scfg, jax.random.PRNGKey(1),
                                   use_scan=False)
        wav_t = _batches(tcfg, 1)[0]
        wav_s = _batches(scfg, 1)[0]
        # each state gets its own buffers: the steps donate them
        fresh = lambda p: jax.tree.map(jnp.copy, p)  # noqa: E731
        steps = {
            "teacher_step": lambda: (
                make_teacher_train_step(teacher, tcfg, mesh),
                create_train_state(fresh(tv["params"]), tcfg.train),
                (wav_t,)),
            "distill_step": lambda: (
                make_distill_train_step(student, make_teacher(
                    scfg, use_scan=False), scfg, mesh),
                create_train_state(fresh(sv["params"]), scfg.train),
                (jax.device_put(t_params), wav_s)),
            "direct_step": lambda: (
                make_student_direct_train_step(student, scfg, mesh),
                create_train_state(fresh(sv["params"]), scfg.train),
                (wav_s,)),
        }
        for name, build in steps.items():
            fn, state, args = build()
            mem = fn.lower(state, *args).compile().memory_analysis()
            t = time_train_step(fn, state, args)
            batch = wav_t.shape[0] if name == "teacher_step" \
                else wav_s.shape[0]
            print(f"  {name}: warm median {t['median_ms']:.3f} ms "
                  f"(min {t['min_ms']:.3f}, max {t['max_ms']:.3f}) = "
                  f"{batch / (t['median_ms'] / 1e3):.1f} utt/s; temp "
                  f"{mem.temp_size_in_bytes / 2**30:.2f} GiB, args "
                  f"{mem.argument_size_in_bytes / 2**30:.2f} GiB",
                  flush=True)
            out[name] = {**t, "temp_gib": mem.temp_size_in_bytes / 2**30}
    return out


# ---------------------------------------------------------------------------
# Phase e: serving
# ---------------------------------------------------------------------------


def _wav_body(wav, sr):
    from scipy.io import wavfile

    buf = io.BytesIO()
    wavfile.write(buf, sr, (np.clip(wav, -1, 1) * 32767).astype(np.int16))
    return buf.getvalue()


def _post(port, body, results, i):
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/synthesize", body=body,
                     headers={"Content-Type": "audio/wav"})
        resp = conn.getresponse()
        first = resp.read(1)
        ttfb = time.perf_counter() - t0
        data = first + resp.read()
        results[i] = (resp.status, resp.getheader("X-Sample-Rate"), data,
                      ttfb, time.perf_counter() - t0)
    finally:
        conn.close()


def phase_serve(case, workdir, seconds=2.0, seed=0, overrides=()):
    from pwn_vocoder.config import get_config
    from pwn_vocoder.data import SyntheticTones
    from pwn_vocoder.serve import VocoderService, drain_and_close, make_server

    cfg = get_config(case, **dict(o.split("=", 1) for o in overrides))
    sr, hop = cfg.dsp.sample_rate, cfg.dsp.hop_length
    service = VocoderService.from_workdir(cfg, workdir, chunk_frames=64,
                                          batch_max=4)
    srv = make_server(service, "127.0.0.1", 0)
    port = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        n = int(seconds * sr)
        clips = SyntheticTones(4, n, sr, seed=seed)
        bodies = [_wav_body(clips[i], sr) for i in range(4)]
        results = [None] * 4
        for i in range(2):
            _post(port, bodies[i], results, i)
        threads = [threading.Thread(target=_post,
                                    args=(port, bodies[i], results, i))
                   for i in (2, 3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        srv.shutdown()
        drain_and_close(service, srv)
        thread.join(timeout=60)
    want = (n // hop) * hop
    out = {"health": health, "requests": []}
    for i, r in enumerate(results):
        if r is None:
            raise PhaseFailure(f"request {i} did not complete")
        status, rate, data, ttfb, total = r
        pcm = np.frombuffer(data, "<i2").astype(np.float32) / 32767.0
        print(f"  request {i} ({'concurrent' if i >= 2 else 'sequential'}"
              f"): status {status}, {len(pcm)} samples @ {rate} Hz, "
              f"TTFB {ttfb * 1e3:.1f} ms, total {total * 1e3:.1f} ms",
              flush=True)
        if status != 200 or rate != str(sr) or len(pcm) != want:
            raise PhaseFailure(
                f"request {i}: status {status}, rate {rate}, "
                f"{len(pcm)} samples (want {want})")
        if not np.isfinite(pcm).all() or not np.abs(pcm).max() > 0:
            raise PhaseFailure(f"request {i}: silent or non-finite audio")
        out["requests"].append({"ttfb_ms": ttfb * 1e3,
                                "total_ms": total * 1e3})
    print(f"  healthz: status {health['status']}, served "
          f"{health['requests_served']}, batch calls "
          f"{health['batch_calls']}, rows {health['batch_rows']}",
          flush=True)
    if health["status"] != "ok":
        raise PhaseFailure(f"healthz: {health}")
    if not health["batch_rows"] > health["batch_calls"]:
        raise PhaseFailure("the concurrent requests were never batched")
    return out


# ---------------------------------------------------------------------------
# Phase f: teacher AR sampling
# ---------------------------------------------------------------------------


def phase_teacher_ar(case, teacher_workdir, batch=8, seconds=0.1, seed=0,
                     overrides=(), reps=3):
    import jax

    from pwn_vocoder.benchmarks import time_call
    from pwn_vocoder.cli import _load_config
    from pwn_vocoder.generate import generate_teacher_batch
    from pwn_vocoder.models.teacher import init_teacher
    from pwn_vocoder.ops import gaussian, mol
    from pwn_vocoder.training.loop import load_teacher_params
    from pwn_vocoder.utils.audio_io import read_wav

    overrides = list(overrides)
    out_wav = os.path.join(teacher_workdir, "teacher_ar.wav")
    _cli(["generate", case, "--workdir", teacher_workdir, "--model",
          "teacher", "--seconds", str(seconds), "--output", out_wav]
         + overrides)
    wav, _ = read_wav(out_wav)
    if not np.isfinite(wav).all() or len(wav) == 0:
        raise PhaseFailure("generate --model teacher: bad wav")

    cfg = _load_config(case, overrides)
    _, params, _ = load_teacher_params(cfg, teacher_workdir)
    mel = synthetic_mels(cfg, batch, seconds, seed)
    key = jax.random.PRNGKey(seed + 3)
    T = mel.shape[1] * cfg.dsp.hop_length
    t0 = time.perf_counter()
    x = jax.block_until_ready(generate_teacher_batch(cfg, params, mel, key))
    first_s = time.perf_counter() - t0
    t = time_call(lambda: generate_teacher_batch(cfg, params, mel, key),
                  reps, warmup=0)
    print(f"  teacher AR: batch {batch} x {T} steps, first call "
          f"{first_s:.2f} s, warm median {t['median_ms']:.3f} ms = "
          f"{t['median_ms'] * 1e3 / T:.2f} us/step", flush=True)

    # Reference: teacher forcing on the sampler's own output in fp32 at
    # "highest" gives each step's head params, and step t re-draws with
    # the sampler's own key fold_in(key, t): a feedback-free comparison.
    tc = cfg.teacher
    teacher32 = init_teacher(fp32(cfg), jax.random.PRNGKey(0))[0]
    draw = (gaussian.sample_from_gaussian if tc.output == "gaussian"
            else mol.sample_from_mol)
    with reference():
        head = jax.jit(lambda p, x, m: teacher32.apply(
            {"params": p}, x, m))(params, x, mel)
        x_ref = jax.vmap(
            lambda t, h: draw(jax.random.fold_in(key, t), h,
                              log_scale_min=tc.log_scale_min),
            in_axes=(0, 1), out_axes=1,
        )(np.arange(T), head)
    err = np.abs(np.asarray(x, np.float64) - np.asarray(x_ref, np.float64))
    agree = float(np.mean(err <= AR_ABS_TOL))
    print(f"  teacher AR vs fp32 teacher forcing: max_abs={err.max():.3e} "
          f"agree(<= {AR_ABS_TOL:g})={agree:.4f} (min {AR_AGREE_MIN})",
          flush=True)
    if not np.isfinite(np.asarray(x)).all() or agree < AR_AGREE_MIN:
        raise PhaseFailure(f"teacher AR agreement {agree:.4f}")
    return {"batch": batch, "samples": T, "first_call_s": first_s, **t,
            "us_per_step": t["median_ms"] * 1e3 / T,
            "max_abs": float(err.max()), "agree": agree}


# ---------------------------------------------------------------------------
# Phase g: four GPUs
# ---------------------------------------------------------------------------


def _rel_l2_tree(a, b):
    import jax

    da = np.concatenate([np.asarray(x, np.float64).ravel()
                         for x in jax.tree.leaves(a)])
    db = np.concatenate([np.asarray(x, np.float64).ravel()
                         for x in jax.tree.leaves(b)])
    return (float(np.abs(da - db).max()),
            float(np.linalg.norm(da - db) / max(np.linalg.norm(db), 1e-12)))


def phase_dp_grads(case="multihost_dp", n_devices=4, global_batch=16,
                   seed=0, overrides=()):
    """The DP distillation gradient over an n x 1 mesh against the same
    per-shard computation run shard by shard on one device."""
    import jax

    from pwn_vocoder.config import MeshConfig, get_config
    from pwn_vocoder.models.student import init_student
    from pwn_vocoder.models.teacher import init_teacher
    from pwn_vocoder.parallel import make_mesh, shard_batch
    from pwn_vocoder.training.distill import (
        distillation_losses,
        make_distill_dp_grads,
    )
    from pwn_vocoder.training.teacher import prepare_batch

    cfg = fp32(get_config(case, **dict(o.split("=", 1) for o in overrides)))
    mesh = make_mesh(MeshConfig(data=n_devices, model=1),
                     jax.devices()[:n_devices])
    teacher, tv = init_teacher(cfg, jax.random.PRNGKey(seed),
                               use_scan=False)
    student, sv = init_student(cfg, jax.random.PRNGKey(seed + 1),
                               use_scan=False)
    wav = np.concatenate(_batches(cfg, 1) * (
        -(-global_batch // _batches(cfg, 1)[0].shape[0])))[:global_batch]
    step_key, step = jax.random.PRNGKey(seed + 2), 0
    rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    with reference():
        dp = jax.jit(make_distill_dp_grads(student, teacher, cfg, mesh))
        metrics, grads = dp(jax.device_put(sv["params"], rep),
                            jax.device_put(tv["params"], rep),
                            shard_batch(mesh, wav), step_key, step)

        def shard_grads(p, tp, w, key):
            return jax.grad(lambda q: distillation_losses(
                student, teacher, q, tp, *prepare_batch(w, cfg), key, cfg,
                step=step)[0])(p)

        one = jax.jit(shard_grads)
        rows = global_batch // n_devices
        per_shard = [
            one(sv["params"], tv["params"], wav[i * rows:(i + 1) * rows],
                jax.random.fold_in(step_key, i))
            for i in range(n_devices)
        ]
        ref = jax.tree.map(lambda *g: sum(g) / n_devices, *per_shard)
    max_abs, rel = _rel_l2_tree(grads, ref)
    print(f"  DP grads ({n_devices} devices, global batch {global_batch}) "
          f"vs one device: max_abs={max_abs:.3e} rel_l2={rel:.3e} "
          f"(tol {DP_GRAD_REL_L2_TOL:g}); loss "
          f"{float(metrics['loss']):.6f}", flush=True)
    if not rel <= DP_GRAD_REL_L2_TOL:
        raise PhaseFailure(f"DP grads rel_l2 {rel:.3e}")
    return {"max_abs": max_abs, "rel_l2": rel}


def phase_dp_steps(case="multihost_dp", n_devices=4, per_device_batch=64,
                   steps=3, overrides=()):
    """A few DP distillation steps at the preset's global batch, halving
    the per-device batch (and saying so) while the compiled step needs
    more than 90% of a device's memory or runs out of it."""
    import jax
    import jax.numpy as jnp

    from pwn_vocoder.benchmarks import time_train_step
    from pwn_vocoder.config import MeshConfig, get_config, override
    from pwn_vocoder.models.student import init_student
    from pwn_vocoder.models.teacher import init_teacher
    from pwn_vocoder.parallel import make_mesh, shard_batch
    from pwn_vocoder.training.common import create_train_state
    from pwn_vocoder.training.distill import make_distill_train_step

    cfg = get_config(case, **dict(o.split("=", 1) for o in overrides))
    mesh = make_mesh(MeshConfig(data=n_devices, model=1),
                     jax.devices()[:n_devices])
    teacher, tv = init_teacher(cfg, jax.random.PRNGKey(0), use_scan=False)
    student, sv = init_student(cfg, jax.random.PRNGKey(1), use_scan=False)
    step = make_distill_train_step(student, teacher, cfg, mesh=mesh)
    t_params = jax.device_put(
        tv["params"], jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec()))
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    while True:
        B = per_device_batch * n_devices
        wav = shard_batch(mesh, _batches(
            override(cfg, "train.global_batch_size", B), 1)[0])
        state = create_train_state(
            jax.tree.map(jnp.copy, sv["params"]), cfg.train)
        mem = step.lower(state, t_params, wav).compile().memory_analysis()
        need = mem.temp_size_in_bytes + mem.argument_size_in_bytes
        print(f"  {per_device_batch} per device: step needs "
              f"{need / 2**30:.2f} GiB per device"
              + (f" of {limit / 2**30:.2f}" if limit else ""), flush=True)
        if limit and need > 0.9 * limit and per_device_batch > 1:
            per_device_batch //= 2
            continue
        try:
            t = time_train_step(step, state, (t_params, wav), reps=steps,
                                warmup=1)
            break
        except jax.errors.JaxRuntimeError as e:
            if "RESOURCE_EXHAUSTED" not in str(e) or per_device_batch == 1:
                raise
            print(f"  {per_device_batch} per device ran out of device "
                  "memory", flush=True)
            per_device_batch //= 2
    if B != cfg.train.global_batch_size:
        print(f"  cut: global batch {cfg.train.global_batch_size} -> {B} "
              f"({per_device_batch} per device)", flush=True)
    print(f"  DP distill step at global batch {B}: warm median "
          f"{t['median_ms']:.3f} ms = {B / (t['median_ms'] / 1e3):.1f} "
          f"utt/s over {n_devices} devices", flush=True)
    return {"global_batch": B, "per_device_batch": per_device_batch,
            "step_gib": need / 2**30, **t}


def phase_sharded_generation(case="large_student_sharded", n_devices=4,
                             batch=8, seconds=2.0, seed=0):
    import jax

    from pwn_vocoder.config import MeshConfig, get_config
    from pwn_vocoder.generate import generate_student_batch
    from pwn_vocoder.parallel import make_mesh
    from pwn_vocoder.parallel.mesh import batch_sharding
    from pwn_vocoder.parallel.tp import make_batch_sharded_generate

    cfg = get_config(case)
    variables = {"params": student_params(cfg, seed)}
    mel = synthetic_mels(cfg, batch, seconds, seed)
    key = jax.random.PRNGKey(seed + 1)
    mesh = make_mesh(MeshConfig(data=n_devices, model=1),
                     jax.devices()[:n_devices])
    gen = make_batch_sharded_generate(cfg, mesh=mesh)
    sharded = gen(variables, key, jax.device_put(mel, batch_sharding(mesh)))
    single = generate_student_batch(cfg, variables["params"], mel, key)
    err = compare(f"{case} batch-sharded over {n_devices} vs one device",
                  sharded, single, SHARDED_GEN_REL_L2_TOL)
    return err


# ---------------------------------------------------------------------------


def _run_phase(name, fn, failures, summary):
    print(f"[{name}]", flush=True)
    t0 = time.perf_counter()
    try:
        summary[name] = fn()
    except Exception as e:  # noqa: BLE001 — every phase must report
        traceback.print_exc()
        failures.append(f"{name}: {e!r}")
        print(f"[{name}] FAILED: {e!r}", flush=True)
    else:
        print(f"[{name}] ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpu", action="store_true",
                    help="run phase g (four GPUs) and nothing else")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--summary", default=None,
                    help="also write every measured number to this JSON")
    args = ap.parse_args(argv)
    if args.four_gpu:
        # one process per card, so it may reserve more than JAX's default
        # three quarters: the preset's 64 utterances per GPU need ~57 GiB
        os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.9")

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {devices}",
              file=sys.stderr)
        return 1
    n_need = 4 if args.four_gpu else 1
    if len(devices) < n_need:
        print(f"chip_smoke.py needs {n_need} GPUs; JAX found {devices}",
              file=sys.stderr)
        return 1

    from pwn_vocoder.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    workdir = os.path.join(REPO, "runs", "chip_smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    failures, summary = [], {}
    device = {"platform": devices[0].platform,
              "kind": devices[0].device_kind, "count": n_need}

    def phase_device():
        cards = card_lines()
        print(f"  jax: platform {device['platform']}, kind "
              f"{device['kind']}, visible devices {len(devices)}, "
              f"jax {jax.__version__}", flush=True)
        print(f"  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
              f"compile cache {cache}", flush=True)
        for line in cards:
            print(line, flush=True)
        return {"cards": cards, **device}

    _run_phase("a device", phase_device, failures, summary)
    seed = args.seed
    if args.four_gpu:
        _run_phase("g dp grads", lambda: phase_dp_grads(seed=seed),
                   failures, summary)
        _run_phase("g dp steps", phase_dp_steps, failures, summary)
        _run_phase("g sharded generation",
                   lambda: phase_sharded_generation(seed=seed),
                   failures, summary)
    else:
        _run_phase("b student_iaf generation", lambda: phase_generation(
            "student_iaf", seed=seed,
            trace_dir=os.path.join(workdir, "trace_student_iaf")),
            failures, summary)
        _run_phase("c large_student_sharded generation",
                   lambda: phase_generation(
                       "large_student_sharded", seed=seed,
                       trace_dir=os.path.join(workdir, "trace_config4")),
                   failures, summary)
        _run_phase("d training", lambda: phase_training(workdir),
                   failures, summary)
        if "d training" in summary:
            _run_phase("e serve", lambda: phase_serve(
                "student_iaf", os.path.join(workdir, "student"), seed=seed),
                failures, summary)
            _run_phase("f teacher AR", lambda: phase_teacher_ar(
                "teacher_lj", os.path.join(workdir, "teacher"), seed=seed,
                overrides=TRAIN_OVERRIDES), failures, summary)
        else:
            failures.append("e serve, f teacher AR: skipped (no "
                            "trained workdirs from phase d)")
    if args.summary:
        with open(args.summary, "w") as f:
            json.dump({"failures": failures, **summary}, f, indent=1,
                      default=str)
    if failures:
        print("FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
