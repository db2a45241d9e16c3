"""Probability-density distillation of the student IAF from a frozen
teacher (SURVEY.md §8 "Distillation loss"; Parallel WaveNet [PW], BASELINE
config[2]).

    L = w_kl * D_KL(p_S || p_T) + w_pow * ||\\,|STFT(x_S)| - |STFT(x_ref)|\\,||^2

with the KL estimated pathwise per z-sample:

    D_KL ≈ E_z[ log p_S(x_S(z)) - log p_T(x_S(z)) ]
         =  E_z[ log p_base(z) - Σ log s ]  -  E_z[ log p_T(x_S(z)) ]

* `log p_S` is the analytic IAF density (StudentOutput.log_p_student);
* `log p_T` is the teacher's CONTINUOUS MoL density evaluated by ONE
  parallel teacher-forcing pass over the student's own sample — fully
  parallel, no AR loop at training time (SURVEY.md §3.1 hot path);
* the power (spectral magnitude) term anchors the student to the ground
  truth waveform — without it reverse-KL distillation is known to
  collapse to whisper (SURVEY.md §7 "hard parts"), so both terms are
  logged separately.

The teacher's params are a frozen input artifact (stop-gradient); gradients
flow into the student pathwise through x_S.

Of the Parallel WaveNet paper's four loss terms [PW], three are
implemented: KL (above), power (above), and CONTRASTIVE
(`distill.contrastive_weight`: the same student sample also scored under
batch-rolled mismatched conditioning, that KL maximized — A/B'd in
BASELINE.md r5).  The fourth, the PERCEPTUAL loss, requires a pretrained
speech classifier, which cannot exist in this zero-egress environment —
documented as out of scope rather than silently absent.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from pwn_vocoder.config import Config
from pwn_vocoder.models.student import StudentIAF, sample_base_noise
from pwn_vocoder.models.teacher import TeacherWaveNet
from pwn_vocoder.ops import gaussian, mol
from pwn_vocoder.parallel.mesh import batch_sharding, replicated
from pwn_vocoder.training.common import (
    TrainState,
    global_norm,
    make_optimizer,
    update_ema,
)
from pwn_vocoder.training.teacher import prepare_batch
from pwn_vocoder.utils import dsp


def spectral_power_loss(x_s: jax.Array, x_ref: jax.Array,
                        cfg: Config) -> jax.Array:
    """Mean squared STFT-magnitude error, averaged over the primary
    cfg.dsp resolution plus any `distill.power_loss_resolutions` extras
    (multi-resolution spectral loss — single-resolution by default,
    matching Parallel WaveNet's power loss [PW] and the frozen goldens)."""
    resolutions = ((cfg.dsp.n_fft, cfg.dsp.hop_length,
                    cfg.dsp.win_length),) + tuple(
        tuple(r) for r in cfg.distill.power_loss_resolutions
    )
    total = jnp.float32(0)
    for n_fft, hop, win in resolutions:
        mag_s = dsp.stft_magnitude(x_s, n_fft, hop, win)
        mag_r = dsp.stft_magnitude(x_ref, n_fft, hop, win)
        total = total + jnp.mean(jnp.square(mag_s - mag_r))
    return total / len(resolutions)


def resolve_objective(cfg: Config) -> str:
    """Resolve distill.objective to "sampled" | "closed_form".

    "sampled" (Parallel WaveNet [PW]): one-z pathwise estimate of
    E[log p_S - log p_T]; works with ANY (teacher.output, student.base)
    pair.  "closed_form" (ClariNet, arXiv:1807.07281): exact per-timestep
    Gaussian KL — requires teacher.output="gaussian" AND
    student.base="gaussian" (the affine flow then makes the student's
    conditional exactly N(mu_total, exp(log_det)^2)).
    """
    obj = cfg.distill.objective
    is_gg = (
        cfg.teacher.output == "gaussian"
        and cfg.student.base == "gaussian"
    )
    if obj == "auto":
        return "closed_form" if is_gg else "sampled"
    if obj == "closed_form" and not is_gg:
        raise ValueError(
            "distill.objective='closed_form' requires "
            "teacher.output='gaussian' and student.base='gaussian' "
            f"(got {cfg.teacher.output!r}/{cfg.student.base!r})"
        )
    if obj not in ("sampled", "closed_form"):
        raise ValueError(f"unknown distill.objective {obj!r}")
    return obj


def kl_weight_at(cfg: Config, step) -> jax.Array:
    """Effective KL weight: linear ramp over `distill.kl_warmup_steps`
    (constant when warmup is 0 or step is None — eval always scores at
    full weight)."""
    dc = cfg.distill
    if step is None or dc.kl_warmup_steps <= 0:
        return jnp.float32(dc.kl_weight)
    ramp = jnp.minimum(
        (jnp.asarray(step, jnp.float32) + 1.0) / dc.kl_warmup_steps, 1.0
    )
    return dc.kl_weight * ramp


def distillation_losses(
    student: StudentIAF,
    teacher: TeacherWaveNet,
    student_params: Any,
    teacher_params: Any,
    x_ref: jax.Array,
    mel: jax.Array,
    key: jax.Array,
    cfg: Config,
    step=None,
) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    """Total distillation loss + metrics for one batch (model domain)."""
    teacher_params = jax.lax.stop_gradient(teacher_params)
    dc = cfg.distill
    objective = resolve_objective(cfg)

    # Parallel WaveNet's contrastive conditioning [PW]: the same student
    # sample is ALSO scored under another utterance's mel (batch roll);
    # maximizing that mismatched KL penalizes conditioning-independent
    # audio.  Static guard keeps the extra teacher pass (and any graph
    # change) out when the weight is 0 — the goldens pin that graph.
    contrastive = dc.contrastive_weight > 0.0
    mel_mis = jnp.roll(mel, 1, axis=0) if contrastive else None

    def one_sample(k):
        z = sample_base_noise(cfg, k, x_ref.shape)
        out = student.apply({"params": student_params}, z, mel)
        x_s = out.wav
        t_out = teacher.apply({"params": teacher_params}, x_s, mel)
        kl_mis = jnp.float32(0)
        if objective == "closed_form":
            # ClariNet: q = N(mu_total, exp(log_det)^2) — the student's
            # exact conditional given its own causal sample path — vs the
            # teacher conditional p = N(mu_T, s_T^2) at that same path.
            # Gradients flow pathwise through x_s into BOTH sides.
            mu_t, log_s_t = gaussian.split_params(t_out)
            log_s_t = jnp.maximum(log_s_t, cfg.teacher.log_scale_min)
            kl_t = gaussian.kl_gaussian(
                out.mu_total, out.log_det, mu_t, log_s_t
            )
            kl = jnp.mean(kl_t)
            reg = jnp.mean(jnp.square(log_s_t - out.log_det))
            ent = jnp.mean(-out.log_p_student)
            xent = kl + ent  # E_q[-log p] = KL + H(q), both exact here
            if contrastive:
                t_mis = teacher.apply(
                    {"params": teacher_params}, x_s, mel_mis
                )
                mu_m, log_s_m = gaussian.split_params(t_mis)
                log_s_m = jnp.maximum(log_s_m, cfg.teacher.log_scale_min)
                kl_mis = jnp.mean(gaussian.kl_gaussian(
                    out.mu_total, out.log_det, mu_m, log_s_m
                ))
        else:
            if cfg.teacher.output == "gaussian":
                mu_t, log_s_t = gaussian.split_params(t_out)
                log_s_t = jnp.maximum(log_s_t, cfg.teacher.log_scale_min)
                log_p_t = gaussian.gaussian_log_density(x_s, mu_t, log_s_t)
            else:
                log_p_t = mol.mol_log_density(
                    x_s, t_out, cfg.teacher.log_scale_min
                )  # (B, T)
            log_p_s = out.log_p_student  # (B, T)
            kl = jnp.mean(log_p_s - log_p_t)  # nats / sample-step
            reg = jnp.float32(0)
            ent = jnp.mean(-log_p_s)
            xent = jnp.mean(-log_p_t)
            if contrastive:
                t_mis = teacher.apply(
                    {"params": teacher_params}, x_s, mel_mis
                )
                if cfg.teacher.output == "gaussian":
                    mu_m, log_s_m = gaussian.split_params(t_mis)
                    log_s_m = jnp.maximum(log_s_m,
                                          cfg.teacher.log_scale_min)
                    log_p_t_mis = gaussian.gaussian_log_density(
                        x_s, mu_m, log_s_m
                    )
                else:
                    log_p_t_mis = mol.mol_log_density(
                        x_s, t_mis, cfg.teacher.log_scale_min
                    )
                kl_mis = jnp.mean(log_p_s - log_p_t_mis)
        power = spectral_power_loss(x_s, x_ref, cfg)
        return kl, reg, power, ent, xent, kl_mis

    # static python loop over the (small) sample count — a vmap here
    # produces batched-FFT layouts XLA:CPU's fft thunk rejects when the
    # batch is sharded, and n_kl_samples is 1-4 anyway.
    keys = jax.random.split(key, dc.n_kl_samples)
    acc = [one_sample(keys[i]) for i in range(dc.n_kl_samples)]
    kl, reg, power, ent, xent, kl_mis = (
        sum(t[i] for t in acc) / dc.n_kl_samples for i in range(6)
    )
    # contrastive [PW]: minimize KL(matched) - gamma * KL(mismatched);
    # both ride the warmup ramp so the power loss anchors early training
    kl_term = kl - dc.contrastive_weight * kl_mis if contrastive else kl
    total = kl_weight_at(cfg, step) * kl_term \
        + dc.power_loss_weight * power
    metrics = {
        "loss": total,
        "kl": kl,
        "power_loss": power,
        "student_entropy": ent,
        "teacher_xent": xent,
    }
    if contrastive:
        metrics["contrastive_kl"] = kl_mis
    if objective == "closed_form":
        # ClariNet's variance regularizer rides the same warmup ramp as
        # the KL it stabilizes
        total = total + kl_weight_at(cfg, step) * (
            dc.log_sigma_reg_weight * reg
        )
        metrics["loss"] = total
        metrics["log_sigma_reg"] = reg
    return total, metrics


def make_distill_train_step(
    student: StudentIAF,
    teacher: TeacherWaveNet,
    cfg: Config,
    mesh: Mesh | None = None,
):
    """Returns jitted `(state, teacher_params, wav) -> (state, metrics)`.

    state holds the student params + rng; teacher params ride as a frozen
    (replicated) input.  wav is the raw ground-truth batch, sharded on
    `data` under a mesh (BASELINE config[3]: batch 256 over 2 hosts).
    """
    tx = make_optimizer(cfg.train)

    def train_step(state: TrainState, teacher_params: Any, wav: jax.Array):
        x_ref, mel = prepare_batch(wav, cfg)
        step_key = jax.random.fold_in(state.rng, state.step)

        def loss_fn(p):
            return distillation_losses(
                student, teacher, p, teacher_params, x_ref, mel, step_key,
                cfg, step=state.step,
            )

        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params
        )
        metrics["grad_norm"] = global_norm(grads)
        state = state.apply_gradients(grads, tx)
        if cfg.train.ema_decay > 0:
            state = update_ema(state, cfg.train.ema_decay)
        return state, metrics

    if mesh is None:
        return jax.jit(train_step, donate_argnums=(0,))
    if mesh.shape.get("model", 1) > 1:
        # TP: caller-driven placement (see teacher.py note).
        return jax.jit(train_step, donate_argnums=(0,))

    # DP via shard_map (see training/teacher.py)
    rep = replicated(mesh)
    sharded_grads = make_distill_dp_grads(student, teacher, cfg, mesh)

    def dp_train_step(state: TrainState, teacher_params, wav):
        step_key = jax.random.fold_in(state.rng, state.step)
        metrics, grads = sharded_grads(
            state.params, teacher_params, wav, step_key, state.step
        )
        metrics["grad_norm"] = global_norm(grads)
        state = state.apply_gradients(grads, tx)
        if cfg.train.ema_decay > 0:
            state = update_ema(state, cfg.train.ema_decay)
        return state, metrics

    return jax.jit(
        dp_train_step,
        in_shardings=(rep, rep, batch_sharding(mesh)),
        out_shardings=(rep, rep),
        donate_argnums=(0,),
    )


def make_distill_dp_grads(
    student: StudentIAF,
    teacher: TeacherWaveNet,
    cfg: Config,
    mesh: Mesh,
):
    """The data-parallel gradient of the distillation step:
    `(params, teacher_params, wav, step_key, step) -> (metrics, grads)`,
    each shard computing its rows' loss and gradients under shard_map and
    the results pmean'd over `data`.  Shard i draws its KL z-noise from
    fold_in(step_key, i) — a different (equally valid) Monte Carlo
    sample than a single-device draw, deterministic per (step, shard)."""

    def dp_grads(params, teacher_params, wav, step_key, step):
        x_ref, mel = prepare_batch(wav, cfg)
        key = jax.random.fold_in(step_key, jax.lax.axis_index("data"))

        def loss_fn(p):
            return distillation_losses(
                student, teacher, p, teacher_params, x_ref, mel, key, cfg,
                step=step,
            )

        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params
        )
        return jax.lax.pmean((metrics, grads), "data")

    return jax.shard_map(
        dp_grads, mesh=mesh,
        in_specs=(P(), P(), P("data"), P(), P()), out_specs=P(),
        check_vma=False,
    )


def make_distill_eval_step(
    student: StudentIAF,
    teacher: TeacherWaveNet,
    cfg: Config,
    mesh: Mesh | None = None,
):
    """Jitted held-out distillation metrics (fixed key; replicated batch)."""

    def eval_step(student_params, teacher_params, wav):
        x_ref, mel = prepare_batch(wav, cfg)
        _, metrics = distillation_losses(
            student, teacher, student_params, teacher_params, x_ref, mel,
            jax.random.PRNGKey(0), cfg,
        )
        return metrics

    if mesh is None or mesh.shape.get("model", 1) > 1:
        return jax.jit(eval_step)
    rep = replicated(mesh)
    return jax.jit(
        eval_step, in_shardings=(rep, rep, rep), out_shardings=rep
    )
