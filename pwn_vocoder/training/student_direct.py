"""Direct (teacher-free) student training: maximum likelihood on the
closed-form IAF density + spectral power loss.

Reference parity: the public repo's actual WIP training mode — SURVEY.md
§2a flags that `models.py::IAFVocoder` [R] likely trained the student IAF
directly (likelihood + spectral "power" loss) without a teacher.  The
distillation pipeline (training/distill.py) remains the north-star path;
this mode completes the reference's capability surface (VERDICT round 1,
missing item 1).

The tractable likelihood: the flow chain is elementwise affine in the base
noise given the causal context, x[t] = S[t] * z0[t] + M[t] with
S = exp(Σ log s_i) and M the accumulated offset (StudentOutput.mu_total).
Since z0[t] ~ Logistic(0, 1), the model's per-timestep output conditional
is exactly Logistic(M[t], S[t]) — so

    ML = E_z[ -mean_t log Logistic(x_ref[t]; M[t], S[t]) ]

is the closed-form student density evaluated at the ground truth (at
x = x_S it reduces to the usual log p_base(z0) - Σ log s identity).  The
power term anchors the spectral envelope exactly as in distillation.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from pwn_vocoder.config import Config
from pwn_vocoder.models.student import StudentIAF, sample_base_noise
from pwn_vocoder.ops import gaussian, mol
from pwn_vocoder.parallel.mesh import batch_sharding, replicated
from pwn_vocoder.training.common import (
    TrainState,
    global_norm,
    make_optimizer,
    update_ema,
)
from pwn_vocoder.training.distill import spectral_power_loss
from pwn_vocoder.training.teacher import prepare_batch


def direct_student_losses(
    student: StudentIAF,
    params: Any,
    x_ref: jax.Array,
    mel: jax.Array,
    key: jax.Array,
    cfg: Config,
) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    """Total direct-training loss + metrics for one batch (model domain)."""
    dc = cfg.distill

    def one_sample(k):
        z = sample_base_noise(cfg, k, x_ref.shape)
        out = student.apply({"params": params}, z, mel)
        # closed-form output conditional base(mu_total, exp(log_det)):
        # Logistic for the default base, N for student.base="gaussian"
        if cfg.student.base == "gaussian":
            log_p = gaussian.gaussian_log_density(
                x_ref, out.mu_total, out.log_det
            )
        else:
            log_p = mol.logistic_log_density(
                x_ref, out.mu_total, out.log_det
            )
        ml = -jnp.mean(log_p)
        power = spectral_power_loss(out.wav, x_ref, cfg)
        return ml, power

    keys = jax.random.split(key, dc.n_kl_samples)
    acc = [one_sample(keys[i]) for i in range(dc.n_kl_samples)]
    ml, power = (
        sum(t[i] for t in acc) / dc.n_kl_samples for i in range(2)
    )
    total = dc.ml_weight * ml + dc.power_loss_weight * power
    metrics = {"loss": total, "ml_nll": ml, "power_loss": power}
    return total, metrics


def make_student_direct_train_step(
    student: StudentIAF, cfg: Config, mesh: Mesh | None = None
):
    """Returns jitted `(state, wav) -> (state, metrics)` — same sharding
    contract as the teacher/distill steps (batch on `data`, state
    replicated)."""
    tx = make_optimizer(cfg.train)

    def train_step(state: TrainState, wav: jax.Array):
        x_ref, mel = prepare_batch(wav, cfg)
        step_key = jax.random.fold_in(state.rng, state.step)

        def loss_fn(p):
            return direct_student_losses(
                student, p, x_ref, mel, step_key, cfg
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
        # TP: caller-driven placement (see training/teacher.py note).
        return jax.jit(train_step, donate_argnums=(0,))

    # DP via shard_map (see training/teacher.py); per-shard
    # stochastic-loss keys fold in the data-axis index.
    rep = replicated(mesh)

    def dp_grads(params, wav, step_key):
        x_ref, mel = prepare_batch(wav, cfg)
        key = jax.random.fold_in(step_key, jax.lax.axis_index("data"))

        def loss_fn(p):
            return direct_student_losses(
                student, p, x_ref, mel, key, cfg
            )

        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params
        )
        return jax.lax.pmean((metrics, grads), "data")

    sharded_grads = jax.shard_map(
        dp_grads, mesh=mesh, in_specs=(P(), P("data"), P()),
        out_specs=P(),
        check_vma=False,
    )

    def dp_train_step(state: TrainState, wav: jax.Array):
        step_key = jax.random.fold_in(state.rng, state.step)
        metrics, grads = sharded_grads(state.params, wav, step_key)
        metrics["grad_norm"] = global_norm(grads)
        state = state.apply_gradients(grads, tx)
        if cfg.train.ema_decay > 0:
            state = update_ema(state, cfg.train.ema_decay)
        return state, metrics

    return jax.jit(
        dp_train_step,
        in_shardings=(rep, batch_sharding(mesh)),
        out_shardings=(rep, rep),
        donate_argnums=(0,),
    )


def make_student_direct_eval_step(
    student: StudentIAF, cfg: Config, mesh: Mesh | None = None
):
    """Jitted held-out direct-training metrics (fixed key)."""

    def eval_step(params, wav):
        x_ref, mel = prepare_batch(wav, cfg)
        _, metrics = direct_student_losses(
            student, params, x_ref, mel, jax.random.PRNGKey(0), cfg
        )
        return metrics

    if mesh is None or mesh.shape.get("model", 1) > 1:
        return jax.jit(eval_step)
    rep = replicated(mesh)
    return jax.jit(eval_step, in_shardings=(rep, rep), out_shardings=rep)
