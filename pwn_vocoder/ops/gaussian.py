"""Single-Gaussian output ops: the ClariNet-style alternative to the
mixture-of-logistics head (Ping et al., arXiv:1807.07281).

Why this exists (round-3 quality finding): Parallel WaveNet's sampled
reverse-KL estimator is the measured weak point of distillation on
speech-like signal (BASELINE.md round-2 speech demo: KL 2.5 nats/sample
vs 0.03 on harmonic tones; multi-res power loss + warmup recover only
part of it).  With a *single Gaussian* teacher head and a Gaussian-base
student IAF, the per-timestep reverse KL has a CLOSED FORM — zero
Monte-Carlo variance in the density term — which is ClariNet's central
trick.  Both output families share the WaveNet trunk; only the tiny
head and the loss change.

Reference parity note: the reference repo's head was MoL (`modules.py`
[R], SURVEY.md §8); the Gaussian family is a beyond-reference capability
selected via `teacher.output="gaussian"` / `student.base="gaussian"` /
`distill.objective="closed_form"` (config.py).  All defaults keep the
MoL semantics and the frozen goldens bit-exact.

Parameter layout: `params[..., 2]` = (mean, log_scale), fp32 math.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def split_params(params: jax.Array):
    """(..., 2) head output -> fp32 (mean, log_scale)."""
    return (
        params[..., 0].astype(jnp.float32),
        params[..., 1].astype(jnp.float32),
    )


def gaussian_log_density(
    x: jax.Array, mean: jax.Array, log_scale: jax.Array
) -> jax.Array:
    """log N(x; mean, exp(log_scale)^2), elementwise fp32."""
    x = x.astype(jnp.float32)
    z = (x - mean) * jnp.exp(-log_scale)
    return -0.5 * (z * z) - log_scale - 0.5 * jnp.log(2.0 * jnp.pi)


def gaussian_nll(
    x: jax.Array, params: jax.Array, log_scale_min: float = -9.0
) -> jax.Array:
    """Mean negative log-likelihood (nats/sample) of the (mu, log_s) head.

    Continuous density with a clamped log-scale floor, per ClariNet §3
    (a discretized variant buys nothing for distillation and loses the
    closed-form KL).
    """
    mean, log_scale = split_params(params)
    log_scale = jnp.maximum(log_scale, log_scale_min)
    return -jnp.mean(gaussian_log_density(x, mean, log_scale))


def sample_from_gaussian(
    key: jax.Array,
    params: jax.Array,
    log_scale_min: float = -9.0,
    temperature: float = 1.0,
) -> jax.Array:
    """Draw one sample per leading position. Returns (...,) in [-1, 1]."""
    mean, log_scale = split_params(params)
    log_scale = jnp.maximum(log_scale, log_scale_min)
    eps = jax.random.normal(key, mean.shape, jnp.float32)
    return jnp.clip(
        mean + jnp.exp(log_scale) * temperature * eps, -1.0, 1.0
    )


def kl_gaussian(
    mu_q: jax.Array,
    log_s_q: jax.Array,
    mu_p: jax.Array,
    log_s_p: jax.Array,
) -> jax.Array:
    """Elementwise KL( N(mu_q, s_q^2) || N(mu_p, s_p^2) ), fp32.

        KL = log(s_p/s_q) + (s_q^2 + (mu_q - mu_p)^2) / (2 s_p^2) - 1/2

    The distillation use (training/distill.py closed_form objective) puts
    the student conditional as q and the frozen teacher as p: the reverse
    KL of Parallel WaveNet [PW], evaluated exactly per timestep instead
    of by a one-sample density estimate.
    """
    d = mu_q.astype(jnp.float32) - mu_p.astype(jnp.float32)
    log_r = log_s_p.astype(jnp.float32) - log_s_q.astype(jnp.float32)
    return log_r + 0.5 * (
        jnp.exp(-2.0 * log_r) * (1.0 + d * d * jnp.exp(-2.0 * log_s_q))
        - 1.0
    )


def sample_normal(key: jax.Array, shape, dtype=jnp.float32) -> jax.Array:
    """z ~ N(0, 1) — the Gaussian-base student IAF's noise."""
    return jax.random.normal(key, shape, dtype)
