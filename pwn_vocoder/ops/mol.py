"""(Discretized) mixture-of-logistics ops.

Reference parity: `modules.py::discretized_mol_loss / sample_from_mol` [R]
(SURVEY.md §2a) — the teacher WaveNet's output head.  Semantics follow the
PixelCNN++ discretization over 16-bit amplitude bins (SURVEY.md §8,
BASELINE configs[1]: "10-component MoL").

Numerics: the loss runs in fp32 regardless of the compute dtype of the
conv stack (bf16 logsumexp over mixture components is the classic numeric
trap — SURVEY.md §7 "MoL numerical edges"); everything is elementwise
work that XLA fuses into the surrounding graph.

Parameter layout: `params[..., 3*K]` splits into
  logit_probs = params[..., 0:K]
  means       = params[..., K:2K]
  log_scales  = params[..., 2K:3K]  (clamped at log_scale_min)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

NUM_CLASSES = 65536  # 16-bit amplitude discretization


def split_params(params: jax.Array):
    k = params.shape[-1] // 3
    logit_probs = params[..., :k].astype(jnp.float32)
    means = params[..., k : 2 * k].astype(jnp.float32)
    log_scales = params[..., 2 * k :].astype(jnp.float32)
    return logit_probs, means, log_scales


def discretized_mol_log_prob(
    x: jax.Array,
    params: jax.Array,
    num_classes: int = NUM_CLASSES,
    log_scale_min: float = -9.0,
) -> jax.Array:
    """Log-probability of x in [-1, 1] under the discretized MoL.

    x: (...,), params: (..., 3*K).  Returns (...,) fp32 log-probs.
    """
    logit_probs, means, log_scales = split_params(params)
    log_scales = jnp.maximum(log_scales, log_scale_min)
    x = x.astype(jnp.float32)[..., None]

    half_bin = 1.0 / (num_classes - 1)
    centered = x - means
    inv_s = jnp.exp(-log_scales)
    plus_in = inv_s * (centered + half_bin)
    min_in = inv_s * (centered - half_bin)

    cdf_plus = jax.nn.sigmoid(plus_in)
    cdf_min = jax.nn.sigmoid(min_in)
    # log CDF at the right edge (for x ~ -1) / log SF at left edge (x ~ +1)
    log_cdf_plus = plus_in - jax.nn.softplus(plus_in)
    log_one_minus_cdf_min = -jax.nn.softplus(min_in)

    cdf_delta = cdf_plus - cdf_min
    mid_in = inv_s * centered
    # log pdf of the continuous logistic at the bin center, times bin width —
    # the numerically-safe fallback when cdf_delta underflows.
    log_pdf_mid = mid_in - log_scales - 2.0 * jax.nn.softplus(mid_in)

    inner = jnp.where(
        cdf_delta > 1e-5,
        jnp.log(jnp.maximum(cdf_delta, 1e-12)),
        log_pdf_mid + jnp.log(half_bin * 2.0),
    )
    log_probs = jnp.where(
        x < -0.999,
        log_cdf_plus,
        jnp.where(x > 0.999, log_one_minus_cdf_min, inner),
    )
    log_probs = log_probs + jax.nn.log_softmax(logit_probs, axis=-1)
    return jax.nn.logsumexp(log_probs, axis=-1)


def discretized_mol_loss(
    x: jax.Array,
    params: jax.Array,
    num_classes: int = NUM_CLASSES,
    log_scale_min: float = -9.0,
) -> jax.Array:
    """Mean negative log-likelihood (nats per sample)."""
    return -jnp.mean(
        discretized_mol_log_prob(x, params, num_classes, log_scale_min)
    )


def mol_log_density(
    x: jax.Array, params: jax.Array, log_scale_min: float = -9.0
) -> jax.Array:
    """CONTINUOUS mixture-of-logistics log-density log p(x).

    Used for the distillation cross-entropy term E_z[-log p_T(x_S(z))]
    [PW]: the KL between student (continuous IAF density) and teacher is
    taken under the teacher's continuous mixture density.
    """
    logit_probs, means, log_scales = split_params(params)
    log_scales = jnp.maximum(log_scales, log_scale_min)
    x = x.astype(jnp.float32)[..., None]
    mid_in = (x - means) * jnp.exp(-log_scales)
    log_pdf = mid_in - log_scales - 2.0 * jax.nn.softplus(mid_in)
    return jax.nn.logsumexp(
        log_pdf + jax.nn.log_softmax(logit_probs, axis=-1), axis=-1
    )


def sample_from_mol(
    key: jax.Array,
    params: jax.Array,
    log_scale_min: float = -9.0,
    temperature: float = 1.0,
) -> jax.Array:
    """Draw one sample per leading position from the MoL. Returns (...,)."""
    logit_probs, means, log_scales = split_params(params)
    log_scales = jnp.maximum(log_scales, log_scale_min)
    k_mix, k_u = jax.random.split(key)

    # Gumbel-max mixture component selection.
    gumbel = -jnp.log(-jnp.log(
        jax.random.uniform(k_mix, logit_probs.shape, minval=1e-5,
                           maxval=1.0 - 1e-5)
    ))
    comp = jnp.argmax(logit_probs + gumbel, axis=-1)
    onehot = jax.nn.one_hot(comp, logit_probs.shape[-1], dtype=jnp.float32)
    mean = jnp.sum(means * onehot, axis=-1)
    log_scale = jnp.sum(log_scales * onehot, axis=-1)

    # Inverse-CDF sample of the logistic.
    u = jax.random.uniform(k_u, mean.shape, minval=1e-5, maxval=1.0 - 1e-5)
    x = mean + jnp.exp(log_scale) * temperature * (
        jnp.log(u) - jnp.log1p(-u)
    )
    return jnp.clip(x, -1.0, 1.0)


def logistic_log_density(
    x: jax.Array, mean: jax.Array, log_scale: jax.Array
) -> jax.Array:
    """log pdf of a single logistic(mean, scale) — the student's base/output
    density building block (IAF closed-form likelihood, SURVEY.md §8)."""
    z = (x - mean) * jnp.exp(-log_scale)
    return z - log_scale - 2.0 * jax.nn.softplus(z)


def sample_logistic(key: jax.Array, shape, dtype=jnp.float32) -> jax.Array:
    """z ~ Logistic(0, 1) — the student IAF's base noise."""
    u = jax.random.uniform(key, shape, dtype=dtype, minval=1e-5,
                           maxval=1.0 - 1e-5)
    return jnp.log(u) - jnp.log1p(-u)
