"""Normalization variants (reference `modules.py::normalize` [R],
SURVEY.md §2a "normalization (instance/weight norm variants)").

The reference exposed instance-norm and weight-norm wrappers around its
convs; the MoL teacher/IAF student here train fine without them, but they
are part of the reference's op surface, so both are provided:

* `instance_norm` — per-(batch, channel) normalization over time, with
  optional learnable gamma/beta (`init_instance_norm`).
* `weight_norm` — reparameterize a conv kernel as g * v / ||v|| (per
  output channel); `init_weight_norm_conv` + `weight_norm_conv1d` are a
  causal conv using it (params: v (K, Cin, Cout), g (Cout,), bias).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pwn_vocoder.ops.conv import causal_conv1d

_conv_init = jax.nn.initializers.variance_scaling(
    1.0, "fan_in", "truncated_normal", in_axis=(0, 1), out_axis=2
)


def instance_norm(
    x: jax.Array,
    gamma: jax.Array | None = None,
    beta: jax.Array | None = None,
    eps: float = 1e-5,
    axis: int = 1,
) -> jax.Array:
    """Normalize (B, T, C) over the time axis per batch/channel."""
    mean = jnp.mean(x, axis=axis, keepdims=True)
    var = jnp.var(x, axis=axis, keepdims=True)
    out = (x - mean) * jax.lax.rsqrt(var + eps)
    if gamma is not None:
        out = out * gamma
    if beta is not None:
        out = out + beta
    return out


def init_instance_norm(channels: int) -> dict:
    """Learnable instance-norm params: gamma = 1, beta = 0."""
    return {"gamma": jnp.ones((channels,)), "beta": jnp.zeros((channels,))}


def weight_norm(v: jax.Array, g: jax.Array, eps: float = 1e-8) -> jax.Array:
    """Kernel (K, Cin, Cout) = g * v / ||v||_{K,Cin} per output channel."""
    norm = jnp.sqrt(jnp.sum(jnp.square(v), axis=(0, 1), keepdims=True))
    return v * (g / jnp.maximum(norm, eps))


def init_weight_norm_conv(key: jax.Array, in_features: int, features: int,
                          kernel_size: int = 1) -> dict:
    """Weight-normalized conv params; g starts at ||v||, so the initial
    effective kernel v*g/||v|| equals v exactly and the conv matches a
    plain conv at init."""
    v = _conv_init(key, (kernel_size, in_features, features))
    return {
        "v": v,
        "g": jnp.sqrt(jnp.sum(jnp.square(v), axis=(0, 1))),
        "bias": jnp.zeros((features,)),
    }


def weight_norm_conv1d(params: dict, x: jax.Array, dilation: int = 1,
                       dtype=jnp.float32) -> jax.Array:
    """Causal dilated conv with the weight-normalized kernel."""
    kernel = weight_norm(params["v"], params["g"])
    return causal_conv1d(x.astype(dtype), kernel.astype(dtype), dilation,
                         params["bias"].astype(dtype))
