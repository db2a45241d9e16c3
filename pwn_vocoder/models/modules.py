"""Building blocks shared by teacher and student, as plain init and apply
functions over nested parameter dicts.

Reference parity: `modules.py` [R] (SURVEY.md §2a) — causal conv1d with
dilation, gated activation unit with conditioning, residual+skip block,
transposed-conv mel upsampler.  Rebuilt for XLA:

* channels-last layout, K=2 convs as shifted matmuls (see ops/conv.py),
* params stored fp32, compute in a configurable dtype (bf16 by default),
  with the output head forced back to fp32 for the loss,
* stable parameter names (`front`, `layer_{i}`, `head1`, `head2`, ...)
  so the `lax.scan` fast-sampling path (models/sampling.py) and the TP
  sharding rules (parallel/tp.py) address one flat layout.

The WaveNet stack has two execution paths over that one layout, and each
call site picks one in code: inference runs `scan_layers` (one
`lax.scan` over stacked layer weights), while training and frozen-teacher
scoring run `unrolled_layers` (a flat per-layer graph, whose backward XLA
schedules better than a scan's).  `reference_stack_xla` is the fp32-
accumulating reference both are tested against.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Sequence

import jax
import jax.numpy as jnp

from pwn_vocoder.ops.conv import causal_conv1d, conv_transpose1d, shift_right
from pwn_vocoder.ops.norm import weight_norm

Params = Dict[str, Any]

_conv_kernel_init = jax.nn.initializers.variance_scaling(
    1.0, "fan_in", "truncated_normal", in_axis=(0, 1), out_axis=2
)
_dense_init = jax.nn.initializers.variance_scaling(
    1.0, "fan_in", "truncated_normal"
)
_zeros = jax.nn.initializers.zeros


class ParamInit:
    """Draws the parameters of one scope of the parameter tree.

    The k-th parameter (k = 1, 2, ...) drawn under scope path
    (p1, ..., pn) uses the key fold_in(rng, h), with h the first four
    bytes of sha1(p1 + ... + pn + k) read as a big-endian uint32.  This is
    the derivation of the flax.linen modules the models were first
    written with, so a seed still gives the parameters that the golden
    fixtures (tests/goldens/) and existing checkpoints were made from.
    """

    def __init__(self, rng: jax.Array, path: tuple = ()):
        self.rng = rng
        self.path = tuple(path)
        self._count = 0

    def child(self, name: str) -> "ParamInit":
        return ParamInit(self.rng, self.path + (name,))

    def __call__(self, init_fn, shape) -> jax.Array:
        self._count += 1
        h = hashlib.sha1()
        for part in self.path + (self._count,):
            if isinstance(part, str):
                h.update(part.encode("utf-8"))
            else:
                h.update(part.to_bytes((part.bit_length() + 7) // 8, "big"))
        fold = int.from_bytes(h.digest()[:4], "big")
        return init_fn(jax.random.fold_in(self.rng, jnp.uint32(fold)), shape)


class Model:
    """`apply(variables, *args, method=None)` runs `forward` (or the named
    method) on `variables["params"]`; subclasses define `init(rng)`."""

    def apply(self, variables: Params, *args, method: str | None = None,
              **kwargs):
        fn = getattr(self, method) if method else self.forward
        return fn(variables["params"], *args, **kwargs)


# ---------------------------------------------------------------------------
# 1x1 / K-tap causal convolution
# ---------------------------------------------------------------------------


def init_conv(init: ParamInit, in_features: int, features: int,
              kernel_size: int = 1) -> Params:
    return {
        "kernel": init(_conv_kernel_init,
                       (kernel_size, in_features, features)),
        "bias": init(_zeros, (features,)),
    }


def conv(p: Params, x: jax.Array, dtype, dilation: int = 1) -> jax.Array:
    """Causal dilated conv with kernel (K, Cin, Cout), computed in dtype."""
    return causal_conv1d(x.astype(dtype), p["kernel"].astype(dtype),
                         dilation, p["bias"].astype(dtype))


# ---------------------------------------------------------------------------
# Gated residual stack
# ---------------------------------------------------------------------------


def init_gated_layer(init: ParamInit, C: int, G: int, S: int,
                     cond_dim: int) -> Params:
    """One gated residual layer's flat parameter set:
        w_dilated (2, C, G), b_dilated, w_cond (M, G), b_cond,
        w_res (G/2, C), b_res, w_skip (G/2, S), b_skip
    (drawn in this order)."""
    return {
        "w_dilated": init(_conv_kernel_init, (2, C, G)),
        "b_dilated": init(_zeros, (G,)),
        "w_cond": init(_dense_init, (cond_dim, G)),
        "b_cond": init(_zeros, (G,)),
        "w_res": init(_dense_init, (G // 2, C)),
        "b_res": init(_zeros, (C,)),
        "w_skip": init(_dense_init, (G // 2, S)),
        "b_skip": init(_zeros, (S,)),
    }


def init_stack(init: ParamInit, n_layers: int, residual_channels: int,
               gate_channels: int, skip_channels: int, cond_dim: int,
               out_dim: int, kernel_size: int = 2) -> Params:
    """Front 1x1 (1 -> C), `n_layers` gated layers, head 1x1s (S -> S ->
    out_dim)."""
    if kernel_size != 2:
        raise NotImplementedError("WaveNet stacks use kernel_size=2")
    C, G, S = residual_channels, gate_channels, skip_channels
    p = {"front": init_conv(init.child("front"), 1, C)}
    for i in range(n_layers):
        p[f"layer_{i}"] = init_gated_layer(init.child(f"layer_{i}"),
                                           C, G, S, cond_dim)
    p["head1"] = init_conv(init.child("head1"), S, S)
    p["head2"] = init_conv(init.child("head2"), S, out_dim)
    return p


def gated_layer_xla(x, cond, lp, dilation, dtype):
    """One gated layer as two wide GEMMs:

        h  = W_dilated *_d x  +  W_cond * c
        z  = tanh(h_a) * sigmoid(h_b)
        out_residual = x + W_res z ;  out_skip = W_skip z

    computed as [x | shift(x,d) | cond] @ stacked gate weights, then
    z @ [W_res | W_skip] — the same contraction the scan path uses.
    """
    dt = dtype
    w_in = jnp.concatenate(
        [lp["w_dilated"][1], lp["w_dilated"][0], lp["w_cond"]], axis=0
    ).astype(dt)
    cat = jnp.concatenate([x, shift_right(x, dilation), cond], axis=-1)
    g = jnp.einsum("btk,kg->btg", cat, w_in) + (
        lp["b_dilated"] + lp["b_cond"]
    ).astype(dt)
    a, b = jnp.split(g, 2, axis=-1)
    z = jnp.tanh(a) * jax.nn.sigmoid(b)
    w_out = jnp.concatenate(
        [lp["w_res"], lp["w_skip"]], axis=1
    ).astype(dt)
    out = jnp.einsum("btg,go->bto", z, w_out)
    C = x.shape[-1]
    res = x + out[..., :C] + lp["b_res"].astype(dt)
    skip = out[..., C:] + lp["b_skip"].astype(dt)
    return res, skip


def stack_weights(layers: Sequence[Params], dtype):
    """Stack per-layer params into the (L, ...) layout of the scan path
    and of `reference_stack_xla`; gate operand order [x, shifted, cond].

    Returns (w_in (L, 2C+M, G), b_g (L, G), w_out (L, G/2, C+S),
    b_res (L, C), b_skip (L, S)), all in dtype."""

    def stk(name):
        return jnp.stack([lp[name] for lp in layers])

    w_in = jnp.concatenate(
        [stk("w_dilated")[:, 1], stk("w_dilated")[:, 0], stk("w_cond")],
        axis=1,
    ).astype(dtype)
    b_g = (stk("b_dilated") + stk("b_cond")).astype(dtype)
    w_out = jnp.concatenate([stk("w_res"), stk("w_skip")],
                            axis=2).astype(dtype)
    return (w_in, b_g, w_out, stk("b_res").astype(dtype),
            stk("b_skip").astype(dtype))


def unrolled_layers(x, cond, layers, dilations, dtype):
    """Skip sum of the gated layers as a flat per-layer graph (the path
    of training and frozen-teacher scoring)."""
    S = layers[0]["w_skip"].shape[-1]
    skip_total = jnp.zeros(x.shape[:-1] + (S,), dtype=dtype)
    for lp, dilation in zip(layers, dilations):
        x, skip = gated_layer_xla(x, cond, lp, dilation, dtype)
        skip_total = skip_total + skip
    return skip_total


def scan_layers(x, cond, layers, dilations, dtype):
    """Skip sum of the gated layers as ONE lax.scan over stacked weights
    (the inference path)."""
    C = x.shape[-1]
    S = layers[0]["w_skip"].shape[-1]
    T = x.shape[1]
    d_max = max(dilations)
    w_in, b_g, w_out, b_res, b_skip = stack_weights(layers, dtype)
    dils = jnp.asarray(dilations, jnp.int32)

    def body(carry, inputs):
        x, skip = carry
        w_in_l, b_g_l, w_out_l, b_res_l, b_skip_l, d = inputs
        # shift(x, d) with per-layer d: static-size dynamic_slice into a
        # max-dilation left pad (zeros = causal padding); also correct
        # when d >= T.
        xp = jnp.pad(x, ((0, 0), (d_max, 0), (0, 0)))
        shifted = jax.lax.dynamic_slice_in_dim(xp, d_max - d, T, axis=1)
        cat = jnp.concatenate([x, shifted, cond], axis=-1)
        g = jnp.einsum("btk,kg->btg", cat, w_in_l) + b_g_l
        a, b = jnp.split(g, 2, axis=-1)
        z = jnp.tanh(a) * jax.nn.sigmoid(b)
        out = jnp.einsum("btg,go->bto", z, w_out_l)
        x = x + out[..., :C] + b_res_l
        skip = skip + out[..., C:] + b_skip_l
        return (x, skip), None

    (_, skip_total), _ = jax.lax.scan(
        body,
        (x, jnp.zeros(x.shape[:-1] + (S,), dtype)),
        (w_in, b_g, w_out, b_res, b_skip, dils),
    )
    return skip_total


def reference_stack_xla(x0, cond, w_in, b_g, w_out, b_rs, dilations):
    """Reference skip sum over stacked weights (`stack_weights` layout,
    b_rs = [b_res | b_skip]): a flat per-layer graph that accumulates the
    GEMMs, biases and skip sum in fp32 whatever the operand dtype.  The
    scan and unrolled paths are tested against it."""
    C = x0.shape[-1]
    dt = x0.dtype
    x = x0
    S = w_out.shape[-1] - C
    skip = jnp.zeros(x0.shape[:-1] + (S,), jnp.float32)
    condc = cond.astype(dt)
    for l, d in enumerate(dilations):
        shifted = shift_right(x, d, axis=1)
        cat = jnp.concatenate([x, shifted, condc], axis=-1)
        g = jnp.einsum("btk,kg->btg", cat, w_in[l]).astype(
            jnp.float32
        ) + b_g[l].astype(jnp.float32)
        a, b = jnp.split(g, 2, axis=-1)
        z = (jnp.tanh(a) * jax.nn.sigmoid(b)).astype(dt)
        out = jnp.einsum("btg,go->bto", z, w_out[l]).astype(
            jnp.float32
        ) + b_rs[l].astype(jnp.float32)
        x = x + out[..., :C].astype(dt)
        skip = skip + out[..., C:]
    return skip.astype(dt)


def wavenet_stack(p: Params, x: jax.Array, cond: jax.Array,
                  dilations: Sequence[int], dtype,
                  use_scan: bool) -> jax.Array:
    """Front 1x1 -> dilated gated layers (skip sum) -> relu/1x1 head.

    The shared trunk of the teacher (out_dim = head_dim) and of each
    student IAF flow (out_dim = 2: mu, log_s).  `use_scan` picks the
    inference path (True) or the training/scoring path (False); both
    compute the same function.  Returns fp32.
    """
    x = conv(p["front"], x, dtype)
    cond = cond.astype(dtype)
    layers = [p[f"layer_{i}"] for i in range(len(dilations))]
    layer_fn = scan_layers if use_scan else unrolled_layers
    skip_total = layer_fn(x, cond, layers, dilations, dtype)
    h = jax.nn.relu(skip_total)
    h = jax.nn.relu(conv(p["head1"], h, dtype))
    return conv(p["head2"], h, dtype).astype(jnp.float32)


# ---------------------------------------------------------------------------
# Mel upsampler
# ---------------------------------------------------------------------------


def init_upsample(init: ParamInit, strides: Sequence[int], in_channels: int,
                  channels: int, kernel_mult: int = 2,
                  weight_norm: bool = False) -> Params:
    """Transposed-conv upsampler params: `kernel_{i}`/`bias_{i}` per
    stride, or `v_{i}`/`g_{i}`/`bias_{i}` with weight normalization
    (ops/norm.py — the reference's `normalize` wrapper [R]; off by
    default, the goldens pin the plain parameterization).  g starts at
    ||v||, so the initial effective kernel equals v exactly."""
    p: Params = {}
    c_in = in_channels
    for i, stride in enumerate(strides):
        shape = (stride * kernel_mult, c_in, channels)
        if weight_norm:
            v = init(_conv_kernel_init, shape)
            p[f"v_{i}"] = v
            p[f"g_{i}"] = init(
                lambda key, _, v=v: jnp.sqrt(jnp.sum(jnp.square(v),
                                                     axis=(0, 1))),
                (channels,),
            )
        else:
            p[f"kernel_{i}"] = init(_conv_kernel_init, shape)
        p[f"bias_{i}"] = init(_zeros, (channels,))
        c_in = channels
    return p


def upsample(p: Params, mel: jax.Array, strides: Sequence[int],
             dtype) -> jax.Array:
    """Mel-frame -> sample-rate conditioning: (B, F, n_mels) ->
    (B, F*prod(strides), channels).  Reference parity: transposed-conv
    mel upsampling in `modules.py` [R]."""
    x = mel.astype(dtype)
    for i, stride in enumerate(strides):
        if f"v_{i}" in p:
            kernel = weight_norm(p[f"v_{i}"], p[f"g_{i}"])
        else:
            kernel = p[f"kernel_{i}"]
        x = conv_transpose1d(x, kernel.astype(dtype), stride,
                             p[f"bias_{i}"].astype(dtype))
        x = jax.nn.leaky_relu(x, 0.4)
    return x


def shift_right_scalar(x: jax.Array) -> jax.Array:
    """(B, T) waveform -> (B, T, 1) of previous samples (AR input)."""
    return shift_right(x[..., None], 1)
