"""Causal / dilated / transposed 1-D convolution primitives.

Reference parity: `modules.py::causal_conv` and the transposed-conv mel
upsampler [R] (SURVEY.md §2a).  Design decisions:

* Layout is channels-last `(batch, time, channels)` everywhere — the
  contiguous last dimension holds channels, the contraction dimension of
  every GEMM below.
* For `kernel_size == 2` (the WaveNet case) the dilated causal conv is
  computed as TWO shifted matmuls
      y[t] = x[t] @ W1 + x[t-d] @ W0
  instead of `lax.conv_general_dilated`.  Each is a `(B*T, Cin) x (Cin, Co)`
  GEMM that XLA hands to its matmul library, fuses with the surrounding
  elementwise work, and — crucially for tensor parallelism — shards cleanly
  along the channel axes without the conv op's layout restrictions.
* General kernel sizes fall back to `lax.conv_general_dilated` with explicit
  left padding `(K-1)*d` (zero future leakage; tested by a causality probe).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

# dimension_numbers for 1-D channels-last convs
_DN = ("NWC", "WIO", "NWC")


def shift_right(x: jax.Array, amount: int, axis: int = 1) -> jax.Array:
    """Shift along `axis` by `amount`, zero-filling at the start.

    shift_right(x, d)[..., t, :] == x[..., t-d, :]  (0 for t < d).
    """
    if amount == 0:
        return x
    if amount >= x.shape[axis]:
        # receptive field longer than the sequence: everything is padding
        return jnp.zeros_like(x)
    pad = [(0, 0)] * x.ndim
    pad[axis] = (amount, 0)
    sliced = lax.slice_in_dim(x, 0, x.shape[axis] - amount, axis=axis)
    return jnp.pad(sliced, pad)


def causal_conv1d(
    x: jax.Array,
    kernel: jax.Array,
    dilation: int = 1,
    bias: jax.Array | None = None,
) -> jax.Array:
    """Causal dilated conv: x (B, T, Cin), kernel (K, Cin, Cout) -> (B, T, Cout).

    Output at time t depends only on x[t], x[t-d], ..., x[t-(K-1)d].
    """
    k = kernel.shape[0]
    if k == 1:
        out = jnp.einsum("btc,co->bto", x, kernel[0])
    elif k == 2:
        # shifted-matmul path (see module docstring).
        out = jnp.einsum("btc,co->bto", x, kernel[1]) + jnp.einsum(
            "btc,co->bto", shift_right(x, dilation), kernel[0]
        )
    else:
        pad = (k - 1) * dilation
        out = lax.conv_general_dilated(
            x,
            kernel,
            window_strides=(1,),
            padding=[(pad, 0)],
            rhs_dilation=(dilation,),
            dimension_numbers=_DN,
        )
    if bias is not None:
        out = out + bias
    return out


def conv1d_step(
    x_tap: jax.Array,
    x_now: jax.Array,
    kernel: jax.Array,
    bias: jax.Array | None = None,
) -> jax.Array:
    """Single-timestep K=2 dilated conv for AR generation (Fast WaveNet
    [P:6]): given the queued activation x[t-d] (`x_tap`, (B, Cin)) and the
    current x[t] (`x_now`, (B, Cin)), produce y[t] (B, Cout).

    This is the hot op of the teacher's `lax.scan` sampling loop — two
    (B, Cin) x (Cin, Cout) GEMMs per layer per step.
    """
    out = x_now @ kernel[1] + x_tap @ kernel[0]
    if bias is not None:
        out = out + bias
    return out


def conv_transpose1d(
    x: jax.Array,
    kernel: jax.Array,
    stride: int,
    bias: jax.Array | None = None,
) -> jax.Array:
    """Length-exact transposed conv (upsampling by `stride`).

    x (B, F, Cin), kernel (K, Cin, Cout) -> (B, F*stride, Cout).

    The raw transposed conv produces (F-1)*stride + K samples; we crop so
    output frame f*stride..(f+1)*stride-1 is driven by input frames around
    f — the mel-upsampler convention (reference `modules.py` upsampling [R]).
    """
    k = kernel.shape[0]
    # lax.conv_transpose explicit padding applies to the stride-dilated
    # input; (k-1, k-1) yields the full overlap-add output of length
    # (F-1)*stride + K, which we then crop to exactly F*stride.
    out = lax.conv_transpose(
        x,
        kernel,
        strides=(stride,),
        padding=[(k - 1, k - 1)],
        dimension_numbers=_DN,
    )
    extra = k - stride
    if extra < 0:
        raise ValueError("kernel must be >= stride for exact upsampling")
    lead = extra // 2
    out = lax.slice_in_dim(out, lead, lead + x.shape[1] * stride, axis=1)
    if bias is not None:
        out = out + bias
    return out
