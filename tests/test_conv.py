"""Conv primitive tests: matmul path ≡ XLA conv, causality probes,
transposed-conv geometry, single-step AR consistency (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from pwn_vocoder.ops import conv


def _xla_causal_conv(x, kernel, dilation):
    k = kernel.shape[0]
    pad = (k - 1) * dilation
    return lax.conv_general_dilated(
        x, kernel, window_strides=(1,), padding=[(pad, 0)],
        rhs_dilation=(dilation,), dimension_numbers=("NWC", "WIO", "NWC"),
    )


@pytest.mark.parametrize("dilation", [1, 2, 8, 64])
def test_k2_matmul_path_equals_xla_conv(rng, dilation):
    x = jnp.asarray(rng.standard_normal((2, 256, 16)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal((2, 16, 24)).astype(np.float32))
    got = conv.causal_conv1d(x, w, dilation)
    want = _xla_causal_conv(x, w, dilation)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k,dilation", [(1, 1), (2, 4), (3, 2), (5, 16)])
def test_causality_zero_future_leakage(rng, k, dilation):
    """Perturbing x[t0:] must not change y[:t0]."""
    x = jnp.asarray(rng.standard_normal((1, 200, 8)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal((k, 8, 8)).astype(np.float32))
    t0 = 100
    y1 = conv.causal_conv1d(x, w, dilation)
    x2 = x.at[:, t0:].add(10.0)
    y2 = conv.causal_conv1d(x2, w, dilation)
    np.testing.assert_array_equal(np.asarray(y1[:, :t0]),
                                  np.asarray(y2[:, :t0]))
    assert not np.allclose(np.asarray(y1[:, t0:]), np.asarray(y2[:, t0:]))


def test_causality_gradient_probe(rng):
    """d y[t] / d x[t'] == 0 for t' > t (gradient-masking probe)."""
    x = jnp.asarray(rng.standard_normal((1, 64, 4)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal((2, 4, 4)).astype(np.float32))
    t = 20

    def out_at_t(xx):
        return jnp.sum(conv.causal_conv1d(xx, w, 4)[0, t])

    g = jax.grad(out_at_t)(x)
    np.testing.assert_array_equal(np.asarray(g[0, t + 1 :]), 0.0)


def test_shift_right(rng):
    x = jnp.asarray(rng.standard_normal((2, 10, 3)).astype(np.float32))
    y = conv.shift_right(x, 2)
    np.testing.assert_array_equal(np.asarray(y[:, :2]), 0.0)
    np.testing.assert_array_equal(np.asarray(y[:, 2:]), np.asarray(x[:, :-2]))


@pytest.mark.parametrize("stride,mult", [(4, 2), (16, 2), (8, 3)])
def test_conv_transpose_length(rng, stride, mult):
    x = jnp.asarray(rng.standard_normal((2, 12, 5)).astype(np.float32))
    w = jnp.asarray(
        rng.standard_normal((stride * mult, 5, 7)).astype(np.float32)
    )
    y = conv.conv_transpose1d(x, w, stride)
    assert y.shape == (2, 12 * stride, 7)


def test_conv_transpose_is_linear_upsampling_of_impulse(rng):
    """An input impulse spreads over exactly `kernel` output taps."""
    stride, k = 4, 8
    x = jnp.zeros((1, 10, 1)).at[0, 5, 0].set(1.0)
    w = jnp.asarray(rng.standard_normal((k, 1, 1)).astype(np.float32))
    y = np.asarray(conv.conv_transpose1d(x, w, stride))[0, :, 0]
    nonzero = np.nonzero(y)[0]
    assert nonzero.size <= k
    assert nonzero.min() >= 5 * stride - k and nonzero.max() <= 6 * stride + k


def test_conv1d_step_matches_full_conv(rng):
    """Fast-WaveNet single-step path ≡ full parallel conv at each t."""
    B, T, C, O, d = 2, 64, 8, 12, 4
    x = jnp.asarray(rng.standard_normal((B, T, C)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal((2, C, O)).astype(np.float32))
    b = jnp.asarray(rng.standard_normal((O,)).astype(np.float32))
    full = conv.causal_conv1d(x, w, d, b)
    for t in [0, 3, d, 17, T - 1]:
        tap = x[:, t - d] if t >= d else jnp.zeros((B, C))
        step = conv.conv1d_step(tap, x[:, t], w, b)
        np.testing.assert_allclose(np.asarray(step), np.asarray(full[:, t]),
                                   rtol=1e-4, atol=1e-5)
