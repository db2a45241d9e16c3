"""Fast conv-queue sampler ≡ naive full-recompute sampler (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np

from pwn_vocoder.config import get_config
from pwn_vocoder.models import sampling
from pwn_vocoder.models.teacher import init_teacher

CFG = get_config("tiny_teacher")
HOP = CFG.dsp.hop_length


def test_fast_equals_naive(rng):
    model, variables = init_teacher(CFG, jax.random.PRNGKey(0))
    frames = 2  # T = 256 samples; naive is O(T^2)
    mel = jnp.asarray(
        rng.uniform(0, 1, (2, frames, CFG.dsp.n_mels)).astype(np.float32)
    )
    key = jax.random.PRNGKey(7)
    fast = sampling.fast_sample(model, variables, key, mel)
    naive = sampling.naive_sample(model, variables, key, mel)
    assert fast.shape == (2, frames * HOP)
    np.testing.assert_allclose(
        np.asarray(fast), np.asarray(naive), rtol=1e-3, atol=1e-4
    )


def test_fast_sample_jits_and_is_deterministic(rng):
    model, variables = init_teacher(CFG, jax.random.PRNGKey(0))
    mel = jnp.asarray(
        rng.uniform(0, 1, (1, 3, CFG.dsp.n_mels)).astype(np.float32)
    )
    f = jax.jit(
        lambda v, k, m: sampling.fast_sample(model, v, k, m)
    )
    w1 = f(variables, jax.random.PRNGKey(1), mel)
    w2 = f(variables, jax.random.PRNGKey(1), mel)
    w3 = f(variables, jax.random.PRNGKey(2), mel)
    np.testing.assert_array_equal(np.asarray(w1), np.asarray(w2))
    assert not np.array_equal(np.asarray(w1), np.asarray(w3))
    assert float(jnp.max(jnp.abs(w1))) <= 1.0
