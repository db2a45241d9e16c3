"""Hypothesis property tests (SURVEY.md §4 unit row: "pytest + chex
asserts + hypothesis property tests").

Targets the numerically-delicate surfaces: the discretized/continuous
mixture-of-logistics (CDF monotonicity, normalization, log-prob vs
numeric integral) and the DSP invertible pairs (mu-law, preemphasis,
dB mapping).
"""

import jax
import jax.numpy as jnp
import numpy as np
from hypothesis import given, settings, strategies as st

from pwn_vocoder.config import DSPConfig
from pwn_vocoder.ops import mol
from pwn_vocoder.utils import dsp

SETTINGS = dict(deadline=None, max_examples=15)


def _mol_params(seed: int, k: int = 5):
    """Random but well-conditioned MoL parameter draw (..., 3k)."""
    rng = np.random.default_rng(seed)
    logit = rng.normal(0, 2, size=k)
    means = rng.uniform(-0.9, 0.9, size=k)
    log_scales = rng.uniform(-5.0, 0.0, size=k)
    return jnp.asarray(
        np.concatenate([logit, means, log_scales]), jnp.float32
    )


@settings(**SETTINGS)
@given(st.integers(0, 10**6))
def test_mol_cdf_monotone(seed):
    """The mixture CDF sum_k pi_k * sigmoid((x - mu_k)/s_k) must be
    nondecreasing in x for any parameter draw."""
    params = _mol_params(seed)
    logit, means, log_scales = mol.split_params(params)
    pi = jax.nn.softmax(logit)
    x = jnp.linspace(-1.5, 1.5, 2001)[:, None]
    cdf = jnp.sum(pi * jax.nn.sigmoid((x - means) * jnp.exp(-log_scales)),
                  axis=-1)
    assert float(jnp.min(jnp.diff(cdf))) >= -1e-7
    assert float(cdf[0]) >= 0.0 and float(cdf[-1]) <= 1.0 + 1e-6


@settings(**SETTINGS)
@given(st.integers(0, 10**6))
def test_discretized_mol_normalizes(seed):
    """Summing exp(log_prob) over every quantization bin must give ~1
    (a probability mass function over the discretized amplitude grid)."""
    params = _mol_params(seed)
    n = 256  # coarse grid keeps the test fast; same math as 65536
    centers = jnp.linspace(-1.0, 1.0, n)
    lp = mol.discretized_mol_log_prob(
        centers, jnp.broadcast_to(params, (n,) + params.shape),
        num_classes=n,
    )
    total = float(jnp.sum(jnp.exp(lp)))
    assert abs(total - 1.0) < 1e-3, total


@settings(**SETTINGS)
@given(st.integers(0, 10**6))
def test_mol_continuous_density_integrates_to_one(seed):
    """The continuous mixture density must integrate to ~1 (trapezoid
    over a wide support)."""
    params = _mol_params(seed)
    # support must cover the widest draw's tails: scale can reach
    # e^0 = 1, and a logistic at mean 0.9/scale 1 still has ~6e-3 mass
    # past x=6 (hypothesis found seed 513417 leaking 2.2e-3 over a
    # [-6, 6] window); ±16 bounds the leak below e^-15
    x = jnp.linspace(-16.0, 16.0, 64001)
    pdf = jnp.exp(
        mol.mol_log_density(
            x, jnp.broadcast_to(params, x.shape + params.shape)
        )
    )
    integral = float(jnp.trapezoid(pdf, x))
    assert abs(integral - 1.0) < 2e-3, integral


@settings(**SETTINGS)
@given(
    st.floats(-2.0, 2.0), st.floats(-1.0, 1.0), st.floats(-3.0, 1.0),
    st.floats(-1.0, 1.0),
)
def test_logistic_log_density_symmetry_and_affine(x, m, ls, shift):
    """Logistic density symmetry about the mean, and the affine identity
    p_{aX+b}(ax+b) = p_X(x)/a that underlies the IAF closed-form density."""
    lp = float(mol.logistic_log_density(
        jnp.float32(x), jnp.float32(m), jnp.float32(ls)))
    mirrored = float(mol.logistic_log_density(
        jnp.float32(2 * m - x), jnp.float32(m), jnp.float32(ls)))
    assert abs(lp - mirrored) < 1e-4
    a = 0.5  # log a handled via log-scale shift
    lp_aff = float(mol.logistic_log_density(
        jnp.float32(x * a + shift), jnp.float32(m * a + shift),
        jnp.float32(ls + np.log(a)),
    ))
    assert abs(lp_aff - (lp - np.log(a))) < 1e-4


@settings(**SETTINGS)
@given(
    st.floats(-1.0, 1.0), st.floats(-4.0, 1.0),
    st.floats(-1.0, 1.0), st.floats(-4.0, 1.0),
)
def test_kl_gaussian_properties(mu_q, ls_q, mu_p, ls_p):
    """The closed-form Gaussian KL (ops/gaussian.py, the ClariNet
    distillation objective) must be nonnegative for every parameter
    draw, zero iff q == p, and match the analytic cross-entropy
    decomposition KL = H(q, p) - H(q)."""
    from pwn_vocoder.ops import gaussian

    args = [jnp.float32(v) for v in (mu_q, ls_q, mu_p, ls_p)]
    kl = float(gaussian.kl_gaussian(*args))
    assert kl >= -1e-6
    assert abs(float(gaussian.kl_gaussian(*args[:2], *args[:2]))) < 1e-6
    # H(q) = ls_q + 0.5 log(2 pi e); H(q,p) via E_q[-log p] closed form
    h_q = ls_q + 0.5 * np.log(2 * np.pi * np.e)
    h_qp = (
        ls_p + 0.5 * np.log(2 * np.pi)
        + (np.exp(2 * ls_q) + (mu_q - mu_p) ** 2) / (2 * np.exp(2 * ls_p))
    )
    assert abs(kl - (h_qp - h_q)) < 1e-4 * max(1.0, abs(kl))


@settings(**SETTINGS)
@given(st.integers(0, 10**6))
def test_gaussian_density_integrates_to_one(seed):
    from pwn_vocoder.ops import gaussian

    rng = np.random.default_rng(seed)
    m = jnp.float32(rng.uniform(-0.9, 0.9))
    ls = jnp.float32(rng.uniform(-4.0, 0.5))
    half = float(6.0 * np.exp(float(ls)))
    x = jnp.linspace(float(m) - half, float(m) + half, 20001)
    pdf = jnp.exp(gaussian.gaussian_log_density(x, m, ls))
    assert abs(float(jnp.trapezoid(pdf, x)) - 1.0) < 2e-3


@settings(**SETTINGS)
@given(st.integers(0, 10**6))
def test_mulaw_roundtrips(seed):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.uniform(-1, 1, size=256), jnp.float32)
    # continuous companding roundtrip is exact up to float error
    np.testing.assert_allclose(
        np.asarray(dsp.mulaw_decode(dsp.mulaw_encode(x))), np.asarray(x),
        atol=1e-5,
    )
    # quantized roundtrip within one bin width
    y = dsp.mulaw_dequantize(dsp.mulaw_quantize(x))
    err = np.abs(np.asarray(dsp.mulaw_encode(x) - dsp.mulaw_encode(y)))
    assert err.max() <= 2.0 / 255 + 1e-5


@settings(**SETTINGS)
@given(st.integers(0, 10**6), st.floats(0.5, 0.99))
def test_preemphasis_roundtrip(seed, coef):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.uniform(-1, 1, size=512), jnp.float32)[None]
    y = dsp.deemphasis(dsp.preemphasis(x, coef), coef)
    np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-4)


@settings(**SETTINGS)
@given(st.integers(0, 10**6))
def test_db_mapping_roundtrips(seed):
    rng = np.random.default_rng(seed)
    cfg = DSPConfig()
    amp = jnp.asarray(10 ** rng.uniform(-4, 1, size=128), jnp.float32)
    np.testing.assert_allclose(
        np.asarray(dsp.db_to_amp(dsp.amp_to_db(amp))), np.asarray(amp),
        rtol=1e-3,
    )
    # normalize_db is invertible only on its clip-free range
    # [min_db + ref_db, ref_db]
    db = jnp.asarray(
        rng.uniform(cfg.min_db + cfg.ref_db + 1.0, cfg.ref_db - 1.0,
                    size=128),
        jnp.float32,
    )
    np.testing.assert_allclose(
        np.asarray(dsp.denormalize_db(dsp.normalize_db(db, cfg), cfg)),
        np.asarray(db), atol=1e-3,
    )
