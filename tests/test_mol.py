"""Mixture-of-logistics tests (SURVEY.md §4: "MoL log-prob/sampling vs
closed-form logistic CDF")."""

import jax
import jax.numpy as jnp
import numpy as np
import scipy.stats

from pwn_vocoder.ops import mol


def _mk_params(rng, shape, k=3):
    logits = rng.standard_normal(shape + (k,)).astype(np.float32)
    means = (rng.uniform(-0.5, 0.5, shape + (k,))).astype(np.float32)
    log_scales = rng.uniform(-4.0, -1.0, shape + (k,)).astype(np.float32)
    return jnp.asarray(np.concatenate([logits, means, log_scales], axis=-1))


def test_discretized_mol_normalizes(rng):
    """Sum of bin probabilities over all discretization levels == 1."""
    num_classes = 256
    params = _mk_params(rng, (), k=3)
    levels = jnp.linspace(-1.0, 1.0, num_classes)
    logp = mol.discretized_mol_log_prob(
        levels, jnp.broadcast_to(params, (num_classes, 9)),
        num_classes=num_classes,
    )
    total = float(jnp.sum(jnp.exp(logp)))
    assert abs(total - 1.0) < 1e-3


def test_continuous_density_integrates_to_one(rng):
    params = _mk_params(rng, (), k=4)
    xs = jnp.linspace(-3.0, 3.0, 20001)
    dens = jnp.exp(
        mol.mol_log_density(xs, jnp.broadcast_to(params, (20001, 12)))
    )
    integral = float(jnp.trapezoid(dens, xs))
    assert abs(integral - 1.0) < 1e-3


def test_logistic_log_density_matches_scipy(rng):
    x = rng.standard_normal(100).astype(np.float32)
    mean, log_scale = 0.3, -0.5
    got = np.asarray(
        mol.logistic_log_density(
            jnp.asarray(x), jnp.full_like(jnp.asarray(x), mean),
            jnp.full_like(jnp.asarray(x), log_scale),
        )
    )
    want = scipy.stats.logistic.logpdf(x, loc=mean, scale=np.exp(log_scale))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_single_component_sampling_stats():
    """Samples from a 1-component MoL match the logistic's mean/std."""
    mean, log_scale = 0.1, -2.0
    params = jnp.asarray([[0.0, mean, log_scale]] * 200000).reshape(
        200000, 3
    )
    x = mol.sample_from_mol(jax.random.PRNGKey(0), params)
    s = np.exp(log_scale)
    want_std = s * np.pi / np.sqrt(3.0)
    assert abs(float(x.mean()) - mean) < 5e-3
    assert abs(float(x.std()) - want_std) < 5e-3


def test_sample_respects_mixture_weights():
    """A dominant component captures nearly all samples."""
    # component 0 at -0.5 with huge weight, component 1 at +0.5
    params = jnp.asarray([10.0, -10.0, -0.5, 0.5, -4.0, -4.0])
    params = jnp.broadcast_to(params, (50000, 6))
    x = mol.sample_from_mol(jax.random.PRNGKey(1), params)
    frac_near = float(jnp.mean(jnp.abs(x + 0.5) < 0.2))
    assert frac_near > 0.99


def test_sample_logistic_base_stats():
    z = mol.sample_logistic(jax.random.PRNGKey(2), (500000,))
    assert abs(float(z.mean())) < 2e-2
    np.testing.assert_allclose(float(z.std()), np.pi / np.sqrt(3.0),
                               rtol=2e-2)


def test_mol_loss_decreases_toward_truth(rng):
    """NLL is lower for params centered on the data than off-center."""
    x = jnp.asarray(rng.uniform(-0.1, 0.1, 512).astype(np.float32))
    k = 2
    good = jnp.concatenate(
        [jnp.zeros((512, k)), jnp.zeros((512, k)),
         jnp.full((512, k), -3.0)], axis=-1
    )
    bad = good.at[:, k : 2 * k].set(0.8)
    assert float(mol.discretized_mol_loss(x, good)) < float(
        mol.discretized_mol_loss(x, bad)
    )


def test_loss_is_fp32_even_for_bf16_params(rng):
    params = _mk_params(rng, (64,)).astype(jnp.bfloat16)
    x = jnp.asarray(rng.uniform(-1, 1, 64).astype(np.float32))
    out = mol.discretized_mol_log_prob(x, params)
    assert out.dtype == jnp.float32
    assert np.isfinite(np.asarray(out)).all()
