"""The WaveNet stack's two execution paths — `scan_layers` (inference) and
`unrolled_layers` (training and frozen-teacher scoring) — against the
fp32-accumulating `reference_stack_xla`, forward and gradients, at every
shipped preset's widths (short T) and on hand-picked dilation layouts."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pwn_vocoder.config import get_config, list_configs
from pwn_vocoder.models.modules import (
    ParamInit,
    init_stack,
    reference_stack_xla,
    scan_layers,
    stack_weights,
    unrolled_layers,
)

STACKS = [(name, kind) for name in list_configs()
          for kind in ("teacher", "student")]


def _widths(cfg, kind):
    if kind == "teacher":
        tc = cfg.teacher
        return (tc.dilations, tc.residual_channels, tc.gate_channels,
                tc.skip_channels)
    sc = cfg.student
    return (sc.flow_dilations, sc.residual_channels, sc.gate_channels,
            sc.skip_channels)


def _preset_stack(name, kind, B=1, T=256):
    cfg = get_config(name)
    dils, C, G, S = _widths(cfg, kind)
    M = cfg.dsp.n_mels
    p = init_stack(ParamInit(jax.random.PRNGKey(0)), len(dils), C, G, S, M,
                   out_dim=2)
    layers = [p[f"layer_{i}"] for i in range(len(dils))]
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((B, T, C)).astype(np.float32))
    cond = jnp.asarray(rng.uniform(0, 1, (B, T, M)).astype(np.float32))
    return x, cond, layers, dils


def _reference(x, cond, layers, dils):
    w_in, b_g, w_out, b_res, b_skip = stack_weights(layers, jnp.float32)
    return reference_stack_xla(
        x, cond, w_in, b_g, w_out, jnp.concatenate([b_res, b_skip], axis=1),
        dilations=dils,
    )


@pytest.mark.parametrize("name,kind", STACKS)
def test_stack_paths_match_reference(name, kind):
    x, cond, layers, dils = _preset_stack(name, kind)
    ref = _reference(x, cond, layers, dils)
    for fn in (scan_layers, unrolled_layers):
        got = fn(x, cond, layers, dils, jnp.float32)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=fn.__name__)


@pytest.mark.parametrize("name,kind", STACKS)
def test_stack_path_grads_match_reference(name, kind):
    x, cond, layers, dils = _preset_stack(name, kind, T=128)
    w = jnp.asarray(np.random.default_rng(1).standard_normal(
        x.shape[:-1] + (layers[0]["w_skip"].shape[-1],)).astype(np.float32))

    def loss(fn, x, cond, layers):
        return jnp.sum(fn(x, cond, layers, dils, jnp.float32) * w)

    want = jax.grad(
        lambda *a: jnp.sum(_reference(*a, dils) * w), argnums=(0, 1, 2)
    )(x, cond, layers)
    for fn in (scan_layers, unrolled_layers):
        got = jax.grad(functools.partial(loss, fn), argnums=(0, 1, 2))(
            x, cond, layers)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-3, atol=1e-4,
                                       err_msg=fn.__name__)


def _mk(rng, *shape, scale=0.1):
    return jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                       * scale)


def _setup(rng, B=2, T=1100, C=16, M=8, G=32, S=16,
           dilations=(1, 2, 4, 512)):
    """Stacked-weight operands of `reference_stack_xla` plus the matching
    per-layer param dicts of the scan/unrolled paths."""
    L = len(dilations)
    args = dict(
        x0=_mk(rng, B, T, C, scale=1.0),
        cond=_mk(rng, B, T, M, scale=1.0),
        w_in=_mk(rng, L, 2 * C + M, G),
        b_g=_mk(rng, L, G),
        w_out=_mk(rng, L, G // 2, C + S),
        b_rs=_mk(rng, L, C + S),
    )
    return args, dilations


def _layers(args):
    """Per-layer params equivalent to the stacked operands (b_g goes to
    b_dilated, b_cond is zero)."""
    C = args["x0"].shape[-1]
    L = args["w_in"].shape[0]
    out = []
    for i in range(L):
        w_in = args["w_in"][i]
        out.append({
            "w_dilated": jnp.stack([w_in[C:2 * C], w_in[:C]]),
            "b_dilated": args["b_g"][i],
            "w_cond": w_in[2 * C:],
            "b_cond": jnp.zeros_like(args["b_g"][i]),
            "w_res": args["w_out"][i][:, :C],
            "w_skip": args["w_out"][i][:, C:],
            "b_res": args["b_rs"][i][:C],
            "b_skip": args["b_rs"][i][C:],
        })
    return out


def test_flow_stack_matches_reference(rng):
    args, dils = _setup(rng)
    got = scan_layers(args["x0"], args["cond"], _layers(args), dils,
                      jnp.float32)
    want = reference_stack_xla(**args, dilations=dils)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_flow_stack_batch_history_isolation(rng):
    """Rows are independent: changing row 1 cannot leak into row 0."""
    args, dils = _setup(rng, B=2, T=1024)
    s1 = scan_layers(args["x0"], args["cond"], _layers(args), dils,
                     jnp.float32)
    x2 = args["x0"].at[1].add(3.0)
    s2 = scan_layers(x2, args["cond"], _layers(args), dils, jnp.float32)
    np.testing.assert_array_equal(np.asarray(s1[0]), np.asarray(s2[0]))
    assert not np.allclose(np.asarray(s1[1]), np.asarray(s2[1]))


def test_flow_stack_grads_match_reference(rng):
    args, dils = _setup(rng, B=1, T=600, C=8, M=4, G=16, S=8,
                        dilations=(1, 4, 16))
    w1 = _mk(rng, 1, 600, 8, scale=1.0)
    w2 = _mk(rng, 1, 600, 8, scale=1.0)

    def loss_scan(a):
        s = scan_layers(a["x0"], a["cond"], _layers(a), dils, jnp.float32)
        return jnp.sum(s * w2) + jnp.sum(s[..., :8] * w1)

    def loss_ref(a):
        s = reference_stack_xla(**a, dilations=dils)
        return jnp.sum(s * w2) + jnp.sum(s[..., :8] * w1)

    g1 = jax.grad(loss_scan)(args)
    g2 = jax.grad(loss_ref)(args)
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("dils,T,B", [
    ((1, 2, 4, 8), 1536, 2),      # growing dilations
    ((1, 2, 4, 512), 1100, 2),    # large dilation, ragged T
    (tuple(2 ** i for i in range(10)), 2048, 2),  # student-shaped
])
def test_train_kernel_vjp_matches_xla(rng, dils, T, B):
    """The training path's (unrolled) VJP reproduces the reference VJP
    for every input: dx0, dcond, dw_in, db_g, dw_out, db_rs."""
    args, _ = _setup(rng, B=B, T=T, dilations=dils)
    order = ["x0", "cond", "w_in", "b_g", "w_out", "b_rs"]
    vals = [args[k] for k in order]
    ref_fn = functools.partial(reference_stack_xla, dilations=dils)

    def unrolled(x0, cond, w_in, b_g, w_out, b_rs):
        a = dict(x0=x0, cond=cond, w_in=w_in, b_g=b_g, w_out=w_out,
                 b_rs=b_rs)
        return unrolled_layers(x0, cond, _layers(a), dils, jnp.float32)

    ct = _mk(rng, B, T, args["w_out"].shape[-1] - args["x0"].shape[-1],
             scale=1.0)
    out_r, vjp_r = jax.vjp(ref_fn, *vals)
    out_n, vjp_n = jax.vjp(unrolled, *vals)
    np.testing.assert_allclose(np.asarray(out_n), np.asarray(out_r),
                               rtol=1e-4, atol=1e-5)
    for name, g_r, g_n in zip(order, vjp_r(ct), vjp_n(ct)):
        np.testing.assert_allclose(
            np.asarray(g_n), np.asarray(g_r), rtol=2e-3, atol=2e-4,
            err_msg=f"grad mismatch for {name}",
        )
