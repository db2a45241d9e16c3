"""Teacher autoregressive sampling: naive reference path and the
Fast-WaveNet conv-queue `lax.scan` path.

This rebuilds the component the reference did NOT have (its student trains
directly; classic WaveNet sampling was a Python sample-by-sample loop in
sibling repos) as required by the north star (BASELINE.json: "replace the
Python sample-by-sample inference loop with ... a lax.scan fast-generation
path using cached conv queues").  Algorithm: Fast WaveNet [P:6]
(arXiv:1611.09482) — O(1) work per emitted sample.

Design (SURVEY.md §3.5, §7 "hard parts"):
* the scan body is fully static-shaped: each layer keeps a dense ring
  buffer `(B, dilation_l, C_res)` with modular slot indexing `t % d_l`;
* per-step compute is a fixed chain of small GEMMs `(B, C) x (C, C')` —
  batched utterances share each weight read;
* conditioning is upsampled OUTSIDE the scan; per-layer 1x1 cond
  projections happen inside the step on `(B, n_mels)` slices to avoid
  materializing `(L, T, gate)` in HBM;
* per-step rng = `fold_in(key, t)` so the naive and fast paths draw
  identical randomness and can be tested for exact agreement.
"""

from __future__ import annotations

from typing import Any, Dict, List

import jax
import jax.numpy as jnp

from pwn_vocoder.config import Config
from pwn_vocoder.models.teacher import TeacherWaveNet, _match_length
from pwn_vocoder.ops import gaussian, mol


def _stack_params(variables: Dict[str, Any]) -> Dict[str, Any]:
    return variables["params"]["stack"]


def _layer(p: Dict[str, Any], i: int) -> Dict[str, Any]:
    return p[f"layer_{i}"]


def teacher_cond(
    model: TeacherWaveNet, variables, mel: jax.Array, n_samples: int
) -> jax.Array:
    cond = model.apply(variables, mel, method="condition")
    return _match_length(cond, n_samples)


def fast_sample(
    model: TeacherWaveNet,
    variables,
    key: jax.Array,
    mel: jax.Array,
    temperature: float = 1.0,
) -> jax.Array:
    """AR-sample a waveform (B, F*hop) with cached conv queues.

    Jit-compiled end to end; the sequential dependency is expressed as one
    `lax.scan` whose body XLA compiles once.  Step t draws its sample
    from fold_in(key, t).
    """
    cfg: Config = model.config
    tc = cfg.teacher
    hop = cfg.dsp.hop_length
    B, F = mel.shape[0], mel.shape[1]
    T = F * hop

    cond = teacher_cond(model, variables, mel, T)  # (B, T, M)
    p = _stack_params(variables)
    dilations = tc.dilations
    L = len(dilations)
    C = tc.residual_channels

    front_k = p["front"]["kernel"][0]  # (1, C)
    front_b = p["front"]["bias"]
    head1_k, head1_b = p["head1"]["kernel"][0], p["head1"]["bias"]
    head2_k, head2_b = p["head2"]["kernel"][0], p["head2"]["bias"]
    layers = []
    for i in range(L):
        lp = _layer(p, i)
        layers.append(
            dict(
                dil_k=lp["w_dilated"],  # (2, C, G)
                dil_b=lp["b_dilated"],
                cond_k=lp["w_cond"],  # (M, G)
                cond_b=lp["b_cond"],
                res_k=lp["w_res"],  # (G/2, C)
                res_b=lp["b_res"],
                skip_k=lp["w_skip"],
                skip_b=lp["b_skip"],
            )
        )

    queues: List[jax.Array] = [
        jnp.zeros((B, d, C), jnp.float32) for d in dilations
    ]
    x0 = jnp.zeros((B,), jnp.float32)

    cond_t_major = jnp.swapaxes(cond, 0, 1)  # (T, B, M)
    ts = jnp.arange(T)
    xs = (ts, cond_t_major)

    def step(carry, inp):
        x_prev, qs = carry
        t, cond_t = inp[0], inp[1]
        h = x_prev[:, None] @ front_k + front_b  # (B, C)
        skip = jnp.zeros((B, head1_k.shape[0]), jnp.float32)
        new_qs = []
        for i, lp in enumerate(layers):
            d = dilations[i]
            slot = jax.lax.rem(t, d)
            tap = jax.lax.dynamic_index_in_dim(
                qs[i], slot, axis=1, keepdims=False
            )  # (B, C)
            new_qs.append(
                jax.lax.dynamic_update_index_in_dim(qs[i], h, slot, axis=1)
            )
            g = (
                h @ lp["dil_k"][1]
                + tap @ lp["dil_k"][0]
                + lp["dil_b"]
                + cond_t @ lp["cond_k"]
                + lp["cond_b"]
            )
            a, b = jnp.split(g, 2, axis=-1)
            z = jnp.tanh(a) * jax.nn.sigmoid(b)
            h = h + z @ lp["res_k"] + lp["res_b"]
            skip = skip + z @ lp["skip_k"] + lp["skip_b"]
        hh = jax.nn.relu(skip)
        hh = jax.nn.relu(hh @ head1_k + head1_b)
        params_t = hh @ head2_k + head2_b  # (B, head_dim)
        if tc.output == "gaussian":
            x_t = gaussian.sample_from_gaussian(
                jax.random.fold_in(key, t),
                params_t,
                log_scale_min=tc.log_scale_min,
                temperature=temperature,
            )
        else:
            x_t = mol.sample_from_mol(
                jax.random.fold_in(key, t),
                params_t,
                log_scale_min=tc.log_scale_min,
                temperature=temperature,
            )
        return (x_t, new_qs), x_t

    (_, _), wav_t = jax.lax.scan(step, (x0, queues), xs)
    return jnp.swapaxes(wav_t, 0, 1)  # (B, T)


def naive_sample(
    model: TeacherWaveNet,
    variables,
    key: jax.Array,
    mel: jax.Array,
    temperature: float = 1.0,
) -> jax.Array:
    """O(T^2) reference sampler: re-runs the full teacher-forcing pass per
    emitted sample.  Ground truth for `fast_sample` equivalence tests
    (SURVEY.md §4: "conv-queue lax.scan fast path ≡ naive full-recompute").
    Only viable for short T / tiny configs.
    """
    cfg = model.config
    hop = cfg.dsp.hop_length
    B, F = mel.shape[0], mel.shape[1]
    T = F * hop
    cond = teacher_cond(model, variables, mel, T)
    wav = jnp.zeros((B, T), jnp.float32)

    sample_one = (
        gaussian.sample_from_gaussian
        if cfg.teacher.output == "gaussian"
        else mol.sample_from_mol
    )

    @jax.jit
    def one_step(wav, t):
        params = model.apply(variables, wav, cond,
                             method="params_from_cond")
        x_t = sample_one(
            jax.random.fold_in(key, t),
            params[:, t],
            log_scale_min=cfg.teacher.log_scale_min,
            temperature=temperature,
        )
        return wav.at[:, t].set(x_t)

    for t in range(T):
        wav = one_step(wav, t)
    return wav
