"""Tensor-parallel sharding of the dilated residual stack (layer T1,
BASELINE config[4] "stack sharded across chips"; SURVEY.md §2c TP row).

Strategy: shard the GATE channel dimension G of every gated residual
layer across the `model` mesh axis.

    w_dilated (2, C, G)  -> P(None, None, "model")   column-parallel
    w_cond    (M, G)     -> P(None, "model")         column-parallel
    b_dilated, b_cond    -> P("model")
    w_res     (G/2, C)   -> P("model", None)         row-parallel
    w_skip    (G/2, S)   -> P("model", None)         row-parallel

The gate computation is then column-parallel (each device owns G/n gate
channels), and the res/skip projections are row-parallel: XLA inserts
exactly one psum per layer (for the z @ W_res/W_skip contraction) — the
Megatron pattern expressed purely through sharding annotations, per the
"pick a mesh, annotate, let XLA insert collectives" recipe.

Gate-split correctness: `z = tanh(g[:G/2]) * sigmoid(g[G/2:])` splits
G in half BEFORE any cross-chip movement, and GSPMD shards each half
over `model` independently — the gate stays elementwise-local as long
as (G/2) % model == 0, asserted by `validate_tp`.

Everything else (front/head 1x1s, upsampler, MoL head) is replicated
(the conditioning network stays replicated per the north star).

The per-layer activation psum is large next to a layer's compute (this
model is activation-dominated), which is why `large_student_sharded`
TRAINS data-parallel (mesh model=1).  TP remains first-class for what it
is good for here: state storage sharding (`shard_state`) and the
batch-sharded generation below; correctness is pinned by
tests/test_tp.py.
"""

from __future__ import annotations

from typing import Any

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_GATE_SPECS = {
    "w_dilated": P(None, None, "model"),
    "b_dilated": P("model"),
    "w_cond": P(None, "model"),
    "b_cond": P("model"),
    "w_res": P("model", None),
    "w_skip": P("model", None),
}


def param_spec(path) -> P:
    """PartitionSpec for one param leaf, keyed by its trailing name."""
    names = [getattr(k, "key", getattr(k, "name", str(k))) for k in path]
    leaf = names[-1] if names else ""
    if leaf in _GATE_SPECS and any(
        str(n).startswith("layer_") for n in names
    ):
        return _GATE_SPECS[leaf]
    return P()


def state_shardings(state: Any, mesh: Mesh):
    """NamedShardings for a full TrainState (params + optimizer mirrors).

    The optimizer state (adam mu/nu) mirrors the param tree structure, so
    the same trailing-name rule applies to it automatically.
    """

    def leaf_sharding(path, leaf):
        if hasattr(leaf, "shape") and getattr(leaf, "ndim", 0) > 0:
            return NamedSharding(mesh, param_spec(path))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map_with_path(leaf_sharding, state)


def validate_tp(gate_channels: int, mesh: Mesh) -> None:
    n = mesh.shape["model"]
    if n > 1 and (gate_channels // 2) % n:
        raise ValueError(
            f"gate_channels/2 = {gate_channels // 2} must divide over "
            f"model axis {n}"
        )


def shard_state(state: Any, mesh: Mesh):
    """Place an (unsharded) TrainState onto the mesh per the TP rules."""
    return jax.device_put(state, state_shardings(state, mesh))


def make_batch_sharded_generate(cfg, temperature: float = 1.0,
                                mesh: Mesh | None = None):
    """Student synthesis sharded over EVERY mesh device: each device runs
    the whole scan-path generate on its rows inside `jax.shard_map`.

    Design note (why not gate-sharded Megatron TP here): each gated
    layer's residual update needs the full C-dim output, so gate
    sharding forces one cross-device reduction PER LAYER.  The stack's
    weights are small (tens of MB even for config[4]); what must scale
    is activation memory and throughput — both of which batch sharding
    over the FULL (data x model) device set delivers with no collective
    at all.  TP param sharding (state_shardings) still applies to
    training state storage; at this jit boundary GSPMD re-gathers the
    small weights automatically.

    Returns `(variables, key, mel) -> wav` with mel/wav batch-sharded
    over ("data", "model") jointly.  B must divide the device count.
    """
    from pwn_vocoder.models.student import make_student, sample_base_noise

    student = make_student(cfg)
    axes = ("data", "model")

    def local_gen(variables, key, mel_local):
        n = jax.lax.axis_size(axes)
        idx = jax.lax.axis_index(axes)
        B_local, F = mel_local.shape[0], mel_local.shape[1]
        T = F * cfg.dsp.hop_length
        # identical global draw on every shard, then slice this shard's
        # rows -> bitwise-stable vs the unsharded generate
        z_global = sample_base_noise(
            cfg, key, (B_local * n, T)
        ) * temperature
        z = jax.lax.dynamic_slice_in_dim(
            z_global, idx * B_local, B_local, axis=0
        )
        return student.apply(variables, z, mel_local,
                             method="generate_from_z")

    def build(mesh: Mesh):
        from jax.sharding import NamedSharding

        fn = jax.shard_map(
            local_gen,
            mesh=mesh,
            in_specs=(P(), P(), P(axes)),
            out_specs=P(axes),
            check_vma=False,
        )
        # no in_shardings: inputs may arrive TP-sharded (training storage
        # layout) — the shard_map in_specs are constraints GSPMD satisfies
        # by inserting the (small) all-gather
        return jax.jit(fn, out_shardings=NamedSharding(mesh, P(axes)))

    if mesh is not None:
        jitted = build(mesh)

        def checked(variables, key, mel):
            n = mesh.shape["data"] * mesh.shape["model"]
            if mel.shape[0] % n:
                raise ValueError(
                    f"batch {mel.shape[0]} not divisible by {n} devices"
                )
            return jitted(variables, key, mel)

        return checked
    return local_gen
