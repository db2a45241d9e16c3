"""Sequence-parallel (SP/CP) waveform synthesis (SURVEY.md §5
"long-context": the conv analogue of context parallelism; §2c SP row).

There is no attention anywhere in the model — every op is either
pointwise or a dilated conv with receptive field Σ(k−1)·d of a few
thousand samples — so "context parallelism" reduces to sharding the TIME
axis across devices and exchanging (k−1)·d = d boundary samples per
layer.  We express this purely through shardings: the time dimension of
z / conditioning is sharded over the `data` mesh axis and every
`shift_right` (pad+slice) on a time-sharded array lowers to the halo
`ppermute` XLA's SPMD partitioner derives automatically — no manual
collectives, per the mesh-and-annotate recipe.

This makes single-utterance synthesis scale across devices: minutes of
audio in one jit call with each device holding only T/n samples.
Weights stay replicated (they are small); batch stays unsharded so the
full `data` axis is available for time.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pwn_vocoder.config import Config
from pwn_vocoder.models.student import StudentIAF


def validate_sp(cfg: Config, mesh: Mesh, n_frames: int) -> None:
    """SP correctness precondition: per-shard sample count must cover the
    largest dilation.  GSPMD's halo exchange for a shifted slice reaches
    ONE neighbor shard; a shift larger than the shard silently drops the
    far taps (verified empirically on the CPU mesh — wrong values, no
    error), so we refuse instead.
    """
    n = mesh.shape["data"]
    if n_frames % n:
        raise ValueError(
            f"frames {n_frames} not divisible by data axis {n}"
        )
    shard_samples = n_frames * cfg.dsp.hop_length // n
    max_dil = max(cfg.student.flow_dilations)
    if shard_samples < max_dil:
        raise ValueError(
            f"sequence-parallel shard of {shard_samples} samples is "
            f"smaller than the max dilation {max_dil}; use >= "
            f"{max_dil * n // cfg.dsp.hop_length} frames or fewer shards"
        )


def make_sp_generate(student: StudentIAF, cfg: Config, mesh: Mesh):
    """`(variables, key, mel) -> wav` with time sharded over `data`.

    mel: (B, F, n_mels) with F sharded; returns (B, F*hop) with T
    sharded the same way.  F must be divisible by the data-axis size and
    long enough that each shard covers the receptive field's largest
    dilation (validate_sp).
    """
    rep = NamedSharding(mesh, P())
    time_sharded_3d = NamedSharding(mesh, P(None, "data", None))
    time_sharded_2d = NamedSharding(mesh, P(None, "data"))

    def gen(variables, key, mel):
        wav = student.apply(variables, key, mel, method="generate")
        return jax.lax.with_sharding_constraint(wav, time_sharded_2d)

    jitted = jax.jit(
        gen,
        in_shardings=(rep, rep, time_sharded_3d),
        out_shardings=time_sharded_2d,
    )

    def checked(variables, key, mel):
        validate_sp(cfg, mesh, mel.shape[1])
        return jitted(variables, key, mel)

    return checked


def shard_mel_time(mesh: Mesh, mel):
    """Place host mel (B, F, M) with the frame axis sharded over data."""
    return jax.device_put(mel, NamedSharding(mesh, P(None, "data", None)))


# ---------------------------------------------------------------------------
# Overlap-recompute SP: sequence parallelism with no runtime communication
# ---------------------------------------------------------------------------


def overlap_geometry(cfg: Config):
    """(R, H): overlap samples (hop-rounded full flow-chain receptive
    field) and upsampler frame halo."""
    sc = cfg.student
    hop = cfg.dsp.hop_length
    r = sc.n_flows * (sum(sc.flow_dilations) + 1)
    R = -(-r // hop) * hop  # ceil to a hop multiple
    H = cfg.teacher.upsample_kernel_mult * len(
        cfg.teacher.upsample_strides
    ) + 2
    return R, H


def validate_sp_overlap(cfg: Config, mesh: Mesh, n_frames: int) -> None:
    n = mesh.shape["data"] * mesh.shape["model"]
    hop = cfg.dsp.hop_length
    R, H = overlap_geometry(cfg)
    if n == 1:
        return  # degenerates to the unsharded single-pass generate
    if n_frames % n:
        raise ValueError(f"frames {n_frames} not divisible by {n} devices")
    shard_T = (n_frames // n) * hop
    if shard_T < R + H * hop:
        raise ValueError(
            f"SP shard of {shard_T} samples is smaller than the overlap "
            f"{R} + upsampler halo {H * hop}; use >= "
            f"{(R + H * hop) * n // hop} frames or fewer shards"
        )
    if shard_T + R + 2 * H * hop > n_frames * hop:
        raise ValueError("window exceeds the utterance; use more frames")


def make_sp_generate_overlap(student: StudentIAF, cfg: Config, mesh: Mesh,
                             temperature: float = 1.0):
    """`(variables, key, mel) -> wav (B, T)` — time sharded over ALL mesh
    devices inside `jax.shard_map`.

    Unlike `make_sp_generate` (GSPMD halo exchange per layer), this path
    gives each shard a static window of `R` overlap samples — the full
    flow-chain receptive field, n_flows * (Σ dilations + 1) — recomputed
    from the neighbor's region, so NO runtime communication is needed at
    all:

    * the base noise z is drawn replicated ((B, T) floats: trivially
      small next to the (T, C) layer activations SP exists to shard) and
      sliced per shard, so every shard sees the identical stream;
    * mel is consumed as per-shard frame windows with an `H`-frame halo
      for the transposed-conv upsampler's edge support;
    * shard 0 (and the right edge of the last shard) aligns its window
      to the utterance boundary instead of padding, reproducing the
      unsharded causal zero-history exactly (zero-padded mel would leak
      bias-colored frames through the upsampler's second stage).

    Overlap overhead: R/shard_T (<5% for the long-form utterances SP
    targets).  Output == the unsharded `generate` up to accumulation
    order.
    """
    del student  # the sharded path builds its own module from cfg
    from pwn_vocoder.models.student import make_student, sample_base_noise

    smodel = make_student(cfg)
    hop = cfg.dsp.hop_length
    R, H = overlap_geometry(cfg)
    axes = ("data", "model")

    if mesh.shape["data"] * mesh.shape["model"] == 1:
        # single device: no overlap window fits/helps — plain generate
        jit_gen = jax.jit(
            lambda variables, key, mel: smodel.apply(
                variables, key, mel, method="generate",
                temperature=temperature,
            )
        )
        return jit_gen

    def local_gen(variables, key, mel):
        n = jax.lax.axis_size(axes)
        idx = jax.lax.axis_index(axes)
        B, F = mel.shape[0], mel.shape[1]
        T = F * hop
        shard_T = T // n
        WT = R + shard_T
        WF = WT // hop + 2 * H

        z_full = sample_base_noise(cfg, key, (B, T)) * temperature
        start = idx * shard_T
        window_start = jnp.where(idx == 0, 0, start - R)
        z_win = jax.lax.dynamic_slice_in_dim(z_full, window_start, WT,
                                             axis=1)
        f_des = window_start // hop - H
        f_start = jnp.clip(f_des, 0, F - WF)
        mel_win = jax.lax.dynamic_slice_in_dim(mel, f_start, WF, axis=1)
        cond = smodel.apply(variables, mel_win, method="upsample_cond")
        off = window_start - f_start * hop
        cond_win = jax.lax.dynamic_slice_in_dim(cond, off, WT, axis=1)
        wav_win = smodel.apply(variables, z_win, cond_win,
                               method="flows_from_z")
        out_off = jnp.where(idx == 0, 0, R)
        return jax.lax.dynamic_slice_in_dim(wav_win, out_off, shard_T,
                                            axis=1)

    rep = NamedSharding(mesh, P())
    t_shard = NamedSharding(mesh, P(None, axes))
    jitted = jax.jit(
        jax.shard_map(
            local_gen, mesh=mesh,
            in_specs=(P(), P(), P()),
            out_specs=P(None, axes),
            check_vma=False,
        ),
        in_shardings=(rep, rep, rep),
        out_shardings=t_shard,
    )

    def checked(variables, key, mel):
        validate_sp_overlap(cfg, mesh, mel.shape[1])
        return jitted(variables, key, mel)

    return checked
