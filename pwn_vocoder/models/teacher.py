"""Teacher WaveNet: autoregressive mel-conditioned model with MoL head.

Reference parity: the AR density model the reference's student is meant to
be distilled from (`models.py` [R]; SURVEY.md §8 "Teacher").  Training is a
single full-parallel teacher-forcing pass (all timesteps at once — one big
batched conv stack); only sampling is sequential, and that lives in
models/sampling.py (naive + Fast-WaveNet conv-queue scan paths).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pwn_vocoder.config import Config
from pwn_vocoder.models.modules import (
    Model,
    ParamInit,
    init_stack,
    init_upsample,
    shift_right_scalar,
    upsample,
    wavenet_stack,
)
from pwn_vocoder.ops import mol


class TeacherWaveNet(Model):
    """p(x_t | x_<t, mel) with a discretized-MoL head (default) or a
    single-Gaussian head (`teacher.output="gaussian"`, ClariNet-style —
    enables the closed-form distillation KL, ops/gaussian.py).

    Parameters: {"params": {"upsample": ..., "stack": ...}}.
    `forward(params, wav, mel)` runs the teacher-forcing pass and returns
    per-step head params (B, T, head_dim: 3*n_mixtures MoL or 2
    Gaussian); `condition` exposes the upsampled conditioning for the AR
    sampling loop.

    use_scan: True for inference, False for training and for scoring a
    frozen teacher inside `jax.grad` (the unrolled stack's backward is
    the faster one) — same parameters, same function.
    """

    def __init__(self, config: Config, use_scan: bool = True):
        self.config = config
        self.use_scan = use_scan

    def init(self, rng: jax.Array) -> dict:
        tc = self.config.teacher
        n_mels = self.config.dsp.n_mels
        root = ParamInit(rng)
        return {"params": {
            "upsample": init_upsample(
                root.child("upsample"), tc.upsample_strides, n_mels,
                n_mels, tc.upsample_kernel_mult, tc.upsample_weight_norm,
            ),
            "stack": init_stack(
                root.child("stack"), tc.n_layers, tc.residual_channels,
                tc.gate_channels, tc.skip_channels, n_mels, tc.head_dim,
                tc.kernel_size,
            ),
        }}

    def condition(self, params, mel: jax.Array) -> jax.Array:
        """(B, F, n_mels) mel frames -> (B, F*hop, n_mels) per-sample cond."""
        tc = self.config.teacher
        return upsample(params["upsample"], mel, tc.upsample_strides,
                        jnp.dtype(tc.compute_dtype))

    def params_from_cond(self, params, wav: jax.Array,
                         cond: jax.Array) -> jax.Array:
        """Teacher-forcing pass given precomputed conditioning.

        wav (B, T) in [-1,1]; cond (B, T, n_mels). Returns MoL params
        (B, T, 3K) — params[t] models x[t] given x[<t].
        """
        tc = self.config.teacher
        return wavenet_stack(
            params["stack"], shift_right_scalar(wav), cond, tc.dilations,
            jnp.dtype(tc.compute_dtype), self.use_scan,
        )

    def forward(self, params, wav: jax.Array, mel: jax.Array) -> jax.Array:
        cond = _match_length(self.condition(params, mel), wav.shape[-1])
        return self.params_from_cond(params, wav, cond)

    def loss(self, params, wav: jax.Array, mel: jax.Array) -> jax.Array:
        """Mean teacher-forcing NLL (nats/sample), fp32: discretized MoL
        or continuous single-Gaussian per `teacher.output`."""
        head = self.forward(params, wav, mel)
        tc = self.config.teacher
        if tc.output == "gaussian":
            from pwn_vocoder.ops import gaussian

            return gaussian.gaussian_nll(
                wav, head, log_scale_min=tc.log_scale_min
            )
        return mol.discretized_mol_loss(
            wav, head, log_scale_min=tc.log_scale_min
        )


def _match_length(cond: jax.Array, T: int) -> jax.Array:
    """Crop/pad upsampled conditioning to exactly T samples.

    With centered STFT there are T//hop + 1 frames; the model consumes
    T//hop frames upsampled by hop (== T).  Any residual mismatch is
    clipped here so all shapes stay static under jit.
    """
    Tc = cond.shape[1]
    if Tc == T:
        return cond
    if Tc > T:
        return cond[:, :T]
    return jnp.pad(cond, ((0, 0), (0, T - Tc), (0, 0)), mode="edge")


def make_teacher(config: Config, use_scan: bool = True) -> TeacherWaveNet:
    return TeacherWaveNet(config, use_scan=use_scan)


def init_teacher(config: Config, rng: jax.Array, use_scan: bool = True):
    """(model, {"params": ...}) for the teacher."""
    model = make_teacher(config, use_scan=use_scan)
    return model, model.init(rng)
