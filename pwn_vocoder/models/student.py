"""Student IAF: parallel mel-conditioned waveform synthesis.

Reference parity: `models.py::IAFVocoder` [R] (SURVEY.md §2a, §8 "Student
IAF").  The whole point of the architecture [PW]: z ~ Logistic(0,1)^T is
pushed through a stack of affine inverse-autoregressive flows, each
parameterized by a *causal* WaveNet over the previous z (strictly previous
timesteps — input shifted by one — so the Jacobian is triangular with
diagonal s_i), giving single-pass fully-parallel generation:

    z_i[t] = z_{i-1}[t] * s_i(z_{i-1}[<t], c) + mu_i(z_{i-1}[<t], c)

This is ONE jit-compiled XLA graph — a few dozen batched GEMMs — with no
sequential loop at all; faster-than-realtime synthesis comes from here.

The closed-form density
    log p_S(x) = log p_base(z_0) - sum_i log s_i
is returned alongside the sample for the distillation KL (SURVEY.md §8
"Distillation loss").
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pwn_vocoder.config import Config
from pwn_vocoder.models.modules import (
    Model,
    ParamInit,
    init_stack,
    init_upsample,
    upsample,
    wavenet_stack,
)
from pwn_vocoder.models.teacher import _match_length
from pwn_vocoder.ops import mol
from pwn_vocoder.ops.conv import shift_right


def sample_base_noise(cfg: Config, key: jax.Array, shape) -> jax.Array:
    """Draw student base noise per `student.base`: Logistic(0,1) (Parallel
    WaveNet default [PW]) or N(0,1) (ClariNet closed-form family).  Shared
    by every generation entry (StudentIAF.generate, the shard_map batch/SP
    paths in parallel/tp.py + parallel/sp.py, streaming in generate.py) so
    sharded and streaming outputs stay bit-comparable with the whole-call
    generate on one key."""
    if cfg.student.base == "gaussian":
        return jax.random.normal(key, shape, jnp.float32)
    return mol.sample_logistic(key, shape)


class StudentOutput(NamedTuple):
    wav: jax.Array        # (B, T) synthesized waveform
    log_det: jax.Array    # (B, T) sum_i log s_i[t]
    log_p_base: jax.Array  # (B, T) base log-density of z_0 (see base)
    mu_last: jax.Array    # (B, T) final flow's mu (diagnostics)
    # (B, T) total affine offset M[t]: the flow chain is elementwise affine
    # in the base noise given the causal context, x[t] = S[t]*z0[t] + M[t]
    # with S = exp(log_det).  The per-timestep output conditional is thus
    # exactly base(mu_total, exp(log_det)) — Logistic for the default
    # base, N for student.base="gaussian" — the closed form direct
    # student training maximizes at the ground truth
    # (training/student_direct.py) and the ClariNet closed-form KL
    # compares against the Gaussian teacher (training/distill.py).
    mu_total: jax.Array

    @property
    def log_p_student(self) -> jax.Array:
        """(B, T) per-sample closed-form student log-density at its own
        sample: log p_S(x) = log p_base(z0) - sum log s."""
        return self.log_p_base - self.log_det


class StudentIAF(Model):
    """Parameters: {"params": {"upsample": ..., "flow_0": ..., ...}}.

    use_scan: see TeacherWaveNet (True for inference, False for the
    training step)."""

    def __init__(self, config: Config, use_scan: bool = True):
        self.config = config
        self.use_scan = use_scan

    def init(self, rng: jax.Array) -> dict:
        sc, tc = self.config.student, self.config.teacher
        n_mels = self.config.dsp.n_mels
        root = ParamInit(rng)
        params = {"upsample": init_upsample(
            root.child("upsample"), tc.upsample_strides, n_mels, n_mels,
            tc.upsample_kernel_mult, tc.upsample_weight_norm,
        )}
        for i in range(sc.n_flows):
            params[f"flow_{i}"] = init_stack(
                root.child(f"flow_{i}"), sc.layers_per_flow,
                sc.residual_channels, sc.gate_channels, sc.skip_channels,
                n_mels, 2, sc.kernel_size,
            )
        return {"params": params}

    def _flow(self, params, i: int, z: jax.Array,
              cond: jax.Array) -> jax.Array:
        """Flow i on the strictly-causal input: at t it sees z[<t] only.
        Returns (B, T, 2) fp32 (mu, log_s)."""
        sc = self.config.student
        return wavenet_stack(
            params[f"flow_{i}"], shift_right(z[..., None], 1), cond,
            sc.flow_dilations, jnp.dtype(sc.compute_dtype), self.use_scan,
        )

    def forward(self, params, z: jax.Array, mel: jax.Array) -> StudentOutput:
        """Transform base noise z (B, T) under mel conditioning (B, F, M)."""
        cond = _match_length(self.upsample_cond(params, mel), z.shape[-1])
        return self.transform(params, z, cond)

    def transform(self, params, z: jax.Array,
                  cond: jax.Array) -> StudentOutput:
        clamp = self.config.student.log_scale_clamp
        z = z.astype(jnp.float32)
        if self.config.student.base == "gaussian":
            from pwn_vocoder.ops import gaussian

            log_p_base = gaussian.gaussian_log_density(
                z, jnp.zeros_like(z), jnp.zeros_like(z)
            )
        else:
            log_p_base = mol.logistic_log_density(
                z, jnp.zeros_like(z), jnp.zeros_like(z)
            )
        log_det = jnp.zeros_like(z)
        mu = jnp.zeros_like(z)
        mu_total = jnp.zeros_like(z)
        for i in range(self.config.student.n_flows):
            out = self._flow(params, i, z, cond)
            mu = out[..., 0]
            log_s = jnp.clip(out[..., 1], -clamp, clamp)
            z = z * jnp.exp(log_s) + mu
            mu_total = mu_total * jnp.exp(log_s) + mu
            log_det = log_det + log_s
        wav = jnp.clip(z, -1.0, 1.0)
        return StudentOutput(wav=wav, log_det=log_det,
                             log_p_base=log_p_base, mu_last=mu,
                             mu_total=mu_total)

    def generate(self, params, key: jax.Array, mel: jax.Array,
                 temperature: float = 1.0) -> jax.Array:
        """Sample a waveform: one parallel pass (the headline fast path).

        Skips the log-density bookkeeping `transform` carries for the
        distillation loss — synthesis only needs the flow outputs.
        """
        hop = self.config.dsp.hop_length
        B, F = mel.shape[0], mel.shape[1]
        z = sample_base_noise(self.config, key, (B, F * hop)) * temperature
        return self.generate_from_z(params, z, mel)

    def generate_from_z(self, params, z: jax.Array,
                        mel: jax.Array) -> jax.Array:
        """Synthesis from caller-provided base noise z (B, T).

        The sharded generation paths (parallel/tp.py batch sharding,
        parallel/sp.py overlap-recompute SP) draw the global z outside
        the shard so every shard sees the identical stream."""
        cond = _match_length(self.upsample_cond(params, mel), z.shape[-1])
        return self.flows_from_z(params, z, cond)

    def upsample_cond(self, params, mel: jax.Array) -> jax.Array:
        """Just the conditioning upsampler (B, F, M) -> (B, F*hop, M);
        the SP path upsamples per-shard mel windows with frame halos."""
        tc = self.config.teacher
        return upsample(params["upsample"], mel, tc.upsample_strides,
                        jnp.dtype(self.config.student.compute_dtype))

    def flows_from_z(self, params, z: jax.Array,
                     cond: jax.Array) -> jax.Array:
        """Apply the flow chain to (z, sample-rate cond); shared tail of
        the generate paths."""
        clamp = self.config.student.log_scale_clamp
        for i in range(self.config.student.n_flows):
            out = self._flow(params, i, z, cond)
            log_s = jnp.clip(out[..., 1], -clamp, clamp)
            z = z * jnp.exp(log_s) + out[..., 0]
        return jnp.clip(z, -1.0, 1.0)


def make_student(config: Config, use_scan: bool = True) -> StudentIAF:
    return StudentIAF(config, use_scan=use_scan)


def init_student(config: Config, rng: jax.Array, use_scan: bool = True):
    """(model, {"params": ...}) for the student."""
    model = make_student(config, use_scan=use_scan)
    return model, model.init(rng)
