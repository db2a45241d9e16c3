"""Teacher training step (reference: `train.py` + tensorpack trainer [R],
SURVEY.md §3.1 — rebuilt as one jit-compiled sharded function).

Twist vs the reference: the mel extraction runs INSIDE the jitted
step on device (jnp STFT, layer T2) — the host pipeline only ships raw
fixed-length wav crops.  The reference computed mels with librosa in forked
ZMQ worker processes and fed (wav, mel) pairs through a TF FIFOQueue.

The model operates in the preemphasized domain (clipped to [-1, 1]);
generation applies deemphasis at the end (reference `audio_utils` conventions).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from pwn_vocoder.config import Config
from pwn_vocoder.models.teacher import TeacherWaveNet
from pwn_vocoder.parallel.mesh import batch_sharding, replicated
from pwn_vocoder.training.common import (
    TrainState,
    global_norm,
    make_optimizer,
    update_ema,
)
from pwn_vocoder.utils import dsp


def prepare_batch(wav: jax.Array, cfg: Config) -> Tuple[jax.Array, jax.Array]:
    """Raw wav (B, T) -> (model-domain x, conditioning mel) on device."""
    x = jnp.clip(
        dsp.preemphasis(wav, cfg.dsp.preemphasis), -1.0, 1.0
    )
    mel = dsp.mel_spectrogram(x, cfg.dsp)
    mel = mel[:, : wav.shape[-1] // cfg.dsp.hop_length]
    return x, mel


def make_teacher_train_step(
    model: TeacherWaveNet, cfg: Config, mesh: Mesh | None = None
):
    """Returns jitted `(state, wav) -> (state, metrics)`.

    With a mesh: state replicated, wav sharded on the `data` axis; the
    gradient all-reduce is derived by XLA from sharding propagation
    (the psum of BASELINE config[3]).
    """
    tx = make_optimizer(cfg.train)

    def train_step(state: TrainState, wav: jax.Array):
        x, mel = prepare_batch(wav, cfg)

        def loss_fn(params):
            return model.apply({"params": params}, x, mel, method="loss")

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        metrics = {
            "loss": loss,
            "grad_norm": global_norm(grads),
        }
        state = state.apply_gradients(grads, tx)
        if cfg.train.ema_decay > 0:
            state = update_ema(state, cfg.train.ema_decay)
        return state, metrics

    if mesh is None:
        return jax.jit(train_step, donate_argnums=(0,))
    if mesh.shape.get("model", 1) > 1:
        # TP: the caller places the state (parallel.tp.shard_state) and
        # the batch (shard_batch); GSPMD derives layer collectives from
        # the parameter shardings — no explicit in_shardings here.
        return jax.jit(train_step, donate_argnums=(0,))

    # DP via shard_map: each device computes its shard's loss and
    # gradients locally, reduced with one explicit pmean (the psum of
    # BASELINE config[3]).
    rep = replicated(mesh)

    def dp_grads(params, wav):
        x, mel = prepare_batch(wav, cfg)

        def loss_fn(p):
            return model.apply({"params": p}, x, mel, method="loss")

        loss, grads = jax.value_and_grad(loss_fn)(params)
        return jax.lax.pmean((loss, grads), "data")

    sharded_grads = jax.shard_map(
        dp_grads, mesh=mesh, in_specs=(P(), P("data")), out_specs=P(),
        check_vma=False,
    )

    def dp_train_step(state: TrainState, wav: jax.Array):
        loss, grads = sharded_grads(state.params, wav)
        metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        state = state.apply_gradients(grads, tx)
        if cfg.train.ema_decay > 0:
            state = update_ema(state, cfg.train.ema_decay)
        return state, metrics

    return jax.jit(
        dp_train_step,
        in_shardings=(rep, batch_sharding(mesh)),
        out_shardings=(rep, rep),
        donate_argnums=(0,),
    )


def make_teacher_eval_step(
    model: TeacherWaveNet, cfg: Config, mesh: Mesh | None = None
):
    """Jitted validation NLL.  With a mesh, both params and the (identical
    per-host) val batch are replicated so the eval is SPMD-safe."""

    def eval_step(params, wav):
        x, mel = prepare_batch(wav, cfg)
        return model.apply({"params": params}, x, mel, method="loss")

    if mesh is None or mesh.shape.get("model", 1) > 1:
        return jax.jit(eval_step)
    rep = replicated(mesh)
    return jax.jit(eval_step, in_shardings=(rep, rep), out_shardings=rep)
