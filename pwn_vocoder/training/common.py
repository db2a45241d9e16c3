"""Optimizer / train-state plumbing shared by teacher training and
distillation.

Reference parity: the reference's optimizer lived inside tensorpack's
`ModelDesc._get_optimizer` (Adam with fixed lr) [R].  Here: optax Adam with
exponential-decay schedule + global-norm clipping over a pytree train
state, with a threaded rng key for the stochastic losses.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
import optax

from pwn_vocoder.config import TrainConfig


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["step", "params", "opt_state", "rng", "ema_params"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class TrainState:
    """Step counter, params, optimizer state, the per-step rng key
    (distillation sampling) and optional EMA (Polyak-averaged) params.

    A pytree: it passes through jit, donation, sharding and the
    checkpoint writer as its five fields.  ema_params is None when
    `train.ema_decay` is 0 (default) so the checkpoint tree is unchanged;
    when enabled, Parallel WaveNet's recipe applies — train on live
    params, ship/score the average [PW].
    """

    step: Any
    params: Any
    opt_state: Any
    rng: Any = None
    ema_params: Any = None

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)

    def apply_gradients(self, grads: Any,
                        tx: optax.GradientTransformation) -> "TrainState":
        """One optimizer update with `tx` (the `make_optimizer` chain the
        state was created with)."""
        updates, opt_state = tx.update(grads, self.opt_state, self.params)
        return self.replace(
            step=self.step + 1,
            params=optax.apply_updates(self.params, updates),
            opt_state=opt_state,
        )


def update_ema(state: TrainState, decay: float) -> TrainState:
    """One EMA step: ema <- ema*decay + params*(1-decay).  Call-site
    gates on decay > 0 so the jit graph is untouched when disabled."""
    new = jax.tree.map(
        lambda e, p: e * decay + p.astype(e.dtype) * (1.0 - decay),
        state.ema_params, state.params,
    )
    return state.replace(ema_params=new)


def serving_params(state: TrainState) -> Any:
    """The params a checkpoint consumer should run: EMA when tracked."""
    return state.params if state.ema_params is None else state.ema_params


def make_optimizer(cfg: TrainConfig) -> optax.GradientTransformation:
    schedule = optax.exponential_decay(
        init_value=cfg.learning_rate,
        transition_steps=cfg.lr_decay_steps,
        decay_rate=cfg.lr_decay_rate,
        staircase=False,
    )
    return optax.chain(
        optax.clip_by_global_norm(cfg.grad_clip_norm),
        optax.adam(schedule, b1=cfg.adam_b1, b2=cfg.adam_b2),
    )


def create_train_state(
    params: Any, cfg: TrainConfig, rng: jax.Array | None = None
) -> TrainState:
    return TrainState(
        step=jnp.zeros((), jnp.int32),
        params=params,
        opt_state=make_optimizer(cfg).init(params),
        rng=rng if rng is not None else jax.random.PRNGKey(cfg.seed),
        # jnp.array copies: ema must not alias params or donating the
        # state buffers would see the same buffer twice
        ema_params=(
            jax.tree.map(lambda p: jnp.array(p, jnp.float32), params)
            if cfg.ema_decay > 0 else None
        ),
    )


def global_norm(tree: Any) -> jax.Array:
    return jnp.sqrt(
        sum(jnp.sum(jnp.square(x.astype(jnp.float32)))
            for x in jax.tree.leaves(tree))
    )
