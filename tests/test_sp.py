"""Sequence-parallel generation ≡ single-device generation (SURVEY.md §5
long-context stretch; halo exchange derived by GSPMD from time sharding).

The per-shard length must cover the largest dilation (512 samples for the
default student): GSPMD's halo exchange reaches one neighbor shard only,
and a larger shift produces silently wrong values — validate_sp refuses
such shapes (regression-tested below).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pwn_vocoder.config import MeshConfig, get_config
from pwn_vocoder.models.student import init_student
from pwn_vocoder.parallel import make_mesh
from pwn_vocoder.parallel.sp import (
    make_sp_generate,
    shard_mel_time,
    validate_sp,
)

CFG = get_config("tiny_teacher")
# tiny hop=128, max student dilation 512, 8 shards -> F >= 32 frames


@pytest.mark.parametrize("F,B", [(32, 1), (40, 2), (64, 1)])
def test_sp_generate_matches_single_device(rng, F, B):
    model, variables = init_student(CFG, jax.random.PRNGKey(0))
    mesh = make_mesh(MeshConfig(data=8, model=1))
    mel = jnp.asarray(
        rng.uniform(0, 1, (B, F, CFG.dsp.n_mels)).astype(np.float32)
    )
    key = jax.random.PRNGKey(5)

    sp_gen = make_sp_generate(model, CFG, mesh)
    wav_sp = sp_gen(variables, key, shard_mel_time(mesh, mel))
    assert wav_sp.sharding.spec == (None, "data")
    assert len(wav_sp.addressable_shards) == 8

    wav_single = jax.jit(
        lambda v, k, m: model.apply(v, k, m, method="generate")
    )(variables, key, mel)
    np.testing.assert_allclose(
        np.asarray(wav_sp), np.asarray(wav_single), rtol=1e-4, atol=1e-5
    )


def test_sp_rejects_undersized_shards(rng):
    """F=16 over 8 shards -> 256-sample shards < 512 max dilation: must
    raise, not silently corrupt (observed 0.15-0.2 max deviation)."""
    model, variables = init_student(CFG, jax.random.PRNGKey(0))
    mesh = make_mesh(MeshConfig(data=8, model=1))
    mel = jnp.asarray(
        rng.uniform(0, 1, (1, 16, CFG.dsp.n_mels)).astype(np.float32)
    )
    sp_gen = make_sp_generate(model, CFG, mesh)
    with pytest.raises(ValueError, match="max dilation"):
        sp_gen(variables, jax.random.PRNGKey(0),
               shard_mel_time(mesh, mel))
    with pytest.raises(ValueError, match="divisible"):
        validate_sp(CFG, mesh, 17)


def test_sp_mega_matches_single_device(rng):
    """Overlap-recompute SP (shard_map, kernel-capable path) ==
    unsharded generate — VERDICT r1 item 1 equivalence gate."""
    from pwn_vocoder.parallel.sp import make_sp_generate_overlap

    cfg = get_config("tiny_teacher")  # fused auto -> xla on CPU; the
    # kernel == xla equivalence is covered by tests/test_flow_stack.py
    model, variables = init_student(cfg, jax.random.PRNGKey(0))
    mesh = make_mesh(MeshConfig(data=4, model=2))  # joint-axis sharding
    key = jax.random.PRNGKey(5)
    mel = jnp.asarray(
        rng.uniform(0, 1, (1, 320, cfg.dsp.n_mels)).astype(np.float32)
    )
    gen = make_sp_generate_overlap(model, cfg, mesh)
    wav = gen(variables, key, mel)
    assert len(wav.addressable_shards) == 8
    ref = jax.jit(
        lambda v, k, m: model.apply(v, k, m, method="generate")
    )(variables, key, mel)
    np.testing.assert_allclose(
        np.asarray(wav), np.asarray(ref), rtol=1e-4, atol=1e-4
    )


def test_sp_mega_rejects_undersized_shards(rng):
    from pwn_vocoder.parallel.sp import (
        make_sp_generate_overlap,
        validate_sp_overlap,
    )

    cfg = get_config("tiny_teacher")
    model, variables = init_student(cfg, jax.random.PRNGKey(0))
    mesh = make_mesh(MeshConfig(data=8, model=1))
    mel = jnp.asarray(
        rng.uniform(0, 1, (1, 64, cfg.dsp.n_mels)).astype(np.float32)
    )
    gen = make_sp_generate_overlap(model, cfg, mesh)
    with pytest.raises(ValueError, match="overlap"):
        gen(variables, jax.random.PRNGKey(0), mel)
    with pytest.raises(ValueError, match="divisible"):
        validate_sp_overlap(cfg, mesh, 321)


def test_sp_mega_single_device_degenerates_to_plain_generate(rng):
    """A 1-device mesh has no shards to overlap: make_sp_generate_overlap
    must return the plain generate (an earlier version raised a spurious
    'window exceeds the utterance' refusal here)."""
    from pwn_vocoder.parallel.sp import (
        make_sp_generate_overlap,
        validate_sp_overlap,
    )

    from jax.sharding import Mesh

    cfg = get_config("tiny_teacher")
    model, variables = init_student(cfg, jax.random.PRNGKey(0))
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    key = jax.random.PRNGKey(5)
    mel = jnp.asarray(
        rng.uniform(0, 1, (1, 40, cfg.dsp.n_mels)).astype(np.float32)
    )
    validate_sp_overlap(cfg, mesh, 40)  # must not raise at n=1
    gen = make_sp_generate_overlap(model, cfg, mesh)
    wav = gen(variables, key, mel)
    ref = jax.jit(
        lambda v, k, m: model.apply(v, k, m, method="generate")
    )(variables, key, mel)
    np.testing.assert_allclose(np.asarray(wav), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
