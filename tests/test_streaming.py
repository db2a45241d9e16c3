"""Streaming (chunked) student synthesis ≡ whole-call generation.

`generate.stream_student_chunks` recomputes each chunk with a
receptive-field overlap prefix (the sp.py overlap-recompute geometry run
sequentially), so concatenated chunks must equal the single-call output
on the same base noise.  The reference had no streaming at all [R]
(SURVEY.md §3.2 single-session generate); this is a serving capability.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pwn_vocoder.config import get_config, override
from pwn_vocoder.generate import stream_student_chunks
from pwn_vocoder.models.student import init_student
from pwn_vocoder.ops import mol

CFG = get_config("tiny_teacher")


@pytest.mark.parametrize("F,chunk_frames,B", [(64, 16, 1), (60, 10, 2)])
def test_streaming_matches_whole_call(rng, F, chunk_frames, B):
    model, variables = init_student(CFG, jax.random.PRNGKey(0))
    params = variables["params"]
    hop = CFG.dsp.hop_length
    mel = jnp.asarray(
        rng.uniform(0, 1, (B, F, CFG.dsp.n_mels)).astype(np.float32)
    )
    z = mol.sample_logistic(jax.random.PRNGKey(3), (B, F * hop))

    whole = jax.jit(
        lambda v, z, m: model.apply(v, z, m, method="generate_from_z")
    )(variables, z, mel)

    chunks = list(stream_student_chunks(
        CFG, params, mel, z=np.asarray(z), chunk_frames=chunk_frames
    ))
    assert len(chunks) == F // chunk_frames
    assert all(c.shape == (B, chunk_frames * hop) for c in chunks)
    streamed = np.concatenate(chunks, axis=1)
    np.testing.assert_allclose(
        streamed, np.asarray(whole), rtol=1e-5, atol=1e-6
    )


def test_streaming_matches_whole_call_gaussian(rng):
    """Streaming exactness holds for the Gaussian/ClariNet family too:
    the window fn is family-agnostic (flows_from_z), and the chunked
    noise stream draws from the config's base via `sample_base_noise`
    (here N(0,1) instead of Logistic(0,1))."""
    from pwn_vocoder.models.student import sample_base_noise

    cfg = CFG
    for k, v in (("teacher.output", "gaussian"),
                 ("student.base", "gaussian")):
        cfg = override(cfg, k, v)
    model, variables = init_student(cfg, jax.random.PRNGKey(0))
    params = variables["params"]
    hop = cfg.dsp.hop_length
    B, F, chunk_frames = 2, 64, 16
    mel = jnp.asarray(
        rng.uniform(0, 1, (B, F, cfg.dsp.n_mels)).astype(np.float32)
    )
    z = sample_base_noise(cfg, jax.random.PRNGKey(3), (B, F * hop))

    whole = jax.jit(
        lambda v, z, m: model.apply(v, z, m, method="generate_from_z")
    )(variables, z, mel)

    streamed = np.concatenate(list(stream_student_chunks(
        cfg, params, mel, z=np.asarray(z), chunk_frames=chunk_frames
    )), axis=1)
    np.testing.assert_allclose(
        streamed, np.asarray(whole), rtol=1e-5, atol=1e-6
    )
    # keyed (chunk-stream) noise also draws from the gaussian base
    a = np.concatenate(list(stream_student_chunks(
        cfg, params, mel, key=jax.random.PRNGKey(7), chunk_frames=16
    )), axis=1)
    assert np.isfinite(a).all() and np.abs(a).max() <= 1.0


def test_streaming_cover_tail_matches_whole_call(rng):
    """cover_tail=True emits a final partial chunk so the FULL
    utterance is synthesized (the serving path previously truncated up
    to chunk_frames*hop - 1 samples); concatenation must still equal
    the whole-call output on the same z."""
    model, variables = init_student(CFG, jax.random.PRNGKey(0))
    params = variables["params"]
    hop = CFG.dsp.hop_length
    B, F, cf = 2, 61, 16  # rem = 13 frames
    mel = jnp.asarray(
        rng.uniform(0, 1, (B, F, CFG.dsp.n_mels)).astype(np.float32)
    )
    z = mol.sample_logistic(jax.random.PRNGKey(3), (B, F * hop))
    whole = jax.jit(
        lambda v, z, m: model.apply(v, z, m, method="generate_from_z")
    )(variables, z, mel)

    chunks = list(stream_student_chunks(
        CFG, params, mel, z=np.asarray(z), chunk_frames=cf,
        cover_tail=True,
    ))
    assert chunks[-1].shape == (B, (F % cf) * hop)
    streamed = np.concatenate(chunks, axis=1)
    assert streamed.shape[1] == F * hop
    np.testing.assert_allclose(
        streamed, np.asarray(whole), rtol=1e-5, atol=1e-6
    )
    # rem == 0 -> no extra chunk, identical to cover_tail=False
    mel64 = jnp.asarray(
        rng.uniform(0, 1, (B, 64, CFG.dsp.n_mels)).astype(np.float32)
    )
    z64 = np.asarray(mol.sample_logistic(
        jax.random.PRNGKey(9), (B, 64 * hop)))
    a = list(stream_student_chunks(
        CFG, params, mel64, z=z64, chunk_frames=cf, cover_tail=True))
    b = list(stream_student_chunks(
        CFG, params, mel64, z=z64, chunk_frames=cf))
    assert len(a) == len(b)
    np.testing.assert_array_equal(
        np.concatenate(a, axis=1), np.concatenate(b, axis=1))


def test_streaming_chunk_noise_is_deterministic_and_bounded(rng):
    """Without a pre-drawn z: same key -> identical chunks across calls,
    finite output in [-1, 1], and the z-block cache stays bounded."""
    model, variables = init_student(CFG, jax.random.PRNGKey(0))
    params = variables["params"]
    mel = jnp.asarray(
        rng.uniform(0, 1, (1, 64, CFG.dsp.n_mels)).astype(np.float32)
    )
    key = jax.random.PRNGKey(11)
    a = np.concatenate(list(stream_student_chunks(
        CFG, params, mel, key=key, chunk_frames=16
    )), axis=1)
    b = np.concatenate(list(stream_student_chunks(
        CFG, params, mel, key=key, chunk_frames=16
    )), axis=1)
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and np.abs(a).max() <= 1.0


def test_streaming_window_fn_is_cached():
    """Successive generators with the same (config, chunk size) must
    reuse one jitted window fn — serving spawns a generator per request,
    and re-jitting per request would put a compile in every
    time-to-first-chunk."""
    from pwn_vocoder.generate import _stream_window_fn

    a = _stream_window_fn(CFG, 16)
    b = _stream_window_fn(CFG, 16)
    assert a is b
    assert _stream_window_fn(CFG, 8) is not a  # distinct chunk size
    # distinct-but-equal config objects hit the same entry
    cfg2 = get_config("tiny_teacher")
    assert cfg2 is not CFG
    assert _stream_window_fn(cfg2, 16) is a


def test_streaming_validation():
    model, variables = init_student(CFG, jax.random.PRNGKey(0))
    params = variables["params"]
    mel = np.zeros((1, 64, CFG.dsp.n_mels), np.float32)
    with pytest.raises(ValueError, match="divisible"):
        next(stream_student_chunks(CFG, params, mel,
                                   key=jax.random.PRNGKey(0),
                                   chunk_frames=31))
    with pytest.raises(ValueError, match="shorter than one"):
        next(stream_student_chunks(
            CFG, params, np.zeros((1, 16, CFG.dsp.n_mels), np.float32),
            key=jax.random.PRNGKey(0), chunk_frames=16,
        ))
    with pytest.raises(ValueError, match="key"):
        next(stream_student_chunks(CFG, params, mel, chunk_frames=16))


def test_vocode_many_exact_and_composition_invariant(rng):
    """Batch/bucketed vocoding (`generate.vocode_many`): each item must
    equal the documented per-item reference (generate_from_z on the
    item's own noise slice) regardless of batch composition, bucket
    padding, or zero batch rows — the upsampler runs at true length and
    the flows are causal, so padding cannot reach a real sample."""
    from pwn_vocoder.generate import _host_deemphasis, vocode_many
    from pwn_vocoder.models.student import sample_base_noise

    model, variables = init_student(CFG, jax.random.PRNGKey(0))
    # jitter EVERY param (biases included): fresh inits have zero
    # biases, which would make bucket-padded upsampling trivially exact
    # and leave the tail-splice correctness argument untested
    leaves, treedef = jax.tree_util.tree_flatten(variables["params"])
    jkeys = jax.random.split(jax.random.PRNGKey(99), len(leaves))
    params = jax.tree_util.tree_unflatten(treedef, [
        p + 0.05 * jax.random.normal(k, p.shape, p.dtype)
        for p, k in zip(leaves, jkeys)
    ])
    hop = CFG.dsp.hop_length
    key = jax.random.PRNGKey(5)
    bucket = 8
    # 13/8 exercise the short-item fallback (< W = 2H+4 frames), 21 and
    # 37 the bucket-padded + tail-splice path, with a partial batch
    lengths = [13, 8, 21, 37]
    mels = [rng.uniform(0, 1, (F, CFG.dsp.n_mels)).astype(np.float32)
            for F in lengths]

    outs = vocode_many(CFG, params, mels, key, temperature=0.9,
                       batch_size=2, bucket_frames=bucket)

    # (a) the precision-critical claim: bucket-padded upsampling + the
    # exact tail-window splice reproduces the TRUE-length conditioning
    # (measured: zero-pad contamination reaches only ~8 samples past
    # the boundary on this config; the splice overwrites (H+2)*hop)
    from pwn_vocoder.generate import _vocode_fns

    up, _, _, W = _vocode_fns(CFG)
    S = (W // 2) * hop
    F = lengths[3]
    fb = -(-F // bucket) * bucket
    m = mels[3]
    cond_pad = np.asarray(up(
        params, jnp.asarray(np.pad(m, ((0, fb - F), (0, 0)))[None])
    ))[0, : F * hop]
    tail = np.asarray(up(params, jnp.asarray(m[-W:][None])))[0]
    spliced = np.concatenate([cond_pad[: F * hop - S], tail[-S:]])
    cond_true = np.asarray(up(params, jnp.asarray(m[None])))[0]
    np.testing.assert_allclose(spliced, cond_true, rtol=1e-4, atol=1e-5)

    # (b) end-to-end waveforms: batched-vs-single fp reordering noise
    # amplifies through 4 flows of exp(log_s) and the deemphasis IIR,
    # so the tolerance is looser than the cond check above
    for i, (F, m) in enumerate(zip(lengths, mels)):
        Tb = -(-F // bucket) * bucket * hop
        z = sample_base_noise(
            CFG, jax.random.fold_in(key, i), (1, Tb)) * 0.9
        ref = model.apply(
            {"params": params}, z[:, : F * hop], jnp.asarray(m[None]),
            method="generate_from_z",
        )
        ref = _host_deemphasis(np.asarray(ref), CFG.dsp.preemphasis)[0]
        assert outs[i].shape == (F * hop,)
        np.testing.assert_allclose(outs[i], ref, rtol=2e-4, atol=2e-4)

    # composition invariance: the same item alone gives the same audio
    solo = vocode_many(CFG, params, [mels[2]], key, temperature=0.9,
                       batch_size=4, bucket_frames=bucket)
    # solo item has index 0 -> different fold_in stream than outs[2];
    # rebuild the reference for index 0 instead of comparing directly
    Tb = -(-lengths[2] // bucket) * bucket * hop
    z0 = sample_base_noise(
        CFG, jax.random.fold_in(key, 0), (1, Tb)) * 0.9
    ref0 = model.apply(
        {"params": params}, z0[:, : lengths[2] * hop],
        jnp.asarray(mels[2][None]), method="generate_from_z",
    )
    ref0 = _host_deemphasis(np.asarray(ref0), CFG.dsp.preemphasis)[0]
    np.testing.assert_allclose(solo[0], ref0, rtol=2e-4, atol=2e-4)
