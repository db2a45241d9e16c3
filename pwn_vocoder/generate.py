"""Waveform generation entry logic (reference: `generate.py` [R],
SURVEY.md §3.2).

The student path is the headline feature: mel -> waveform in ONE jitted
parallel pass (no sample loop).  The teacher path uses the conv-queue
`lax.scan` fast sampler.  Both consume mel computed on device from a
source waveform (copy-synthesis, as the reference's generate.py did with
held-out utterances).
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from pwn_vocoder.config import Config
from pwn_vocoder.models import sampling
from pwn_vocoder.models.student import make_student, sample_base_noise
from pwn_vocoder.models.teacher import make_teacher
from pwn_vocoder.utils import dsp


def mel_from_wav(cfg: Config, wav: np.ndarray) -> jax.Array:
    """Host wav (T,) float32 -> conditioning mel (1, F, n_mels)."""
    x = jnp.clip(
        dsp.preemphasis(jnp.asarray(wav)[None], cfg.dsp.preemphasis),
        -1.0, 1.0,
    )
    mel = dsp.mel_spectrogram(x, cfg.dsp)
    return mel[:, : wav.shape[-1] // cfg.dsp.hop_length]


def mel_from_wav_host(cfg: Config, wav: np.ndarray) -> np.ndarray:
    """`mel_from_wav` computed entirely on host numpy — (T,) float32 ->
    (F, n_mels).  For the batch-vocoding and serving paths, where an
    eager device mel would compile once per distinct clip length.
    """
    wav = np.asarray(wav, np.float32)
    if cfg.dsp.preemphasis:
        x = wav - cfg.dsp.preemphasis * np.concatenate(
            [[0.0], wav[:-1]]).astype(np.float32)
    else:
        x = wav
    x = np.clip(x, -1.0, 1.0)
    mel = dsp.mel_spectrogram_np(x[None], cfg.dsp)
    return mel[0, : len(wav) // cfg.dsp.hop_length]


def coerce_mel(cfg: Config, mel: np.ndarray) -> np.ndarray:
    """Externally supplied mel (F, n_mels) or (1, F, n_mels) float ->
    validated HOST (1, F, n_mels) conditioning array (every consumer
    either slices it host-side or ships it to the device itself).

    This is the production vocoder input path: a TTS acoustic model
    hands the vocoder a mel directly (the reference only did wav
    copy-synthesis, SURVEY.md §3.2).  The expected convention is
    exactly `utils/dsp.mel_spectrogram` output — n_mels =
    cfg.dsp.n_mels bands (Slaney mel, fmin/fmax per config), dB-scale
    normalized to [0, 1] via `normalize_db`, computed on a
    preemphasized source.  `cli generate --dump-mel` emits mels in
    this convention for calibration.
    """
    arr = np.asarray(mel, dtype=np.float32)
    if arr.ndim == 2:
        arr = arr[None]
    if (arr.ndim != 3 or arr.shape[0] != 1
            or arr.shape[-1] != cfg.dsp.n_mels):
        raise ValueError(
            f"mel must be (frames, {cfg.dsp.n_mels}) or "
            f"(1, frames, {cfg.dsp.n_mels}); got {arr.shape}"
        )
    if not np.isfinite(arr).all():
        raise ValueError("mel contains non-finite values")
    return arr


def generate_student(
    cfg: Config,
    student_params: Any,
    mel: jax.Array,
    key: jax.Array,
    temperature: float = 1.0,
) -> np.ndarray:
    """Single-pass student synthesis of row 0, deemphasized (host
    numpy)."""
    wav = generate_student_batch(cfg, student_params, mel, key, temperature)
    wav = dsp.deemphasis(wav, cfg.dsp.preemphasis)
    return np.asarray(wav[0])


def generate_student_batch(
    cfg: Config,
    student_params: Any,
    mel: jax.Array,
    key: jax.Array,
    temperature: float = 1.0,
) -> jax.Array:
    """Student synthesis of a mel batch (B, F, n_mels) -> (B, F*hop) in
    the model (preemphasized) domain: StudentIAF.generate on the scan
    inference path, one jitted call per mel shape."""
    return _generate_fn(cfg)(student_params, key, mel, temperature)


@functools.lru_cache(maxsize=8)
def _generate_fn(cfg: Config):
    model = make_student(cfg)

    @jax.jit
    def gen(params, key, mel, temperature):
        return model.apply({"params": params}, key, mel,
                           method="generate", temperature=temperature)

    return gen


def _host_deemphasis(wav: np.ndarray, coef: float) -> np.ndarray:
    """Deemphasis IIR on host via scipy's C loop: the device version is
    a T-step sequential `lax.scan`, for an op with no parallelism."""
    if coef == 0.0:
        return np.asarray(wav, np.float32)
    from scipy.signal import lfilter

    return lfilter([1.0], [1.0, -coef], np.asarray(wav),
                   axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _vocode_fns(cfg: Config):
    """Jitted pieces of `vocode_many`, shaped to minimise BOTH
    dispatches and distinct compiles:

    * `up` — the conditioning upsampler, called once per batch on
      bucket-padded mels (one graph per bucket) and once per batch on
      fixed-W tail windows (one graph total);
    * `flows` — tail splice + noise draw + flow stack in ONE dispatch.

    The tail splice is what keeps bucket padding EXACT: a zero mel
    frame contributes nothing to a transposed conv's overlap-add, so
    the padded upsampler's prefix differs from the true-length one only
    where inter-stage biases within the halo `H` of the boundary leak
    back — the last <= H*hop samples.  Re-running the upsampler on the
    item's TRUE last W frames reproduces the true right boundary; its
    output is left-boundary-contaminated only in its first H*hop
    samples, so splicing its last S = (H+2)*hop samples (W = 2H + 4,
    W*hop - S >= H*hop) overwrites every contaminated position with an
    exact value.  Pinned against unpadded generation by
    tests/test_streaming.py."""
    from pwn_vocoder.parallel.sp import overlap_geometry

    model = make_student(cfg)
    hop = cfg.dsp.hop_length
    _, H = overlap_geometry(cfg)
    W = 2 * H + 4
    S = (H + 2) * hop

    def _up(p, mel):
        return model.apply({"params": p}, mel, method="upsample_cond")

    def _flows(p, cond, tail, t_arr, key, idx, temperature):
        # tail is (B, W*hop, C) upsampled from TRUE last-W-frame mel
        # windows; t_arr the per-row true sample lengths
        def fix(c, t, T):
            return jax.lax.dynamic_update_slice(c, t[-S:], (T - S, 0))

        cond = jax.vmap(fix)(cond, tail, t_arr)
        Tb = cond.shape[1]
        z = jax.vmap(
            lambda i: sample_base_noise(
                cfg, jax.random.fold_in(key, i), (Tb,))
        )(idx) * temperature
        return model.apply({"params": p}, z, cond,
                           method="flows_from_z")

    def _flows_plain(p, cond, key, idx, temperature):
        Tb = cond.shape[1]
        z = jax.vmap(
            lambda i: sample_base_noise(
                cfg, jax.random.fold_in(key, i), (Tb,))
        )(idx) * temperature
        return model.apply({"params": p}, z, cond,
                           method="flows_from_z")

    return (jax.jit(_up), jax.jit(_flows), jax.jit(_flows_plain), W)


def vocode_many(
    cfg: Config,
    student_params: Any,
    mels,
    key: jax.Array,
    temperature: float = 1.0,
    batch_size: int = 8,
    bucket_frames: int = 64,
):
    """Batch-vocode many variable-length utterances at the device's
    batched throughput (the single-utterance path leaves most of the
    device idle).

    Items are bucketed by length (rounded up to `bucket_frames`) and
    run through the flow stack in `batch_size` groups — one compile per
    distinct bucket, reused across runs via the persistent cache.  The
    per-item result is EXACT, independent of batch composition and
    padding: the conditioning upsampler (the only non-causal module)
    runs per item at its TRUE length, and the flow stack is causal over
    (z, cond), so zero-padded tails and repeated batch rows cannot
    reach a real sample.  Item i's waveform equals
    `generate_from_z(z_i[:, :T_i], mel_i)` for
    `z_i = sample_base_noise(cfg, fold_in(key, i), (1, bucket_len)) *
    temperature`, deemphasized with the host IIR (bit-matching the
    streaming serve path's `_Deemph`; pinned by
    tests/test_streaming.py).

    mels: sequence of (F_i, n_mels) or (1, F_i, n_mels) arrays
    (convention: `coerce_mel`).  Returns a list of (T_i,) float32
    deemphasized numpy waveforms, order-preserving.
    """
    hop = cfg.dsp.hop_length
    up, flows, flows_plain, W = _vocode_fns(cfg)
    items = [coerce_mel(cfg, m)[0] for m in mels]  # host (F, M)
    buckets: dict = {}
    for i, m in enumerate(items):
        fb = -(-m.shape[0] // bucket_frames) * bucket_frames
        buckets.setdefault(fb, []).append(i)

    out: list = [None] * len(items)
    for fb in sorted(buckets):
        idxs = buckets[fb]
        Tb = fb * hop
        for at in range(0, len(idxs), batch_size):
            group = idxs[at: at + batch_size]
            # ragged groups reuse the full-batch executable: pad rows
            # with repeated entries and discard them
            rows = group + [group[-1]] * (batch_size - len(group))
            if all(items[i].shape[0] >= W for i in group):
                # bucket-padded upsample + exact tail windows (host
                # pads are free; two device dispatches per batch)
                mel_pad = jnp.asarray(np.stack([
                    np.pad(items[i],
                           ((0, fb - items[i].shape[0]), (0, 0)))
                    for i in rows]))
                tails = jnp.asarray(np.stack(
                    [items[i][-W:] for i in rows]))
                t_arr = jnp.asarray(
                    [items[i].shape[0] * hop for i in rows])
                wav = flows(
                    student_params, up(student_params, mel_pad),
                    up(student_params, tails), t_arr, key,
                    jnp.asarray(rows), temperature,
                )
            else:
                # ultra-short utterances (< W = 2H+4 frames): per-item
                # exact upsample at true length, eager pad (rare path)
                cond = jnp.concatenate([
                    jnp.pad(
                        up(student_params,
                           jnp.asarray(items[i][None])),
                        ((0, 0),
                         (0, Tb - items[i].shape[0] * hop), (0, 0)))
                    for i in rows])
                wav = flows_plain(student_params, cond, key,
                                  jnp.asarray(rows), temperature)
            wav = _host_deemphasis(wav, cfg.dsp.preemphasis)
            for row, i in enumerate(group):
                out[i] = wav[row, : items[i].shape[0] * hop]
    return out


def _stream_geometry(cfg: Config, chunk_frames: int):
    """(R, H, CT, WT, WF) for streaming windows: receptive-field prefix,
    upsampler frame halo, chunk samples, window samples, window frames."""
    from pwn_vocoder.parallel.sp import overlap_geometry

    hop = cfg.dsp.hop_length
    R, H = overlap_geometry(cfg)
    CT = chunk_frames * hop
    WT = CT + R
    return R, H, CT, WT, WT // hop + 2 * H


def _stream_plan(cfg: Config, F: int, chunk_frames: int,
                 cover_tail: bool):
    """Window descriptors for streaming synthesis over an F-frame mel:
    yields (ws, f_start, off, out_off, trim) — base-noise window start
    (samples), mel window start (frames), cond offset and output offset
    within the window, and the count of leading samples of the emitted
    CT-sample chunk to drop (non-zero only for the final partial tail
    chunk).  Shared by `stream_student_chunks` and the serving batch
    engine (`serve._BatchEngine`) so the two paths are window-for-window
    identical."""
    hop = cfg.dsp.hop_length
    R, H, CT, WT, WF = _stream_geometry(cfg, chunk_frames)
    for c in range(F // chunk_frames):
        start = c * CT
        ws = max(0, start - R)
        f_start = min(max(ws // hop - H, 0), F - WF)
        yield ws, f_start, ws - f_start * hop, start - ws, 0
    rem = F % chunk_frames
    if cover_tail and rem:
        # final partial chunk: the same static window, positioned to END
        # at the utterance boundary; it re-emits CT samples of which the
        # first CT - rem*hop overlap already-yielded audio (F >= WF
        # guarantees T >= WT, so ws >= 0)
        T = F * hop
        ws = T - WT
        f_start = min(max(ws // hop - H, 0), F - WF)
        yield ws, f_start, ws - f_start * hop, (T - CT) - ws, \
            CT - rem * hop


@functools.lru_cache(maxsize=16)
def _batched_stream_window_fn(cfg: Config, chunk_frames: int,
                              batch: int):
    """Serving batch-engine kernel: ONE jitted call computes one
    streaming window for `batch` INDEPENDENT single-utterance requests.
    Each row carries its own request key (base noise is drawn IN-JIT
    from the same `fold_in(key, block)` random-access stream as
    `stream_student_chunks`' z_at — per-row window phases must not
    trigger per-request eager device ops), its own
    cond/output offsets (requests sit at different chunk positions),
    and its own temperature.  Row i equals the direct streaming path's
    window for that request — pinned by tests/test_serve.py.

    Inputs: params; mel_win (B, WF, n_mels); keys (B, 2) uint32;
    ws/off/out_off (B,) int32; temp (B,) float32.  Output (B, CT).
    """
    model = make_student(cfg)
    _, _, CT, WT, _ = _stream_geometry(cfg, chunk_frames)
    # noise blocks covering any window phase: ws spans < NB*CT - WT + 1
    NB = WT // CT + 2

    @jax.jit
    def window_fn(params, mel_win, keys, ws, off, out_off, temp):
        def row_z(key, w):
            b0 = w // CT
            blocks = [
                sample_base_noise(
                    cfg, jax.random.fold_in(key, b0 + i), (1, CT))[0]
                for i in range(NB)
            ]
            full = jnp.concatenate(blocks)
            return jax.lax.dynamic_slice_in_dim(full, w - b0 * CT, WT)

        z = jax.vmap(row_z)(keys, ws) * temp[:, None]
        cond = model.apply({"params": params}, mel_win,
                           method="upsample_cond")
        cond = jax.vmap(
            lambda c, o: jax.lax.dynamic_slice_in_dim(c, o, WT, axis=0)
        )(cond, off)
        wav = model.apply({"params": params}, z, cond,
                          method="flows_from_z")
        return jax.vmap(
            lambda w, o: jax.lax.dynamic_slice_in_dim(w, o, CT, axis=0)
        )(wav, out_off)

    return window_fn


@functools.lru_cache(maxsize=8)
def _stream_window_fn(cfg: Config, chunk_frames: int):
    """Jitted one-window step for streaming synthesis, cached per
    (config, chunk size) so successive `stream_student_chunks` calls —
    the serving pattern: one generator per request — reuse the traced
    executable instead of re-jitting."""
    from pwn_vocoder.parallel.sp import overlap_geometry

    model = make_student(cfg)
    R, _ = overlap_geometry(cfg)
    CT = chunk_frames * cfg.dsp.hop_length
    WT = CT + R

    @jax.jit
    def window_fn(params, z_win, mel_win, off, out_off):
        cond = model.apply({"params": params}, mel_win,
                           method="upsample_cond")
        cond = jax.lax.dynamic_slice_in_dim(cond, off, WT, axis=1)
        wav = model.apply({"params": params}, z_win, cond,
                          method="flows_from_z")
        return jax.lax.dynamic_slice_in_dim(wav, out_off, CT, axis=1)

    return window_fn


def stream_student_chunks(
    cfg: Config,
    student_params: Any,
    mel,
    key: jax.Array | None = None,
    z=None,
    chunk_frames: int = 64,
    temperature: float = 1.0,
    cover_tail: bool = False,
):
    """Streaming student synthesis: yield waveform chunks of
    `chunk_frames * hop` samples whose concatenation equals the
    whole-call generate (serving: bounded memory, playback can start
    before the utterance finishes; the reference had no streaming at
    all — single-session full-graph generate [R] SURVEY.md §3.2).

    cover_tail=True additionally yields a final PARTIAL chunk of
    `(F % chunk_frames) * hop` samples so the full utterance is
    synthesized (the serving path would otherwise truncate up to
    chunk_frames*hop - 1 samples — audibly, the end of the last word).
    It reuses the same fixed-shape window jit positioned to end exactly
    at the utterance boundary, so it costs no extra compile and remains
    exact vs the whole-call output.

    Exactness comes from the causal stack's finite receptive field: each
    chunk is recomputed with an `R = n_flows * (Σ dilations + 1)` sample
    prefix plus the upsampler's frame halo — the same overlap-recompute
    geometry as `parallel/sp.py::make_sp_generate_overlap`, run sequentially
    instead of across devices.  One static window shape → one compile.

    z: optional pre-drawn (B, F*hop) base noise — streaming output then
    matches `generate_from_z` on the same z bit-for-bit per sample.
    Without it, noise is drawn per chunk_frames block from `key` (a
    random-access stream: overlapping windows reuse identical values),
    which is an equally valid logistic draw but a DIFFERENT stream than
    the single-call `generate`.

    Yields (B, chunk_frames * hop) float32 numpy chunks.
    """
    from pwn_vocoder.parallel.sp import overlap_geometry

    hop = cfg.dsp.hop_length
    R, H = overlap_geometry(cfg)
    B, F = mel.shape[0], mel.shape[1]
    CT = chunk_frames * hop
    # chunks smaller than R are legal (sequential recompute), just
    # increasingly wasteful: overhead per chunk is R/CT
    WT = CT + R
    WF = WT // hop + 2 * H
    if F % chunk_frames and not cover_tail:
        raise ValueError(
            f"frames {F} not divisible by chunk_frames {chunk_frames} "
            "(pass cover_tail=True to emit a final partial chunk)"
        )
    if F < WF:
        raise ValueError(
            f"utterance of {F} frames is shorter than one streaming "
            f"window ({WF}); call generate_student directly"
        )
    # keep mel on host and slice windows with numpy: an eager
    # dynamic_slice on a device-resident (1, F, M) array compiles per
    # distinct F, for an op that is free on host.  The fixed-size window
    # is shipped as the jit input it was anyway.
    mel = np.asarray(mel)
    if z is not None:
        z = np.asarray(z)  # host windows for the same reason

    window_fn = _stream_window_fn(cfg, chunk_frames)

    if z is None and key is None:
        raise ValueError("pass key= (chunk-stream noise) or z=")
    z_blocks: dict = {}

    def z_at(ws: int) -> jax.Array:
        """Window [ws, ws+WT) of the base-noise stream."""
        if z is not None:
            return jnp.asarray(z[:, ws: ws + WT])
        # windows advance monotonically: blocks before ws//CT are dead
        for old in [k for k in z_blocks if k < ws // CT]:
            del z_blocks[old]
        parts = []
        for b in range(ws // CT, (ws + WT - 1) // CT + 1):
            if b not in z_blocks:
                z_blocks[b] = (
                    sample_base_noise(cfg, jax.random.fold_in(key, b),
                                      (B, CT)) * temperature
                )
            parts.append(z_blocks[b])
        full = jnp.concatenate(parts, axis=1)
        lo = ws - (ws // CT) * CT
        return full[:, lo: lo + WT]

    for ws, f_start, off, out_off, trim in _stream_plan(
            cfg, F, chunk_frames, cover_tail):
        mel_win = jnp.asarray(mel[:, f_start: f_start + WF])
        out = np.asarray(window_fn(
            student_params, z_at(ws), mel_win,
            jnp.int32(off), jnp.int32(out_off),
        ))
        yield out[:, trim:] if trim else out


def generate_teacher(
    cfg: Config,
    teacher_params: Any,
    mel: jax.Array,
    key: jax.Array,
    temperature: float = 1.0,
) -> np.ndarray:
    """AR teacher synthesis of row 0, deemphasized (host numpy)."""
    wav = generate_teacher_batch(cfg, teacher_params, mel, key, temperature)
    wav = dsp.deemphasis(wav, cfg.dsp.preemphasis)
    return np.asarray(wav[0])


def generate_teacher_batch(
    cfg: Config,
    teacher_params: Any,
    mel: jax.Array,
    key: jax.Array,
    temperature: float = 1.0,
) -> jax.Array:
    """AR teacher sampling of a mel batch (B, F, n_mels) -> (B, F*hop)
    in the model domain, through the conv-queue `lax.scan` sampler
    (models/sampling.py::fast_sample); step t draws from
    fold_in(key, t)."""
    return _teacher_sample_fn(cfg)(teacher_params, key, mel, temperature)


@functools.lru_cache(maxsize=8)
def _teacher_sample_fn(cfg: Config):
    model = make_teacher(cfg)

    @jax.jit
    def sample(params, key, mel, temperature):
        return sampling.fast_sample(model, {"params": params}, key, mel,
                                    temperature=temperature)

    return sample
