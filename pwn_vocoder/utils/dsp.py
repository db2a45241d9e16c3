"""On-device DSP: STFT, mel spectrograms, dB (de)normalization, preemphasis.

Replaces the reference's librosa-based host DSP (`audio_utils.py` [R],
SURVEY.md §2a row "DSP utils").  Everything here is pure jnp so it runs
inside jit on the device — mel extraction happens next to the model instead of
in forked ZMQ worker processes, and the spectral ("power") distillation loss
is differentiable for free.

Conventions (the behavior contract of SURVEY.md §8, frozen for goldens):
  * preemphasis:    y[t] = x[t] - coef * x[t-1], y[0] = x[0]
  * STFT:           centered (reflect pad n_fft//2), periodic Hann window of
                    `win_length` zero-padded to `n_fft`, magnitude of rfft
  * mel filterbank: Slaney-style mel scale + Slaney area normalization
                    (librosa.filters.mel defaults, reimplemented in numpy)
  * amplitude->dB:  20*log10(max(amp, 1e-5)), then normalize_db maps
                    [min_db, 0] -> [0, 1] after subtracting ref_db

The filterbank and window are host-precomputed numpy constants (closed over
by jit, so they are embedded once and live in HBM).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from pwn_vocoder.config import DSPConfig

_AMP_FLOOR = 1e-5


# ---------------------------------------------------------------------------
# Host-side constants (numpy)
# ---------------------------------------------------------------------------


def hz_to_mel(freq: np.ndarray | float) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, log above."""
    freq = np.asarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = freq >= min_log_hz
    safe = np.maximum(freq, min_log_hz)
    mels = np.where(
        log_region, min_log_mel + np.log(safe / min_log_hz) / logstep, mels
    )
    return mels


def mel_to_hz(mels: np.ndarray | float) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(
        log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs
    )
    return freqs


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    sample_rate: int, n_fft: int, n_mels: int, fmin: float, fmax: float
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, n_fft//2+1).

    Reimplements librosa.filters.mel(htk=False, norm='slaney') from the
    mel-scale definition — no librosa dependency (it is not installed).
    """
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney area normalization: each triangle integrates to ~constant energy.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
def hann_window(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann window of win_length, centered and zero-padded to n_fft."""
    if win_length > n_fft:
        raise ValueError("win_length must be <= n_fft")
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(win_length) / win_length))
    pad = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=np.float32)
    out[pad : pad + win_length] = w
    return out


# ---------------------------------------------------------------------------
# Device-side transforms (jnp; all support leading batch dims via vmap-free
# broadcasting over the last axis)
# ---------------------------------------------------------------------------


def preemphasis(x: jax.Array, coef: float = 0.97) -> jax.Array:
    """y[t] = x[t] - coef*x[t-1] along the last axis (y[0] = x[0])."""
    if coef == 0.0:
        return x
    shifted = jnp.pad(x[..., :-1], [(0, 0)] * (x.ndim - 1) + [(1, 0)])
    return x - coef * shifted


def deemphasis(y: jax.Array, coef: float = 0.97) -> jax.Array:
    """Inverse of `preemphasis`: x[t] = y[t] + coef*x[t-1] (IIR scan)."""
    if coef == 0.0:
        return y

    def step(carry, yt):
        xt = yt + coef * carry
        return xt, xt

    flat = y.reshape(-1, y.shape[-1])
    _, out = jax.lax.scan(step, jnp.zeros(flat.shape[0], y.dtype), flat.T)
    return out.T.reshape(y.shape)


def frame(x: jax.Array, n_fft: int, hop: int, center: bool = True) -> jax.Array:
    """Slice a signal (..., T) into overlapping frames (..., n_frames, n_fft)."""
    if center:
        pad = [(0, 0)] * (x.ndim - 1) + [(n_fft // 2, n_fft // 2)]
        x = jnp.pad(x, pad, mode="reflect")
    T = x.shape[-1]
    n_frames = 1 + (T - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    return x[..., idx]


def stft_magnitude(
    x: jax.Array, n_fft: int, hop: int, win_length: int, center: bool = True
) -> jax.Array:
    """|STFT| of (..., T) -> (..., n_frames, n_fft//2 + 1), float32."""
    frames = frame(x.astype(jnp.float32), n_fft, hop, center=center)
    win = jnp.asarray(hann_window(win_length, n_fft))
    spec = jnp.fft.rfft(frames * win, n=n_fft, axis=-1)
    return jnp.abs(spec)


def amp_to_db(amp: jax.Array) -> jax.Array:
    return 20.0 * jnp.log10(jnp.maximum(amp, _AMP_FLOOR))


def db_to_amp(db: jax.Array) -> jax.Array:
    return jnp.power(10.0, db * 0.05)


def normalize_db(db: jax.Array, cfg: DSPConfig) -> jax.Array:
    """Map dB to [0, 1]: clip((db - ref_db - min_db) / -min_db, 0, 1)."""
    return jnp.clip((db - cfg.ref_db - cfg.min_db) / (-cfg.min_db), 0.0, 1.0)


def denormalize_db(norm: jax.Array, cfg: DSPConfig) -> jax.Array:
    return jnp.clip(norm, 0.0, 1.0) * (-cfg.min_db) + cfg.min_db + cfg.ref_db


def linear_spectrogram(x: jax.Array, cfg: DSPConfig) -> jax.Array:
    """Normalized linear-magnitude spectrogram (..., frames, n_fft//2+1)."""
    mag = stft_magnitude(x, cfg.n_fft, cfg.hop_length, cfg.win_length)
    return normalize_db(amp_to_db(mag), cfg)


def mel_spectrogram(x: jax.Array, cfg: DSPConfig) -> jax.Array:
    """Normalized log-mel spectrogram of (..., T) -> (..., frames, n_mels).

    This is the conditioning input of both teacher and student, and the
    quantity the "mel allclose" correctness gate (BASELINE.json) is
    evaluated on.
    """
    mag = stft_magnitude(x, cfg.n_fft, cfg.hop_length, cfg.win_length)
    fbank = jnp.asarray(
        mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin,
                       cfg.fmax_hz)
    )
    mel = jnp.einsum("...tf,mf->...tm", mag, fbank)
    return normalize_db(amp_to_db(mel), cfg)


def wav_to_mel(wav: jax.Array, cfg: DSPConfig) -> jax.Array:
    """Full reference pipeline wav -> conditioning mel: preemphasis + mel."""
    return mel_spectrogram(preemphasis(wav, cfg.preemphasis), cfg)


def mel_spectrogram_np(x: np.ndarray, cfg: DSPConfig) -> np.ndarray:
    """Pure-numpy mirror of `mel_spectrogram` (..., T) -> (..., F, n_mels).

    For host-side mel extraction on the serving and batch-vocoding paths:
    an eager per-utterance mel on the device compiles once per distinct
    clip length.  Allclose-pinned to the jnp pipeline by
    tests/test_dsp.py.
    """
    x = np.asarray(x, np.float32)
    pad = [(0, 0)] * (x.ndim - 1) + [(cfg.n_fft // 2, cfg.n_fft // 2)]
    xp = np.pad(x, pad, mode="reflect")
    n_frames = 1 + (xp.shape[-1] - cfg.n_fft) // cfg.hop_length
    idx = (np.arange(n_frames)[:, None] * cfg.hop_length
           + np.arange(cfg.n_fft)[None, :])
    frames = xp[..., idx] * hann_window(cfg.win_length, cfg.n_fft)
    mag = np.abs(np.fft.rfft(frames, n=cfg.n_fft, axis=-1)).astype(
        np.float32)
    fbank = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels,
                           cfg.fmin, cfg.fmax_hz)
    mel = mag @ fbank.T
    db = 20.0 * np.log10(np.maximum(mel, _AMP_FLOOR))
    return np.clip((db - cfg.ref_db - cfg.min_db) / (-cfg.min_db),
                   0.0, 1.0).astype(np.float32)


def power_spectrum(x: jax.Array, cfg: DSPConfig) -> jax.Array:
    """|STFT|^2, un-normalized — the distillation power-loss feature [PW]."""
    mag = stft_magnitude(x, cfg.n_fft, cfg.hop_length, cfg.win_length)
    return jnp.square(mag)


# ---------------------------------------------------------------------------
# mu-law companding (reference `audio_utils` [R] kept it for the classic
# 8-bit WaveNet input path; our MoL teacher does not need it, but it is
# part of the reference's DSP surface)
# ---------------------------------------------------------------------------


def mulaw_encode(x: jax.Array, mu: int = 255) -> jax.Array:
    """x in [-1,1] -> companded [-1,1]."""
    mu_f = float(mu)
    return jnp.sign(x) * jnp.log1p(mu_f * jnp.abs(x)) / np.log1p(mu_f)


def mulaw_decode(y: jax.Array, mu: int = 255) -> jax.Array:
    mu_f = float(mu)
    return jnp.sign(y) * (jnp.power(1.0 + mu_f, jnp.abs(y)) - 1.0) / mu_f


def mulaw_quantize(x: jax.Array, mu: int = 255) -> jax.Array:
    """x in [-1,1] -> integer class in [0, mu]."""
    y = mulaw_encode(x, mu)
    return jnp.clip(((y + 1.0) / 2.0 * mu + 0.5), 0, mu).astype(jnp.int32)


def mulaw_dequantize(q: jax.Array, mu: int = 255) -> jax.Array:
    y = 2.0 * (q.astype(jnp.float32) / mu) - 1.0
    return mulaw_decode(y, mu)


# ---------------------------------------------------------------------------
# Griffin-Lim (debugging utility, reference had one for spectrogram checks)
# ---------------------------------------------------------------------------


def _istft(spec: jax.Array, n_fft: int, hop: int, win_length: int,
           length: int) -> jax.Array:
    """Overlap-add inverse STFT of a complex (..., frames, n_fft//2+1)."""
    win = jnp.asarray(hann_window(win_length, n_fft))
    frames = jnp.fft.irfft(spec, n=n_fft, axis=-1) * win
    n_frames = frames.shape[-2]
    total = n_fft + hop * (n_frames - 1)

    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    flat = frames.reshape(-1, n_frames, n_fft)

    def ola(fr):
        sig = jnp.zeros(total, jnp.float32).at[idx.reshape(-1)].add(
            fr.reshape(-1)
        )
        wsum = jnp.zeros(total, jnp.float32).at[idx.reshape(-1)].add(
            jnp.tile(jnp.square(win), (n_frames,))
        )
        return sig / jnp.maximum(wsum, 1e-8)

    out = jax.vmap(ola)(flat).reshape(spec.shape[:-2] + (total,))
    start = n_fft // 2
    return out[..., start : start + length]


def griffin_lim(
    mag: jax.Array, cfg: DSPConfig, length: int, n_iters: int = 50,
    seed: int = 0,
) -> jax.Array:
    """Phase reconstruction from a linear magnitude spectrogram."""
    key = jax.random.PRNGKey(seed)
    angles = jax.random.uniform(key, mag.shape, minval=-np.pi, maxval=np.pi)
    spec = mag * jnp.exp(1j * angles.astype(jnp.complex64))

    def body(_, spec):
        wav = _istft(spec, cfg.n_fft, cfg.hop_length, cfg.win_length, length)
        re = stft_magnitude(wav, cfg.n_fft, cfg.hop_length, cfg.win_length)
        re_c = jnp.fft.rfft(
            frame(wav, cfg.n_fft, cfg.hop_length)
            * jnp.asarray(hann_window(cfg.win_length, cfg.n_fft)),
            n=cfg.n_fft, axis=-1,
        )
        phase = re_c / jnp.maximum(jnp.abs(re_c), 1e-8)
        del re
        return mag * phase

    spec = jax.lax.fori_loop(0, n_iters, body, spec)
    return _istft(spec, cfg.n_fft, cfg.hop_length, cfg.win_length, length)
