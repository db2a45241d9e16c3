"""Objective evaluation metrics (SURVEY.md §4 integration rows:
"AR-sample and check spectral distance").

The reference had no quantitative eval (listening + TensorBoard curves
only [R]); these metrics make the quality gates testable:

* mel_l2: mean squared distance between normalized mel spectrograms —
  the "mel allclose" gate's graded version (BASELINE.json).
* spectral_convergence / log_spectral_distance: standard copy-synthesis
  fidelity measures on |STFT|.
"""

from __future__ import annotations

from typing import Dict

import jax.numpy as jnp

from pwn_vocoder.config import Config
from pwn_vocoder.utils import dsp


def mel_l2(cfg: Config, wav_a, wav_b) -> float:
    ma = dsp.mel_spectrogram(jnp.asarray(wav_a), cfg.dsp)
    mb = dsp.mel_spectrogram(jnp.asarray(wav_b), cfg.dsp)
    n = min(ma.shape[-2], mb.shape[-2])
    return float(jnp.mean(jnp.square(ma[..., :n, :] - mb[..., :n, :])))


def spectral_convergence(cfg: Config, wav_ref, wav_gen) -> float:
    a = dsp.stft_magnitude(jnp.asarray(wav_ref), cfg.dsp.n_fft,
                           cfg.dsp.hop_length, cfg.dsp.win_length)
    b = dsp.stft_magnitude(jnp.asarray(wav_gen), cfg.dsp.n_fft,
                           cfg.dsp.hop_length, cfg.dsp.win_length)
    n = min(a.shape[-2], b.shape[-2])
    a, b = a[..., :n, :], b[..., :n, :]
    return float(jnp.linalg.norm(a - b) / jnp.maximum(
        jnp.linalg.norm(a), 1e-8))


def log_spectral_distance(cfg: Config, wav_ref, wav_gen) -> float:
    a = dsp.amp_to_db(dsp.stft_magnitude(
        jnp.asarray(wav_ref), cfg.dsp.n_fft, cfg.dsp.hop_length,
        cfg.dsp.win_length))
    b = dsp.amp_to_db(dsp.stft_magnitude(
        jnp.asarray(wav_gen), cfg.dsp.n_fft, cfg.dsp.hop_length,
        cfg.dsp.win_length))
    n = min(a.shape[-2], b.shape[-2])
    return float(jnp.sqrt(jnp.mean(jnp.square(a[..., :n, :] -
                                              b[..., :n, :]))))


def voiced_metrics(cfg: Config, wav_ref, wav_gen,
                   rms_floor: float = 0.01) -> Dict[str, float]:
    """Silence-aware split of the fidelity picture.

    Whole-utterance LSD is dominated by log-spectra of silences (the
    r2 best-recipe demo: gen noise floor 16× the source's in silent
    frames wrecked LSD while voiced RMS matched to 1 %).  Reported:

    * lsd_voiced_db — LSD over frames whose REFERENCE frame RMS is
      above `rms_floor` (the perceptually dominant part);
    * silence_noise_floor_db — mean generated frame RMS in
      reference-silent frames, in dBFS (lower = cleaner silences);
    * voiced_fraction — fraction of reference frames counted voiced.
    """
    hop, nfft, win = (cfg.dsp.hop_length, cfg.dsp.n_fft,
                      cfg.dsp.win_length)
    a_db = dsp.amp_to_db(dsp.stft_magnitude(jnp.asarray(wav_ref),
                                            nfft, hop, win))
    b_db = dsp.amp_to_db(dsp.stft_magnitude(jnp.asarray(wav_gen),
                                            nfft, hop, win))
    # STFT centering can add a frame vs the raw-sample count: clamp to
    # the common frame count of spectra and hop-aligned waveform
    n = min(a_db.shape[-2], b_db.shape[-2],
            jnp.asarray(wav_ref).shape[-1] // hop,
            jnp.asarray(wav_gen).shape[-1] // hop)
    a_db, b_db = a_db[..., :n, :], b_db[..., :n, :]

    ref = jnp.asarray(wav_ref)[..., : n * hop]
    gen = jnp.asarray(wav_gen)[..., : n * hop]
    frame_rms = lambda x: jnp.sqrt(  # noqa: E731
        jnp.mean(jnp.square(x.reshape(*x.shape[:-1], n, hop)), axis=-1)
    )
    r_rms, g_rms = frame_rms(ref), frame_rms(gen)
    voiced = r_rms > rms_floor
    n_voiced = jnp.maximum(jnp.sum(voiced), 1)
    lsd_frames = jnp.sqrt(jnp.mean(jnp.square(a_db - b_db), axis=-1))
    lsd_voiced = jnp.sum(
        jnp.where(voiced, lsd_frames, 0.0)
    ) / n_voiced
    sil = ~voiced
    noise = jnp.sum(jnp.where(sil, g_rms, 0.0)) / jnp.maximum(
        jnp.sum(sil), 1
    )
    return {
        "lsd_voiced_db": float(lsd_voiced),
        "silence_noise_floor_db": float(
            20.0 * jnp.log10(jnp.maximum(noise, 1e-8))
        ),
        "voiced_fraction": float(jnp.mean(voiced.astype(jnp.float32))),
    }


def copy_synthesis_report(cfg: Config, wav_ref, wav_gen) -> Dict[str, float]:
    return {
        "mel_l2": mel_l2(cfg, wav_ref, wav_gen),
        "spectral_convergence": spectral_convergence(cfg, wav_ref, wav_gen),
        "log_spectral_distance_db": log_spectral_distance(
            cfg, wav_ref, wav_gen
        ),
        **voiced_metrics(cfg, wav_ref, wav_gen),
    }
