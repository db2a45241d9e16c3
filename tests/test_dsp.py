"""DSP unit tests (SURVEY.md §4 "Unit / DSP" row).

STFT/mel are validated against an INDEPENDENT numpy implementation written
directly from the conventions in SURVEY.md §8 (scipy.fft on hand-framed
signals), plus structural/roundtrip properties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft

from pwn_vocoder.config import DSPConfig
from pwn_vocoder.utils import dsp

CFG = DSPConfig(sample_rate=16000, n_fft=512, hop_length=128, win_length=512,
                n_mels=40)


def _numpy_stft_mag(x, n_fft, hop, win_length):
    """Independent host reference: centered reflect-pad, periodic Hann."""
    pad = n_fft // 2
    xp = np.pad(x, pad, mode="reflect")
    win = 0.5 * (1 - np.cos(2 * np.pi * np.arange(win_length) / win_length))
    wpad = (n_fft - win_length) // 2
    w = np.zeros(n_fft)
    w[wpad : wpad + win_length] = win
    n_frames = 1 + (len(xp) - n_fft) // hop
    out = np.empty((n_frames, n_fft // 2 + 1))
    for f in range(n_frames):
        seg = xp[f * hop : f * hop + n_fft] * w
        out[f] = np.abs(scipy.fft.rfft(seg))
    return out


def test_stft_matches_numpy_reference(rng):
    x = rng.standard_normal(4000).astype(np.float32)
    got = np.asarray(
        dsp.stft_magnitude(jnp.asarray(x), CFG.n_fft, CFG.hop_length,
                           CFG.win_length)
    )
    want = _numpy_stft_mag(x, CFG.n_fft, CFG.hop_length, CFG.win_length)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_stft_batched_matches_single(rng):
    x = rng.standard_normal((3, 2000)).astype(np.float32)
    batched = dsp.stft_magnitude(jnp.asarray(x), CFG.n_fft, CFG.hop_length,
                                 CFG.win_length)
    for i in range(3):
        single = dsp.stft_magnitude(jnp.asarray(x[i]), CFG.n_fft,
                                    CFG.hop_length, CFG.win_length)
        np.testing.assert_allclose(
            np.asarray(batched[i]), np.asarray(single), rtol=1e-5, atol=1e-5
        )


def test_sine_peak_bin():
    """A pure tone's energy concentrates in the right FFT bin."""
    freq = 1000.0
    t = np.arange(CFG.sample_rate) / CFG.sample_rate
    x = np.sin(2 * np.pi * freq * t).astype(np.float32)
    mag = np.asarray(
        dsp.stft_magnitude(jnp.asarray(x), CFG.n_fft, CFG.hop_length,
                           CFG.win_length)
    )
    peak_bin = mag[10].argmax()
    expect = round(freq * CFG.n_fft / CFG.sample_rate)
    assert abs(int(peak_bin) - expect) <= 1


def test_mel_filterbank_structure():
    fb = dsp.mel_filterbank(CFG.sample_rate, CFG.n_fft, CFG.n_mels, 0.0,
                            8000.0)
    assert fb.shape == (CFG.n_mels, CFG.n_fft // 2 + 1)
    assert (fb >= 0).all()
    # every filter has support, center freqs increase
    assert (fb.sum(axis=1) > 0).all()
    centers = fb.argmax(axis=1)
    assert (np.diff(centers) >= 0).all()
    # Slaney mel scale: 1 kHz boundary maps to mel 15
    np.testing.assert_allclose(dsp.hz_to_mel(1000.0), 15.0, atol=1e-9)
    np.testing.assert_allclose(dsp.mel_to_hz(15.0), 1000.0, atol=1e-6)
    # roundtrip
    hz = np.linspace(0, 8000, 50)
    np.testing.assert_allclose(dsp.mel_to_hz(dsp.hz_to_mel(hz)), hz,
                               rtol=1e-10, atol=1e-6)


def test_preemphasis_roundtrip(rng):
    x = rng.standard_normal((2, 500)).astype(np.float32)
    y = dsp.preemphasis(jnp.asarray(x), 0.97)
    back = dsp.deemphasis(y, 0.97)
    np.testing.assert_allclose(np.asarray(back), x, rtol=1e-4, atol=1e-4)


def test_db_normalize_roundtrip():
    cfg = CFG
    db = jnp.linspace(cfg.min_db + cfg.ref_db, cfg.ref_db, 64)
    norm = dsp.normalize_db(db, cfg)
    assert float(norm.min()) >= 0.0 and float(norm.max()) <= 1.0
    back = dsp.denormalize_db(norm, cfg)
    np.testing.assert_allclose(np.asarray(back), np.asarray(db), atol=1e-3)


def test_mel_spectrogram_shape_and_range(rng):
    x = rng.standard_normal((2, 4096)).astype(np.float32) * 0.1
    mel = np.asarray(dsp.mel_spectrogram(jnp.asarray(x), CFG))
    n_frames = 4096 // CFG.hop_length + 1
    assert mel.shape == (2, n_frames, CFG.n_mels)
    assert mel.min() >= 0.0 and mel.max() <= 1.0


def test_griffin_lim_reconstructs_tone():
    """GL from a linear magnitude spec should recover a tone's spectrum."""
    t = np.arange(8000) / CFG.sample_rate
    x = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    mag = dsp.stft_magnitude(jnp.asarray(x), CFG.n_fft, CFG.hop_length,
                             CFG.win_length)
    rec = dsp.griffin_lim(mag, CFG, length=len(x), n_iters=60)
    mag_rec = dsp.stft_magnitude(rec, CFG.n_fft, CFG.hop_length,
                                 CFG.win_length)
    err = float(jnp.linalg.norm(mag_rec - mag) / jnp.linalg.norm(mag))
    assert err < 0.15


@pytest.mark.parametrize("coef", [0.0, 0.97])
def test_wav_to_mel_runs(rng, coef):
    cfg = DSPConfig(sample_rate=16000, n_fft=512, hop_length=128,
                    win_length=512, n_mels=40, preemphasis=coef)
    x = rng.standard_normal(3000).astype(np.float32) * 0.2
    mel = dsp.wav_to_mel(jnp.asarray(x), cfg)
    assert np.isfinite(np.asarray(mel)).all()


def test_mel_spectrogram_np_matches_jnp(rng):
    """The host-numpy mel mirror (used by batch vocoding and serving)
    must match the on-device jnp pipeline."""
    cfg = DSPConfig(sample_rate=16000, n_fft=512, hop_length=128,
                    win_length=400, n_mels=40)
    x = (rng.standard_normal((2, 4000)) * 0.3).astype(np.float32)
    a = np.asarray(dsp.mel_spectrogram(jnp.asarray(x), cfg))
    b = dsp.mel_spectrogram_np(x, cfg)
    assert b.shape == a.shape
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=2e-5)


def test_mel_from_wav_host_matches_device_path(rng):
    from pwn_vocoder.config import get_config
    from pwn_vocoder.generate import mel_from_wav, mel_from_wav_host

    cfg = get_config("tiny_teacher")
    wav = (rng.standard_normal(4000) * 0.3).astype(np.float32)
    a = np.asarray(mel_from_wav(cfg, wav)[0])
    b = mel_from_wav_host(cfg, wav)
    assert b.shape == a.shape
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=2e-5)
