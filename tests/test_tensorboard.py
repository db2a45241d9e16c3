"""Dependency-free TensorBoard writer (utils/tensorboard.py): wire
format + CRC framing roundtrip, and the MetricsLogger integration."""

import glob
import io
import os

import numpy as np
from scipy.io import wavfile

from pwn_vocoder.utils.tensorboard import (
    SummaryWriter,
    crc32c,
    masked_crc32c,
    read_events,
)


def _event_file(d):
    files = glob.glob(os.path.join(d, "events.out.tfevents.*"))
    assert len(files) == 1
    return files[0]


def test_crc32c_known_answer():
    # the Castagnoli check value (RFC 3720 appendix B / iSCSI)
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(b"") == 0
    # masking is invertible-style distinct from the raw CRC
    assert masked_crc32c(b"123456789") != crc32c(b"123456789")


def test_scalar_roundtrip(tmp_path):
    d = str(tmp_path / "tb")
    w = SummaryWriter(d)
    w.add_scalar("loss", 3.5, step=10)
    w.add_scalars(20, nll=1.25, lr=1e-3, skipme=float("nan"))
    w.close()
    evs = read_events(_event_file(d))
    assert evs[0]["file_version"] == "brain.Event:2"
    assert evs[1]["step"] == 10
    assert abs(evs[1]["summary"]["loss"] - 3.5) < 1e-7
    assert evs[2]["step"] == 20
    assert abs(evs[2]["summary"]["nll"] - 1.25) < 1e-7
    assert abs(evs[2]["summary"]["lr"] - 1e-3) < 1e-9
    assert "skipme" not in evs[2]["summary"]  # non-finite dropped


def test_audio_roundtrip(tmp_path):
    d = str(tmp_path / "tb")
    w = SummaryWriter(d)
    t = np.arange(1600) / 16000.0
    wav = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    w.add_audio("sample", wav, 16000, step=5)
    w.close()
    evs = read_events(_event_file(d))
    audio = evs[1]["summary"]["sample"]
    # Audio proto fields: 1 sample_rate, 3 length_frames, 4 wav bytes
    assert audio[1] == 16000.0
    assert audio[3] == 1600
    sr, decoded = wavfile.read(io.BytesIO(audio[4]))
    assert sr == 16000
    np.testing.assert_allclose(
        decoded.astype(np.float32) / 32767.0, wav, atol=1 / 32000
    )


def test_metrics_logger_writes_tb(tmp_path):
    from pwn_vocoder.utils.metrics import MetricsLogger

    d = str(tmp_path)
    log = MetricsLogger(os.path.join(d, "m.jsonl"), echo=False,
                        tb_dir=os.path.join(d, "tb"))
    log.log(0, loss=2.0, note="text")
    log.log(50, loss=1.0)
    log.close()
    evs = read_events(_event_file(os.path.join(d, "tb")))
    scalar_evs = [e for e in evs if "summary" in e]
    assert [e["step"] for e in scalar_evs] == [0, 50]
    assert abs(scalar_evs[0]["summary"]["loss"] - 2.0) < 1e-7
    assert "note" not in scalar_evs[0]["summary"]
    # jsonl sink unaffected
    assert os.path.getsize(os.path.join(d, "m.jsonl")) > 0
