"""C++ native data loader tests: build, decode, determinism, resume,
crop validity, stereo handling (SURVEY.md §2b native-equivalents row)."""

import numpy as np
import pytest
from scipy.io import wavfile

from pwn_vocoder.data.native_loader import (
    NativeWavCropLoader,
    build_native,
    native_available,
)

pytestmark = pytest.mark.skipif(
    not native_available(), reason="g++ toolchain unavailable"
)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    # ramp files so any crop is identifiable as a contiguous slice
    for i in range(4):
        n = 3000 + 500 * i
        ramp = (np.arange(n) % 20000 - 10000).astype(np.int16)
        wavfile.write(str(d / f"mono_{i}.wav"), 16000, ramp)
    # a stereo file (averaged by the loader)
    st = rng.integers(-5000, 5000, size=(2000, 2)).astype(np.int16)
    wavfile.write(str(d / "stereo.wav"), 16000, st)
    # a short file (zero-padded by the loader)
    wavfile.write(str(d / "short.wav"), 16000,
                  np.ones(100, np.int16) * 1000)
    # a junk file that must be skipped, not crash
    (d / "broken.wav").write_bytes(b"RIFFnotawave")
    return str(d)


def test_build_and_decode(corpus):
    build_native()
    loader = NativeWavCropLoader(corpus, crop_samples=512, batch_size=3,
                                 seed=1)
    assert loader.n_clips == 6  # 4 mono + stereo + short; broken skipped
    b = next(loader)
    assert b.shape == (3, 512) and b.dtype == np.float32
    assert np.abs(b).max() <= 1.0
    loader.close()


def test_deterministic_and_resumable(corpus):
    l1 = NativeWavCropLoader(corpus, 256, 2, seed=7)
    stream = [next(l1) for _ in range(6)]
    l1.close()
    l2 = NativeWavCropLoader(corpus, 256, 2, seed=7)
    np.testing.assert_array_equal(next(l2), stream[0])
    l2.close()
    l3 = NativeWavCropLoader(corpus, 256, 2, seed=7, start_step=4)
    np.testing.assert_array_equal(next(l3), stream[4])
    np.testing.assert_array_equal(next(l3), stream[5])
    l3.close()
    l4 = NativeWavCropLoader(corpus, 256, 2, seed=8)
    assert not np.array_equal(next(l4), stream[0])
    l4.close()


def test_crops_are_contiguous_slices(corpus):
    """Every sample crop from a ramp file is an arithmetic sequence, i.e.
    a true contiguous window, no off-by-one in the copy."""
    loader = NativeWavCropLoader(corpus, 400, 8, seed=3)
    found_ramp = False
    for _ in range(5):
        batch = next(loader) * 32768.0
        for row in batch:
            d = np.diff(row)
            if np.all(np.abs(d - 1.0) < 0.5):  # ramp region slice
                found_ramp = True
    loader.close()
    assert found_ramp


def test_short_clip_zero_padded(corpus):
    loader = NativeWavCropLoader(corpus, 1024, 16, seed=5)
    hit = False
    for _ in range(10):
        batch = next(loader)
        for row in batch:
            # the short file: 100 constant samples then zeros
            if np.allclose(row[:100], 1000 / 32768.0) and np.all(
                row[100:] == 0.0
            ):
                hit = True
    loader.close()
    assert hit


def test_undecodable_corpus_raises_not_crashes(tmp_path):
    """Zero decodable clips must raise RuntimeError in Python. Regression:
    the constructor used to spawn the producer thread before the empty
    check, racing fill_batch into `key % 0` (SIGFPE, exit 136)."""
    d = tmp_path / "f32"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):  # float32 wavs: valid RIFF, unsupported format tag
        wavfile.write(str(d / f"f_{i}.wav"), 16000,
                      rng.random(1000).astype(np.float32))
    for _ in range(10):  # old bug was a ~1-in-5 race; hammer it
        with pytest.raises(RuntimeError, match="no decodable"):
            NativeWavCropLoader(str(d), 256, 2, seed=1)


def test_oversize_data_chunk_is_decode_failure(tmp_path):
    """A data-chunk header claiming ~4GB with a tiny file behind it must be
    skipped (not allocated): regression for the bad_alloc->terminate path."""
    import struct

    d = tmp_path / "corrupt"
    d.mkdir()
    fmt = struct.pack("<HHIIHH", 1, 1, 16000, 32000, 2, 16)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt
            + b"data" + struct.pack("<I", 0xFFFFFF00) + b"\x00" * 64)
    (d / "huge_claim.wav").write_bytes(
        b"RIFF" + struct.pack("<I", len(body)) + body)
    wavfile.write(str(d / "good.wav"), 16000,
                  (np.arange(2000) % 1000).astype(np.int16))
    loader = NativeWavCropLoader(str(d), 256, 2, seed=1)
    assert loader.n_clips == 1  # only the good file survives
    assert next(loader).shape == (2, 256)
    loader.close()


def test_host_sharding_partition(corpus):
    l0 = NativeWavCropLoader(corpus, 256, 1, process_index=0,
                             process_count=2)
    l1 = NativeWavCropLoader(corpus, 256, 1, process_index=1,
                             process_count=2)
    assert l0.n_clips + l1.n_clips <= 6  # broken file may land either way
    assert l0.n_clips >= 2 and l1.n_clips >= 2
    l0.close()
    l1.close()


def test_cache_budget_preserves_stream(corpus):
    """A tiny cache budget (forces on-demand decode for most clips) must
    yield byte-identical batches to the fully-resident loader — the
    (seed, step) -> clip mapping is fixed at header-parse time, not by
    what happens to be cached (VERDICT r1 weak item 7)."""
    full = NativeWavCropLoader(corpus, 256, 4, seed=11)
    tiny = NativeWavCropLoader(corpus, 256, 4, seed=11, cache_bytes=1)
    assert tiny.n_clips == full.n_clips
    for _ in range(6):
        np.testing.assert_array_equal(next(tiny), next(full))
    full.close()
    tiny.close()
