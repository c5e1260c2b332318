"""Chromaprint slot: analysis pipeline + the AcoustID container format.

The subfingerprint BITS are re-derived (the trained classifier constants
aren't reproducible here — PARITY.md), so these tests pin what IS exact:
the container bitstream layout, and the published pipeline's structure.
Reference: `/root/reference/preprocess/features.py:531-545`.
"""

import numpy as np
import pytest

from acoss_jax.features.fingerprint import (
    _CLASSIFIERS, _filter_and_normalize, chromaprint,
    compress_fingerprint, decode_chromaprint, decompress_fingerprint,
    fingerprint_from_chroma)


def test_compress_known_bytes_single_bit():
    # subfp 0x1 -> set-bit gap 1, terminator 0 -> normal bits 1,0
    assert compress_fingerprint(np.array([1], dtype=np.uint32)) == \
        b"\x01\x00\x00\x01\x01"


def test_compress_known_bytes_exception_path():
    # subfp 0x80000000 -> gap 32 -> normal 7 + exceptional 25, term 0:
    # normal stream bits 111 000, exception stream 11001 -> 0x47 0x06
    got = compress_fingerprint(np.array([0x80000000], dtype=np.uint32))
    assert got == b"\x01\x00\x00\x01\x47\x06"


def test_compress_header_algorithm_and_length():
    fps = np.arange(300, dtype=np.uint32)
    data = compress_fingerprint(fps, algorithm=2)
    assert data[0] == 2
    assert (data[1] << 16) | (data[2] << 8) | data[3] == 300


def test_roundtrip_random_including_exceptions():
    rng = np.random.default_rng(7)
    # full-range values exercise gaps >= 7 (5-bit exception codes) and
    # the XOR-delta chaining
    fps = rng.integers(0, 2**32, size=500, dtype=np.uint64).astype(
        np.uint32)
    back, algo = decompress_fingerprint(compress_fingerprint(fps))
    assert algo == 1
    np.testing.assert_array_equal(back, fps)


def test_roundtrip_empty_and_zero():
    for fps in (np.zeros(0, np.uint32), np.zeros(5, np.uint32)):
        back, _ = decompress_fingerprint(compress_fingerprint(fps))
        np.testing.assert_array_equal(back, fps)


def test_decompress_rejects_truncated():
    data = compress_fingerprint(np.array([2**31 - 1, 12345], np.uint32))
    with pytest.raises(ValueError):
        decompress_fingerprint(data[:-1])
    with pytest.raises(ValueError):
        decompress_fingerprint(b"\x01\x00")


def test_string_roundtrip_urlsafe_no_padding():
    y = np.sin(2 * np.pi * 220.0 *
               np.arange(44100 * 4) / 44100).astype(np.float32)
    fp = chromaprint(y)
    assert "=" not in fp and "+" not in fp and "/" not in fp
    sub, algo = decode_chromaprint(fp)
    assert algo == 1
    assert len(sub) > 10
    # deterministic
    assert chromaprint(y) == fp


def test_subfingerprints_use_all_classifiers():
    rng = np.random.default_rng(3)
    chroma = _filter_and_normalize(rng.random((200, 12)) ** 4)
    h = fingerprint_from_chroma(chroma)
    assert h.dtype == np.uint32 and len(h) == chroma.shape[0] - 15
    # every classifier's 2-bit field varies over a random input
    for k in range(len(_CLASSIFIERS)):
        field = (h >> np.uint32(2 * (15 - k))) & np.uint32(3)
        assert len(np.unique(field)) > 1, f"classifier {k} is constant"


def test_pipeline_discriminates_and_tracks_transposition():
    sr, t = 44100, np.arange(44100 * 5) / 44100

    def tone(f):
        return np.sin(2 * np.pi * f * t).astype(np.float32)

    a = decode_chromaprint(chromaprint(tone(261.63), sr))[0]
    a2 = decode_chromaprint(chromaprint(tone(261.63), sr))[0]
    b = decode_chromaprint(chromaprint(tone(392.0), sr))[0]
    np.testing.assert_array_equal(a, a2)
    n = min(len(a), len(b))
    bit_err = np.unpackbits(
        (a[:n] ^ b[:n]).view(np.uint8)).mean()
    assert bit_err > 0.05   # different pitch classes -> different bits


def test_silence_gate_zeroes_frames():
    quiet = _filter_and_normalize(np.full((50, 12), 1e-6))
    np.testing.assert_array_equal(quiet, 0.0)
