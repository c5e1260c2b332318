"""Feature-extraction tests on synthetic signals with known ground truth
(no audio libraries exist in CI, so oracles are physical properties:
tone -> right chroma bin, click train -> right tempo/beats, etc.)."""

import numpy as np
import pytest

SR = 44100


def tone(freq, dur=3.0, sr=SR, amp=0.5, noise=0.001):
    t = np.arange(int(dur * sr)) / sr
    y = amp * np.sin(2 * np.pi * freq * t)
    y += noise * np.random.default_rng(7).standard_normal(len(t))
    return y.astype(np.float32)


def click_track(period_s=0.5, dur=10.0, sr=SR):
    y = 0.005 * np.random.default_rng(0).standard_normal(
        int(dur * sr)).astype(np.float32)
    for t in np.arange(0.1, dur - 0.05, period_s):
        i = int(t * sr)
        n = 256
        y[i:i + n] += (np.hanning(n) * np.sin(
            2 * np.pi * 1500 * np.arange(n) / sr)).astype(np.float32)
    return y


PITCH_CLASS = {"C": 0, "A": 9, "E": 4}


def test_stft_parseval():
    from acoss_jax.features.spectral import stft
    y = np.random.default_rng(1).standard_normal(8192).astype(np.float32)
    S = np.asarray(stft(y, n_fft=1024, hop_length=256, window="ones",
                        center=False))
    frame0 = y[:1024]
    # Parseval for the first frame (rfft doubling except DC/nyquist)
    e_spec = (np.abs(S[0, 0]) ** 2 + np.abs(S[0, -1]) ** 2
              + 2 * np.sum(np.abs(S[0, 1:-1]) ** 2)) / 1024
    np.testing.assert_allclose(e_spec, np.sum(frame0 ** 2), rtol=1e-3)


def test_chroma_stft_tone():
    from acoss_jax.features.chroma import chroma_stft
    C = chroma_stft(tone(440.0))        # A4
    assert C.shape[1] == 12
    assert np.argmax(C.mean(axis=0)) == PITCH_CLASS["A"]


def test_hpcp_tone_and_harmonics():
    from acoss_jax.features.hpcp import hpcp
    H = hpcp(tone(440.0))
    assert H.shape[1] == 12
    assert np.argmax(H.mean(axis=0)) == PITCH_CLASS["A"]
    # chord: A + E (fifth) -> both classes prominent
    H2 = hpcp(tone(440.0) + tone(659.25))
    top2 = set(np.argsort(-H2.mean(axis=0))[:2])
    assert PITCH_CLASS["A"] in top2 and PITCH_CLASS["E"] in top2


def test_cqt_chroma_tone():
    from acoss_jax.features.chroma import chroma_cqt, chroma_cens
    C = chroma_cqt(tone(261.63))        # C4
    assert np.argmax(C.mean(axis=0)) == PITCH_CLASS["C"]
    cens = chroma_cens(tone(261.63))
    assert cens.shape == C.shape
    assert np.argmax(cens.mean(axis=0)) == PITCH_CLASS["C"]


def test_mfcc_htk_shapes_and_stability():
    from acoss_jax.features.mfcc import mfcc_htk, mfcc_librosa
    y = tone(440.0, dur=2.0)
    M = mfcc_htk(y)
    assert M.shape[0] == 13
    ML = mfcc_librosa(y)
    assert ML.shape[0] == 20
    # same-timbre frames are far closer than different-timbre frames
    # (frame-to-frame wiggle is inherent: the HTK lifter amplifies mid
    # cepstral coefficients up to ~12x)
    M2 = mfcc_htk(np.sign(tone(440.0, dur=2.0)).astype(np.float32) * 0.5)
    within = np.linalg.norm(M[1:, 5] - M[1:, 50])
    across = np.linalg.norm(M[1:, 5] - M2[1:, 5])
    assert across > 3 * within


def test_onset_strength_and_beats():
    from acoss_jax.features.onsets import (beat_track_dp,
                                           madmom_features_substitute,
                                           onset_strength)
    y = click_track(period_s=0.5, dur=10.0)     # 120 bpm
    env = onset_strength(y)
    assert env.shape[0] > 100
    tempo, beats = beat_track_dp(env)
    assert 110 < tempo < 130
    assert len(beats) >= 15
    # beat spacing ~ 0.5 s = ~43 hops
    spacing = np.diff(beats)
    assert abs(np.median(spacing) - 0.5 * SR / 512) < 3
    m = madmom_features_substitute(y)
    assert set(m) == {"tempos", "onsets", "novfn", "snovfn"}
    assert m["onsets"].max() < len(m["novfn"])


def test_key_extractor():
    from acoss_jax.features.hpcp import hpcp
    from acoss_jax.features.key import key_extractor
    # C major triad
    y = tone(261.63) + tone(329.63) + tone(392.0)
    res = key_extractor(hpcp(y))
    assert res["key"] == "C"
    assert res["scale"] == "major"
    assert res["strength"] > 0.5


def test_full_pipeline_and_store_roundtrip(tmp_path):
    from acoss_jax.features.pipeline import (batch_extract,
                                             compute_features,
                                             song_dict_for_store)
    y = click_track(0.5, 6.0) + 0.3 * tone(261.63, 6.0)
    feats = compute_features(y)
    assert feats["hpcp"].shape[1] == 12
    assert feats["mfcc_htk"].shape[0] == 13
    assert feats["crema"].shape[1] == 12
    assert "key" in feats["key_extractor"]
    song = song_dict_for_store(feats)
    assert song["onsets"].ndim == 2

    # WAV write + batch_extract round trip
    import wave
    for name in ("a.wav", "b.wav"):
        with wave.open(str(tmp_path / name), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SR)
            w.writeframes((y * 32767).astype("<i2").tobytes())
    fs = batch_extract([str(tmp_path / "a.wav"), str(tmp_path / "b.wav")],
                       labels=["W_1", "W_1"])
    assert fs.n_songs == 2
    assert "hpcp" in fs.features


def test_two_d_fft_mag():
    from acoss_jax.features.pipeline import two_d_fft_mag
    rng = np.random.default_rng(2)
    X = rng.random((12, 40))
    got = two_d_fft_mag(X)
    want = np.fft.fftshift(np.abs(np.fft.fft2(X)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_onset_clicks_and_fingerprint(tmp_path):
    from acoss_jax.features.audio import export_onset_clicks, load_wav
    from acoss_jax.features.fingerprint import chromaprint
    y = click_track(0.5, 4.0)
    out = str(tmp_path / "clicks.wav")
    export_onset_clicks(y, out, np.array([10, 50, 100]))
    y2, sr = load_wav(out)
    assert sr == SR and len(y2) == len(y)
    # blip region was overwritten
    assert not np.allclose(y2[10 * 512:10 * 512 + 100],
                           y[10 * 512:10 * 512 + 100], atol=1e-3)

    fp1 = chromaprint(y + 0.2 * tone(261.63, 4.0))
    fp2 = chromaprint(y + 0.2 * tone(261.63, 4.0))
    fp3 = chromaprint(y + 0.2 * tone(392.0, 4.0))
    assert fp1 == fp2          # deterministic
    assert fp1 != fp3          # different content -> different print
    # the AcoustID container round-trips (test_fingerprint.py pins the
    # bitstream itself)
    from acoss_jax.features.fingerprint import decode_chromaprint
    sub, algo_byte = decode_chromaprint(fp1)
    assert algo_byte == 1 and len(sub) > 5


def test_tempogram_aggregated_batch_matches_per_song(rng):
    """Batched corpus tempogram == per-song path, bitwise."""
    from acoss_jax.features.rhythm import (tempogram_aggregated,
                                           tempogram_aggregated_batch)
    envs, bs = [], []
    for L in (3000, 5000, 3100, 7000):
        envs.append(rng.random(L).astype(np.float32))
        bs.append(np.arange(0, L, 37))
    got = tempogram_aggregated_batch(envs, bs, 96, batch_size=2)
    for e, b, g in zip(envs, bs, got):
        np.testing.assert_array_equal(g, tempogram_aggregated(e, b, 96))


def test_uniform_downsample_batch_matches_per_song(rng):
    """Batched x`fac` downsample == per-song host path (masked-median
    remainder windows exact) to fp32 rounding."""
    from acoss_jax.ops.segment import (uniform_downsample,
                                       uniform_downsample_batch)
    arrs = [rng.normal(size=(L, 12)).astype(np.float32)
            for L in (403, 160, 81, 4097)]
    for agg in ("median", "mean"):
        got = uniform_downsample_batch(arrs, 40, agg, bucket=128,
                                       batch_size=2)
        for a, g in zip(arrs, got):
            ref = uniform_downsample(a, 40, agg)
            assert ref.shape == g.shape
            np.testing.assert_allclose(g, ref, atol=2e-5)


def test_chroma_stft_l2_normalized():
    """Reference passes norm=2 (`features.py:162`): every non-silent
    frame is L2-normalized, not peak-normalized."""
    from acoss_jax.features.chroma import chroma_stft
    C = chroma_stft(tone(440.0))
    norms = np.linalg.norm(C, axis=1)
    live = norms > 0
    assert live.any()
    np.testing.assert_allclose(norms[live], 1.0, atol=1e-4)


def test_dct_htk_scaling():
    """HTK's DCT (book eq. 5.11) scales EVERY row by sqrt(2/N) — no
    orthonormal 1/sqrt(2) on C0 (essentia dctType=3, the reference's
    'MFCC the HTK way')."""
    from acoss_jax.features.spectral import dct_matrix
    N = 26
    H = dct_matrix(13, N, htk=True)
    np.testing.assert_allclose(H[0], np.sqrt(2.0 / N), atol=1e-6)
    O = dct_matrix(13, N, ortho=True)
    np.testing.assert_allclose(H[0], O[0] * np.sqrt(2.0), atol=1e-6)
    np.testing.assert_allclose(H[1:], O[1:], atol=1e-6)


def test_onset_strength_lag_padding():
    """The envelope's front padding is lag + n_fft//(2*hop): with lag=2
    the envelope must stay hop-aligned (same length as lag=1) and the
    extra zero frame appears at the front."""
    from acoss_jax.features.onsets import onset_strength
    y = tone(220.0)
    e1 = onset_strength(y, lag=1)
    e2 = onset_strength(y, lag=2)
    assert e1.shape == e2.shape
    pad1 = 1 + 2048 // (2 * 512)
    assert np.all(e2[:pad1 + 1] == 0.0)   # lag=2 pads one more zero


def test_key_extractor_rejects_empty():
    from acoss_jax.features.key import key_extractor
    with pytest.raises(ValueError):
        key_extractor(np.zeros((0, 12), np.float32))


def test_compute_features_empty_list():
    """An explicitly-empty feature list extracts nothing (must not fall
    back to the full default profile)."""
    from acoss_jax.features.pipeline import compute_features
    out = compute_features(tone(440.0, dur=0.5), features=[])
    assert out == {}


def test_downsample_median_program_has_no_masked_sort():
    """The batched median sorts the HOST-prefilled windows directly
    (no iota-where validity mask fused into the jnp.sort operand), so
    the traced
    program must contain NO select/where at the 4-D window shape
    (B, nseg, fac, d) — that is exactly the shape the old mask
    produced (small-integer index selects inside floor_divide /
    take_along_axis are fine). The +inf prefill itself is pinned by
    the batch-vs-per-song equality test above."""
    import jax

    from acoss_jax.ops.segment import _down_batch

    B, Lp, fac, d = 2, 160, 40, 4
    X = np.full((B, Lp, d), np.inf, np.float32)
    X[:, :81] = 0.0
    lens = np.full(B, 81, np.int32)
    jaxpr = jax.make_jaxpr(_down_batch, static_argnums=(2, 3))(
        X, lens, fac, "median").jaxpr

    def walk(jx):
        for e in jx.eqns:
            yield e
            for v in e.params.values():
                if hasattr(v, "jaxpr"):      # ClosedJaxpr
                    yield from walk(v.jaxpr)
                elif hasattr(v, "eqns"):     # Jaxpr
                    yield from walk(v)

    eqns = list(walk(jaxpr))
    assert any(e.primitive.name == "sort" for e in eqns)
    window_shape = (B, Lp // fac, fac, d)
    bad = [e for e in eqns if e.primitive.name == "select_n"
           and any(getattr(v.aval, "shape", None) == window_shape
                   for v in e.outvars)]
    assert not bad, bad
