"""NSG constant-Q transform (the reference's essentia NSGConstantQ slot,
`/root/reference/preprocess/features.py:388-396`)."""

import numpy as np
import pytest

from acoss_jax.features.nsgcq import (cqt_nsg, nsgcq_windows, nsgcqgram,
                                      _nsg_block)

SR = 44100


def test_windows_cover_spectrum_and_are_constant_q():
    G, M, freqs = nsgcq_windows(4096, SR)
    K = len(freqs)
    assert G.shape == (K + 2, 4096)
    assert freqs[0] == pytest.approx(65.41)
    assert freqs[-1] <= 6000.0
    # no spectral hole: every positive-frequency bin is covered by some
    # band (frame covers [0, sr/2])
    cover = G.sum(axis=0)[:4096 // 2 + 1]
    assert (cover > 1e-6).all()
    # constant-Q: bin bandwidth proportional to frequency — on bins whose
    # ideal width exceeds the min_window clamp (below ~1.5 kHz at
    # frameSize 4096 / 48 bpo the 4-bin minimum dominates, exactly as in
    # essentia's minimumWindow)
    widths = (G[1:-1] > 0).sum(axis=1).astype(float)
    ideal = freqs * (2 ** (1 / 96) - 2 ** (-1 / 96)) * 2 * 4096 / SR
    free = (ideal > 8) & (np.arange(len(freqs)) < len(freqs) - 2)
    assert free.sum() > 20
    q = widths[free] / (freqs[free] * 4096 / SR)
    assert q.std() / q.mean() < 0.1
    # and the clamp floor holds everywhere
    assert (widths >= 3).all()
    # per-band rasterization lengths are pow2 and critically sampled
    assert all((m & (m - 1)) == 0 for m in M)
    assert (M[1:-1] >= widths - 2).all()


def test_fold_decimation_exact():
    # the reshape-fold ifft must equal brute-force full ifft + stride
    rng = np.random.default_rng(0)
    n, stride = 256, 8
    frames = rng.normal(size=(3, n)).astype(np.float32)
    G, _, _ = nsgcq_windows(n, SR, fmin=400.0, fmax=8000.0,
                            bins_per_octave=6)
    got = np.asarray(_nsg_block(frames, G[1:-1], stride))
    X = np.fft.fft(frames, axis=-1)
    Y = G[None, 1:-1, :] * X[:, None, :]
    want = np.fft.ifft(Y, axis=-1)[..., ::stride]
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_tone_lights_matching_bin():
    t = np.arange(int(SR * 1.0)) / SR
    y = np.sin(2 * np.pi * 440.0 * t).astype(np.float32)
    cq, dc, nb = nsgcqgram(y, SR)
    _, _, freqs = nsgcq_windows(4096, SR)
    mag = np.abs(cq).mean(axis=(0, 2))            # (K,)
    k_hit = int(np.argmax(mag))
    k_want = int(np.round(48 * np.log2(440.0 / 65.41)))
    assert abs(k_hit - k_want) <= 1
    # energy concentrates: the winning bin dominates bins an octave away
    assert mag[k_hit] > 10 * mag[max(k_hit - 48, 0)]
    assert dc.shape[0] == cq.shape[0] and nb.shape[0] == cq.shape[0]
    assert np.isfinite(mag).all()


def test_cqt_nsg_flat_view():
    t = np.arange(int(SR * 0.5)) / SR
    y = np.sin(2 * np.pi * 220.0 * t).astype(np.float32)
    out = cqt_nsg(y, SR)
    cq, _, _ = nsgcqgram(y, SR)
    assert out.shape == (cq.shape[0] * cq.shape[2], cq.shape[1])
    assert out.dtype == np.float32
    np.testing.assert_allclose(out[:cq.shape[2]], np.abs(cq[0]).T,
                               rtol=1e-6)


def test_pipeline_slot():
    from acoss_jax.features.pipeline import compute_features
    t = np.arange(int(SR * 0.5)) / SR
    y = np.sin(2 * np.pi * 330.0 * t).astype(np.float32)
    feats = compute_features(y, features=["cqt_nsg"])
    assert set(feats) == {"cqt_nsg"}
    assert feats["cqt_nsg"].ndim == 2
