"""Chroma features: STFT chroma, constant-Q chroma, CENS, processed chroma.

Replaces the reference's librosa chroma family
(`/root/reference/preprocess/features.py:155-207`): `chroma_stft`,
`chroma_cqt`, `chroma_cens`, and `chroma_cqt_processed` (harmonic
enhancement + nearest-neighbor filtering + median smoothing). All return
(n_frames, 12) like the reference (which transposes librosa's output).

The CQT is the Brown-Puckette frequency-domain kernel method: one constant
filterbank matmul against rFFT frames instead of librosa's recursive
multirate implementation — magnitudes agree to within the kernel-truncation
tolerance.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from acoss_jax.features.spectral import (bucket_pad_signal, frame_signal,
                                         n_frames_centered, stft)


def chroma_filterbank(sr: int, n_fft: int, n_chroma: int = 12,
                      tuning: float = 0.0) -> np.ndarray:
    """(n_chroma, n_fft//2+1) wrapped-Gaussian chroma filters
    (librosa.filters.chroma semantics with default octwidth=2,
    base_c=True)."""
    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)[1:]
    frqbins = n_chroma * np.log2(freqs / (440.0 / 16))  # ref A0-ish
    frqbins = np.concatenate(([frqbins[0] - 1.5 * n_chroma], frqbins))
    binwidthbins = np.concatenate(
        (np.maximum(frqbins[1:] - frqbins[:-1], 1.0), [1.0]))
    D = np.subtract.outer(frqbins, np.arange(0, n_chroma, dtype="d")).T
    n_chroma2 = np.round(float(n_chroma) / 2)
    D = np.remainder(D + n_chroma2 + 10 * n_chroma, n_chroma) - n_chroma2
    wts = np.exp(-0.5 * (2 * D / np.tile(binwidthbins, (n_chroma, 1))) ** 2)
    wts /= np.maximum(np.sqrt(np.sum(wts ** 2, axis=0)), 1e-12)
    octwidth = 2
    ctroct = 5.0
    wts *= np.tile(
        np.exp(-0.5 * (((frqbins / n_chroma - ctroct) / octwidth) ** 2)),
        (n_chroma, 1))
    # rotate so bin 0 = C
    wts = np.roll(wts, -3 * (n_chroma // 12), axis=0)
    return wts.astype(np.float32)


@functools.partial(jax.jit, static_argnames=("sr", "n_fft", "hop_length"))
def _chroma_stft_jax(y, sr, n_fft, hop_length):
    S = jnp.abs(stft(y, n_fft=n_fft, hop_length=hop_length)) ** 2
    fb = jnp.asarray(chroma_filterbank(sr, n_fft))
    raw = jnp.matmul(S, fb.T, precision="highest")   # (n_frames, 12)
    # the reference passes norm=2 (`features.py:162`): each frame
    # L2-normalized, not peak-normalized
    nrm = jnp.sqrt(jnp.sum(raw * raw, axis=-1, keepdims=True))
    return raw / jnp.where(nrm == 0, 1.0, nrm)


def chroma_stft(y: np.ndarray, sr: int = 44100, n_fft: int = 4096,
                hop_length: int = 512) -> np.ndarray:
    """(n_frames, 12) — parity: `features.py:155-167` (norm=2,
    frameSize=4096, tuning=0)."""
    yp, L = bucket_pad_signal(y)
    out = np.asarray(_chroma_stft_jax(jnp.asarray(yp), sr, n_fft,
                                      hop_length))
    return out[:n_frames_centered(L, hop_length)]


# ------------------------------------------------------------- CQT -------


def cqt_kernels(sr: int, fmin: float, n_bins: int, bins_per_octave: int,
                n_fft: int, q_scale: float = 1.0):
    """Frequency-domain CQT kernels (n_bins, n_fft//2+1) complex64."""
    Q = q_scale / (2 ** (1.0 / bins_per_octave) - 1)
    K = np.zeros((n_bins, n_fft // 2 + 1), dtype=np.complex128)
    for k in range(n_bins):
        f = fmin * 2 ** (k / bins_per_octave)
        length = int(min(np.ceil(Q * sr / f), n_fft))
        n = np.arange(length) - length // 2
        win = np.hanning(length)
        kern = win * np.exp(2j * np.pi * f * n / sr) / length
        buf = np.zeros(n_fft, dtype=np.complex128)
        start = (n_fft - length) // 2
        buf[start:start + length] = kern
        spec = np.fft.fft(buf)[:n_fft // 2 + 1] / n_fft
        # sparsify tiny coefficients (Brown-Puckette)
        mag = np.abs(spec)
        spec[mag < 0.005 * mag.max()] = 0
        K[k] = np.conj(spec)
    return K.astype(np.complex64)


@functools.partial(jax.jit, static_argnames=(
    "sr", "hop_length", "fmin", "n_bins", "bins_per_octave", "n_fft"))
def _cqt_jax(y, sr, hop_length, fmin, n_bins, bins_per_octave, n_fft):
    frames = frame_signal(y, n_fft, hop_length, center=True)
    F = jnp.fft.fft(frames, axis=-1)[:, :n_fft // 2 + 1]
    K = jnp.asarray(cqt_kernels(sr, fmin, n_bins, bins_per_octave, n_fft))
    C = jnp.matmul(F, K.T, precision="highest")   # (n_frames, n_bins)
    return jnp.abs(C) * n_fft


def cqt(y: np.ndarray, sr: int = 44100, hop_length: int = 512,
        fmin: float = 32.7031956626, n_bins: int = 84,
        bins_per_octave: int = 12, n_fft: int = 32768) -> np.ndarray:
    """Constant-Q magnitudes, (n_frames, n_bins).

    Parity: `features.py:398-416` (librosa.cqt defaults: C1, 7 octaves).
    """
    yp, L = bucket_pad_signal(y)
    out = np.asarray(_cqt_jax(jnp.asarray(yp), sr, hop_length, fmin,
                              n_bins, bins_per_octave, n_fft))
    return out[:n_frames_centered(L, hop_length)]


def chroma_cqt(y: np.ndarray, sr: int = 44100, hop_length: int = 512,
               n_chroma: int = 12, n_octaves: int = 7,
               fmin: float = 32.7031956626) -> np.ndarray:
    """(n_frames, 12) CQT chroma — parity: `features.py:169-178`."""
    C = cqt(y, sr, hop_length, fmin, n_octaves * 12, 12)
    folded = C.reshape(C.shape[0], n_octaves, 12).sum(axis=1)
    peak = folded.max(axis=-1, keepdims=True)
    return folded / np.where(peak == 0, 1.0, peak)


def cens_from_chroma(chroma: np.ndarray, win_len_smooth: int = 41
                     ) -> np.ndarray:
    """CENS post-processing of a chroma sequence (librosa semantics):
    L1 normalize, amplitude quantization, Hann smoothing, L2 normalize."""
    c = np.asarray(chroma, dtype=np.float64)
    l1 = np.sum(np.abs(c), axis=1, keepdims=True)
    c = c / np.where(l1 == 0, 1.0, l1)
    q = np.zeros_like(c)
    for thresh, value in zip([0.4, 0.2, 0.1, 0.05], [1.0, 0.75, 0.5, 0.25]):
        q = np.where((q == 0) & (c > thresh), value, q)
    win = np.hanning(win_len_smooth + 2)[1:-1]
    win /= win.sum()
    sm = np.apply_along_axis(
        lambda x: np.convolve(x, win, mode="same"), 0, q)
    l2 = np.sqrt(np.sum(sm ** 2, axis=1, keepdims=True))
    return (sm / np.where(l2 == 0, 1.0, l2)).astype(np.float32)


def chroma_cens(y: np.ndarray, sr: int = 44100,
                hop_length: int = 512) -> np.ndarray:
    """(n_frames, 12) — parity: `features.py:180-190`."""
    return cens_from_chroma(chroma_cqt(y, sr, hop_length))


def nn_filter(X: np.ndarray, k: int = 10) -> np.ndarray:
    """Nearest-neighbor smoothing (librosa.decompose.nn_filter with cosine
    affinity): replace each frame by the MEDIAN of its k most similar
    frames — the reference passes aggregate=np.median
    (`features.py:202`), the outlier-rejecting point of the denoising
    step (used by `chroma_cqt_processed`, `features.py:192-207`)."""
    Xn = X / np.maximum(
        np.linalg.norm(X, axis=1, keepdims=True), 1e-12)
    sim = Xn @ Xn.T
    np.fill_diagonal(sim, -np.inf)
    idx = np.argsort(-sim, axis=1)[:, :k]
    return np.median(X[idx], axis=1)


def chroma_cqt_processed(y: np.ndarray, sr: int = 44100,
                         hop_length: int = 512) -> np.ndarray:
    """Harmonic-enhanced, NN-filtered, median-smoothed CQT chroma
    (`features.py:192-207`; librosa's harmonic separation is approximated
    by time-median filtering of the CQT before folding)."""
    import scipy.ndimage
    C = cqt(y, sr, hop_length)
    # crude harmonic enhancement: median filter along time
    Ch = scipy.ndimage.median_filter(C, size=(9, 1))
    folded = Ch.reshape(Ch.shape[0], -1, 12).sum(axis=1)
    peak = folded.max(axis=-1, keepdims=True)
    folded = folded / np.where(peak == 0, 1.0, peak)
    sm = np.minimum(folded, nn_filter(folded))
    return scipy.ndimage.median_filter(sm, size=(9, 1)).astype(np.float32)
