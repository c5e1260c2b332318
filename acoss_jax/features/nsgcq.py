"""Non-stationary Gabor constant-Q transform (NSG-CQT).

Parity target: `AudioFeatures.cqt_nsg`
(`/root/reference/preprocess/features.py:388-396`), which calls
essentia's NSGConstantQ via `essentia.pytools.spectral.nsgcqgram`
(Velasco/Holighaus et al., the invertible CQT): the signal is sliced
into frames and each frame is analyzed with a non-stationary Gabor
frame — one Hann window PER FREQUENCY BIN in the spectral domain, whose
bandwidth grows proportionally with the bin's center frequency
(constant Q), each bin inverse-transformed at its own critically-sampled
rate.

Design: instead of essentia's per-bin C++ loop, the windows
are assembled once into a dense (K, n) filterbank; a frame batch is then
ONE fft, one broadcast multiply, an exact spectral fold (reshape + sum —
the alias identity ifft_n(Y)[::s] == (M/n) * ifft_M(fold_M(Y))) and one
batched ifft of length M. Everything is static-shape and jit-compiled;
frames stream through in fixed-size chunks so the (chunk, K, n)
intermediate stays bounded.

Documented substitutions vs essentia (the library is not in this image,
so coefficient-exact parity is not claimable): frames are half-overlapped
(hop = frame_size // 2) Tukey-less raw slices, `rasterize='full'` is the
only supported layout (every CQT bin decimated to the same pow2 length),
phase convention is 'global' (windows stay at their absolute spectral
positions), normalization 'none'.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _next_pow2(x: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(x, 1)))), 0)


def nsgcq_windows(frame_size: int, sr: int, fmin: float = 65.41,
                  fmax: float = 6000.0, bins_per_octave: int = 48,
                  min_window: int = 4):
    """Build the NSG analysis filterbank for one frame.

    Returns (G, M, freqs):
    - G: (K + 2, frame_size) float32 — row 0 is the DC band, rows
      1..K the constant-Q bins at f_k = fmin * 2^(k/B), row K+1 the
      Nyquist band; each row a Hann window in the spectral domain whose
      support spans its geometric neighbors (essentia's 'hannnsgcq').
      Positive-frequency windows only (real input, analytic output).
    - M: (K + 2,) int — per-band critically-sampled pow2 output length
      (`rasterize='full'` uses max(M[1:K+1]) for the CQT block).
    - freqs: (K,) the CQT bin center frequencies.
    """
    n = frame_size
    B = bins_per_octave
    fmax = min(fmax, sr / 2)
    K = int(np.floor(B * np.log2(fmax / fmin))) + 1
    freqs = fmin * 2.0 ** (np.arange(K) / B)
    # geometric neighbors, extrapolated at the edges; the DC and Nyquist
    # bands plug the spectral gaps so the frame covers [0, sr/2]
    if n & (n - 1):
        raise ValueError(f"frame_size must be a power of two, got {n}")
    posit = freqs * n / sr                       # fractional bin centers
    centers = np.concatenate(([0.0], posit, [n / 2.0]))
    # Hann support of band j spans its neighbors centers[j-1:j+2]; the
    # DC and Nyquist edge bands get symmetric support around their
    # center (mirroring to negative frequencies / past n/2)
    widths = np.empty(K + 2)
    widths[1:-1] = centers[2:] - centers[:-2]
    widths[0] = 2.0 * centers[1]
    widths[-1] = 2.0 * (n / 2.0 - centers[-2])
    widths = np.maximum(widths, float(min_window))

    G = np.zeros((K + 2, n), dtype=np.float32)
    M = np.zeros(K + 2, dtype=np.int64)
    for j in range(K + 2):
        c, w = centers[j], widths[j]
        start = int(np.ceil(c - w / 2.0))
        stop = int(np.floor(c + w / 2.0))
        idx = np.arange(start, stop + 1)
        win = 0.5 + 0.5 * np.cos(2.0 * np.pi * (idx - c) / w)
        keep = win > 0
        G[j, np.mod(idx[keep], n)] = win[keep]
        M[j] = _next_pow2(int(np.ceil(w)))
    M = np.minimum(M, n)
    return G, M, freqs


@functools.partial(jax.jit, static_argnames=("stride",))
def _nsg_block(frames, G, stride: int):
    """frames (F, n) real, G (Kb, n) -> (F, Kb, n // stride) complex.

    ifft of the windowed spectrum, decimated by the exact fold identity:
    subsampling ifft_n by `stride` equals (M/n) * ifft_M of the spectrum
    alias-folded mod M. The fold happens BEFORE the ifft, so the big
    (F, Kb, n) product never feeds an n-point transform.
    """
    n = frames.shape[-1]
    M = n // stride
    X = jnp.fft.fft(frames, axis=-1)                     # (F, n) complex
    Y = G[None, :, :] * X[:, None, :]                    # (F, Kb, n)
    Yf = Y.reshape(Y.shape[0], Y.shape[1], stride, M).sum(axis=2)
    return jnp.fft.ifft(Yf, axis=-1) * (M / n)


def nsgcqgram(y: np.ndarray, sr: int = 44100, frame_size: int = 4096,
              fmin: float = 65.41, fmax: float = 6000.0,
              bins_per_octave: int = 48, chunk_frames: int = 16):
    """Framewise NSG constant-Q gram — the `epy.nsgcqgram` analog
    (`features.py:395`).

    Returns (cq, dc, nb):
    - cq: (n_frames, K, M) complex64 — constant-Q coefficients,
      rasterized to the common pow2 length M of the widest CQT bin;
    - dc: (n_frames, Mdc) complex64 — the DC band;
    - nb: (n_frames, Mnb) complex64 — the Nyquist band.
    Frames are half-overlapped slices (hop = frame_size // 2), tail
    zero-padded.
    """
    y = np.asarray(y, dtype=np.float32).ravel()
    n = int(frame_size)
    hop = n // 2
    n_frames = max(1, int(np.ceil(max(len(y) - n, 0) / hop)) + 1)
    buf = np.zeros(((n_frames - 1) * hop + n,), dtype=np.float32)
    buf[:len(y)] = y
    frames = np.stack([buf[i * hop:i * hop + n] for i in range(n_frames)])

    G, M, _ = nsgcq_windows(n, sr, fmin, fmax, bins_per_octave)
    Mcq = int(M[1:-1].max())
    s_cq, s_dc, s_nb = n // Mcq, n // int(M[0]), n // int(M[-1])
    Gj = jnp.asarray(G)

    cq, dc, nb = [], [], []
    for at in range(0, n_frames, chunk_frames):
        f = jnp.asarray(frames[at:at + chunk_frames])
        cq.append(np.asarray(_nsg_block(f, Gj[1:-1], s_cq)))
        dc.append(np.asarray(_nsg_block(f, Gj[:1], s_dc))[:, 0])
        nb.append(np.asarray(_nsg_block(f, Gj[-1:], s_nb))[:, 0])
    return (np.concatenate(cq).astype(np.complex64),
            np.concatenate(dc).astype(np.complex64),
            np.concatenate(nb).astype(np.complex64))


def cqt_nsg(y: np.ndarray, sr: int = 44100, frame_size: int = 4096,
            fmin: float = 65.41, fmax: float = 6000.0,
            bins_per_octave: int = 48) -> np.ndarray:
    """Magnitude NSG-CQT, flattened frames-first (T, K) float32 — the
    FeatureSet-storable view of `cqt_nsg` (`features.py:388-396`): the
    per-frame (K, M) rasterized blocks are unrolled along time."""
    cq, _, _ = nsgcqgram(y, sr, frame_size, fmin, fmax, bins_per_octave)
    mag = np.abs(cq)                          # (n_frames, K, M)
    return mag.transpose(0, 2, 1).reshape(-1, mag.shape[1]) \
        .astype(np.float32)
