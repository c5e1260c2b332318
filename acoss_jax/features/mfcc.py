"""MFCCs: HTK-style (essentia parity) and librosa-style.

Parity targets:
- `mfcc_htk` (`/root/reference/preprocess/features.py:418-470`): Hamming
  window of 22050 samples zero-padded to the next pow2 FFT, htkMel warping,
  26 triangular bands with unit-max normalization built in the Hz domain,
  log magnitudes, DCT, HTK sinusoidal liftering (CEPLIFTER=22), frames NOT
  centered (startFromZero). Returns (n_mfcc, n_frames) like the reference.
- `mfcc_librosa` (`features.py:472-503`): slaney mel on amplitude-to-db,
  ortho DCT, power liftering n^0.6.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from acoss_jax.features.spectral import (bucket_pad_signal, dct_matrix,
                                         frame_signal, mel_filterbank,
                                         n_frames_centered,
                                         n_frames_uncentered)


def _hamming(n: int) -> np.ndarray:
    return 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(n) / (n - 1))


@functools.partial(jax.jit, static_argnames=(
    "sr", "window_length", "hop_length", "n_mfcc", "n_mels", "fmax",
    "lifterexp"))
def _mfcc_htk_jax(y, sr, window_length, hop_length, n_mfcc, n_mels, fmax,
                  lifterexp):
    fftlen = int(2 ** np.ceil(np.log2(window_length)))
    frames = frame_signal(y, window_length, hop_length, center=False)
    w = jnp.asarray(_hamming(window_length).astype(np.float32))
    spec = jnp.abs(jnp.fft.rfft(frames * w[None, :], n=fftlen, axis=-1))
    fb = jnp.asarray(mel_filterbank(sr, fftlen, n_mels, 0.0, fmax,
                                    htk=True, norm=None))
    mel = jnp.matmul(spec, fb.T, precision="highest")
    logmel = jnp.log(jnp.maximum(mel, 1e-8))  # silence floor (HTK-style)
    # HTK DCT scaling: uniform sqrt(2/N) incl. C0 (HTK book eq. 5.11 /
    # essentia dctType=3) — NOT the orthonormal row-0 correction
    D = jnp.asarray(dct_matrix(n_mfcc, n_mels, htk=True))
    cc = jnp.matmul(logmel, D.T, precision="highest")
    # HTK sinusoidal liftering: c_n *= 1 + (L/2) sin(pi n / L)
    n = jnp.arange(n_mfcc)
    lift = 1.0 + (lifterexp / 2.0) * jnp.sin(jnp.pi * n / lifterexp)
    return (cc * lift[None, :]).T                    # (n_mfcc, n_frames)


def mfcc_htk(y: np.ndarray, sr: int = 44100, window_length: int = 22050,
             hop_length: int = 512, n_mfcc: int = 13, n_mels: int = 26,
             fmax: int = 8000, lifterexp: int = 22) -> np.ndarray:
    """(n_mfcc, n_frames) HTK-style MFCCs."""
    yp, L = bucket_pad_signal(y)
    out = np.asarray(_mfcc_htk_jax(jnp.asarray(yp), sr, window_length,
                                   hop_length, n_mfcc, n_mels, fmax,
                                   lifterexp))
    return out[:, :n_frames_uncentered(L, window_length, hop_length)]


@functools.partial(jax.jit, static_argnames=(
    "sr", "window_length", "hop_length", "n_mfcc", "n_mels", "fmax",
    "lifterexp"))
def _mfcc_librosa_jax(y, sr, window_length, hop_length, n_mfcc, n_mels,
                      fmax, lifterexp):
    from acoss_jax.features.spectral import stft
    S = jnp.abs(stft(y, n_fft=window_length, hop_length=hop_length))
    fb = jnp.asarray(mel_filterbank(sr, window_length, n_mels, 0.0, fmax,
                                    htk=False, norm="slaney"))
    X = jnp.matmul(fb, S.T, precision="highest")     # (n_mels, n_frames)
    # librosa.amplitude_to_db DEFAULTS (`features.py:493` passes none):
    # ref=1.0 (NOT np.max), amin=1e-5, floored at max - top_db(80)
    amin = 1e-5
    db = 20.0 * jnp.log10(jnp.maximum(X, amin))
    db = jnp.maximum(db, jnp.max(db) - 80.0)
    D = jnp.asarray(dct_matrix(n_mfcc, n_mels, ortho=True))
    cc = jnp.matmul(D, db, precision="highest")
    coeffs = jnp.asarray(
        np.concatenate([[1.0], np.arange(1, n_mfcc) ** lifterexp])
        .astype(np.float32))
    return coeffs[:, None] * cc


def mfcc_librosa(y: np.ndarray, sr: int = 44100,
                 window_length: int = 22050, hop_length: int = 512,
                 n_mfcc: int = 20, n_mels: int = 40, fmax: int = 8000,
                 lifterexp: float = 0.6) -> np.ndarray:
    """(n_mfcc, n_frames) librosa-style MFCCs with power liftering."""
    yp, L = bucket_pad_signal(y)
    out = np.asarray(_mfcc_librosa_jax(jnp.asarray(yp), sr, window_length,
                                       hop_length, n_mfcc, n_mels, fmax,
                                       lifterexp))
    return out[:, :n_frames_centered(L, hop_length)]
