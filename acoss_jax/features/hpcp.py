"""Harmonic Pitch Class Profiles (Gomez 2006).

Replaces the essentia HPCP pipeline of the reference
(`/root/reference/preprocess/features.py:209-275`): per frame, spectral
peaks (interpolated local maxima, 100-3500 Hz, top `max_peaks`), spectral
whitening, and harmonic weighting of each peak into `n_bins` pitch classes
with a cos^2 window.

Everything is vectorized over frames: local-max masking + top_k replace
essentia's per-frame C++ peak loop; the whitening is a smoothed-envelope
normalization (essentia's band-preset whitening differs in detail — parity
target is retrieval MAP, not bitwise frames).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from acoss_jax.features.spectral import (bucket_pad_signal,
                                         n_frames_uncentered, stft)


@functools.partial(jax.jit, static_argnames=(
    "sr", "frame_size", "hop_length", "max_peaks", "n_bins", "harmonics",
    "window_size", "whitening"))
def _hpcp_jax(y, sr, frame_size, hop_length, min_freq, max_freq,
              ref_freq, max_peaks, n_bins, harmonics, window_size,
              whitening):
    S = jnp.abs(stft(y, n_fft=frame_size, hop_length=hop_length,
                     window="blackmanharris62", center=False))
    n_frames, F = S.shape
    freqs = jnp.asarray(
        np.linspace(0, sr / 2, frame_size // 2 + 1).astype(np.float32))

    # --- spectral peaks: interior local maxima in [min_freq, max_freq]
    left = jnp.pad(S[:, :-1], ((0, 0), (1, 0)))
    right = jnp.pad(S[:, 1:], ((0, 0), (0, 1)))
    is_peak = (S > left) & (S >= right) & \
        (freqs >= min_freq)[None, :] & (freqs <= max_freq)[None, :]
    # parabolic interpolation around each bin
    denom = left - 2 * S + right
    delta = jnp.where(jnp.abs(denom) > 1e-12,
                      0.5 * (left - right) / denom, 0.0)
    delta = jnp.clip(delta, -0.5, 0.5)
    pk_freq = (jnp.arange(F)[None, :] + delta) * (sr / frame_size)
    pk_mag = S - 0.25 * (left - right) * delta

    if whitening:
        # Spectral-envelope compensation: divide peak magnitudes by a
        # gaussian-smoothed spectrum (width ~ 1/3 octave at 1 kHz) with a
        # relative floor so the noise floor is not boosted. (Essentia's
        # band-preset whitening differs in detail; MAP-level substitution.)
        sigma = max(frame_size / sr * 90.0, 3.0)    # bins
        radius = int(3 * sigma)
        kern = np.exp(-0.5 * (np.arange(-radius, radius + 1) / sigma) ** 2)
        kern = (kern / kern.sum()).astype(np.float32)
        Sp = jnp.pad(S, ((0, 0), (radius, radius)), mode="edge")
        env = jax.lax.conv_general_dilated(
            Sp[:, None, :], jnp.asarray(kern)[None, None, :],
            window_strides=(1,), padding="VALID",
            dimension_numbers=("NCH", "OIH", "NCH"))[:, 0, :]
        floor = 1e-3 * jnp.max(S, axis=1, keepdims=True)
        pk_mag = pk_mag / jnp.maximum(env, floor + 1e-12)

    masked = jnp.where(is_peak, pk_mag, -jnp.inf)
    top_mag, top_idx = jax.lax.top_k(masked, max_peaks)   # (n_frames, P)
    top_freq = jnp.take_along_axis(pk_freq, top_idx, axis=1)
    valid = jnp.isfinite(top_mag) & (top_mag > 0)
    top_mag = jnp.where(valid, top_mag, 0.0)
    top_freq = jnp.where(valid, top_freq, ref_freq)

    # --- harmonic weighting into pitch-class bins
    hs = np.arange(1, harmonics + 1)
    hweights = jnp.asarray((0.6 ** (hs - 1)).astype(np.float32))
    # pitch class (in bins) of each peak's h-th subharmonic. Essentia
    # indexes bin 0 at the reference frequency (A440); we rotate so bin 0
    # is C, consistent with the chroma family (downstream use is
    # transposition-invariant either way).
    ratio = top_freq[:, :, None] / (ref_freq * hs[None, None, :])
    a_offset = 9.0 * n_bins / 12.0
    pc = (n_bins * jnp.log2(jnp.maximum(ratio, 1e-9)) + a_offset) % n_bins
    # cos^2 window of +-window_size semitones around each bin center
    bins = jnp.arange(n_bins, dtype=jnp.float32)
    d = jnp.abs(pc[..., None] - bins)                  # (T, P, H, B)
    d = jnp.minimum(d, n_bins - d)
    semi = d * (12.0 / n_bins)
    w = jnp.where(semi <= window_size,
                  jnp.cos(jnp.pi / 2 * semi / window_size) ** 2, 0.0)
    contrib = (top_mag[:, :, None, None] ** 2) * hweights[None, None, :,
                                                          None] * w
    hpcp = jnp.sum(contrib, axis=(1, 2))               # (T, B)
    peak = jnp.max(hpcp, axis=1, keepdims=True)        # unit-max normalize
    return hpcp / jnp.where(peak == 0, 1.0, peak)


def hpcp(y: np.ndarray, sr: int = 44100, frame_size: int = 4096,
         hop_length: int = 512, min_freq: float = 100.0,
         max_freq: float = 3500.0, ref_freq: float = 440.0,
         max_peaks: int = 100, n_bins: int = 12, harmonics: int = 8,
         window_size: float = 1.0, whitening: bool = True) -> np.ndarray:
    """(n_frames, n_bins) HPCP — the reference's default feature profile
    entry (`extractors.py:22-29`)."""
    yp, L = bucket_pad_signal(y)
    out = np.asarray(_hpcp_jax(jnp.asarray(yp), sr, frame_size, hop_length,
                               float(min_freq), float(max_freq),
                               float(ref_freq), max_peaks, n_bins,
                               harmonics, float(window_size), whitening))
    return out[:n_frames_uncentered(L, frame_size, hop_length)]
