"""Onset novelty functions and dynamic-programming beat tracking.

Replaces the reference's librosa/madmom rhythm stack:
- `onset_strength` / superflux novelty (`features.py:66-77`): mel
  spectrogram -> dB -> frequency max-filter (max_size=3) -> positive
  first difference -> mean over bands;
- DP beat tracker (`features.py:129-143` librosa path): tempo estimate
  from the windowed-autocorrelation tempogram, then the Ellis dynamic
  program over onset strength. The madmom RNN+DBN tracker
  (`features.py:79-127`) has no pretrained-model equivalent here; the DP
  tracker is the documented substitution (SURVEY.md section 7.7) — `onsets`
  are returned in hop units exactly like `madmom_features`
  (`features.py:115`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from acoss_jax.features.rhythm import tempogram
from acoss_jax.features.spectral import (bucket_pad_signal, mel_filterbank,
                                         n_frames_centered, stft)


@functools.partial(jax.jit, static_argnames=(
    "sr", "n_fft", "hop_length", "n_mels", "max_size", "lag"))
def _onset_strength_jax(y, sr, n_fft, hop_length, n_mels, max_size, lag):
    S = jnp.abs(stft(y, n_fft=n_fft, hop_length=hop_length))
    fb = jnp.asarray(mel_filterbank(sr, n_fft, n_mels, htk=False,
                                    norm="slaney"))
    mel = jnp.matmul(S * S, fb.T, precision="highest")  # (T, n_mels)
    db = 10.0 * jnp.log10(jnp.maximum(mel, 1e-10))
    db = jnp.maximum(db, jnp.max(db) - 80.0)
    if max_size > 1:
        # maximum_filter1d(mode='reflect') along the mel-band axis: the
        # reflected out-of-bounds samples duplicate in-window values, so
        # this equals the max over the CLIPPED window — shifts must pad
        # with -inf, never wrap (a roll would mix band 0 and band n-1)
        r = max_size // 2
        m = db
        for off in range(-r, r + 1):
            if off == 0:
                continue
            if off > 0:
                shifted = jnp.pad(db[:, :-off], ((0, 0), (off, 0)),
                                  constant_values=-jnp.inf)
            else:
                shifted = jnp.pad(db[:, -off:], ((0, 0), (0, -off)),
                                  constant_values=-jnp.inf)
            m = jnp.maximum(m, shifted)
        ref = m
    else:
        ref = db
    diff = db[lag:] - ref[:-lag]
    diff = jnp.maximum(diff, 0.0)
    env = jnp.mean(diff, axis=1)
    # librosa compensates the lag + centering offset: pad at the front
    pad = lag + n_fft // (2 * hop_length)
    env = jnp.concatenate([jnp.zeros(pad), env])
    return env[:S.shape[0]]


def onset_strength(y: np.ndarray, sr: int = 44100, n_fft: int = 2048,
                   hop_length: int = 512, n_mels: int = 128,
                   max_size: int = 3, lag: int = 1) -> np.ndarray:
    """Superflux-style onset envelope, one value per hop frame
    (`features.py:66-77`)."""
    yp, L = bucket_pad_signal(y)
    out = np.asarray(_onset_strength_jax(jnp.asarray(yp), sr, n_fft,
                                         hop_length, n_mels, max_size,
                                         lag))
    return out[:n_frames_centered(L, hop_length)]


def estimate_tempo(oenv: np.ndarray, sr: int = 44100,
                   hop_length: int = 512, start_bpm: float = 120.0,
                   std_bpm: float = 1.0) -> float:
    """Global tempo from the mean tempogram, log-normal prior around
    start_bpm (librosa.beat.tempo semantics)."""
    tg = tempogram(oenv).mean(axis=1)              # (win,)
    win = len(tg)
    frame_rate = sr / hop_length
    bpms = 60.0 * frame_rate / np.maximum(np.arange(win), 1e-9)
    bpms[0] = np.inf
    prior = np.exp(-0.5 * ((np.log2(bpms) - np.log2(start_bpm))
                           / std_bpm) ** 2)
    best = int(np.argmax(tg * prior))
    return float(60.0 * frame_rate / max(best, 1))


def beat_track_dp(oenv: np.ndarray, sr: int = 44100, hop_length: int = 512,
                  start_bpm: float = 120.0, tightness: float = 100.0
                  ) -> tuple[float, np.ndarray]:
    """Ellis dynamic-programming beat tracker.

    Returns (tempo_bpm, beat frame indices in hop units).
    """
    oenv = np.asarray(oenv, dtype=np.float64).ravel()
    if oenv.size < 4 or oenv.max() <= 0:
        return 0.0, np.zeros(0, dtype=np.int64)
    tempo = estimate_tempo(oenv, sr, hop_length, start_bpm)
    period = max(int(round(60.0 * sr / (hop_length * tempo))), 1)
    # normalize envelope
    env = oenv / oenv.std() if oenv.std() > 0 else oenv
    n = env.size
    backlink = np.full(n, -1, dtype=np.int64)
    cumscore = env.copy()
    prange = np.arange(-2 * period, -period // 2)
    txcost = -tightness * (np.log(-prange / period) ** 2)
    for i in range(n):
        lo = i + prange[0]
        cand = lo + np.arange(len(prange))
        ok = cand >= 0
        if not ok.any():
            continue
        scores = np.where(ok, txcost + np.where(ok, cumscore[np.clip(
            cand, 0, n - 1)], -np.inf), -np.inf)
        best = int(np.argmax(scores))
        if scores[best] > 0:
            cumscore[i] += scores[best]
            backlink[i] = cand[best]
    # backtrace from the best ending in the last period
    tail = cumscore[max(n - period, 0):]
    end = int(np.argmax(tail)) + max(n - period, 0)
    beats = [end]
    while backlink[beats[-1]] >= 0:
        beats.append(int(backlink[beats[-1]]))
    beats = np.array(beats[::-1], dtype=np.int64)
    return tempo, beats


def madmom_features_substitute(y: np.ndarray, sr: int = 44100,
                               hop_length: int = 512) -> dict:
    """The `madmom_features` dict of the reference's h5 schema
    (`extractors.py:43-53`), computed with the superflux envelope + DP
    tracker substitution: {'tempos', 'onsets', 'novfn', 'snovfn'}."""
    snovfn = onset_strength(y, sr, hop_length=hop_length, max_size=3)
    novfn = onset_strength(y, sr, hop_length=hop_length, max_size=1)
    tempo, onsets = beat_track_dp(snovfn, sr, hop_length)
    return {
        "tempos": np.array([[tempo, 1.0]], dtype=np.float64),
        "onsets": onsets,
        "novfn": novfn.astype(np.float32),
        "snovfn": snovfn.astype(np.float32),
    }
