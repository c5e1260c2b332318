"""Rhythm features: local autocorrelation tempogram.

Replaces `librosa.feature.tempogram` as used by the reference
(`Tempogram.py:47`, `StrucFTM2D.py:74`, `StrucLaplacian.py:73`): hop-1
sliding Hann-windowed frames of the onset envelope, per-frame FFT
autocorrelation, per-frame infinity-norm normalization. Computed as one
batched FFT on device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


SHAPE_BUCKET = 4096  # envelope lengths are padded to a multiple of this
                     # so a corpus compiles O(few) shapes, not O(n_songs)


@functools.partial(jax.jit, static_argnames=("win_length", "n_frames"))
def _tempogram_jax(padded: jax.Array, win_length: int,
                   n_frames: int) -> jax.Array:
    idx = jnp.arange(n_frames)[:, None] + jnp.arange(win_length)[None, :]
    frames = padded[idx]                                   # (L, win)
    window = jnp.asarray(np.hanning(win_length).astype(np.float32))
    frames = frames * window[None, :]
    n_fft = 2 * win_length
    spec = jnp.fft.rfft(frames, n=n_fft, axis=-1)
    ac = jnp.fft.irfft(spec * jnp.conj(spec), n=n_fft, axis=-1)
    ac = jnp.real(ac[:, :win_length])
    peak = jnp.max(jnp.abs(ac), axis=-1, keepdims=True)
    ac = ac / jnp.where(peak == 0, 1.0, peak)
    return ac.T                                            # (win, L)


def _ramp_pad_envelope(oenv: np.ndarray, win_length: int):
    """librosa's linear-ramp edge padding + shape-bucket zero padding.

    Frame t < L only reads the ramped region
    (t + win - 1 <= L - 1 + 2*half < len(ramped)), so bucketing is
    exact. Returns (padded, n_frames) with n_frames the bucketed count.
    ONE definition — the per-song, aggregated, and batch tempogram paths
    all share this convention."""
    L = oenv.size
    half = win_length // 2
    ramped = np.concatenate([
        np.linspace(0.0, 1.0, half, endpoint=False) * oenv[0],
        oenv,
        np.linspace(1.0, 0.0, half + 1)[1:] * oenv[-1],
    ]).astype(np.float32)
    pad_to = -(-(L + SHAPE_BUCKET) // SHAPE_BUCKET) * SHAPE_BUCKET
    padded = np.zeros(pad_to + win_length, dtype=np.float32)
    padded[:len(ramped)] = ramped
    n_frames = -(-L // SHAPE_BUCKET) * SHAPE_BUCKET
    return padded, n_frames


def _segment_prep(oenv: np.ndarray, boundaries, win_length: int):
    """Shared host prep for the aggregated tempogram paths:
    (padded, seg_ids, n_frames, nseg_pad, n_seg, counts)."""
    from acoss_jax.ops.segment import fix_frames

    L = oenv.size
    b = fix_frames(boundaries, L)
    n_seg = len(b) - 1
    seg_of_frame = np.zeros(L, dtype=np.int32)
    seg_of_frame[b[1:-1]] = 1
    seg_of_frame = np.cumsum(seg_of_frame).astype(np.int32)
    counts = np.diff(b).astype(np.float64)
    padded, n_frames = _ramp_pad_envelope(oenv, win_length)
    seg_ids = np.full(n_frames, n_seg, dtype=np.int32)   # pad -> junk seg
    seg_ids[:L] = seg_of_frame
    nseg_pad = -(-(n_seg + 1) // 64) * 64                # few static shapes
    return padded, seg_ids, n_frames, nseg_pad, n_seg, counts


def tempogram(onset_envelope: np.ndarray, win_length: int = 384,
              sr: int = 44100, hop_length: int = 512) -> np.ndarray:
    """Local autocorrelation tempogram, (win_length, n_frames).

    sr/hop_length are accepted for signature parity with librosa; the
    autocorrelation itself only depends on the envelope and win_length.
    """
    oenv = np.ascontiguousarray(onset_envelope, dtype=np.float32).ravel()
    L = oenv.size
    padded, n_frames = _ramp_pad_envelope(oenv, win_length)
    out = np.asarray(_tempogram_jax(jnp.asarray(padded), win_length,
                                    n_frames))
    return out[:, :L]


@functools.partial(jax.jit, static_argnames=("win_length", "n_frames",
                                             "num_segments"))
def _tempogram_segsum_jax(padded, seg_ids, win_length, n_frames,
                          num_segments):
    tg = _tempogram_jax(padded, win_length, n_frames)      # (win, L)
    sums = jax.ops.segment_sum(tg.T, seg_ids, num_segments=num_segments)
    return sums                                            # (S, win)


def tempogram_aggregated(onset_envelope: np.ndarray,
                         boundaries: np.ndarray,
                         win_length: int = 384) -> np.ndarray:
    """Mean-aggregated tempogram between boundary frames, computed WITHOUT
    reading the full (L, win) tempogram back to the host (the aggregation
    — a segment-sum — runs inside the same device program; only the
    (n_segments, win) result crosses the wire).

    Equivalent to `sync_agg(tempogram(env).T, boundaries, "mean")`.
    Returns (n_segments, win_length).
    """
    oenv = np.ascontiguousarray(onset_envelope, dtype=np.float32).ravel()
    padded, seg_ids, n_frames, nseg_pad, n_seg, counts = _segment_prep(
        oenv, boundaries, win_length)
    sums = np.asarray(_tempogram_segsum_jax(
        jnp.asarray(padded), jnp.asarray(seg_ids), win_length, n_frames,
        nseg_pad))
    return sums[:n_seg] / counts[:, None]


def tempogram_aggregated_batch(envelopes: list, boundaries_list: list,
                               win_length: int = 384,
                               batch_size: int = 16) -> list:
    """`tempogram_aggregated` for a whole corpus: songs are grouped by
    their padded shapes and swept `batch_size` at a time through ONE
    vmapped device program per group (vs one dispatch per song).
    Numerically identical to the per-song path. Returns the per-song
    (n_segments, win_length) arrays in input order."""
    preps = []
    for env, bounds in zip(envelopes, boundaries_list):
        oenv = np.ascontiguousarray(env, dtype=np.float32).ravel()
        preps.append(_segment_prep(oenv, bounds, win_length))

    by_shape: dict = {}
    for i, p in enumerate(preps):
        by_shape.setdefault((len(p[0]), p[2], p[3]), []).append(i)

    out = [None] * len(preps)
    for (plen, n_frames, nseg_pad), idxs in sorted(by_shape.items()):
        for lo in range(0, len(idxs), batch_size):
            chunk = idxs[lo:lo + batch_size]
            B = min(batch_size, len(idxs))
            pchunk = chunk + [chunk[0]] * (B - len(chunk))
            P = np.stack([preps[i][0] for i in pchunk])
            S = np.stack([preps[i][1] for i in pchunk])
            sums = np.asarray(_tempogram_segsum_batch(
                jnp.asarray(P), jnp.asarray(S), win_length, n_frames,
                nseg_pad))
            for b_, i in enumerate(chunk):
                n_seg, counts = preps[i][4], preps[i][5]
                out[i] = sums[b_, :n_seg] / counts[:, None]
    return out


@functools.partial(jax.jit, static_argnames=("win_length", "n_frames",
                                             "num_segments"))
def _tempogram_segsum_batch(padded, seg_ids, win_length, n_frames,
                            num_segments):
    def one(p, s):
        tg = _tempogram_jax(p, win_length, n_frames)
        return jax.ops.segment_sum(tg.T, s, num_segments=num_segments)

    return jax.vmap(one)(padded, seg_ids)
