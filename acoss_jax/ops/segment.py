"""Segment (beat-synchronous) aggregation helpers.

Replaces the reference's use of `librosa.util.sync` (median/mean aggregation
between boundary frames — used by FTM2D at `FTM2D.py:90` and Serra09 at
`Serra09.py:104,111`). Semantics match librosa: boundaries are augmented
with 0 and L, clipped, uniqued; output has len(boundaries)-1 segments.

These run host-side in numpy: they execute once per song (O(N) total) on
ragged data, while everything O(N^2) runs on device.
"""

from __future__ import annotations

import numpy as np


def fix_frames(boundaries: np.ndarray, length: int) -> np.ndarray:
    """Augment boundary frames with 0 and `length`, clip, unique."""
    b = np.concatenate([[0], np.asarray(boundaries).ravel(), [length]])
    b = np.clip(b, 0, length)
    return np.unique(b).astype(np.int64)


def sync_agg(X: np.ndarray, boundaries: np.ndarray,
             aggregate: str = "median") -> np.ndarray:
    """Aggregate frames of X (L, d) between consecutive boundaries.

    Returns (n_segments, d) with n_segments = len(fix_frames)-1.
    """
    L = X.shape[0]
    b = fix_frames(boundaries, L)
    if aggregate == "mean":
        sums = np.add.reduceat(np.asarray(X, np.float64), b[:-1], axis=0)
        counts = np.diff(b)
        return sums / counts[:, None]
    # Measured-and-rejected (round 3): a vectorized grouped median (one
    # (segment, value) lexsort per dim, middles at closed-form sorted
    # positions) was 2x SLOWER than this loop at the real sizes
    # (~600 beat segments x 12-23 dims: 37 vs 18 ms/song), and a device
    # segment-median kernel would add a host<->device round trip to a
    # stage that profiles at ~30 ms/song total (~7% of StrucLaplacian's
    # covers80 wall) — the "0.2 s/song host prep" of earlier rounds was
    # retired by the batched device tempogram path, not by this loop.
    out = np.empty((len(b) - 1, X.shape[1]), dtype=np.float64)
    for k in range(len(b) - 1):
        out[k] = np.median(X[b[k]:b[k + 1]], axis=0)
    return out


def _uniform_median(X: np.ndarray, fac: int) -> np.ndarray:
    """Median over fixed windows of `fac` frames (+ remainder window) —
    the reshape fast path of `uniform_downsample`."""
    L, d = X.shape
    nfull = L // fac
    out_full = np.median(
        X[:nfull * fac].reshape(nfull, fac, d), axis=1)
    if L % fac:
        rem = np.median(X[nfull * fac:], axis=0, keepdims=True)
        return np.concatenate([out_full, rem], axis=0)
    return out_full


def uniform_downsample(X: np.ndarray, fac: int,
                       aggregate: str = "median") -> np.ndarray:
    """Downsample (L, d) by aggregating windows of `fac` frames — the
    reference's `librosa.util.sync(X.T, np.arange(0, L, fac), ...)`
    (`Serra09.py:104`)."""
    if aggregate == "median":
        return _uniform_median(np.asarray(X), fac)
    return sync_agg(X, np.arange(0, X.shape[0], fac), aggregate)


def stack_memory(X: np.ndarray, n_steps: int, delay: int = 1) -> np.ndarray:
    """History (delay) embedding with zero padding, frames-first.

    librosa.feature.stack_memory semantics transposed: X (t, d) ->
    (t, d * n_steps) where column block k is X delayed by k * delay frames
    (zeros shifted in at the start), matching the layout
    `get_csm_blocked_oti` expects (block-major feature axis).

    NOTE: the reference calls `stack_memory(chroma, self.tau, self.m)`
    (`ChenFusion.py:53`) which binds n_steps=tau=1, delay=m=9 — an
    effective no-op (the intended call is n_steps=m, delay=tau, the Chen
    2017 delay embedding). We implement the intended embedding; pass
    n_steps=1 to reproduce the reference's literal behavior.
    """
    t, d = X.shape
    blocks = []
    for k in range(n_steps):
        s = k * delay
        blk = np.zeros_like(X)
        if s < t:
            blk[s:] = X[:t - s]
        blocks.append(blk)
    return np.concatenate(blocks, axis=1)


def _down_batch(X, lengths, fac: int, agg: str):
    """The device program behind `uniform_downsample_batch`: windowed
    aggregation of a (B, Lp, d) host-staged batch.

    The median branch sorts the raw windows WITHOUT a validity mask:
    invalid positions arrive pre-filled with +inf from the HOST staging
    buffer, which saves a masking pass on the device. The fill is
    bit-identical to masking: valid values sort among themselves first
    and the median gathers stay inside the valid prefix for every window
    the caller keeps (c >= 1). Module-level so the no-masked-sort
    property is testable on the traced program.
    """
    import jax.numpy as jnp

    B, Lp, d = X.shape
    nseg = Lp // fac
    W = X.reshape(B, nseg, fac, d)
    k = jnp.arange(nseg)[None, :]
    c = jnp.clip(lengths[:, None] - k * fac, 0, fac)    # (B, nseg)
    if agg == "mean":
        s = jnp.sum(W, axis=2)
        return s / jnp.maximum(c, 1)[..., None]
    srt = jnp.sort(W, axis=2)
    cc = jnp.maximum(c, 1)
    lo = jnp.take_along_axis(
        srt, ((cc - 1) // 2)[..., None, None], axis=2)[:, :, 0]
    hi = jnp.take_along_axis(
        srt, (cc // 2)[..., None, None], axis=2)[:, :, 0]
    return 0.5 * (lo + hi)


def uniform_downsample_batch(arrays: list, fac: int,
                             aggregate: str = "median",
                             bucket: int = 4096,
                             batch_size: int = 16) -> list:
    """`uniform_downsample` for a corpus: songs grouped by padded length
    and aggregated on device in a few vmapped calls (prefilled medians /
    count-correct means make the remainder window exact — equal to the
    per-song host path up to float32 rounding). Returns per-song
    (ceil(L_i / fac), d) float32 arrays in input order."""
    import jax

    down = uniform_downsample_batch._jit
    if down is None:
        down = jax.jit(_down_batch, static_argnames=("fac", "agg"))
        uniform_downsample_batch._jit = down

    by_shape: dict = {}
    for i, a in enumerate(arrays):
        L = a.shape[0]
        Lp = max(-(-L // bucket) * bucket, bucket)
        by_shape.setdefault((Lp, a.shape[1]), []).append(i)

    out = [None] * len(arrays)
    for (Lp, d), idxs in sorted(by_shape.items()):
        for lo_ in range(0, len(idxs), batch_size):
            chunk = idxs[lo_:lo_ + batch_size]
            B = min(batch_size, len(idxs))
            pchunk = chunk + [chunk[0]] * (B - len(chunk))
            # median: pad with +inf so the device sort needs no mask
            # (see `down`); mean: zero padding + count-correct divide
            fill = np.inf if aggregate == "median" else 0.0
            X = np.full((B, -(-Lp // fac) * fac, d), fill, np.float32)
            lens = np.zeros(B, np.int32)
            for b, i in enumerate(pchunk):
                a = np.nan_to_num(np.asarray(arrays[i], np.float32),
                                  nan=0.0, posinf=0.0, neginf=0.0)
                X[b, :a.shape[0]] = a
                lens[b] = a.shape[0]
            Y = np.asarray(down(X, lens, fac, aggregate))
            for b, i in enumerate(chunk):
                n = -(-int(lens[b]) // fac)
                out[i] = Y[b, :n]
    return out


uniform_downsample_batch._jit = None
