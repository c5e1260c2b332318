"""ANFScattering: 1D scattering of audio novelty functions.

Parity target: `/root/reference/benchmarking/ANFScattering.py:10-67`:
novelty functions polyphase-resampled to T = 2^14; per function (a) global
z-normalized Scattering1D(J=6, Q=8) and (b) a 16-segment shingle (each
segment z-normalized, scattered at T/16, median over segments, unit norm);
pair score = plain Euclidean DISTANCE (`ANFScattering.py:54-67` stores
distances — eval negates).

Descriptors are fixed-size, so the sweep is one Gram matmul
(`full_scores`).
"""

from __future__ import annotations

import numpy as np
import scipy.signal

import jax
import jax.numpy as jnp

from acoss_jax.benchmarking.harness import CoverAlgorithm
from acoss_jax.data.store import FeatureSet
from acoss_jax.ops.scattering import Scattering1D

DOWNSAMPLE_FAC = 16

# songs per scattering dispatch: bounds the complex U1/U2 working set in
# device memory (64 songs x ~200 paths x 16384 x 8 B ~ 1.6 GB) while
# amortizing the per-dispatch overhead over the batch (the best chunk is
# not measured on the H100)
SCATTER_CHUNK = 64


def _chunked(scatter, X: np.ndarray, chunk: int = SCATTER_CHUNK,
             reduce=None):
    """Apply a scattering instance over the leading axis in fixed-size
    chunks (tail repeat-padded so each corpus compiles O(1) shapes).

    `reduce(chunk_out) -> smaller array` runs per chunk BEFORE
    accumulation, so corpus-sized pre-reduction tensors (e.g. the
    16x-per-song segment scattering before its median) never
    materialize in host RAM."""
    n = X.shape[0]
    if n <= chunk:
        out = np.asarray(scatter(X))
        return reduce(out) if reduce is not None else out
    outs = []
    for lo in range(0, n, chunk):
        part = X[lo:lo + chunk]
        valid = part.shape[0]
        if valid < chunk:
            part = np.concatenate(
                [part, np.repeat(part[:1], chunk - valid, axis=0)])
        out = np.asarray(scatter(part))[:valid]
        outs.append(reduce(out) if reduce is not None else out)
    return np.concatenate(outs, axis=0)


class ANFScattering(CoverAlgorithm):
    NAME = "ANFScattering"
    SIMILARITY_TYPES = ("anfrnn", "anfrnn_shingle",
                        "anfsuperflux", "anfsuperflux_shingle")
    DISTANCE_TYPES = SIMILARITY_TYPES
    SYMMETRIC = True

    def __init__(self, J: int = 6, T: int = 2 ** 14, Q: int = 8):
        self.J = J
        self.T = T
        self.Q = Q
        self.S = Scattering1D(J, T, Q)
        self.S2 = Scattering1D(J, T // DOWNSAMPLE_FAC, Q)

    def _song_prep(self, novfn: np.ndarray):
        """Host prep: polyphase resample to exactly T samples, global
        z-norm vector + 16 per-segment z-normed windows."""
        l = np.lcm(novfn.size, self.T)
        x = scipy.signal.resample_poly(
            novfn, int(l / novfn.size), int(l / self.T))
        y = x - np.mean(x)
        n = np.sqrt(np.sum(y ** 2))
        y = y / (n if n > 0 else 1.0)
        win = x.size // DOWNSAMPLE_FAC
        segs = x[:win * DOWNSAMPLE_FAC].reshape(DOWNSAMPLE_FAC, win)
        segs = segs - segs.mean(axis=1, keepdims=True)
        norms = np.sqrt(np.sum(segs ** 2, axis=1, keepdims=True))
        segs = segs / np.where(norms == 0, 1.0, norms)
        # fp32 here is exact w.r.t. the pipeline: the scattering casts
        # its input to fp32 anyway; this halves the corpus prep stacks
        # (resample_poly returns float64)
        return y.astype(np.float32), segs.astype(np.float32)

    def extract_descriptors(self, fs: FeatureSet) -> dict:
        """Whole-corpus batched: all songs' resampled novelty functions
        scatter in ONE device call per (feature, variant) — the per-song
        version was 4 dispatches/song through a ~30 ms-RTT link."""
        out = {}
        nlen = fs.length("novfn")
        slen = fs.length("snovfn")
        n_songs = fs.n_songs
        for name, key, ln in (("novfn", "anfrnn", nlen),
                              ("snovfn", "anfsuperflux", slen)):
            globs, segss = [], []
            for i in range(n_songs):
                y, segs = self._song_prep(fs.feature(name)[i, :ln[i], 0])
                globs.append(y)
                segss.append(segs)
            G = _chunked(self.S, np.stack(globs))         # (n, paths, t)
            out[key] = np.ascontiguousarray(
                G.reshape(n_songs, -1).astype(np.float32))
            # per-chunk median over the 16 segment windows: only the
            # (chunk, 16, p, t) pre-median tensor is ever resident
            sh = _chunked(
                self.S2, np.stack(segss),
                reduce=lambda SC: np.median(
                    SC.reshape(SC.shape[0], DOWNSAMPLE_FAC, -1), axis=1))
            norms = np.sqrt(np.sum(sh ** 2, axis=1, keepdims=True))
            sh = sh / np.where(norms == 0, 1.0, norms)
            out[f"{key}_shingle"] = sh.astype(np.float32)
        return out

    def full_scores(self, desc: dict) -> dict:
        return {k: np.asarray(_gram_dist(jnp.asarray(desc[k])))
                for k in self.SIMILARITY_TYPES}


@jax.jit
def _gram_dist(X):
    sq = jnp.sum(X * X, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * jnp.matmul(
        X, X.T, precision="highest")
    return jnp.sqrt(jnp.maximum(d2, 0.0))
