"""Simple (SiMPle): similarity matrix profile of smoothed chroma.

Parity target: `/root/reference/benchmarking/Simple.py:13-126`:
- descriptor: mean-pooled chroma (WIN=200, SKIP=100) + CENS-style Hann
  smoothing (length 6) + per-column L2 norm (`Simple.py:29-65`);
- pair: OTI variant (roll B by the argmax of profile dot products,
  `Simple.py:41-52`), then the SiMPle matrix profile with subsequence
  length SSLEN=10; score = -median(matrix_profile) (`Simple.py:67-117`).
  ASYMMETRIC (`Simple.py:149` uses symmetric=False).

Design: the reference's streaming-FFT dot-product updates are a CPU
optimization of exactly `min_j sum_k ||a_{i+k} - b_{j+k}||^2` — which is
the square of `sliding_csm(CSM, SSLEN)`. One matmul for the CSM + the
shifted-slice window sum replace the whole per-pair update loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import scipy.signal

from acoss_jax.benchmarking.harness import CoverAlgorithm
from acoss_jax.data.store import FeatureSet, pad_stack
from acoss_jax.ops import crp


def _hann_norm(n: int) -> np.ndarray:
    w = np.hanning(n)  # == scipy get_window('hann', n, fftbins=False)
    return w / w.sum()


def masked_median(x: jax.Array, n: jax.Array) -> jax.Array:
    """Median of the first `n` entries of x; entries past n must be +inf."""
    s = jnp.sort(x)
    n = jnp.maximum(n, 1)
    lo = jnp.take(s, (n - 1) // 2)
    hi = jnp.take(s, n // 2)
    return 0.5 * (lo + hi)


class Simple(CoverAlgorithm):
    NAME = "Simple"
    SIMILARITY_TYPES = ("main",)
    SYMMETRIC = False
    TILE = 8

    def __init__(self, chroma_type: str = "hpcp", SSLEN: int = 10,
                 WIN: int = 200, SKIP: int = 100,
                 pad_to_multiple: int = 64):
        self.chroma_type = chroma_type
        self.SSLEN = SSLEN
        self.WIN = WIN
        self.SKIP = SKIP
        self.pad_to_multiple = pad_to_multiple

    def _song_descriptor(self, chroma: np.ndarray) -> np.ndarray:
        """(L, 12) -> (L // SKIP, 12): mean pooling + Hann smoothing + L2
        column norm (`Simple.py:29-65`)."""
        L = chroma.shape[0]
        n = L // self.SKIP
        feat = np.zeros((12, n))
        ct = chroma.T
        for i in range(n):
            feat[:, i] = np.mean(ct[:, i * self.SKIP:
                                    i * self.SKIP + self.WIN], axis=1)
        win = np.atleast_2d(_hann_norm(6))
        feat = scipy.signal.convolve2d(feat, win, mode="same",
                                       boundary="fill")
        norms = np.linalg.norm(feat, axis=0)
        norms[norms == 0] = 1
        return (feat / norms).T.astype(np.float32)

    def extract_descriptors(self, fs: FeatureSet) -> dict:
        feats, profiles = [], []
        clen = fs.length(self.chroma_type)
        for i in range(fs.n_songs):
            d = self._song_descriptor(
                fs.feature(self.chroma_type)[i, :clen[i]])
            feats.append(d)
            profiles.append(d.sum(axis=0))
        Lmax = max(max(f.shape[0] for f in feats), self.SSLEN + 1)
        pad_to = -(-Lmax // self.pad_to_multiple) * self.pad_to_multiple
        arr, lengths = pad_stack(feats, pad_to)
        return {
            "feat": arr,
            "profile": np.stack(profiles).astype(np.float32),
            "length": lengths.astype(np.int32),
        }

    def _pair(self, r, c):
        # OTI variant: roll B's chroma axis by the best shift of its
        # profile against A's (`Simple.py:41-52`).
        shift = jnp.argmax(
            crp.get_all_shift_scores(c["profile"], r["profile"]))
        B = crp.transpose_chroma(c["feat"], shift)
        csm = crp.get_csm(r["feat"], B)
        w = crp.sliding_csm_padded(csm, self.SSLEN)
        d2 = w * w                                 # subsequence sq-dists
        l1e = jnp.maximum(r["length"] - self.SSLEN + 1, 0)
        l2e = jnp.maximum(c["length"] - self.SSLEN + 1, 0)
        Lp = d2.shape[0]
        jj = jnp.arange(Lp)
        d2 = jnp.where((jj < l2e)[None, :], d2, jnp.inf)
        mp = jnp.min(d2, axis=1)                   # matrix profile
        mp = jnp.where(jj < l1e, mp, jnp.inf)
        med = masked_median(mp, l1e)
        return -med

    def tile_scores(self, row: dict, col: dict) -> dict:
        pair = jax.vmap(jax.vmap(self._pair, in_axes=(None, 0)),
                        in_axes=(0, None))
        return {"main": pair(row, col)}
