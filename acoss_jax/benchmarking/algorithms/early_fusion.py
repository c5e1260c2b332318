"""EarlyFusion (the reference's EarlySNF_Old): beat-blocked features +
constrained Smith-Waterman + early/late fusion.

Parity target: `/root/reference/benchmarking/EarlySNF_Old.py:52-241`:
- per song: 20-beat blocks; MFCCs resized to 50 frames/block and
  Z-normalized (flattened), their SSM upper triangles, chroma blocks
  resized to 40 frames/block, median chroma for OTI (`:98-185`);
- per pair: Euclidean CSMs (blocked-OTI cosine for chroma) ->
  csm_to_binary(kappa=0.1) -> `swconstrained`; EARLY fusion:
  exp(-sum_s get_WCSM(CSM_s, K, K)) -> binarize -> swconstrained
  (`:188-233`);
- LATE fusion: SNF over 1 / (1 + D) score matrices (K=20, 20 iters)
  (`:235-241`), emitted as 'late' and 'early+late'.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from acoss_jax.benchmarking.harness import CoverAlgorithm
from acoss_jax.data.store import FeatureSet, pad_stack
from acoss_jax.ops import alignment, crp, fusion


def _gauss_blur_rows_np(x: np.ndarray, sigma: float) -> np.ndarray:
    if sigma <= 0:
        return x
    import scipy.ndimage
    return scipy.ndimage.gaussian_filter1d(x, sigma, axis=0,
                                           mode="nearest")


def resize_rows_np(x: np.ndarray, n_out: int) -> np.ndarray:
    """Anti-aliased resize of the row axis (skimage-like), host numpy
    (block lengths vary, so this cannot be one static-jit shape)."""
    n_in = x.shape[0]
    if n_in == 0:
        return np.zeros((n_out, x.shape[1]), dtype=np.float64)
    if n_in == 1:
        return np.repeat(x.astype(np.float64), n_out, axis=0)
    scale = n_in / n_out
    y = _gauss_blur_rows_np(x.astype(np.float64),
                            max(0.0, (scale - 1) / 2))
    pos = np.clip((np.arange(n_out) + 0.5) * scale - 0.5, 0, n_in - 1)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, n_in - 1)
    w = (pos - lo)[:, None]
    return y[lo] * (1 - w) + y[hi] * w


class EarlyFusion(CoverAlgorithm):
    NAME = "EarlyFusion"
    SIMILARITY_TYPES = ("mfccs", "ssms", "chromas", "early")
    SYMMETRIC = True
    TILE = 8

    def __init__(self, chroma_type: str = "hpcp", blocksize: int = 20,
                 mfccs_per_block: int = 50, chromas_per_block: int = 40,
                 kappa: float = 0.1, K: int = 10,
                 late_K: int = 20, late_niters: int = 20,
                 pad_to_multiple: int = 64, sequential: bool = True):
        self.sequential = sequential
        self.chroma_type = chroma_type
        self.blocksize = blocksize
        self.mfccs_per_block = mfccs_per_block
        self.chromas_per_block = chromas_per_block
        self.kappa = kappa
        self.K = K
        self.late_K = late_K
        self.late_niters = late_niters
        self.pad_to_multiple = pad_to_multiple

    def _song(self, fs: FeatureSet, i: int):
        chroma = fs.feature(self.chroma_type)[i,
                                              :fs.length(self.chroma_type)[i]]
        mfcc = np.nan_to_num(
            fs.feature("mfcc_htk")[i, :fs.length("mfcc_htk")[i]])
        onsets = fs.feature("onsets")[i, :fs.length("onsets")[i], 0]
        n_blocks = max(len(onsets) - self.blocksize, 0)
        d = mfcc.shape[1]
        mpb, cpb = self.mfccs_per_block, self.chromas_per_block
        iu = np.triu_indices(mpb, 1)
        mfccs = np.zeros((max(n_blocks, 1), mpb * d), np.float32)
        ssms = np.zeros((max(n_blocks, 1), len(iu[0])), np.float32)
        chromas = np.zeros((max(n_blocks, 1), cpb * 12), np.float32)
        for b in range(n_blocks):
            x = resize_rows_np(
                mfcc[onsets[b]:onsets[b + self.blocksize - 1]], mpb)
            x = x - x.mean(axis=0, keepdims=True)
            norms = np.sqrt(np.sum(x ** 2, axis=1, keepdims=True))
            xn = x / np.where(norms == 0, 1.0, norms)
            mfccs[b] = xn.ravel()
            # tiny (50 x 50) SSM: host numpy (one device dispatch and
            # readback per block would cost more than the arithmetic)
            sq = np.sum(xn * xn, axis=1)
            D2 = np.maximum(sq[:, None] + sq[None, :] - 2 * xn @ xn.T, 0)
            np.fill_diagonal(D2, 0)
            ssms[b] = np.sqrt(D2)[iu]
            c = resize_rows_np(
                chroma[onsets[b]:onsets[b + self.blocksize]], cpb)
            chromas[b] = c.ravel()
        return mfccs, ssms, chromas, np.median(chroma, axis=0), n_blocks

    def extract_descriptors(self, fs: FeatureSet) -> dict:
        per = [self._song(fs, i) for i in range(fs.n_songs)]
        Lmax = max(p[4] for p in per)
        pad_to = max(-(-Lmax // self.pad_to_multiple) * self.pad_to_multiple,
                     self.pad_to_multiple)
        out = {}
        for k, name in enumerate(("mfccs", "ssms", "chromas")):
            out[name], _ = pad_stack([p[k] for p in per], pad_to)
        out["chroma_med"] = np.stack(
            [p[3] for p in per]).astype(np.float32)
        out["length"] = np.array([p[4] for p in per], np.int32)
        return out

    def _pair_crps(self, r, c):
        l1, l2 = r["length"], c["length"]
        csm_m = crp.get_csm(r["mfccs"], c["mfccs"])
        csm_s = crp.get_csm(r["ssms"], c["ssms"])
        csm_c = crp.get_csm_blocked_oti(
            r["chromas"], c["chromas"], r["chroma_med"], c["chroma_med"],
            crp.get_csm_cosine)
        Bs = [crp.csm_to_binary(x, self.kappa, l1, l2)
              for x in (csm_m, csm_s, csm_c)]
        # EARLY fusion: sum of exponential cross affinities, flipped back
        # to a "distance" (`EarlySNF_Old.py:211-216`).
        wsum = sum(fusion.get_WCSM(x, self.K, self.K,
                                   row_length=l1, col_length=l2)
                   for x in (csm_m, csm_s, csm_c))
        Bs.append(crp.csm_to_binary(jnp.exp(-wsum), self.kappa, l1, l2))
        return tuple(Bs), l1, l2

    def tile_scores(self, row: dict, col: dict) -> dict:
        pair = jax.vmap(jax.vmap(self._pair_crps, in_axes=(None, 0)),
                        in_axes=(0, None))
        Bs, l1, l2 = pair(row, col)
        bi, bj, L, _ = Bs[0].shape
        S = jnp.concatenate([B.reshape(-1, L, L) for B in Bs])
        ml = jnp.tile(l1.reshape(-1), 4)
        nl = jnp.tile(l2.reshape(-1), 4)
        sw = alignment.swconstrained_batch_best(
            S, ml, nl, backend=self.aligner).reshape(4, bi, bj)
        return {"mfccs": sw[0], "ssms": sw[1], "chromas": sw[2],
                "early": sw[3]}

    def post_process(self, Ds: dict, desc: dict) -> dict:
        out = dict(Ds)
        late_in = [1.0 / (1.0 + Ds[s])
                   for s in ("chromas", "ssms", "mfccs")]
        _, late = fusion.snf(np.stack(late_in), K=self.late_K,
                             niters=self.late_niters, reg_diag=True,
                             sequential=self.sequential)
        out["late"] = np.asarray(late, dtype=np.float32)
        _, el = fusion.snf(
            np.stack(late_in + [1.0 / (1.0 + Ds["early"])]),
            K=self.late_K, niters=self.late_niters, reg_diag=True,
            sequential=self.sequential)
        out["early+late"] = np.asarray(el, dtype=np.float32)
        return out
