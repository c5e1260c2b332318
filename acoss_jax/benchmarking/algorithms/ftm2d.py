"""FTM2D: 2D Fourier Transform Magnitude shingles.

Parity target: `/root/reference/benchmarking/FTM2D.py:51-130` — beat-sync
median chroma -> chrompwr(PWR=1.96) -> all 12x75 2D-FFT magnitude patches
-> per-shingle L2 norm + log(C x + 1) -> median shingle -> unit norm;
pair similarity exp(-||s1 - s2||^2) (`FTM2D.py:126-129`).

Design: the descriptor is fixed-size (900,), so the whole N x N sweep
collapses to ONE Gram matmul (`full_scores`), the same trick the reference
only applied in StrucFTM2D (`StrucFTM2D.py:173-189`) — score-identical to
its per-pair loop.

Ablation variants mirror the reference's separate files as toggles:
  do_log=False           -> FTM2D_noLog.py
  do_norm=False          -> FTM2D_noNorm.py
  both False             -> FTM2D_noNormNoLog.py
  mode="zeropad"         -> FTM2D_zeroPad.py (whole beat-chroma zero-padded
                            to 12 x PAD_LEN, ONE global fft2, unit-norm;
                            `FTM2D_zeroPad.py:99-108`)
  mode="zeropad", do_log -> FTM2D_zeroPadLog.py (log(x + 1) after norm)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from acoss_jax.benchmarking.harness import CoverAlgorithm
from acoss_jax.data.store import FeatureSet
from acoss_jax.ops.crp import chrompwr_np
from acoss_jax.ops.segment import sync_agg


def fft2_mag_patches(btchroma: np.ndarray, win: int) -> np.ndarray:
    """All fftshifted 2D-FFT magnitude patches of a (12, n_beats) matrix.

    Parity: `FTM2D.py:30-48`, batched: one fft2 over the stacked
    (n_patches, 12, win) sliding windows instead of a per-patch loop.
    Host numpy: per-song patch counts vary, and ~1k-point FFTs are far
    cheaper than one device compile per distinct shape.
    Returns (n_patches, 12 * win).
    """
    nchr, nbeats = btchroma.shape
    n_patches = nbeats - win + 1
    if n_patches <= 0:
        return np.zeros((0, nchr * win), dtype=np.float32)
    idx = np.arange(win)[None, :] + np.arange(n_patches)[:, None]
    patches = np.swapaxes(btchroma.T[idx], 1, 2)      # (P, 12, win)
    F = np.abs(np.fft.fft2(patches, axes=(-2, -1)))
    F = np.fft.fftshift(F, axes=(-2, -1))
    return F.reshape(n_patches, nchr * win).astype(np.float32)


class FTM2D(CoverAlgorithm):
    NAME = "FTM2D"
    SIMILARITY_TYPES = ("main",)
    SYMMETRIC = True

    def __init__(self, chroma_type: str = "hpcp", PWR: float = 1.96,
                 WIN: int = 75, C: float = 5.0, do_log: bool = True,
                 do_norm: bool = True, mode: str = "median",
                 PAD_LEN: int = 2000):
        assert mode in ("median", "zeropad")
        self.chroma_type = chroma_type
        self.PWR = PWR
        self.WIN = WIN
        self.C = C
        self.do_log = do_log
        self.do_norm = do_norm
        self.mode = mode
        self.PAD_LEN = PAD_LEN

    def _shingle_zeropad(self, bt: np.ndarray) -> np.ndarray:
        """Zero-pad the whole beat-chroma to 12 x PAD_LEN, one global 2D
        FFT magnitude, unit norm (+ optional log) (`FTM2D_zeroPad.py:
        99-108`, `FTM2D_zeroPadLog.py:108`)."""
        pad = np.zeros((12, self.PAD_LEN), dtype=np.float64)
        bt = bt[:, :self.PAD_LEN]
        pad[:, :bt.shape[1]] = bt
        flat = np.abs(np.fft.fft2(pad)).flatten()
        n = np.sqrt(np.sum(flat ** 2))
        s = flat / (n if n > 0 else 1.0)
        if self.do_log:
            s = np.log(s + 1)
        return s.astype(np.float32)

    def shingle(self, chroma: np.ndarray, onsets: np.ndarray) -> np.ndarray:
        """Single-song FTM2D shingle (`FTM2D.py:78-117`)."""
        dim = 12 * (self.PAD_LEN if self.mode == "zeropad" else self.WIN)
        out = np.zeros(dim, dtype=np.float32)
        if onsets.size <= self.WIN:   # "Not enough beats" (`FTM2D.py:88`)
            return out
        bt = sync_agg(chroma, onsets, "median").T      # (12, n_seg)
        return self.shingle_from_bt(bt)

    def shingle_from_bt(self, bt: np.ndarray) -> np.ndarray:
        """Shingle from an already beat-synced (12, n_beats) chroma —
        the shared-input entry point of the cross-implementation parity
        harness (`benchmarking.crossimpl.ref_ftm2d_shingle` feeds the
        reference's chrompwr/btchroma_to_fftmat the same matrix)."""
        dim = 12 * (self.PAD_LEN if self.mode == "zeropad" else self.WIN)
        out = np.zeros(dim, dtype=np.float32)
        bt = chrompwr_np(bt, self.PWR, axis=0)
        if self.mode == "zeropad":
            return self._shingle_zeropad(bt)
        sh = fft2_mag_patches(bt, self.WIN)            # (P, 900)
        if sh.shape[0] == 0:
            return out
        if self.do_norm:
            norm = np.linalg.norm(sh, axis=1)
            norm[norm == 0] = 1
            sh = sh / norm[:, None]
        if self.do_log:
            sh = np.log(self.C * sh + 1)
        s = np.median(sh, axis=0)
        n = np.sqrt(np.sum(s ** 2))
        if n > 0:
            s = s / n
        return s.astype(np.float32)

    def extract_descriptors(self, fs: FeatureSet) -> dict:
        chroma = fs.feature(self.chroma_type)
        clen = fs.length(self.chroma_type)
        onsets = fs.feature("onsets")
        olen = fs.length("onsets")
        shingles = np.stack([
            self.shingle(chroma[i, :clen[i]], onsets[i, :olen[i], 0])
            for i in range(fs.n_songs)
        ])
        return {"shingle": shingles}

    def full_scores(self, desc: dict) -> dict:
        return {"main": np.asarray(_gram_exp(jnp.asarray(desc["shingle"])))}


@jax.jit
def _gram_exp(S):
    """exp(-||s_i - s_j||^2) Gram — ONE jitted program (eager ops would
    each compile and dispatch separately)."""
    sq = jnp.sum(S * S, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * jnp.matmul(
        S, S.T, precision="highest")
    return jnp.exp(-jnp.maximum(d2, 0.0))
