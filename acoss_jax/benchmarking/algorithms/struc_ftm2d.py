"""StrucFTM2D / StrucShingles: sparse shingles of the fused structural W.

Parity targets:
- StrucFTM2D (`/root/reference/benchmarking/StrucFTM2D.py:30-189`): fused W
  (MFCC + HPCP SNF, `StrucFTM2D.py:119`) zero-padded to PAD_LEN^2, 2D-FFT
  magnitude, L2-normalized log shingle truncated to its 5 * PAD_LEN largest
  entries; similarity exp(-d^2) over all pairs via one sparse Gram
  (`StrucFTM2D.py:173-189`).
- StrucShingles (`StrucShingles.py:32-170`): identical but WITHOUT the 2D
  FFT (raw padded W shingle).

The sparse Gram runs on device as a dense matmul over the shingles'
column union (`ops/sparse_gram.py` — measured shingle supports
concentrate, so the union is small and the reference's host SpGEMM
scaling `StrucFTM2D.py:173-189` is quadratic-with-a-scipy-constant at
Da-TACOS scale; the scipy path remains as the unconcentrated fallback).
Everything upstream (tempogram, SSMs, SNF, FFT) also runs on device.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from acoss_jax.benchmarking.algorithms.struct_common import (
    sparse_top_shingle, structural_fused_w, structural_fused_w_all)
from acoss_jax.benchmarking.harness import CoverAlgorithm
from acoss_jax.data.store import FeatureSet
from acoss_jax.ops.sparse_gram import host_gram_scores, sparse_gram_scores
from acoss_jax.ops.structure import shingle_topk_batch


class StrucFTM2D(CoverAlgorithm):
    NAME = "StrucFTM2D"
    SIMILARITY_TYPES = ("main",)
    SYMMETRIC = True
    DO_FFT = True
    FUSE_FEATURES = ("mfcc", "hpcp")

    def __init__(self, chroma_type: str = "hpcp", wins_per_block: int = 20,
                 K: int = 10, niters: int = 10, do_sync: bool = True,
                 downsample_fac: int = 40, PAD_LEN: int = 2000,
                 tempogram_win: int = 384):
        self.chroma_type = chroma_type
        self.wins_per_block = wins_per_block
        self.K = K
        self.niters = niters
        self.do_sync = do_sync
        self.downsample_fac = downsample_fac
        self.PAD_LEN = PAD_LEN
        self.tempogram_win = tempogram_win

    def _song_shingle(self, fs: FeatureSet, i: int):
        W, _ = structural_fused_w(
            fs, i, self.chroma_type, self.wins_per_block, self.K,
            self.niters, self.do_sync, self.downsample_fac,
            fuse_features=self.FUSE_FEATURES,
            tempogram_win=self.tempogram_win)
        P = self.PAD_LEN
        n = min(P, W.shape[0])
        Wres = np.zeros((P, P), dtype=np.float32)
        Wres[:n, :n] = W[:n, :n]
        if self.DO_FFT:
            flat = np.asarray(
                jnp.abs(jnp.fft.fft2(jnp.asarray(Wres)))).flatten()
        else:
            flat = Wres.flatten()
        return sparse_top_shingle(flat, 5 * P)

    def extract_descriptors(self, fs: FeatureSet) -> dict:
        """Batched: fused W, 2D FFT, log normalization and the exact
        top-(5 * PAD_LEN) truncation run on device per song chunk
        (`ops/structure.shingle_topk_batch`); only the (idx, val) sparse
        shingles cross back to the host."""
        n_keep = 5 * self.PAD_LEN

        def consume(Wb, lengths, onsets_list):
            idx, val = shingle_topk_batch(Wb, lengths, self.PAD_LEN,
                                          n_keep, self.DO_FFT)
            idx = np.asarray(idx, np.int64)
            val = np.asarray(val, np.float32)
            outs = []
            for b in range(idx.shape[0]):
                keep = idx[b] >= 0
                ix, v = idx[b][keep], val[b][keep]
                order = np.argsort(ix)
                outs.append((ix[order], v[order]))
            return outs

        shingles = structural_fused_w_all(
            fs, self.chroma_type, self.wins_per_block, self.K,
            self.niters, self.do_sync, self.downsample_fac,
            fuse_features=self.FUSE_FEATURES,
            tempogram_win=self.tempogram_win, consume=consume)
        return {"idx": [s[0] for s in shingles],
                "val": [s[1] for s in shingles],
                "dim": self.PAD_LEN * self.PAD_LEN}

    # scipy fallback thresholds: beyond UNION_MAX the supports are not
    # concentrated and the dense-over-union matmul loses its economics
    # (measured: StrucShingles at 15k grows to ~1.4M union and the
    # device path still wins ~10x — scripts/sparse_gram_scale.py);
    # below HOST_MAX_N songs the host SpGEMM is sub-second and beats a
    # possible device compile
    UNION_MAX = 1 << 21
    HOST_MAX_N = 512

    def full_scores(self, desc: dict) -> dict:
        """exp(-d^2) over all pairs (`StrucFTM2D.py:173-189`) — device
        dense-over-union Gram, scipy SpGEMM fallback past UNION_MAX or
        under HOST_MAX_N songs."""
        return {"main": sparse_gram_scores(
            desc["idx"], desc["val"], desc["dim"],
            union_max=self.UNION_MAX, host_max_n=self.HOST_MAX_N)}

    def full_scores_host(self, desc: dict) -> dict:
        """The reference-shaped host path, kept callable for parity
        tests and as the explicit fallback."""
        return {"main": host_gram_scores(
            desc["idx"], desc["val"], desc["dim"])}


class StrucShingles(StrucFTM2D):
    """StrucFTM2D without the 2D FFT (`StrucShingles.py:132-142`)."""

    NAME = "StrucShingles"
    DO_FFT = False
