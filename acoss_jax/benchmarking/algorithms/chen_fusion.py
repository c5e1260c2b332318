"""ChenFusion: blocked-OTI qmax/dmax with length normalization + late SNF.

Parity target: `/root/reference/benchmarking/ChenFusion.py:17-109`:
- descriptors: global chroma + x40 median-downsampled chroma -> delay
  embedding (`ChenFusion.py:43-55`);
- pair score: blocked-OTI Euclidean CSM -> csm_to_binary (NON-mutual,
  `ChenFusion.py:63`) -> RAW qmax/dmax (no (M+N) normalization);
- post passes: `normalize_by_length` (sqrt(len_j) / score — asymmetric,
  column-song length, `ChenFusion.py:71-80`) and late SNF fusion of the
  normalized score matrices (K=20, 20 iters, `ChenFusion.py:82-85`), then
  the per-kernel matrices are negated so larger = closer.

NOTE on the delay embedding: the reference's
`librosa.feature.stack_memory(chroma, self.tau, self.m)` binds
n_steps=tau=1, delay=m — an effective identity (no stacking). The DEFAULT
here reproduces that literal behavior (stack_n_steps=1) so covers80
numbers are comparable with upstream; pass `stack_n_steps=None` (or m) to
opt into the intended Chen 2017 embedding (n_steps=m, delay=tau). The
`sequential` flag likewise pins the late-SNF update order to the
reference's aliasing artifact (see `fusion.snf_ws`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from acoss_jax.benchmarking.algorithms.serra09 import global_chroma
from acoss_jax.benchmarking.harness import CoverAlgorithm
from acoss_jax.data.store import FeatureSet, pad_stack
from acoss_jax.ops import alignment, crp, fusion
from acoss_jax.ops.segment import (stack_memory, uniform_downsample_batch)


class ChenFusion(CoverAlgorithm):
    NAME = "ChenFusion"
    SIMILARITY_TYPES = ("qmax", "dmax")
    SYMMETRIC = True
    TILE = 8

    def __init__(self, chroma_type: str = "hpcp", oti: bool = True,
                 kappa: float = 0.095, tau: int = 1, m: int = 9,
                 downsample_fac: int = 40, stack_n_steps: int | None = 1,
                 late_K: int = 20, late_niters: int = 20,
                 pad_to_multiple: int = 64, sequential: bool = True):
        self.chroma_type = chroma_type
        self.oti = oti
        self.kappa = kappa
        self.tau = tau
        self.m = m
        self.downsample_fac = downsample_fac
        # stack_n_steps=1 == the reference's literal (no-op) stack_memory
        # call; None selects the intended Chen 2017 embedding (n_steps=m).
        self.stack_n_steps = m if stack_n_steps is None else stack_n_steps
        self.late_K = late_K
        self.late_niters = late_niters
        self.pad_to_multiple = pad_to_multiple
        self.sequential = sequential

    def extract_descriptors(self, fs: FeatureSet) -> dict:
        stacked, gchromas = [], []
        clen = fs.length(self.chroma_type)
        chs = [fs.feature(self.chroma_type)[i, :clen[i]]
               for i in range(fs.n_songs)]
        ch_all = uniform_downsample_batch(chs, self.downsample_fac,
                                          "median")
        for i in range(fs.n_songs):
            gchromas.append(global_chroma(chs[i]))
            stacked.append(
                stack_memory(ch_all[i], self.stack_n_steps, self.tau)
                .astype(np.float32))
        Lmax = max(s.shape[0] for s in stacked)
        pad_to = -(-Lmax // self.pad_to_multiple) * self.pad_to_multiple
        arr, lengths = pad_stack(stacked, pad_to)
        return {
            "stacked": arr,
            "gchroma": np.stack(gchromas).astype(np.float32),
            "length": lengths.astype(np.int32),
        }

    def _pair_crp(self, r, c):
        csm = crp.get_csm_blocked_oti(
            r["stacked"], c["stacked"], r["gchroma"], c["gchroma"],
            crp.get_csm) if self.oti else crp.get_csm(
                r["stacked"], c["stacked"])
        B = crp.csm_to_binary(csm, self.kappa, r["length"], c["length"])
        return B, r["length"], c["length"]

    def tile_scores(self, row: dict, col: dict) -> dict:
        pair = jax.vmap(jax.vmap(self._pair_crp, in_axes=(None, 0)),
                        in_axes=(0, None))
        B, l1, l2 = pair(row, col)
        bi, bj, L, _ = B.shape
        S = B.reshape(-1, L, L)
        ml, nl = l1.reshape(-1), l2.reshape(-1)
        q = alignment.qmax_batch_best(
            S, ml, nl, backend=self.aligner).reshape(bi, bj)
        d = alignment.dmax_batch_best(
            S, ml, nl, backend=self.aligner).reshape(bi, bj)
        return {"qmax": q, "dmax": d}

    def post_process(self, Ds: dict, desc: dict) -> dict:
        # normalize_by_length (`ChenFusion.py:71-80`): sqrt(len_j) / score
        # per COLUMN song — turns similarities into distances.
        norm = np.sqrt(desc["length"].astype(np.float64))[None, :]
        out = {}
        for k in ("qmax", "dmax"):
            D = np.asarray(Ds[k], dtype=np.float64)
            out[k] = (norm / np.maximum(D, 1e-12)).astype(np.float32)
        # Late SNF fusion of the distance matrices (`ChenFusion.py:82-85`).
        stackD = jnp.stack([out["qmax"], out["dmax"]])
        _, late = fusion.snf(stackD, K=self.late_K,
                             niters=self.late_niters, reg_diag=True,
                             sequential=self.sequential)
        # Negate the per-kernel matrices so larger = closer again.
        result = {k: -v for k, v in out.items()}
        result["Late"] = np.asarray(late, dtype=np.float32)
        return result
