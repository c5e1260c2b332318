"""StrucLaplacian: structural-novelty curves from spectral clustering.

Parity target: `/root/reference/benchmarking/StrucLaplacian.py:25-181`:
fused W of all three feature stacks -> random-walk Laplacian eigenvectors
-> sequential spectral clustering at k = 2..neigs -> hierarchy meet matrix
-> SVD -> curvature-magnitude (velocity) profile -> sliding window (m=10)
descriptor; pair score: Euclidean CSM -> csm_to_binary (non-mutual) ->
qmax/dmax / (M + N) (`StrucLaplacian.py:166-181`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from acoss_jax.benchmarking.algorithms.struct_common import (
    structural_fused_w, structural_fused_w_all)
from acoss_jax.benchmarking.harness import CoverAlgorithm
from acoss_jax.data.store import FeatureSet, pad_stack
from acoss_jax.ops import alignment, crp
from acoss_jax.ops.curvature import get_curv_vectors
from acoss_jax.ops.laplacian import (meet_matrix,
                                     random_walk_laplacian_eigs,
                                     spectral_cluster_sequential)
from acoss_jax.ops.structure import laplacian_profile_batch

HOP_LENGTH = 512
SR = 44100


class StrucLaplacian(CoverAlgorithm):
    NAME = "StructureLaplacian"
    SIMILARITY_TYPES = ("snovfn_qmax", "snovfn_dmax")
    SYMMETRIC = True
    TILE = 8

    def __init__(self, chroma_type: str = "hpcp", kappa: float = 0.095,
                 m: int = 10, wins_per_block: int = 20, K: int = 10,
                 niters: int = 10, neigs: int = 10, do_sync: bool = True,
                 downsample_fac: int = 40, tempogram_win: int = 384,
                 pad_to_multiple: int = 64):
        self.chroma_type = chroma_type
        self.kappa = kappa
        self.m = m
        self.wins_per_block = wins_per_block
        self.K = K
        self.niters = niters
        self.neigs = neigs
        self.do_sync = do_sync
        self.downsample_fac = downsample_fac
        self.tempogram_win = tempogram_win
        self.pad_to_multiple = pad_to_multiple

    def _profile_from_curve(self, X: np.ndarray) -> np.ndarray:
        """SVD curve (nmeet, neigs) -> sliding-window velocity-magnitude
        profile (`StrucLaplacian.py:138-152`)."""
        curvs = np.array(get_curv_vectors(X, 3, 2))    # (4, n, d)
        prof = np.sqrt(np.sum(curvs ** 2, axis=2)).T[:, 1]
        if prof.size < self.m:
            return np.zeros((1, self.m), dtype=np.float32)
        n_out = prof.size - self.m + 1
        return np.stack([prof[k:k + n_out] for k in range(self.m)],
                        axis=1).astype(np.float32)

    def _song_profile(self, fs: FeatureSet, i: int) -> np.ndarray:
        W, onsets = structural_fused_w(
            fs, i, self.chroma_type, self.wins_per_block, self.K,
            self.niters, self.do_sync, self.downsample_fac,
            fuse_features=("mfcc", "hpcp", "tempogram"),
            tempogram_win=self.tempogram_win)
        times = onsets * HOP_LENGTH / SR
        if len(times) < max(self.neigs + 1, self.m + 2):
            return np.zeros((1, self.m), dtype=np.float32)
        vs = np.asarray(random_walk_laplacian_eigs(jnp.asarray(W)))
        vs = vs[:len(times)]
        labels = [spectral_cluster_sequential(vs, k, times)
                  for k in range(2, self.neigs + 1)]
        interval = float(np.mean(times[1:] - times[:-1]))
        L = meet_matrix([r["intervals_hier"] for r in labels],
                        [r["labels_hier"] for r in labels],
                        max(interval, 1e-4))
        U, s, _ = np.linalg.svd(L)
        s = s[:self.neigs]
        s = s / max(s[0], 1e-12)
        X = U[:, :self.neigs] * s[None, :]
        # same curvature -> velocity profile -> sliding window as the
        # batched path (verified elementwise-identical: sliding_window
        # == the stacked-offset construction)
        return self._profile_from_curve(X)

    def extract_descriptors(self, fs: FeatureSet) -> dict:
        """Batched: fused W + eigenvectors + spectral k-means + meet
        matrix + SVD all run on device per song chunk
        (`ops/structure.laplacian_profile_batch`); only curvature +
        sliding window (O(n) per song) run on the host."""
        min_beats = max(self.neigs + 1, self.m + 2)

        def consume(Wb, lengths, onsets_list):
            from acoss_jax.utils.profiling import stages

            npad = Wb.shape[1]
            # size the static meet-grid capacity from the TRUE per-song
            # nmeet = round(tend / frame_size) with frame_size =
            # (tend - t0) / (n - 1): a song whose first beat sits late in
            # the file needs nmeet >> n, and clipping it at npad + 128
            # would silently shorten its SVD curve vs the per-song path
            need = npad + 128
            times = np.full((len(onsets_list), npad), 1e18, np.float32)
            for b, o in enumerate(onsets_list):
                t = o.astype(np.float64) * HOP_LENGTH / SR
                times[b, :len(o)] = t
                if len(o) >= 2:
                    fs_ = max((t[-1] - t[0]) / (len(o) - 1), 1e-4)
                    need = max(need, int(round(t[-1] / fs_)) + 8)
            meet_pad = -(-need // 64) * 64
            with stages.stage("lap:profile_batch"):
                X, nmeet = stages.block(laplacian_profile_batch(
                    Wb, lengths, times, self.neigs, meet_pad))
            with stages.stage("lap:readback+curvature"):
                X = np.asarray(X, np.float64)
                nmeet = np.asarray(nmeet)
                outs = []
                for b in range(len(onsets_list)):
                    if lengths[b] < min_beats:
                        outs.append(
                            np.zeros((1, self.m), dtype=np.float32))
                    else:
                        outs.append(
                            self._profile_from_curve(X[b, :nmeet[b]]))
            return outs

        profiles = structural_fused_w_all(
            fs, self.chroma_type, self.wins_per_block, self.K,
            self.niters, self.do_sync, self.downsample_fac,
            fuse_features=("mfcc", "hpcp", "tempogram"),
            tempogram_win=self.tempogram_win, consume=consume)
        Lmax = max(p.shape[0] for p in profiles)
        pad_to = -(-Lmax // self.pad_to_multiple) * self.pad_to_multiple
        arr, lengths = pad_stack(profiles, pad_to)
        return {"profile": arr, "length": lengths.astype(np.int32)}

    def _pair_crp(self, r, c):
        csm = crp.get_csm(r["profile"], c["profile"])
        return crp.csm_to_binary(csm, self.kappa, r["length"], c["length"])

    def tile_scores(self, row: dict, col: dict) -> dict:
        pair = jax.vmap(jax.vmap(self._pair_crp, in_axes=(None, 0)),
                        in_axes=(0, None))
        B = pair(row, col)
        bi, bj, L, _ = B.shape
        S = B.reshape(-1, L, L)
        ml = jnp.broadcast_to(row["length"][:, None], (bi, bj)).reshape(-1)
        nl = jnp.broadcast_to(col["length"][None, :], (bi, bj)).reshape(-1)
        q = alignment.qmax_batch_best(S, ml, nl, backend=self.aligner)
        d = alignment.dmax_batch_best(S, ml, nl, backend=self.aligner)
        denom = jnp.maximum(ml + nl, 1).astype(jnp.float32)
        return {"snovfn_qmax": (q / denom).reshape(bi, bj),
                "snovfn_dmax": (d / denom).reshape(bi, bj)}
