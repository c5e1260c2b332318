"""TGAlg: tempogram qmax/dmax.

Parity target: `/root/reference/benchmarking/Tempogram.py:13-70`:
autocorrelation tempograms of the RNN and superflux novelty functions,
mean-downsampled x40 (`Tempogram.py:38-51`); pair score: Euclidean CSM ->
csm_to_binary (non-mutual) -> qmax/dmax / (M + N) (`Tempogram.py:53-70`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from acoss_jax.benchmarking.harness import CoverAlgorithm
from acoss_jax.data.store import FeatureSet, pad_stack
from acoss_jax.features.rhythm import tempogram_aggregated_batch
from acoss_jax.ops import alignment, crp


class TGAlg(CoverAlgorithm):
    NAME = "TGAlg"
    SIMILARITY_TYPES = ("tempogram_rnn_qmax", "tempogram_rnn_dmax",
                        "tempogram_sflux_qmax", "tempogram_sflux_dmax")
    SYMMETRIC = True
    TILE = 8

    def __init__(self, kappa: float = 0.095, downsample_fac: int = 40,
                 win_length: int = 384, pad_to_multiple: int = 64):
        self.kappa = kappa
        self.downsample_fac = downsample_fac
        self.win_length = win_length
        self.pad_to_multiple = pad_to_multiple

    def extract_descriptors(self, fs: FeatureSet) -> dict:
        envs, bounds = [], []
        nlen = fs.length("novfn")
        slen = fs.length("snovfn")
        for name, ln in (("novfn", nlen), ("snovfn", slen)):
            for i in range(fs.n_songs):
                envs.append(fs.feature(name)[i, :ln[i], 0])
                bounds.append(np.arange(0, ln[i], self.downsample_fac))
        tgs = [t.astype(np.float32) for t in
               tempogram_aggregated_batch(envs, bounds, self.win_length)]
        rnn, sflux = tgs[:fs.n_songs], tgs[fs.n_songs:]
        Lmax = max(x.shape[0] for x in rnn + sflux)
        pad_to = -(-Lmax // self.pad_to_multiple) * self.pad_to_multiple
        rnn_arr, rlen = pad_stack(rnn, pad_to)
        sflux_arr, slen2 = pad_stack(sflux, pad_to)
        return {"rnn": rnn_arr, "sflux": sflux_arr,
                "rnn_len": rlen.astype(np.int32),
                "sflux_len": slen2.astype(np.int32)}

    def _pair_crps(self, r, c):
        out = []
        for key, lkey in (("rnn", "rnn_len"), ("sflux", "sflux_len")):
            # centered: tempogram rows are highly correlated, so pair
            # distances are small against their norms and the plain fp32
            # Gram loses ~5e-4 — above the smallest kth-neighbor margins
            # (see crp.get_csm_centered / scripts/crossimpl_parity.py)
            csm = crp.get_csm_centered(r[key], c[key])
            out.append(crp.csm_to_binary(csm, self.kappa, r[lkey], c[lkey]))
        return tuple(out), (r["rnn_len"], r["sflux_len"]), \
            (c["rnn_len"], c["sflux_len"])

    def tile_scores(self, row: dict, col: dict) -> dict:
        pair = jax.vmap(jax.vmap(self._pair_crps, in_axes=(None, 0)),
                        in_axes=(0, None))
        Bs, l1s, l2s = pair(row, col)
        bi, bj, L, _ = Bs[0].shape
        S = jnp.concatenate([B.reshape(-1, L, L) for B in Bs])
        ml = jnp.concatenate([x.reshape(-1) for x in l1s])
        nl = jnp.concatenate([x.reshape(-1) for x in l2s])
        q = alignment.qmax_batch_best(S, ml, nl, backend=self.aligner)
        d = alignment.dmax_batch_best(S, ml, nl, backend=self.aligner)
        denom = jnp.maximum(ml + nl, 1).astype(jnp.float32)
        q = (q / denom).reshape(2, bi, bj)
        d = (d / denom).reshape(2, bi, bj)
        return {"tempogram_rnn_qmax": q[0], "tempogram_rnn_dmax": d[0],
                "tempogram_sflux_qmax": q[1], "tempogram_sflux_dmax": d[1]}
