"""EarlySNF: per-pair early similarity-network fusion + qmax/dmax.

Parity target: `/root/reference/benchmarking/EarlySNF.py:12-97` (extends
Serra09): per pair, build the joint [[W_SSMA, W_CSM], [W_CSM^T, W_SSMB]]
affinity (`get_WCSMSSM`) for the chroma sliding-CSM features and for the
MFCC block-SSM-scattering features, cross-diffuse them (`snf_ws`, K =
kappa * (M + N), niters = 3, reg_diag), negate the fused cross block,
mutual-kNN binarize and run qmax/dmax — while also emitting all the plain
Serra09 similarity types en route (`EarlySNF.py:44-97`).

Design: the whole per-pair fusion (W construction + 3 diffusion
iterations of dense (M+N)^2 matmuls) is vmapped over the tile's pairs —
dense matmul work. Padded layout puts song A's rows at [0:Lp) and song B's at
[Lp:2Lp), so the fused cross block is a static slice.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from acoss_jax.benchmarking.algorithms.serra09 import Serra09
from acoss_jax.ops import crp, fusion


class EarlySNF(Serra09):
    NAME = "EarlySNF"
    # 64 pairs/tile; the best tile size is not measured on the H100
    # (TILE=16 would hold ~8 GB of per-pair SNF temps at covers80 scale)
    TILE = 8

    def __init__(self, chroma_type: str = "hpcp", oti: bool = True,
                 kappa: float = 0.095, m: int = 9,
                 downsample_fac: int = 40, pad_to_multiple: int = 64,
                 snf_niters: int = 3, do_ssms: bool = True,
                 ssm_win_mul: int = 2, ssm_res: int = 64,
                 sequential: bool = True,
                 snf_precision: str = "highest"):
        super().__init__(chroma_type=chroma_type, oti=oti, kappa=kappa,
                         m=m, downsample_fac=downsample_fac,
                         pad_to_multiple=pad_to_multiple, do_ssms=do_ssms,
                         ssm_win_mul=ssm_win_mul, ssm_res=ssm_res)
        self.snf_niters = snf_niters
        # sequential=True pins the reference's in-place SNF update order
        # (`fusion.snf_ws` docstring) for upstream-comparable numbers.
        self.sequential = sequential
        # "highest" is the parity setting; "default" is the reduced-
        # precision diffusion for throughput sweeps (CLI
        # --snf-precision; see `fusion.snf_ws`)
        self.snf_precision = snf_precision
        self.SIMILARITY_TYPES = self.SIMILARITY_TYPES + (
            "snf_qmax", "snf_dmax")

    def _pair_mats(self, r, c):
        """The four per-pair matrices the tile binarizes: chroma sliding
        CSM, mfcc sliding CSM, [ssms CSM,] negated fused SNF cross block
        — in the channel order of `tile_scores`."""
        m = self.m
        if self.oti:
            oti = crp.get_oti(r["gchroma"], c["gchroma"])
            ch1 = crp.transpose_chroma(r["chroma"], oti)
        else:
            ch1 = r["chroma"]
        l1e = r["length"] - m + 1
        l2e = c["length"] - m + 1
        K = (self.kappa * (l1e + l2e)).astype(jnp.int32)

        csm_c = crp.sliding_csm_padded(crp.get_csm(ch1, c["chroma"]), m)
        ssma_c = crp.sliding_csm_padded(crp.get_csm(ch1, ch1), m)
        ssmb_c = crp.sliding_csm_padded(
            crp.get_csm(c["chroma"], c["chroma"]), m)
        # static neighbor bound: K = kappa*(l1e+l2e) <= kappa*(padded
        # effective dims) — turns fusion's row selections into bounded
        # lax.top_k instead of full-width row sorts (bit-identical)
        kmax = int(np.ceil(
            self.kappa * (ssma_c.shape[0] + ssmb_c.shape[0]))) + 1
        def build_w(sa, sb, cab):
            return fusion.get_WCSMSSM(sa, sb, cab, K, m_len=l1e, n_len=l2e,
                                      k_static_max=kmax)
        Ws = [build_w(ssma_c, ssmb_c, csm_c)]
        if self.do_ssms:
            # ssms arrive PRE-CENTERED by tile_crps (tile-shared
            # origin — pair-independent operands; see
            # Serra09._center_ssms), which removes the fp32 Gram
            # cancellation of the 20736-dim scattering norms
            csm_s = crp.get_csm(r["ssms"], c["ssms"])
            ssma_s = crp.get_ssm(r["ssms"])
            ssmb_s = crp.get_ssm(c["ssms"])
            Ws.append(build_w(ssma_s, ssmb_s, csm_s))
        fused = fusion.snf_ws(jnp.stack(Ws), K=K, niters=self.snf_niters,
                              reg_diag=True, sequential=self.sequential,
                              k_static_max=kmax,
                              precision=self.snf_precision)
        Lp = csm_c.shape[0]
        cross = -fused[:Lp, Lp:]   # similarity -> "distance" for binarize

        # plain Serra09 channels "while we're at it" (`EarlySNF.py:60-83`)
        mats = [csm_c]
        csm_m = crp.sliding_csm_padded(
            crp.get_csm_centered(r["mfcc"], c["mfcc"]), m)
        mats.append(csm_m)
        if self.do_ssms:
            mats.append(csm_s)
        mats.append(cross)
        return tuple(mats), l1e, l2e

    def _channels(self) -> list:
        return super()._channels() + ["snf"]

    def _pair_crps(self, r, c):
        """Binary CRPs for one padded pair (the XLA binarize path)."""
        mats, l1e, l2e = self._pair_mats(r, c)
        crps = tuple(crp.csm_to_binary_mutual(M, self.kappa, l1e, l2e)
                     for M in mats)
        return crps, l1e, l2e
