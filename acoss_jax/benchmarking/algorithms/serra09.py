"""Serra 2009 Qmax/Dmax — the flagship alignment algorithm.

Parity target: `/root/reference/benchmarking/Serra09.py:73-196`:
- global chroma for OTI (`Serra09.py:102`, `get_oti` over 12 shifts);
- chroma median-downsampled x40, mfcc mean-downsampled x40, both truncated
  to the common length N (`Serra09.py:104-114`);
- per pair: OTI-roll -> Euclidean CSM -> sliding_csm(m=9) ->
  mutual-kNN binarize (kappa=0.095) -> qmax & dmax, normalized by (M + N)
  (`Serra09.py:158-196`).

Design: descriptors are padded (N_songs, L, d) arrays; a (bi x bj) tile
of the pair grid builds all its binary CRPs with ONE nested-vmap (CSM
matmul, top-k binarization) and runs ONE batched qmax/dmax aligner call
over the 2 x bi x bj stacked CRPs (chroma + mfcc share the alignment
batch).

The ssms_scatter_{qmax,dmax} similarity types use the MFCC block-SSM
2D-scattering descriptors of `Serra09.py:30-71` (see
`acoss_jax.ops.ssm_features`); they are heavy (20736-dim per block), so
`do_ssms` defaults to False here — EarlySNF and reference-parity runs
enable it.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from acoss_jax.benchmarking.harness import CoverAlgorithm
from acoss_jax.data.store import FeatureSet, pad_stack
from acoss_jax.ops import alignment, crp
from acoss_jax.ops.segment import (uniform_downsample,
                                    uniform_downsample_batch)
from acoss_jax.ops.ssm_features import build_ssms_device


def global_chroma(chroma: np.ndarray) -> np.ndarray:
    """Sum over frames, normalized by its max (`Serra09.py:24-29`)."""
    s = chroma.sum(axis=0)
    return s / max(s.max(), 1e-12)


class Serra09(CoverAlgorithm):
    NAME = "Serra09"
    SYMMETRIC = True
    TILE = 8

    def __init__(self, chroma_type: str = "hpcp", oti: bool = True,
                 kappa: float = 0.095, m: int = 9,
                 downsample_fac: int = 40, pad_to_multiple: int = 64,
                 do_ssms: bool = False, ssm_win_mul: int = 2,
                 ssm_res: int = 64):
        self.chroma_type = chroma_type
        self.oti = oti
        self.kappa = kappa
        self.m = m
        self.downsample_fac = downsample_fac
        self.pad_to_multiple = pad_to_multiple
        self.do_ssms = do_ssms
        self.ssm_win_mul = ssm_win_mul
        self.ssm_res = ssm_res
        self.SIMILARITY_TYPES = ("chroma_qmax", "chroma_dmax",
                                 "mfcc_qmax", "mfcc_dmax")
        if do_ssms:
            self.SIMILARITY_TYPES += ("ssms_scatter_qmax",
                                      "ssms_scatter_dmax")

    def extract_descriptors(self, fs: FeatureSet) -> dict:
        chromas, mfccs, gchromas, full_mfccs = [], [], [], []
        clen = fs.length(self.chroma_type)
        mlen = fs.length("mfcc_htk")
        chs = [fs.feature(self.chroma_type)[i, :clen[i]]
               for i in range(fs.n_songs)]
        mfs = [np.nan_to_num(fs.feature("mfcc_htk")[i, :mlen[i]],
                             nan=0.0, posinf=0.0, neginf=0.0)
               for i in range(fs.n_songs)]
        # whole-corpus x40 downsample in a few batched device calls
        ch_all = uniform_downsample_batch(chs, self.downsample_fac,
                                          "median")
        mf_all = uniform_downsample_batch(mfs, self.downsample_fac,
                                          "mean")
        for i in range(fs.n_songs):
            gchromas.append(global_chroma(chs[i]))
            ch_ds, mf_ds = ch_all[i], mf_all[i]
            n = min(ch_ds.shape[0], mf_ds.shape[0])
            chromas.append(ch_ds[:n].astype(np.float32))
            mfccs.append(mf_ds[:n].astype(np.float32))
            if self.do_ssms:
                full_mfccs.append(
                    np.asarray(mfs[i][:n * self.downsample_fac],
                               np.float32))
        # Pad to a multiple of 64 so a corpus compiles few tile shapes.
        Lmax = max(c.shape[0] for c in chromas)
        pad_to = -(-Lmax // self.pad_to_multiple) * self.pad_to_multiple
        chroma_arr, lengths = pad_stack(chromas, pad_to)
        mfcc_arr, _ = pad_stack(mfccs, pad_to)
        desc = {
            "chroma": chroma_arr,
            "mfcc": mfcc_arr,
            "gchroma": np.stack(gchromas).astype(np.float32),
            "length": lengths.astype(np.int32),
        }
        if self.do_ssms:
            # sequences of scattered MFCC block-SSMs, length-matched to
            # M = n - m + 1 (`Serra09.py:126,146-152`), built DEVICE-
            # RESIDENT: at 20736 dims per block the corpus must feed the
            # device-resident sweep without a host round trip
            # (`ops.ssm_features.build_ssms_device`).
            desc["ssms"] = build_ssms_device(
                full_mfccs,
                [max(int(n) - self.m + 1, 1) for n in lengths],
                pad_to, self.downsample_fac,
                self.m * self.ssm_win_mul, self.ssm_res)
        return desc

    def _pair_crps(self, r, c):
        """Binary CRPs (chroma + mfcc) for ONE pair of padded songs."""
        m = self.m
        if self.oti:
            oti = crp.get_oti(r["gchroma"], c["gchroma"])
            ch1 = crp.transpose_chroma(r["chroma"], oti)
        else:
            ch1 = r["chroma"]
        l1e = r["length"] - m + 1
        l2e = c["length"] - m + 1

        def make(x1, x2, sliding, centered=False):
            csm = (crp.get_csm_centered if centered else crp.get_csm)(
                x1, x2)
            if sliding:
                csm = crp.sliding_csm_padded(csm, m)
            return crp.csm_to_binary_mutual(csm, self.kappa, l1e, l2e)

        Bc = make(ch1, c["chroma"], True)
        # mfcc centered: HTK MFCCs carry a large leading energy term on
        # real audio, the classic fp32 Gram-cancellation case
        Bm = make(r["mfcc"], c["mfcc"], True, centered=True)
        if self.do_ssms:
            # ssms rows are already length-matched to M = n - m + 1, so the
            # effective lengths are the same l1e/l2e; no sliding CSM
            # (`Serra09.py:188-195`). The ssms arrays arrive PRE-CENTERED
            # by tile_crps (tile-shared origin): per-pair centering
            # under the nested vmap would materialize a
            # (pairs, L, 20736) tensor — 38 GB at Da-TACOS dims.
            csm = crp.get_csm(r["ssms"], c["ssms"])
            Bs = crp.csm_to_binary_mutual(csm, self.kappa, l1e, l2e)
            return (Bc, Bm, Bs), l1e, l2e
        return (Bc, Bm), l1e, l2e

    def _center_ssms(self, row: dict, col: dict):
        """Subtract a TILE-SHARED origin (the first row song's first
        block) from both sides' ssms. Pairwise distances are translation
        invariant, so this is exact in infinite precision while removing
        the fp32 x^2+y^2-2xy Gram cancellation of the large-norm
        scattering vectors (see `crp.get_csm_centered`); a tile-shared
        constant keeps the centered operands PAIR-INDEPENDENT, so XLA
        materializes one copy per tile instead of one per pair."""
        c0 = row["ssms"][0, 0]
        row = dict(row)
        col = dict(col)
        row["ssms"] = row["ssms"] - c0[None, None, :]
        col["ssms"] = col["ssms"] - c0[None, None, :]
        return row, col

    def _channels(self) -> list:
        """Channel names, in the order of `_pair_crps`'s CRPs."""
        return ["chroma", "mfcc"] + (["ssms_scatter"] if self.do_ssms
                                     else [])

    def tile_crps(self, row: dict, col: dict):
        """(CRPs, one (bi, bj, L, L) stack per channel; l1e; l2e) of one
        tile: what `tile_scores` aligns."""
        if self.do_ssms:
            row, col = self._center_ssms(row, col)
        pair = jax.vmap(jax.vmap(self._pair_crps, in_axes=(None, 0)),
                        in_axes=(0, None))
        return pair(row, col)

    def crp_scores(self, Bs, l1e, l2e) -> dict:
        """Normalized qmax / dmax scores of a tile's CRPs, per channel."""
        nf = len(Bs)
        bi, bj, L, _ = Bs[0].shape
        S = jnp.concatenate([B.reshape(-1, L, L) for B in Bs])
        ml = jnp.tile(l1e.reshape(-1), nf)
        nl = jnp.tile(l2e.reshape(-1), nf)
        q = alignment.qmax_batch_best(S, ml, nl, backend=self.aligner)
        d = alignment.dmax_batch_best(S, ml, nl, backend=self.aligner)
        denom = jnp.maximum(ml + nl, 1).astype(jnp.float32)
        q = (q / denom).reshape(nf, bi, bj)
        d = (d / denom).reshape(nf, bi, bj)
        out = {}
        for k, name in enumerate(self._channels()):
            out[f"{name}_qmax"] = q[k]
            out[f"{name}_dmax"] = d[k]
        return out

    def tile_scores(self, row: dict, col: dict) -> dict:
        return self.crp_scores(*self.tile_crps(row, col))
