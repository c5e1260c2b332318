"""StrucScattering: 2D scattering of the fused structural W.

Parity target: `/root/reference/benchmarking/StrucScattering.py:35-199`
(torch kymatio backend replaced by `acoss_jax.ops.scattering`): fused W of
all three feature stacks, anti-aliased resize to 512x512, Scattering2D
(J=6, L=8), optional per-path L2 normalization, flattened descriptor;
similarity exp(-||s1 - s2||^2) via one dense Gram
(`StrucScattering.py:181-199`).
"""

from __future__ import annotations


import jax.numpy as jnp
import numpy as np

from acoss_jax.benchmarking.algorithms.struct_common import (
    structural_fused_w, structural_fused_w_all)
from acoss_jax.benchmarking.harness import CoverAlgorithm
from acoss_jax.data.store import FeatureSet
from acoss_jax.ops.resize import resize
from acoss_jax.ops.scattering import Scattering2D
from acoss_jax.ops.structure import resize_dynamic_batch


class StrucScattering(CoverAlgorithm):
    NAME = "StrucScattering"
    SIMILARITY_TYPES = ("main",)
    SYMMETRIC = True

    def __init__(self, chroma_type: str = "hpcp", wins_per_block: int = 20,
                 K: int = 10, niters: int = 10, norm_per_path: bool = True,
                 final_size: int = 512, J: int = 6, L: int = 8,
                 do_sync: bool = True, downsample_fac: int = 40,
                 tempogram_win: int = 384):
        self.chroma_type = chroma_type
        self.wins_per_block = wins_per_block
        self.K = K
        self.niters = niters
        self.norm_per_path = norm_per_path
        self.final_size = final_size
        self.do_sync = do_sync
        self.downsample_fac = downsample_fac
        self.tempogram_win = tempogram_win
        self.scattering = Scattering2D((final_size, final_size), J=J, L=L)

    def extract_descriptors(self, fs: FeatureSet) -> dict:
        """Batched: fused W, traced-length anti-aliased resize, 2D
        scattering and per-path normalization run on device per song
        chunk; only the flat descriptors cross back to the host."""

        # Scattering2D at 512^2 holds ~0.5-1 GB of U1/order-2 complex
        # temps per song, so one song per dispatch at 512 (the best
        # batch is not measured on the H100); small test sizes batch up.
        sub = max(1, (128 // self.final_size) ** 2)

        def consume(Wb, lengths, onsets_list):
            Wr = resize_dynamic_batch(Wb, lengths,
                                      self.final_size)   # (B, f, f)
            outs = []
            for lo in range(0, Wr.shape[0], sub):
                S = self.scattering(Wr[lo:lo + sub])     # (b, paths, m, m)
                if self.norm_per_path:
                    norms = jnp.sqrt(jnp.sum(S * S, axis=(-2, -1),
                                             keepdims=True))
                    S = S / jnp.where(norms == 0, 1.0, norms)
                Sh = np.asarray(S, dtype=np.float32)
                outs.extend(Sh[b].ravel() for b in range(Sh.shape[0]))
            return outs

        shingles = structural_fused_w_all(
            fs, self.chroma_type, self.wins_per_block, self.K,
            self.niters, self.do_sync, self.downsample_fac,
            fuse_features=("mfcc", "hpcp", "tempogram"),
            tempogram_win=self.tempogram_win, consume=consume)
        return {"shingle": np.stack(shingles)}

    def full_scores(self, desc: dict) -> dict:
        from acoss_jax.benchmarking.algorithms.ftm2d import _gram_exp
        return {"main": np.array(_gram_exp(jnp.asarray(desc["shingle"])),
                                 dtype=np.float32)}
