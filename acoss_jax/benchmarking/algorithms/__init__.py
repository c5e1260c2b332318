"""Cover-song scoring algorithms (the reference's L3 subclasses).

Capability map to the reference (SURVEY.md section 2.5):
  Serra09        -> Serra09.py        (qmax/dmax flagship, + ssms_scatter)
  FTM2D          -> FTM2D.py + the noLog/noNorm/zeroPad(Log) ablations
  ChenFusion     -> ChenFusion.py     (blocked-OTI + late SNF)
  EarlySNF       -> EarlySNF.py       (per-pair early SNF)
  EarlyFusion    -> EarlySNF_Old.py   (swconstrained + early/late fusion)
  Simple         -> Simple.py         (SiMPle matrix profile, asymmetric)
  TGAlg          -> Tempogram.py
  ANFScattering  -> ANFScattering.py
  StrucFTM2D     -> StrucFTM2D.py     (sparse fused-W FFT shingles)
  StrucShingles  -> StrucShingles.py
  StrucScattering-> StrucScattering.py
  StrucLaplacian -> StrucLaplacian.py
"""

from acoss_jax.benchmarking.algorithms.anf_scattering import \
    ANFScattering  # noqa: F401
from acoss_jax.benchmarking.algorithms.chen_fusion import \
    ChenFusion  # noqa: F401
from acoss_jax.benchmarking.algorithms.early_fusion import \
    EarlyFusion  # noqa: F401
from acoss_jax.benchmarking.algorithms.early_snf import \
    EarlySNF  # noqa: F401
from acoss_jax.benchmarking.algorithms.ftm2d import FTM2D  # noqa: F401
from acoss_jax.benchmarking.algorithms.serra09 import Serra09  # noqa: F401
from acoss_jax.benchmarking.algorithms.simple import Simple  # noqa: F401
from acoss_jax.benchmarking.algorithms.struc_ftm2d import (  # noqa: F401
    StrucFTM2D, StrucShingles)
from acoss_jax.benchmarking.algorithms.struc_laplacian import \
    StrucLaplacian  # noqa: F401
from acoss_jax.benchmarking.algorithms.struc_scattering import \
    StrucScattering  # noqa: F401
from acoss_jax.benchmarking.algorithms.tempogram import TGAlg  # noqa: F401

ALL_ALGORITHMS = {
    cls.NAME: cls for cls in (
        Serra09, FTM2D, ChenFusion, EarlySNF, EarlyFusion, Simple, TGAlg,
        ANFScattering, StrucFTM2D, StrucShingles, StrucScattering,
        StrucLaplacian)
}
