"""acoss_jax: cover-song identification benchmarking in JAX.

A ground-up JAX/XLA re-design of the capabilities of `acoss`
(the Audio Cover Song Suite built for the Da-TACOS dataset). Where the
reference is an object-per-song / file-per-song / loop-per-pair CPU
design, this framework is arrays-of-songs and grids-of-pairs:

- ``acoss_jax.ops``            similarity math (CSM/CRP/OTI/SNF/...) as XLA ops
- ``acoss_jax.ops.alignment``  qmax/dmax/Smith-Waterman over batches of pairs
                               (an XLA scan, or CUDA kernels on an NVIDIA GPU)
- ``acoss_jax.features``       batched audio feature extraction in JAX
- ``acoss_jax.data``           bucketed, padded feature store + dataset manifests
- ``acoss_jax.benchmarking``   the pair-grid harness, algorithms, and retrieval
                               evaluation (MR/MRR/MDR/MAP/Top-K)
- ``acoss_jax.parallel``       mesh / shard_map sharding of the N x N pair grid
"""

import os

__version__ = "0.1.0"

#: XLA's persistent compilation cache, at a fixed path inside the checkout
#: (git-ignored) so that repeat runs from the same checkout hit it.
COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def compile_cache_dir() -> str | None:
    """The cache directory this package sets: None when
    JAX_COMPILATION_CACHE_DIR is set (JAX then uses that directory and
    nothing is set in code), else `COMPILE_CACHE_DIR`."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return COMPILE_CACHE_DIR


def _enable_persistent_compile_cache() -> None:
    path = compile_cache_dir()
    if path is not None:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)


_enable_persistent_compile_cache()
