"""Similarity-math ops (the reference's L2 layer) as batched XLA ops."""

from acoss_jax.ops.crp import (  # noqa: F401
    get_ssm,
    get_csm,
    get_csm_cosine,
    get_oti,
    get_all_shift_scores,
    transpose_chroma,
    get_csm_blocked_oti,
    sliding_window,
    sliding_csm,
    csm_to_binary,
    csm_to_binary_mutual,
    chrompwr,
)
from acoss_jax.ops.alignment import (  # noqa: F401
    qmax,
    dmax,
    swconstrained,
    qmax_batch,
    dmax_batch,
    swconstrained_batch,
    qmax_batch_best,
    dmax_batch_best,
    swconstrained_batch_best,
)
from acoss_jax.ops.curvature import (  # noqa: F401
    get_curv_vectors,
    get_multires_curvature_images,
    get_scale_space_images,
    get_zero_crossings,
)
from acoss_jax.ops.fusion import (  # noqa: F401
    get_P,
    get_S,
    get_W,
    get_WCSM,
    get_WCSMSSM,
    snf,
    snf_ws,
)
from acoss_jax.ops.laplacian import (  # noqa: F401
    meet_matrix,
    random_walk_laplacian_eigs,
    spectral_cluster_sequential,
    symmetric_laplacian_eigs,
    unweighted_laplacian_eigs,
)
from acoss_jax.ops.resize import resize  # noqa: F401
from acoss_jax.ops.scattering import Scattering1D, Scattering2D  # noqa: F401
from acoss_jax.ops.segment import (  # noqa: F401
    stack_memory,
    sync_agg,
    uniform_downsample,
)
