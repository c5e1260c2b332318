"""Shape DNA: isospectral structural descriptors of cover songs.

Parity target: `/root/reference/coverstats/SongStructure.py:45-148`:
chroma + MFCC stacked SSMs -> SNF (K = 1% of N, 5 iters) -> resize 256 ->
random-walk Laplacian EIGENVALUES as the descriptor; cover vs non-cover
Euclidean distances compared with a KS test.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from scipy.stats import ks_2samp

from acoss_jax.data.store import FeatureSet
from acoss_jax.ops import crp, fusion
from acoss_jax.ops.segment import stack_memory, uniform_downsample

#: per-song matrix sizes are padded up to a multiple of this before the
#: jitted device calls, so a whole corpus compiles O(few) distinct
#: programs instead of one per song length (an unpadded per-song loop
#: would compile once per distinct length at covers80 scale)
_SHAPE_BUCKET = 64


@jax.jit
def _ssm_pair(c, mf):
    """(npad, dc)/(npad, dm) zero-padded stacked features -> padded
    SSMs. Zero rows only touch entries outside the valid block, which
    `snf_padded` masks by length."""
    return crp.get_ssm(c), crp.get_ssm(mf)


@functools.partial(
    jax.jit, static_argnames=("dim", "niters", "k_static_max"))
def _dna_device(Dstack, n, K, dim, niters=5, k_static_max=None):
    """SNF over the valid (n, n) block (n, K traced) + traced-length
    resize of the fused affinity to (dim, dim). `k_static_max` bounds K
    per padded-shape group (see `fusion._smallest_sorted`)."""
    from acoss_jax.ops.structure import resize_dynamic_batch

    fused = fusion.snf_padded(Dstack, K, niters=niters, length=n,
                              sequential=True, k_static_max=k_static_max)
    return resize_dynamic_batch(fused[None], jnp.asarray([n]), dim)[0]


def _rw_laplacian_eigvals(W: np.ndarray, neigs: int) -> np.ndarray:
    """Lowest `neigs`+1 generalized eigenvalues of L u = lam D u."""
    d = W.sum(axis=1)
    L = np.diag(d) - W
    sq = np.sqrt(np.maximum(d, 0.0))
    inv = np.where(sq == 0, 1.0, 1.0 / sq)
    LSym = inv[:, None] * L * inv[None, :]
    w = np.linalg.eigvalsh(LSym)
    return w[:neigs + 1]


def get_shape_dna(hpcp: np.ndarray, mfcc: np.ndarray,
                  downsample_fac: int = 10, m: int = 20, dim: int = 256,
                  neigs: int = 30) -> dict:
    """Shape-DNA descriptor of one song (`SongStructure.py:45-75`).

    Args: hpcp (L, 12) and mfcc (L, 13) frames-first.
    Returns {'w': eigenvalues, 'W': fused+resized affinity}.
    """
    chroma = stack_memory(uniform_downsample(hpcp, downsample_fac,
                                             "median"), m, 1)
    mfcc = np.nan_to_num(mfcc, nan=0.0, posinf=0.0, neginf=0.0)
    mf = stack_memory(uniform_downsample(mfcc, downsample_fac, "median"),
                      m, 1)
    n = min(chroma.shape[0], mf.shape[0])
    npad = -(-max(n, 1) // _SHAPE_BUCKET) * _SHAPE_BUCKET
    cpad = np.zeros((npad, chroma.shape[1]), np.float32)
    cpad[:n] = chroma[:n]
    mpad = np.zeros((npad, mf.shape[1]), np.float32)
    mpad[:n] = mf[:n]
    DChroma, DMFCC = _ssm_pair(jnp.asarray(cpad), jnp.asarray(mpad))
    K = max(int(round(n * 0.01)), 2)
    # bound K by the bucket maximum (n <= npad), constant per shape group
    kmax = max(int(round(npad * 0.01)), 2)
    W = np.asarray(_dna_device(jnp.stack([DChroma, DMFCC]),
                               jnp.int32(n), jnp.int32(K), dim,
                               k_static_max=kmax))
    return {"w": _rw_laplacian_eigvals(W, neigs), "W": W}


def shape_dna_study(fs: FeatureSet, chroma_type: str = "hpcp",
                    **kwargs) -> dict:
    """Compute shape DNA for every song and compare cover vs non-cover
    eigenvalue distances (`SongStructure.py:100-148`)."""
    ws, labels = [], []
    for i in range(fs.n_songs):
        h = fs.feature(chroma_type)[i, :fs.length(chroma_type)[i]]
        mf = fs.feature("mfcc_htk")[i, :fs.length("mfcc_htk")[i]]
        ws.append(get_shape_dna(h, mf, **kwargs)["w"])
        labels.append(fs.labels[i])
    ws = np.stack(ws)
    labels = np.asarray(labels)
    D = np.asarray(crp.get_csm(ws.astype(np.float32),
                               ws.astype(np.float32)))
    same = labels[:, None] == labels[None, :]
    off = ~np.eye(len(labels), dtype=bool)
    dcover = D[same & off]
    dfalse = D[~same]
    ks = ks_2samp(dcover, dfalse) if len(dcover) and len(dfalse) else None
    return {"ws": ws, "dcover": dcover, "dfalse": dfalse, "ks": ks}
