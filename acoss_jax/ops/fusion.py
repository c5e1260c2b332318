"""Similarity Network Fusion (SNF) as dense batched XLA ops.

JAX re-design of the reference's SNF library
(`/root/reference/benchmarking/SimilarityFusion.py:50-287`, after Wang et
al. 2012/2014 and Tralie et al. ICASSP 2019). The reference uses
scipy.sparse row-kNN matrices; here every matrix stays dense (P is a few
hundred to a few thousand square) so the cross-diffusion iterations
`P_i <- S_i . mean(P_k, k != i) . S_i^T` are straight dense matmuls, batched
over song pairs with `vmap`.

kNN selections use rank thresholds (k-th order statistic per row) instead
of `np.argpartition`; identical up to ties, and `k` may be a traced value
(EarlySNF's K = kappa * (M + N) depends on per-pair lengths).

Padding convention: a `length` argument marks the valid prefix; padded
rows/cols are excluded from neighbor statistics and forced to W = 0, which
propagates as exact zeros through get_P / get_S / diffusion (zero rows are
row-normalized by 1).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_BIG = 1e30


def _host_int(x) -> int | None:
    """x as a Python int when it is a host scalar, else None (traced)."""
    return int(x) if isinstance(x, (int, np.integer)) else None


def _smallest_sorted(D: jax.Array, k_static_max: int | None) -> jax.Array:
    """Ascending per-row smallest values.

    With a static bound k < N, only the exact k smallest values per row
    are materialized via `lax.top_k` — a bounded partial selection instead
    of a full-width row sort (the same values in the same
    ascending order, so every consumer below is bit-identical). Without a
    bound (or bound >= N) this is a plain row sort.
    """
    N = D.shape[1]
    if k_static_max is None or k_static_max >= N:
        return jnp.sort(D, axis=1)
    neg, _ = jax.lax.top_k(-D, max(int(k_static_max), 1))
    return -neg


def _kth_smallest(D: jax.Array, k: jax.Array,
                  k_static_max: int | None = None) -> jax.Array:
    """Per-row k-th smallest value (1-indexed), k may be traced. (M, 1).

    `k_static_max` is a STATIC upper bound on every runtime k; when given,
    runtime k values above it are clamped to it (callers own the bound).
    """
    M = D.shape[0]
    srt = _smallest_sorted(D, k_static_max)
    kk = jnp.clip(jnp.broadcast_to(k, (M,)), 1, srt.shape[1])
    return jnp.take_along_axis(srt, kk[:, None] - 1, axis=1)


def _mean_k_smallest(D: jax.Array, k: jax.Array,
                     k_static_max: int | None = None) -> jax.Array:
    """Per-row mean of the k smallest values, k possibly traced. (M,)."""
    M = D.shape[0]
    srt = _smallest_sorted(D, k_static_max)
    kk = jnp.clip(jnp.broadcast_to(k, (M,)), 1, srt.shape[1])
    csum = jnp.cumsum(srt, axis=1)
    tot = jnp.take_along_axis(csum, kk[:, None] - 1, axis=1)[:, 0]
    return tot / kk.astype(D.dtype)


def get_W(D: jax.Array, K, Mu: float = 0.5,
          length: jax.Array | None = None,
          k_static_max: int | None = None) -> jax.Array:
    """Adaptive-bandwidth Gaussian affinity from a self-dissimilarity matrix.

    Parity: `SimilarityFusion.py:50-71` (Eq. 1 of the SNF paper): symmetrize,
    zero diagonal, estimate per-point radius as the mean of the K+1 smallest
    row entries (scaled by (K+1)/K to exclude the diagonal zero),
    W = exp(-D^2 / (2 (Mu * (r_i + r_j + D_ij) / 3)^2)).

    `k_static_max`: static upper bound on runtime K (auto-derived when K is
    a host int) — bounds the neighbor selection to a `lax.top_k` instead of
    a full row sort, bit-identically (see `_smallest_sorted`).
    """
    if k_static_max is None:
        k_static_max = _host_int(K)
    n = D.shape[0]
    DSym = 0.5 * (D + D.T)
    DSym = DSym * (1.0 - jnp.eye(n, dtype=D.dtype))
    K = jnp.asarray(K, jnp.int32)
    if length is not None:
        valid = jnp.arange(n) < length
        Dknn = jnp.where(valid[None, :], DSym, _BIG)
    else:
        valid = None
        Dknn = DSym
    mean_dist = _mean_k_smallest(
        Dknn, K + 1,
        None if k_static_max is None else k_static_max + 1,
    ) * (K + 1) / jnp.maximum(K, 1)
    eps = (mean_dist[:, None] + mean_dist[None, :] + DSym) / 3.0
    denom = 2.0 * (Mu * eps) ** 2
    denom = jnp.where(denom == 0, 1.0, denom)
    W = jnp.exp(-DSym ** 2 / denom)
    if valid is not None:
        W = W * (valid[:, None] & valid[None, :])
    return W


def get_WCSM(CSMAB: jax.Array, k1, k2, Mu: float = 0.5,
             row_length: jax.Array | None = None,
             col_length: jax.Array | None = None,
             k_static_max: int | None = None) -> jax.Array:
    """Exponential affinity for a CROSS-dissimilarity matrix.

    Parity: `SimilarityFusion.py:74-89`: row radius = mean of k2 smallest in
    the row; column radius = mean of k1 smallest in the column.

    `k_static_max`: static upper bound on max(k1, k2) at runtime
    (auto-derived when both are host ints); see `get_W`.
    """
    if k_static_max is None:
        b1, b2 = _host_int(k1), _host_int(k2)
        if b1 is not None and b2 is not None:
            k_static_max = max(b1, b2)
    M, N = CSMAB.shape
    C = CSMAB
    if col_length is not None:
        C = jnp.where(jnp.arange(N)[None, :] < col_length, C, _BIG)
    if row_length is not None:
        C = jnp.where(jnp.arange(M)[:, None] < row_length, C, _BIG)
    m1 = _mean_k_smallest(C, jnp.asarray(k2, jnp.int32),
                          k_static_max)                         # rows
    m2 = _mean_k_smallest(C.T, jnp.asarray(k1, jnp.int32),
                          k_static_max)                         # cols
    eps = (m1[:, None] + m2[None, :] + CSMAB) / 3.0
    denom = 2.0 * (Mu * eps) ** 2
    # zero-denominator guard, same convention as get_W: an exactly-zero
    # cross block (degenerate all-zero descriptors) yields affinity 1,
    # not NaN. The reference guards get_W but not get_WCSM
    # (`SimilarityFusion.py:68` vs `:89`) — there a zero block NaNs and
    # poisons the whole SNF; we deviate only on those inputs.
    denom = jnp.where(denom == 0, 1.0, denom)
    W = jnp.exp(-CSMAB ** 2 / denom)
    if row_length is not None:
        W = W * (jnp.arange(M)[:, None] < row_length)
    if col_length is not None:
        W = W * (jnp.arange(N)[None, :] < col_length)
    return W


def setup_WCSMSSM(WSSMA, WSSMB, WCSMAB):
    """Assemble [[WSSMA, WCSMAB], [WCSMAB^T, WSSMB]]
    (`SimilarityFusion.py:91-108`)."""
    top = jnp.concatenate([WSSMA, WCSMAB], axis=1)
    bot = jnp.concatenate([WCSMAB.T, WSSMB], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def get_WCSMSSM(SSMA, SSMB, CSMAB, K, Mu: float = 0.5,
                m_len=None, n_len=None,
                k_static_max: int | None = None):
    """Cross-affinity parent matrix with the neighbor budget split
    proportionally between the SSM and CSM parts of each row.

    Parity: `SimilarityFusion.py:110-132`:
      k1 = K * M / (M + N); k2 = K - k1  (true lengths when padded).
    Padded layout: A occupies [0:Lp), B occupies [Lp:2Lp) (real prefix of
    each), so the fused cross block is always at [0:Lp, Lp:2Lp).

    `k_static_max`: static upper bound on runtime K (auto-derived when K
    is a host int); k1, k2 <= K so it bounds every inner selection.
    """
    if k_static_max is None:
        k_static_max = _host_int(K)
    M = SSMA.shape[0]
    N = SSMB.shape[0]
    m = jnp.asarray(M if m_len is None else m_len, jnp.int32)
    n = jnp.asarray(N if n_len is None else n_len, jnp.int32)
    K = jnp.asarray(K, jnp.int32)
    k1 = (K * m) // jnp.maximum(m + n, 1)
    k2 = K - k1
    WSSMA = get_W(SSMA, k1, Mu, length=None if m_len is None else m,
                  k_static_max=k_static_max)
    WSSMB = get_W(SSMB, k2, Mu, length=None if n_len is None else n,
                  k_static_max=k_static_max)
    WCSMAB = get_WCSM(CSMAB, k1, k2, Mu,
                      None if m_len is None else m,
                      None if n_len is None else n,
                      k_static_max=k_static_max)
    return setup_WCSMSSM(WSSMA, WSSMB, WCSMAB)


def get_P(W: jax.Array, reg_diag: bool = False) -> jax.Array:
    """Row-stochastic matrix; optional 0.5 I + 0.5 P(off-diag) diagonal
    regularization (`SimilarityFusion.py:134-155`)."""
    n = W.shape[0]
    if reg_diag:
        WNoDiag = W * (1.0 - jnp.eye(n, dtype=W.dtype))
        row = jnp.sum(WNoDiag, axis=1)
        row = jnp.where(row == 0, 1.0, row)
        return 0.5 * jnp.eye(n, dtype=W.dtype) + 0.5 * WNoDiag / row[:, None]
    row = jnp.sum(W, axis=1)
    row = jnp.where(row == 0, 1.0, row)
    return W / row[:, None]


def get_S(W: jax.Array, K, k_static_max: int | None = None) -> jax.Array:
    """Row-kNN-truncated, L1-row-normalized version of W (kept dense — the
    accelerator prefers a dense masked matmul over sparse ops).

    Parity: `SimilarityFusion.py:157-177` (neighbors include the element
    itself); kNN by rank threshold (ties may keep a few extra entries).
    """
    if k_static_max is None:
        k_static_max = _host_int(K)
    n = W.shape[0]
    K = jnp.asarray(K, jnp.int32)
    thresh = -_kth_smallest(-W, K, k_static_max)  # k-th LARGEST per row
    mask = W >= thresh
    V = jnp.where(mask, W, 0.0)
    norm = jnp.sum(V, axis=1)
    norm = jnp.where(norm == 0, 1.0, norm)
    return V / norm[:, None]


def snf_ws(Ws: jax.Array, K, niters: int = 20,
           reg_diag: bool = True, sequential: bool = False,
           k_static_max: int | None = None,
           precision: str = "highest") -> jax.Array:
    """Cross-diffusion of a stack of affinity matrices.

    Parity: `SimilarityFusion.py:202-277`:
      P_i <- S_i . mean(P_k, k != i) . S_i^T  for `niters` iterations,
      then average. With reg_diag, each iterate is re-regularized as
      0.5 I + 0.5 rownorm(offdiag).

    Update order: the default is a JACOBI sweep (every P_i advances from
    the previous iterate — the update rule the SNF paper states). The
    reference deviates from its own rule by an aliasing artifact: after
    iteration 1 it rebinds `Pts = nextPts` (`SimilarityFusion.py:272`), so
    iterations >= 2 update the matrices IN PLACE in index order
    (Gauss-Seidel-like) — P_i sees already-updated P_j for j < i. Pass
    `sequential=True` to replicate that behavior bit-for-bit on parity
    runs (iteration 1 Jacobi, iterations >= 2 sequential).

    Args:
      Ws: (F, n, n) stacked affinity matrices.
      K: neighbors for the S truncation (may be traced).
      k_static_max: static upper bound on runtime K (auto-derived when K
        is a host int) — see `get_W`.
      precision: matmul precision of the diffusion einsums. The default
        "highest" is the parity setting (fp32-accurate);
        "default" (TF32 inputs on the GPU, fp32 accumulation; its speed
        is not measured on the H100) is a THROUGHPUT mode for large
        sweeps — like the quantized streams,
        not for full-precision parity runs (retrieval-stat invariance
        is pinned by tests/test_fusion_bounded.py).
    Returns: fused (n, n) similarity matrix.
    """
    if k_static_max is None:
        k_static_max = _host_int(K)
    return _snf_ws_impl(Ws, K, niters=niters, reg_diag=reg_diag,
                        sequential=sequential, k_static_max=k_static_max,
                        precision=precision)


@functools.partial(
    jax.jit,
    static_argnames=("niters", "reg_diag", "sequential", "k_static_max",
                     "precision"))
def _snf_ws_impl(Ws: jax.Array, K, niters: int = 20,
                 reg_diag: bool = True, sequential: bool = False,
                 k_static_max: int | None = None,
                 precision: str = "highest") -> jax.Array:
    Ws = jnp.asarray(Ws)
    F = Ws.shape[0]
    Ps = jax.vmap(lambda W: get_P(W, reg_diag))(Ws)
    Ss = jax.vmap(lambda W: get_S(W, K, k_static_max))(Ws)

    def diffuse(S_i, mean_others):
        nxt = jnp.einsum("ij,jk,lk->il", S_i, mean_others, S_i,
                         precision=precision)
        return get_P(nxt, True) if reg_diag else nxt

    def body_jacobi(Ps, _):
        mean_others = (jnp.sum(Ps, axis=0)[None] - Ps) / max(F - 1, 1)
        return jax.vmap(diffuse)(Ss, mean_others), None

    def body_seq(Ps, _):
        for i in range(F):
            mean_others = (jnp.sum(Ps, axis=0) - Ps[i]) / max(F - 1, 1)
            Ps = Ps.at[i].set(diffuse(Ss[i], mean_others))
        return Ps, None

    if sequential and niters > 0:
        Ps, _ = body_jacobi(Ps, None)
        Ps, _ = jax.lax.scan(body_seq, Ps, None, length=niters - 1)
    else:
        Ps, _ = jax.lax.scan(body_jacobi, Ps, None, length=niters)
    return jnp.mean(Ps, axis=0)


def snf(Ds, K=5, niters: int = 20, reg_diag: bool = True,
        sequential: bool = False, k_static_max: int | None = None):
    """Full SNF from a stack of DISTANCE matrices
    (`SimilarityFusion.py:279-287`): W each, then cross-diffuse.

    Returns (Ws, fused similarity matrix).
    """
    if k_static_max is None:
        k_static_max = _host_int(K)
    return _snf_impl(Ds, K, niters=niters, reg_diag=reg_diag,
                     sequential=sequential, k_static_max=k_static_max)


@functools.partial(
    jax.jit,
    static_argnames=("niters", "reg_diag", "sequential", "k_static_max"))
def _snf_impl(Ds, K=5, niters: int = 20, reg_diag: bool = True,
              sequential: bool = False, k_static_max: int | None = None):
    Ds = jnp.asarray(Ds)
    Ws = jax.vmap(lambda D: get_W(D, K, k_static_max=k_static_max))(Ds)
    return Ws, _snf_ws_impl(Ws, K=K, niters=niters, reg_diag=reg_diag,
                            sequential=sequential,
                            k_static_max=k_static_max)


def snf_padded(Ds: jax.Array, K, niters: int = 20, reg_diag: bool = True,
               length=None, sequential: bool = False,
               k_static_max: int | None = None):
    """`snf` over zero-padded distance matrices with a valid-prefix length:
    affinities are masked to the valid block (zero rows/cols propagate
    exactly through get_P/get_S/diffusion). One compile per padded shape —
    use with bucket-padded inputs so a whole corpus compiles O(few) shapes
    instead of one per song."""
    if k_static_max is None:
        k_static_max = _host_int(K)
    return _snf_padded_impl(Ds, K, niters=niters, reg_diag=reg_diag,
                            length=length, sequential=sequential,
                            k_static_max=k_static_max)


@functools.partial(
    jax.jit,
    static_argnames=("niters", "reg_diag", "sequential", "k_static_max"))
def _snf_padded_impl(Ds: jax.Array, K, niters: int = 20,
                     reg_diag: bool = True, length=None,
                     sequential: bool = False,
                     k_static_max: int | None = None):
    Ds = jnp.asarray(Ds)
    K = jnp.asarray(K, jnp.int32)
    Ws = jax.vmap(lambda D: get_W(D, K, length=length,
                                  k_static_max=k_static_max))(Ds)
    return _snf_ws_impl(Ws, K=K, niters=niters, reg_diag=reg_diag,
                        sequential=sequential, k_static_max=k_static_max)
