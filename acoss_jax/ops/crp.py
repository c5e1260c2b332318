"""Cross-recurrence-plot math as pure, padded, batch-friendly JAX ops.

JAX re-design of the reference's CRP utilities
(`/root/reference/benchmarking/CRPUtils.py:8-219`). Differences by design:

- Every op is pure and jittable; ragged songs are handled with *static*
  padded shapes plus explicit length arguments, so a whole tile of song
  pairs can be `vmap`-ed and fed to the device at once.
- The reference's `np.argpartition` row-kNN binarization
  (`CRPUtils.py:194`) becomes a rank-threshold formulation
  (k-th smallest per row via `jax.lax.top_k`): identical output up to
  ties, which are measure-zero for real-valued CSMs.
- `sliding_csm`'s per-diagonal cumsum loop (`CRPUtils.py:39-44`) becomes a
  sum of `win` shifted slices (XLA fuses these into one pass).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp


def get_ssm(X: jax.Array, length: jax.Array | None = None) -> jax.Array:
    """Euclidean self-similarity matrix of a point cloud.

    Parity: `CRPUtils.py:48-65` (x^2 + y^2 - 2xy with clamp at 0 and an
    explicitly zeroed diagonal).

    Args:
      X: (N, d) points (rows beyond `length` should be zero padding).
      length: optional scalar count of valid rows; padded rows produce
        garbage distances that callers must mask.
    """
    # One Gram matmul; squared norms come from ITS diagonal rather than a
    # separate row-reduce: within a single matmul, cells with identical
    # input vectors reduce in the same order, so bitwise-equal rows i, j
    # give G[i,i] == G[j,j] == G[i,j] and hence D2 == 0 EXACTLY. (The
    # reference's repeat-padded ssms blocks make duplicate rows routine,
    # `Serra09.py:147-152`, and a mixed-reduction sq leaves ~1e-4 fp32
    # dust there that flips downstream kNN/affinity decisions.)
    G = jnp.matmul(X, X.T, precision="highest")
    sq = jnp.diagonal(G)
    D2 = sq[:, None] + sq[None, :] - 2.0 * G
    D2 = jnp.maximum(D2, 0.0)
    D2 = D2 * (1.0 - jnp.eye(X.shape[0], dtype=D2.dtype))
    return jnp.sqrt(D2)


def get_csm(X: jax.Array, Y: jax.Array) -> jax.Array:
    """Euclidean cross-similarity matrix between rows of X (M,d) and Y (N,d).

    Parity: `CRPUtils.py:67-84`. One matmul plus fused elementwise ops.
    """
    C = (
        jnp.sum(X * X, axis=-1)[:, None]
        + jnp.sum(Y * Y, axis=-1)[None, :]
        - 2.0 * jnp.matmul(X, Y.T, precision="highest")
    )
    return jnp.sqrt(jnp.maximum(C, 0.0))


get_csm_euclidean = get_csm


def get_csm_centered(X: jax.Array, Y: jax.Array) -> jax.Array:
    """`get_csm` after subtracting X's first row from BOTH point clouds.

    Pairwise Euclidean distances are translation-invariant, so this is
    exact in infinite precision — but in fp32 it removes the
    catastrophic cancellation of the x^2 + y^2 - 2xy Gram trick when
    feature norms are large. On the 20736-dim MFCC-SSM scattering
    descriptors (`Serra09.py:186-195`) centering cuts the max CSM error
    vs a float64 oracle from ~5e-4 to ~2e-6 and eliminates kth-neighbor
    flips in the downstream mutual-kNN binarization (measured by
    `scripts/crossimpl_parity.py`). X[0] is used as the shared origin
    because the first row is always a valid (non-padding) block."""
    c = X[0]
    return get_csm(X - c[None, :], Y - c[None, :])


def get_ssm_centered(X: jax.Array) -> jax.Array:
    """`get_ssm` with the same shared-origin trick as
    `get_csm_centered` (exact in infinite precision, far better fp32
    conditioning for large-norm descriptors)."""
    return get_ssm(X - X[0][None, :])


def get_csm_cosine(X: jax.Array, Y: jax.Array) -> jax.Array:
    """Cosine-distance CSM. Parity: `CRPUtils.py:88-107`
    (zero-norm rows treated as norm 1)."""
    xn = jnp.sqrt(jnp.sum(X * X, axis=-1))
    yn = jnp.sqrt(jnp.sum(Y * Y, axis=-1))
    xn = jnp.where(xn == 0, 1.0, xn)
    yn = jnp.where(yn == 0, 1.0, yn)
    return 1.0 - jnp.matmul(
        X / xn[:, None], (Y / yn[:, None]).T, precision="highest")


def get_all_shift_scores(C1: jax.Array, C2: jax.Array) -> jax.Array:
    """Scores of all circular transpositions of C1 against C2.

    scores[s] = sum_b roll(C1, s)[b] * C2[b].  Parity: `CRPUtils.py:109-136`
    inner loop, but computed as one small matmul over the circulant of C1 so
    batches of pairs vectorize.
    """
    n = C1.shape[-1]
    idx = (jnp.arange(n)[None, :] - jnp.arange(n)[:, None]) % n
    # circ[s, b] = C1[(b - s) mod n] = roll(C1, s)[b]
    circ = C1[..., idx]
    return jnp.einsum("...sb,...b->...s", circ, C2, precision="highest")


def get_oti(C1: jax.Array, C2: jax.Array) -> jax.Array:
    """Optimal transposition index of C1 w.r.t. C2 (argmax over shifts).

    Parity: `CRPUtils.py:109-136`.
    """
    return jnp.argmax(get_all_shift_scores(C1, C2), axis=-1)


def transpose_chroma(X: jax.Array, oti: jax.Array, n_chroma: int = 12) -> jax.Array:
    """Circularly shift the chroma axis of X (..., n_chroma) by a traced `oti`.

    jnp.roll with a traced shift lowers to a gather; we instead build the
    permutation indices directly (cheap, fuses).
    """
    idx = (jnp.arange(n_chroma) - oti) % n_chroma
    return jnp.take(X, idx, axis=-1)


def get_csm_blocked_oti(X, Y, C1, C2, csm_fn=get_csm_cosine, n_chroma: int = 12):
    """CSM between stacked chroma blocks after a global OTI applied to X.

    Parity: `CRPUtils.py:138-166` (reshape to (M, blocks, n_chroma), roll the
    chroma axis by the OTI of the *global* chroma vectors, reshape back).
    """
    oti = get_oti(C1, C2)
    M, D = X.shape
    per_block = D // n_chroma
    X1 = X.reshape(M, per_block, n_chroma)
    X1 = transpose_chroma(X1, oti, n_chroma)
    return csm_fn(X1.reshape(M, D), Y)


def sliding_window(X: jax.Array, win: int) -> jax.Array:
    """Delay embedding: (N, d) -> (N - win + 1, d * win).

    Parity: `CRPUtils.py:8-22`. Static `win` stacked slices; XLA fuses the
    concat. Equivalent to librosa's `stack_memory` layout used by ChenFusion.
    """
    N, d = X.shape
    M = N - win + 1
    cols = [jax.lax.dynamic_slice_in_dim(X, i, M, axis=0) for i in range(win)]
    return jnp.concatenate(cols, axis=1)


def sliding_window_padded(X: jax.Array, win: int) -> jax.Array:
    """Like `sliding_window` but keeps the leading dim at N (rows past
    N - win + 1 wrap garbage from zero padding). For use on padded batches
    where the true output length is `length - win + 1`."""
    N, d = X.shape
    Xp = jnp.pad(X, ((0, win - 1), (0, 0)))
    cols = [jax.lax.dynamic_slice_in_dim(Xp, i, N, axis=0) for i in range(win)]
    return jnp.concatenate(cols, axis=1)


def sliding_csm(D: jax.Array, win: int) -> jax.Array:
    """Diagonal windowed RMS: S[i, j] = sqrt(sum_k D[i+k, j+k]^2), k < win.

    The CSM-domain equivalent of a delay embedding.  Parity:
    `CRPUtils.py:24-45` (per-diagonal cumsum); here it is `win` shifted
    slices of D^2 summed — O(win * M * N) fully-vectorized adds.
    Output shape (M - win + 1, N - win + 1).
    """
    M, N = D.shape
    Mo, No = M - win + 1, N - win + 1
    D2 = D * D
    acc = jnp.zeros((Mo, No), dtype=D.dtype)
    for k in range(win):
        acc = acc + jax.lax.dynamic_slice(D2, (k, k), (Mo, No))
    return jnp.sqrt(acc)


def sliding_csm_padded(D: jax.Array, win: int) -> jax.Array:
    """`sliding_csm` keeping the (M, N) shape (rows/cols past
    length - win + 1 are garbage; callers mask by effective lengths)."""
    M, N = D.shape
    D2 = jnp.pad(D * D, ((0, win - 1), (0, win - 1)))
    acc = jnp.zeros((M, N), dtype=D.dtype)
    for k in range(win):
        acc = acc + jax.lax.dynamic_slice(D2, (k, k), (M, N))
    return jnp.sqrt(acc)


def _row_knn_mask(
    D: jax.Array,
    n_neighbs: jax.Array,
    col_valid: jax.Array | None,
    k_static_max: int,
    exact: bool = True,
) -> jax.Array:
    """Per-row k-nearest-neighbor membership via rank threshold.

    B[i, j] = 1 iff D[i, j] is among the `n_neighbs` smallest entries of row i
    (restricted to valid columns).  Matches `np.argpartition`-based selection
    (`CRPUtils.py:194`) up to tie-breaking.

    `k_static_max` is a static upper bound on n_neighbs: only the
    k_static_max smallest values per row are materialized (lax.top_k),
    which is ~10x cheaper than a full row sort for kappa ~ 0.1.
    """
    M, N = D.shape
    big = jnp.asarray(jnp.finfo(D.dtype).max, D.dtype)
    Dm = D if col_valid is None else jnp.where(col_valid[None, :], D, big)
    kmax = min(max(k_static_max, 1), N)
    if exact:
        # lax.top_k of -D: EXACT k smallest, already ascending when negated.
        neg, _ = jax.lax.top_k(-Dm, kmax)
        smallest = -neg
    else:
        # approx_min_k's bin-collision misses can drop arbitrary members
        # of the true kNN set (not just ties) — opt-in for
        # throughput-over-parity runs only (its speed is not measured on
        # the H100).
        smallest, _ = jax.lax.approx_min_k(Dm, kmax, recall_target=0.999)
        smallest = jnp.sort(smallest, axis=1)        # ascending k smallest
    k = jnp.clip(n_neighbs, 1, kmax)
    thresh = jnp.take_along_axis(
        smallest, jnp.broadcast_to(k[None] - 1, (M, 1)), axis=1)
    # n_neighbs == 0 (round(kappa * ncols) of a degenerate short song):
    # the reference selects ZERO neighbors (argpartition[:, 0:0],
    # `CRPUtils.py:194`) — an all-zero CRP, score 0 — so nothing may
    # pass the threshold
    thresh = jnp.where(n_neighbs > 0, thresh,
                       jnp.asarray(-jnp.inf, D.dtype))
    B = (Dm <= thresh).astype(jnp.uint8)
    return B


def csm_to_binary(
    D: jax.Array,
    kappa: float,
    row_length: jax.Array | None = None,
    col_length: jax.Array | None = None,
    exact: bool = True,
) -> jax.Array:
    """Binarize a CSM by per-row nearest neighbors.

    Parity: `CRPUtils.py:169-199`:
      kappa == 0  -> all ones;
      kappa < 1   -> round(kappa * n_cols) neighbors per row (n_cols is the
                     *valid* column count when `col_length` is given);
      kappa >= 1  -> kappa neighbors.

    Padded rows/columns (beyond row_length/col_length) are forced to 0 so a
    downstream aligner never sees a spurious match in the padding.
    """
    M, N = D.shape
    if kappa == 0:
        B = jnp.ones_like(D, dtype=jnp.uint8)
    else:
        ncols = jnp.asarray(N if col_length is None else col_length, jnp.int32)
        if kappa < 1:
            n_neighbs = jnp.round(kappa * ncols).astype(jnp.int32)
            k_static_max = int(round(kappa * N)) + 1
        else:
            n_neighbs = jnp.full((), int(kappa), jnp.int32)
            k_static_max = int(kappa)
        col_valid = None
        if col_length is not None:
            col_valid = jnp.arange(N) < col_length
        B = _row_knn_mask(D, n_neighbs, col_valid, k_static_max, exact)
    if row_length is not None:
        B = B * (jnp.arange(M)[:, None] < row_length).astype(jnp.uint8)
    if col_length is not None:
        B = B * (jnp.arange(N)[None, :] < col_length).astype(jnp.uint8)
    return B


def csm_to_binary_mutual(
    D: jax.Array,
    kappa: float,
    row_length: jax.Array | None = None,
    col_length: jax.Array | None = None,
    exact: bool = True,
) -> jax.Array:
    """Mutual-kNN binarization: AND of row-kNN of D and row-kNN of D^T.

    Parity: `CRPUtils.py:201-219`.
    """
    B1 = csm_to_binary(D, kappa, row_length, col_length, exact)
    B2 = csm_to_binary(D.T, kappa, col_length, row_length, exact)
    return B1 * B2.T


def chrompwr(X: jax.Array, P: float = 0.5, axis: int = -1) -> jax.Array:
    """Raise the profile of chroma columns to a power, preserving norm.

    Parity: the FTM2D helper (`/root/reference/benchmarking/FTM2D.py:9-26`):
    each chroma column is unit-normalized, raised to power P, renormalized,
    then rescaled to its original L2 norm. Zero columns stay zero.
    """
    nX = jnp.sqrt(jnp.sum(X * X, axis=axis, keepdims=True))
    safe = jnp.where(nX == 0, 1.0, nX)
    U = X / safe
    UP = jnp.abs(U) ** P * jnp.sign(U)
    nUP = jnp.sqrt(jnp.sum(UP * UP, axis=axis, keepdims=True))
    nUP = jnp.where(nUP == 0, 1.0, nUP)
    return UP / nUP * nX


def chrompwr_np(X, P: float = 0.5, axis: int = -1):
    """Host-numpy `chrompwr` (descriptor extraction calls this once per
    song; an eager device call would pay a dispatch and a copy each)."""
    import numpy as _np
    X = _np.asarray(X, dtype=_np.float64)
    nX = _np.sqrt(_np.sum(X * X, axis=axis, keepdims=True))
    safe = _np.where(nX == 0, 1.0, nX)
    U = X / safe
    UP = _np.abs(U) ** P * _np.sign(U)
    nUP = _np.sqrt(_np.sum(UP * UP, axis=axis, keepdims=True))
    nUP = _np.where(nUP == 0, 1.0, nUP)
    return UP / nUP * nX
