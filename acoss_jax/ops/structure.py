"""Batched, device-resident structural-descriptor pipeline.

The reference computes its Struc* descriptors one song at a time on the
host: delay-embedded feature stacks -> SSM/CSM distance matrices -> SNF
(`/root/reference/benchmarking/StrucFTM2D.py:50-158`,
`StrucLaplacian.py:59-164`, `StrucScattering.py:35-150`), plus 9 separate
50-init sklearn KMeans fits per song for the Laplacian variant
(`Laplacian.py:80-127` via `StrucLaplacian.py:120-131`).

Here the whole per-song pipeline is batched over songs inside a handful of
jitted programs, so a corpus bucket costs a few device dispatches instead
of dozens per song:

- the delay-embedding (stack_memory) distance matrices are computed FROM
  THE UNSTACKED base features: the squared Euclidean distance between
  stacked rows i and j is a forward window-sum over the (i, j) diagonal of
  the base squared-distance matrix (and likewise stacked dots/norms for the
  cosine CSM), so only the small synced features cross the host<->device
  boundary — never the (n, d * wins_per_block) stacks or per-song
  matrices;
- SNF runs vmapped over the song batch (`fusion.snf_ws` with per-song
  traced lengths / K);
- spectral clustering is a fixed-iteration, kmeans++-seeded, multi-restart
  Lloyd iteration vmapped over (songs x k x restarts);
- the hierarchy meet matrix, its SVD, the 2D-FFT log shingle + exact
  top-k truncation, and the anti-aliased resize all run batched on device
  with traced per-song lengths.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from acoss_jax.ops import fusion

_BIG_EIG = 1e4


# ---------------------------------------------------------------------------
# Stacked-feature distances from unstacked base features
# ---------------------------------------------------------------------------

def _window_diag_sum(A: jax.Array, win: int, n_out: int) -> jax.Array:
    """out[i, j] = sum_{k=0}^{win-1} A[i + k, j + k] for A (P, P) with
    P >= n_out + win - 1. Static `win` shifted slices; XLA fuses the adds."""
    out = A[0:n_out, 0:n_out]
    for k in range(1, win):
        out = out + A[k:k + n_out, k:k + n_out]
    return out


def stacked_euclidean(x: jax.Array, win: int) -> jax.Array:
    """Euclidean SSM of the `win`-step delay embedding of x, without
    materializing the embedding.

    x: (P, d) base features FRONT-PADDED with win-1 zero rows (the zero
    history stack_memory shifts in, `ops/segment.py:65-87`); P = n + win-1.
    Returns (n, n) = crp.get_ssm(stack_memory(base, win, 1)) exactly
    (clamp at 0, zeroed diagonal).
    """
    n = x.shape[0] - (win - 1)
    sq = jnp.sum(x * x, axis=-1)
    G = jnp.matmul(x, x.T, precision="highest")
    base2 = jnp.maximum(sq[:, None] + sq[None, :] - 2.0 * G, 0.0)
    D2 = _window_diag_sum(base2, win, n)
    D2 = jnp.maximum(D2, 0.0) * (1.0 - jnp.eye(n, dtype=x.dtype))
    return jnp.sqrt(D2)


def stacked_cosine(x: jax.Array, win: int) -> jax.Array:
    """Cosine-distance SSM of the delay embedding of x (front-padded as in
    `stacked_euclidean`). Matches crp.get_csm_cosine(stack, stack) with
    zero-norm rows treated as norm 1 (`CRPUtils.py:88-107`)."""
    n = x.shape[0] - (win - 1)
    sq = jnp.sum(x * x, axis=-1)
    G = jnp.matmul(x, x.T, precision="highest")
    num = _window_diag_sum(G, win, n)
    # stacked squared norm of row i = sum_{k} |x[i + k]|^2 (1-D window sum)
    csq = jnp.cumsum(jnp.concatenate([jnp.zeros(1, sq.dtype), sq]))
    nrm2 = csq[win:] - csq[:-win]                      # (n,)
    nrm = jnp.sqrt(jnp.maximum(nrm2, 0.0))
    nrm = jnp.where(nrm == 0, 1.0, nrm)
    return 1.0 - num / (nrm[:, None] * nrm[None, :])


@functools.partial(
    jax.jit,
    static_argnames=("kinds", "win", "niters", "reg_diag", "sequential",
                     "k_static_max"))
def fused_w_batch(feats: tuple, lengths: jax.Array, Ks: jax.Array,
                  kinds: tuple, win: int, niters: int = 10,
                  reg_diag: bool = True,
                  sequential: bool = True,
                  k_static_max: int | None = None) -> jax.Array:
    """Batched fused structural affinity matrices.

    Args:
      feats: tuple of (B, npad + win - 1, d_f) base feature arrays, each
        front-padded with win-1 zero rows and zero beyond its valid length.
      lengths: (B,) valid row counts (shared across features; callers
        truncate each song to the min feature length first).
      Ks: (B,) SNF neighbor budgets (autotune_k, may vary per song).
      k_static_max: static upper bound on every Ks value — bounds the
        fusion neighbor selections to `lax.top_k` instead of full row
        sorts (bit-identical; see `fusion._smallest_sorted`).
      kinds: per-feature distance kind, "euclidean" | "cosine".
      win: wins_per_block delay-embedding depth.
    Returns: (B, npad, npad) fused W; rows/cols beyond length are zero
      except the reg_diag 0.5 on the padded diagonal (crop before use).
    """
    def per_song(xs, length, K):
        Ds = []
        for x, kind in zip(xs, kinds):
            if kind == "cosine":
                Ds.append(stacked_cosine(x, win))
            else:
                Ds.append(stacked_euclidean(x, win))
        Ds = jnp.stack(Ds)
        Ws = jax.vmap(
            lambda D: fusion.get_W(D, K, length=length,
                                   k_static_max=k_static_max))(Ds)
        return fusion.snf_ws(Ws, K=K, niters=niters, reg_diag=reg_diag,
                             sequential=sequential,
                             k_static_max=k_static_max)

    return jax.vmap(per_song, in_axes=((0,) * len(feats), 0, 0))(
        tuple(feats), jnp.asarray(lengths, jnp.int32),
        jnp.asarray(Ks, jnp.int32))


def _valid_block(W: jax.Array, length: jax.Array) -> jax.Array:
    """Zero W outside its valid (length, length) block (clears the padded
    reg_diag 0.5 diagonal `fusion.get_P` leaves on padded rows)."""
    v = jnp.arange(W.shape[-1]) < length
    return W * (v[:, None] & v[None, :])


# ---------------------------------------------------------------------------
# StrucFTM2D / StrucShingles: batched 2D-FFT log shingle + exact top-k
# ---------------------------------------------------------------------------

#: extra top-k capacity for values TIED with the n_keep-th largest (the
#: reference keeps every entry >= the cutoff, `StrucFTM2D.py:141-142`;
#: real-input |fft2| has exact conjugate-pair duplicates, so ties at the
#: cutoff are common)
TIE_SLACK = 64


@functools.partial(
    jax.jit, static_argnames=("pad_len", "n_keep", "do_fft"))
def shingle_topk_batch(W: jax.Array, lengths: jax.Array, pad_len: int,
                       n_keep: int, do_fft: bool = True):
    """Batched sparse structural shingles.

    Parity: `StrucFTM2D.py:133-143` per song — W embedded in a
    (pad_len, pad_len) zero canvas, optionally |fft2|, then
    log(flat / ||flat|| + 1) with everything below the n_keep-th largest
    value zeroed (ties at the cutoff kept, like the reference, up to
    TIE_SLACK extras). Selection by `lax.top_k` is EXACT and — because
    log(x/n + 1) is monotone in x — independent of the norm's rounding.

    Args:
      W: (B, npad, npad) fused affinity batch (padding need not be clean).
      lengths: (B,) valid row counts.
    Returns (idx (B, n_keep + TIE_SLACK) int32 flat indices — entries
    past the kept set are -1 — and matching val float32), sorted by
    descending value; hosts drop idx < 0 and re-sort by index for CSR
    assembly.
    """
    B, npad, _ = W.shape
    n_in = min(npad, pad_len)
    k_tot = min(n_keep + TIE_SLACK, pad_len * pad_len)

    def per_song(Wi, length):
        Wi = _valid_block(Wi, jnp.minimum(length, n_in))[:n_in, :n_in]
        canvas = jnp.zeros((pad_len, pad_len), jnp.float32)
        canvas = jax.lax.dynamic_update_slice(canvas, Wi, (0, 0))
        if do_fft:
            canvas = jnp.abs(jnp.fft.fft2(canvas))
        flat = canvas.reshape(-1)
        nrm = jnp.sqrt(jnp.sum(flat * flat))
        s = jnp.log(flat / jnp.where(nrm > 0, nrm, 1.0) + 1.0)
        val, idx = jax.lax.top_k(s, k_tot)
        keep = val >= val[min(n_keep, k_tot) - 1]
        return (jnp.where(keep, idx, -1).astype(jnp.int32),
                jnp.where(keep, val, 0.0).astype(jnp.float32))

    return jax.vmap(per_song)(W, jnp.asarray(lengths, jnp.int32))


# ---------------------------------------------------------------------------
# StrucScattering: traced-length anti-aliased resize
# ---------------------------------------------------------------------------

def _reflect_idx(idx: jax.Array, n: jax.Array) -> jax.Array:
    """Mirror-reflect indices into [0, n) (numpy 'reflect': no edge repeat,
    period 2(n-1)) — n may be traced."""
    period = jnp.maximum(2 * (n - 1), 1)
    p = jnp.abs(idx) % period
    return jnp.where(p < n, p, period - p)


@functools.partial(jax.jit, static_argnames=("out_size", "max_in"))
def resize_dynamic_batch(W: jax.Array, lengths: jax.Array, out_size: int,
                         max_in: int | None = None) -> jax.Array:
    """Anti-aliased bilinear resize of each song's valid (n, n) block of W
    to (out_size, out_size), with n TRACED (one compile per padded shape,
    not per song). Matches `ops/resize.resize` of the cropped block: the
    Gaussian pre-blur uses sigma = (n/out - 1)/2 over a static radius
    taken from the worst case in the batch, with mirror reflection at the
    true boundary.
    """
    B, npad, _ = W.shape
    max_in = max_in or npad
    import numpy as _np
    sigma_max = max(0.0, (max_in / out_size - 1) / 2)
    R = max(1, int(_np.ceil(3 * sigma_max))) if sigma_max > 0 else 0

    def per_song(Wi, n):
        n = jnp.maximum(n, 1)
        x = Wi
        if R > 0:
            sigma = jnp.maximum((n.astype(jnp.float32) / out_size - 1) / 2,
                                0.0)
            offs = jnp.arange(-R, R + 1).astype(jnp.float32)
            k = jnp.where(sigma > 0,
                          jnp.exp(-0.5 * (offs / jnp.maximum(sigma, 1e-6))
                                  ** 2),
                          (offs == 0).astype(jnp.float32))
            k = k / jnp.sum(k)
            rows = jnp.arange(npad)[:, None] + jnp.arange(-R, R + 1)[None]
            ridx = _reflect_idx(rows, n)
            x = jnp.einsum("rkc,k->rc", x[ridx], k,
                           precision="highest")          # blur rows
            x = jnp.einsum("rkc,k->rc", x.T[ridx], k,
                           precision="highest").T        # blur cols
        # bilinear sample of the (n, n) block (skimage edge-aligned grid)
        scale = n.astype(jnp.float32) / out_size
        g = (jnp.arange(out_size).astype(jnp.float32) + 0.5) * scale - 0.5
        g = jnp.clip(g, 0.0, n.astype(jnp.float32) - 1.0)
        lo = jnp.floor(g).astype(jnp.int32)
        hi = jnp.minimum(lo + 1, n - 1)
        w = g - lo.astype(jnp.float32)
        rows = x[lo] * (1 - w)[:, None] + x[hi] * w[:, None]
        out = (rows[:, lo] * (1 - w)[None, :] + rows[:, hi] * w[None, :])
        return out

    return jax.vmap(per_song)(W, jnp.asarray(lengths, jnp.int32))


# ---------------------------------------------------------------------------
# StrucLaplacian: eigvecs -> k-means -> meet matrix -> SVD, batched
# ---------------------------------------------------------------------------

def _median_filter_time(x: jax.Array, length: jax.Array,
                        size: int) -> jax.Array:
    """Median filter along axis 0 with scipy 'reflect' (= numpy
    'symmetric') boundary at the TRACED valid length."""
    n = x.shape[0]
    r = size // 2
    pos = jnp.arange(n)[:, None] + jnp.arange(-r, r + 1)[None, :]
    period = jnp.maximum(2 * length, 1)
    p = pos % period
    idx = jnp.where(p < length, p, period - 1 - p)
    idx = jnp.clip(idx, 0, n - 1)
    return jnp.median(x[idx], axis=1)


def rw_laplacian_eigs_padded(W: jax.Array, length: jax.Array) -> jax.Array:
    """`laplacian.random_walk_laplacian_eigs` of the valid block of a
    padded W: padded dimensions are pushed to the TOP of the spectrum with
    a large diagonal bias so the leading (small-eigenvalue) eigenvectors
    are exactly the valid block's, zero on padded rows."""
    n = W.shape[0]
    W = _valid_block(W, length)
    pad = jnp.arange(n) >= length
    d = jnp.sum(W, axis=1)
    L = jnp.diag(d) - W
    sq = jnp.sqrt(jnp.maximum(d, 0.0))
    inv = jnp.where(sq == 0, 1.0, 1.0 / sq)
    LSym = inv[:, None] * L * inv[None, :] + jnp.diag(
        _BIG_EIG * pad.astype(W.dtype))
    _, w = jnp.linalg.eigh(LSym)
    return inv[:, None] * w


def _kmeans_labels(x: jax.Array, wmask: jax.Array, k: int, key: jax.Array,
                   n_init: int, iters: int) -> jax.Array:
    """Masked k-means labels: kmeans++ seeding, fixed Lloyd iterations,
    best of `n_init` restarts by inertia (replaces the reference's
    sklearn KMeans(n_clusters=k, n_init=50, max_iter=500),
    `Laplacian.py:113`). Label IDs are arbitrary; downstream only uses
    label equality/changes.
    """
    x = jnp.asarray(x)
    n, d = x.shape
    w = jnp.asarray(wmask).astype(x.dtype)

    def d2_to(centers):
        return jnp.sum((x[:, None, :] - centers[None, :, :]) ** 2, -1)

    def one_init(key):
        keys = jax.random.split(key, k)
        i0 = jax.random.categorical(keys[0], jnp.log(w + 1e-30))
        centers = jnp.zeros((k, d), x.dtype).at[0].set(x[i0])
        d2 = jnp.sum((x - x[i0]) ** 2, -1)
        for j in range(1, k):
            p = w * d2
            ij = jax.random.categorical(keys[j], jnp.log(p + 1e-30))
            centers = centers.at[j].set(x[ij])
            d2 = jnp.minimum(d2, jnp.sum((x - x[ij]) ** 2, -1))

        def lloyd(centers, _):
            D = d2_to(centers)
            assign = jnp.argmin(D, axis=1)
            onehot = jax.nn.one_hot(assign, k, dtype=x.dtype) * w[:, None]
            counts = jnp.sum(onehot, axis=0)
            sums = jnp.matmul(onehot.T, x, precision="highest")
            new = sums / jnp.maximum(counts, 1.0)[:, None]
            new = jnp.where(counts[:, None] > 0, new, centers)
            return new, None

        centers, _ = jax.lax.scan(lloyd, centers, None, length=iters)
        D = d2_to(centers)
        inertia = jnp.sum(w * jnp.min(D, axis=1))
        return jnp.argmin(D, axis=1), inertia

    labels, inert = jax.vmap(one_init)(jax.random.split(key, n_init))
    return labels[jnp.argmin(inert)]


@functools.partial(
    jax.jit,
    static_argnames=("neigs", "meet_pad", "evec_smooth", "n_init",
                     "iters"))
def laplacian_profile_batch(W: jax.Array, lengths: jax.Array,
                            times: jax.Array, neigs: int, meet_pad: int,
                            evec_smooth: int = 9, n_init: int = 50,
                            iters: int = 60):
    """Batched StrucLaplacian structure stage: fused W -> random-walk
    Laplacian eigenvectors -> median-filtered spectral k-means at
    k = 2..neigs -> hierarchy meet matrix -> SVD curve.

    Parity: `StrucLaplacian.py:120-140` + `Laplacian.py:80-127` +
    `meet_matrix` semantics (`ops/laplacian.py:86-106`): the meet value of
    sample frames i, j is the deepest level at which their containing
    beat's cluster labels agree; sample k lives at t = (k + 0.5) *
    frame_size with frame_size = max(mean beat interval, 1e-4), and
    samples outside [times[0], times[n-1]) carry no label.

    Args:
      W: (B, npad, npad) fused affinities (padding may be dirty).
      lengths: (B,) valid counts.
      times: (B, npad) beat times, padded with +inf-like large values.
      meet_pad: static meet-grid capacity (>= max nmeet in the batch).
    Returns (X (B, meet_pad, neigs) SVD curves, nmeet (B,) int32).
    """
    def per_song(Wi, n, t, song_idx):
        vs = rw_laplacian_eigs_padded(Wi, n)
        vs = _median_filter_time(vs[:, :neigs], n, evec_smooth)
        valid = jnp.arange(Wi.shape[0]) < n

        # meet grid
        t0 = t[0]
        tend = t[jnp.maximum(n - 1, 0)]
        fs_ = jnp.maximum((tend - t0) / jnp.maximum(n - 1, 1), 1e-4)
        nmeet = jnp.clip(jnp.round(tend / fs_).astype(jnp.int32),
                         1, meet_pad)
        tg = (jnp.arange(meet_pad).astype(jnp.float32) + 0.5) * fs_
        beat = jnp.clip(
            jnp.searchsorted(t, tg, side="right") - 1, 0, Wi.shape[0] - 1)
        sample_ok = (tg >= t0) & (tg < tend) & \
            (jnp.arange(meet_pad) < nmeet)

        meet = jnp.zeros((meet_pad, meet_pad), jnp.float32)
        key = jax.random.fold_in(jax.random.PRNGKey(0), song_idx)
        for level, k in enumerate(range(2, neigs + 1), 1):
            lab = _kmeans_labels(vs[:, :k], valid, k,
                                 jax.random.fold_in(key, k), n_init, iters)
            slab = lab[beat]
            same = (slab[:, None] == slab[None, :]) & \
                sample_ok[:, None] & sample_ok[None, :]
            meet = jnp.where(same, float(level), meet)

        # NOTE: a randomized symmetric top-k SVD (subspace iteration) was
        # measured here and REJECTED: the meet matrix has large degenerate
        # eigenspaces whose arbitrary rotations corrupt the SVD curve
        # (snovfn_dmax MAP collapsed).
        U, s, _ = jnp.linalg.svd(meet, full_matrices=False)
        s = s[:neigs]
        X = U[:, :neigs] * (s / jnp.maximum(s[0], 1e-12))[None, :]
        return X, nmeet

    B = W.shape[0]
    return jax.vmap(per_song)(
        W, jnp.asarray(lengths, jnp.int32), jnp.asarray(times, jnp.float32),
        jnp.arange(B))
