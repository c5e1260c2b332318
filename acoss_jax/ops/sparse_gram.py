"""Device sparse Gram for the Struc* shingle similarity.

The reference computes exp(-d^2) over all song pairs with one host-side
scipy SpGEMM over the (n, PAD_LEN^2) shingle CSR
(`/root/reference/benchmarking/StrucFTM2D.py:173-189`). SpGEMM cost is
sum_c n_c^2 over the column counts, so it is governed by how much the
shingle supports CONCENTRATE: measured on real extractions
(`scripts/sparse_gram_scale.py`), most songs keep largely the same
low-frequency bins, the per-column counts approach n, and the host cost
approaches nnz_row * n^2 with a scipy hash-merge constant — quadratic
blow-up at Da-TACOS scale on a 1-core host.

The replacement here: the flip side of concentration is that the
COLUMN UNION across the corpus is small (tens of thousands of the 4M
dims), so the Gram is a dense matmul over union-remapped coordinates —
exactly what the device wants:

1. host (cheap, vectorized): U = union of all shingle columns; each
   row's indices -> positions in U via `np.searchsorted`;
2. device: the compact (pos int32, val fp32) arrays live in HBM
   ([n, K], K = max nnz); row blocks are densified on device by scatter
   into [R, |U|] (no per-tile H2D — the compact form ships once) and
   multiplied blockwise at fp32 HIGHEST precision;
3. exp(-max(sq_a + sq_b - 2 G, 0)) is fused on device; only the final
   [R, R] score tiles cross back (this link's D2H is the scarce
   resource — tiles total n^2 * 4 bytes, the minimum possible).

Falls back to the host scipy path when the union exceeds `union_max`
(unconcentrated supports flip the economics back).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["compact_shingles", "sparse_gram_scores", "host_gram_scores"]


def host_gram_scores(idx_list, val_list, dim: int) -> np.ndarray:
    """Reference-shaped host path (`StrucFTM2D.py:173-189`): one scipy
    SpGEMM, then exp(-d^2). Kept as the fallback and the test oracle."""
    from scipy import sparse

    n = len(idx_list)
    indptr = np.cumsum([0] + [len(ix) for ix in idx_list])
    X = sparse.csr_matrix(
        (np.concatenate(val_list), np.concatenate(idx_list), indptr),
        shape=(n, dim))
    sq = np.asarray(X.power(2).sum(axis=1)).ravel()
    G = np.asarray((X @ X.T).todense())
    d2 = sq[:, None] + sq[None, :] - 2.0 * G
    return np.exp(-np.maximum(d2, 0.0)).astype(np.float32)


def compact_shingles(idx_list, val_list):
    """Union-remap ragged (idx, val) shingles to fixed-width compact form.

    Returns (union_size, pos [n, K] int32, val [n, K] float32, sq [n]
    float32). Padding entries carry pos == union_size, which the device
    scatter drops (mode='drop')."""
    n = len(idx_list)
    U = np.unique(np.concatenate(idx_list)) if n else np.empty(0, np.int64)
    K = max((len(ix) for ix in idx_list), default=1) or 1
    pos = np.full((n, K), U.size, np.int32)
    val = np.zeros((n, K), np.float32)
    sq = np.zeros(n, np.float32)
    for i, (ix, v) in enumerate(zip(idx_list, val_list)):
        k = len(ix)
        pos[i, :k] = np.searchsorted(U, ix)
        val[i, :k] = v
        sq[i] = np.dot(np.asarray(v, np.float64),
                       np.asarray(v, np.float64))
    return int(U.size), pos, val, sq


@functools.partial(jax.jit, static_argnames=("upad",))
def _densify(pos, val, upad: int):
    R = pos.shape[0]
    X = jnp.zeros((R, upad), jnp.float32)
    return X.at[jnp.arange(R)[:, None], pos].set(val, mode="drop")


@jax.jit
def _score_tile(Xa, Xb, sqa, sqb):
    G = jax.lax.dot_general(
        Xa, Xb, (((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST)
    d2 = sqa[:, None] + sqb[None, :] - 2.0 * G
    return jnp.exp(-jnp.maximum(d2, 0.0))


def sparse_gram_scores(idx_list, val_list, dim: int,
                       union_max: int = 1 << 21,
                       hbm_budget_bytes: int = 6 << 30,
                       max_row_block: int = 2048,
                       host_max_n: int = 512,
                       force_device: bool = False) -> np.ndarray:
    """exp(-d^2) over all row pairs of the sparse shingle matrix.

    Numerically equivalent to `host_gram_scores` (fp32 HIGHEST matmul vs
    scipy's fp32 accumulation; tested to 1e-5). Device path when the
    column union is concentrated AND the corpus is big enough to matter
    (measured host SpGEMM is ~10 s at n=1000 and quadratic beyond, but
    sub-second at covers80 sizes where a device compile would dominate);
    scipy fallback otherwise."""
    n = len(idx_list)
    if n == 0:
        return np.zeros((0, 0), np.float32)
    if n <= host_max_n and not force_device:
        return host_gram_scores(idx_list, val_list, dim)
    usize, pos, val, sq = compact_shingles(idx_list, val_list)
    if usize > union_max and not force_device:
        return host_gram_scores(idx_list, val_list, dim)

    # The jitted block programs depend only on (R, upad, K), so bucket
    # the shape params to let one compiled program serve many corpora
    # (each compile costs seconds): union width to the next
    # power of two while compiles dominate (small unions), 128-aligned
    # once the matmul flops dominate (large unions, where pow2 padding
    # would cost up to 2x flops for one saved compile).
    if usize <= 1 << 17:
        upad = 1 << max(10, int(np.ceil(np.log2(max(usize, 1)))))
    else:
        upad = -(-usize // 128) * 128
    kpad = -(-pos.shape[1] // 256) * 256
    if kpad != pos.shape[1]:
        pos = np.pad(pos, ((0, 0), (0, kpad - pos.shape[1])),
                     constant_values=usize)
        val = np.pad(val, ((0, 0), (0, kpad - val.shape[1])))
    # two dense row blocks must fit the budget next to the compact form
    R = int(min(max_row_block,
                max(8, hbm_budget_bytes // (2 * upad * 4))))
    R = -(-R // 8) * 8
    nb = -(-n // R)
    pad = nb * R - n
    if pad:
        pos = np.pad(pos, ((0, pad), (0, 0)), constant_values=usize)
        val = np.pad(val, ((0, pad), (0, 0)))
        sq = np.pad(sq, (0, pad))
    pos_d = jax.device_put(pos)
    val_d = jax.device_put(val)
    sq_d = jax.device_put(sq)

    out = np.empty((n, n), np.float32)
    for a in range(nb):
        a0, a1 = a * R, (a + 1) * R
        Xa = _densify(pos_d[a0:a1], val_d[a0:a1], upad)
        for b in range(a + 1):
            b0, b1 = b * R, (b + 1) * R
            Xb = Xa if b == a else _densify(
                pos_d[b0:b1], val_d[b0:b1], upad)
            S = np.asarray(_score_tile(Xa, Xb, sq_d[a0:a1], sq_d[b0:b1]))
            ah, bh = min(a1, n) - a0, min(b1, n) - b0
            out[a0:a0 + ah, b0:b0 + bh] = S[:ah, :bh]
            if b != a:
                out[b0:b0 + bh, a0:a0 + ah] = S[:ah, :bh].T
    return out
