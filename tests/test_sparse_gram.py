"""Device dense-over-union sparse Gram vs the scipy SpGEMM oracle.

The host path (`ops/sparse_gram.host_gram_scores`) is shaped after the
reference (`StrucFTM2D.py:173-189`); the device path must reproduce it
for any ragged shingle set, including the blockwise tiling and padded
tail rows."""

import numpy as np
import pytest

from acoss_jax.ops.sparse_gram import (
    compact_shingles, host_gram_scores, sparse_gram_scores)


def _random_shingles(rng, n, dim, nnz_lo, nnz_hi, shared_frac=0.7):
    """Ragged shingles with a concentrated shared support (like real
    FFT-magnitude shingles) plus a per-row random remainder."""
    shared = rng.choice(dim, size=max(nnz_hi, 8), replace=False)
    idx_list, val_list = [], []
    for _ in range(n):
        k = int(rng.integers(nnz_lo, nnz_hi + 1))
        k_sh = int(k * shared_frac)
        ix = np.concatenate([
            rng.choice(shared, size=k_sh, replace=False),
            rng.choice(dim, size=k - k_sh, replace=False)])
        ix = np.unique(ix)
        idx_list.append(ix.astype(np.int64))
        val_list.append(rng.random(ix.size, dtype=np.float32) + 0.1)
    return idx_list, val_list


@pytest.mark.parametrize("n,dim", [(5, 200), (23, 4000)])
def test_device_matches_scipy(n, dim):
    rng = np.random.default_rng(0)
    idx, val = _random_shingles(rng, n, dim, 10, 40)
    want = host_gram_scores(idx, val, dim)
    got = sparse_gram_scores(idx, val, dim, force_device=True)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert got.dtype == np.float32


def test_tiling_with_padded_tail():
    # n not a multiple of the row block; force multi-block tiling
    rng = np.random.default_rng(1)
    n, dim = 37, 1000
    idx, val = _random_shingles(rng, n, dim, 5, 20)
    want = host_gram_scores(idx, val, dim)
    got = sparse_gram_scores(idx, val, dim, force_device=True,
                             max_row_block=16)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_union_fallback_is_host_path():
    rng = np.random.default_rng(2)
    idx, val = _random_shingles(rng, 6, 5000, 10, 30, shared_frac=0.0)
    want = host_gram_scores(idx, val, 5000)
    got = sparse_gram_scores(idx, val, 5000, union_max=4)
    np.testing.assert_array_equal(got, want)


def test_compact_shingles_padding():
    idx = [np.array([3, 7], np.int64), np.array([7], np.int64)]
    val = [np.array([1.0, 2.0], np.float32), np.array([3.0], np.float32)]
    usize, pos, v, sq = compact_shingles(idx, val)
    assert usize == 2
    np.testing.assert_array_equal(pos, [[0, 1], [1, 2]])  # 2 = drop slot
    np.testing.assert_allclose(sq, [5.0, 9.0])


def test_struc_algorithms_device_vs_host_scores():
    from acoss_jax.benchmarking.algorithms.struc_ftm2d import StrucShingles
    rng = np.random.default_rng(3)
    algo = StrucShingles()
    algo.HOST_MAX_N = 0   # force the device path at this tiny n
    n, dim = 9, algo.PAD_LEN * algo.PAD_LEN
    idx, val = _random_shingles(rng, n, dim, 50, 120)
    desc = {"idx": idx, "val": val, "dim": dim}
    want = algo.full_scores_host(desc)["main"]
    got = algo.full_scores(desc)["main"]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
