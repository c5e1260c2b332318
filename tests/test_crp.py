"""Golden tests for acoss_jax.ops.crp against tiny numpy oracles."""

import numpy as np
import pytest

from acoss_jax.ops import crp
from tests import oracles


def test_get_ssm(rng):
    X = rng.normal(size=(17, 5)).astype(np.float32)
    got = np.asarray(crp.get_ssm(X))
    np.testing.assert_allclose(got, oracles.ssm_np(X), atol=1e-4)


def test_get_csm(rng):
    X = rng.normal(size=(13, 7)).astype(np.float32)
    Y = rng.normal(size=(19, 7)).astype(np.float32)
    got = np.asarray(crp.get_csm(X, Y))
    np.testing.assert_allclose(got, oracles.csm_np(X, Y), atol=1e-4)


def test_get_csm_cosine(rng):
    X = rng.normal(size=(11, 6)).astype(np.float32)
    Y = rng.normal(size=(9, 6)).astype(np.float32)
    Y[3] = 0.0  # zero-norm row handling
    got = np.asarray(crp.get_csm_cosine(X, Y))
    np.testing.assert_allclose(got, oracles.csm_cosine_np(X, Y), atol=1e-5)


def test_get_oti(rng):
    for _ in range(20):
        C1 = rng.random(12).astype(np.float32)
        C2 = rng.random(12).astype(np.float32)
        assert int(crp.get_oti(C1, C2)) == oracles.oti_np(C1, C2)


def test_transpose_chroma_matches_roll(rng):
    X = rng.normal(size=(5, 12)).astype(np.float32)
    for oti in range(12):
        got = np.asarray(crp.transpose_chroma(X, oti))
        np.testing.assert_allclose(got, np.roll(X, oti, axis=-1))


def test_blocked_oti_roll_semantics(rng):
    # Rolling the chroma axis inside stacked blocks then taking the CSM
    # must match doing it by hand (CRPUtils.py:138-166 semantics).
    n_chroma, blocks = 12, 3
    X = rng.random((8, n_chroma * blocks)).astype(np.float32)
    Y = rng.random((6, n_chroma * blocks)).astype(np.float32)
    C1 = rng.random(n_chroma).astype(np.float32)
    C2 = rng.random(n_chroma).astype(np.float32)
    oti = oracles.oti_np(C1, C2)
    X1 = X.reshape(8, blocks, n_chroma)
    X1 = np.roll(X1, oti, axis=2).reshape(8, -1)
    want = oracles.csm_np(X1, Y)
    got = np.asarray(crp.get_csm_blocked_oti(X, Y, C1, C2, crp.get_csm))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_sliding_window(rng):
    X = rng.normal(size=(20, 4)).astype(np.float32)
    got = np.asarray(crp.sliding_window(X, 9))
    np.testing.assert_allclose(got, oracles.sliding_window_np(X, 9))
    padded = np.asarray(crp.sliding_window_padded(X, 9))
    assert padded.shape == (20, 36)
    np.testing.assert_allclose(padded[:12], got)


def test_sliding_csm(rng):
    D = rng.random((25, 18)).astype(np.float32)
    got = np.asarray(crp.sliding_csm(D, 9))
    np.testing.assert_allclose(got, oracles.sliding_csm_np(D, 9), atol=1e-4)
    padded = np.asarray(crp.sliding_csm_padded(D, 9))
    np.testing.assert_allclose(padded[:17, :10], got, atol=1e-4)


@pytest.mark.parametrize("kappa", [0, 0.095, 0.3, 5])
def test_csm_to_binary(rng, kappa):
    D = rng.random((30, 40)).astype(np.float32)
    got = np.asarray(crp.csm_to_binary(D, kappa))
    want = oracles.csm_to_binary_np(D, kappa)
    np.testing.assert_array_equal(got, want)


def test_csm_to_binary_mutual(rng):
    D = rng.random((30, 40)).astype(np.float32)
    got = np.asarray(crp.csm_to_binary_mutual(D, 0.2))
    want = oracles.csm_to_binary_mutual_np(D, 0.2)
    np.testing.assert_array_equal(got, want)


def test_csm_to_binary_padded_matches_unpadded(rng):
    """Binarizing a zero-padded CSM with true lengths must equal binarizing
    the unpadded CSM — the invariant the aligners rely on."""
    m, n, M, N = 23, 31, 32, 48
    D = rng.random((m, n)).astype(np.float32)
    Dp = np.zeros((M, N), dtype=np.float32)
    Dp[:m, :n] = D
    want = oracles.csm_to_binary_np(D, 0.095)
    got = np.asarray(crp.csm_to_binary(Dp, 0.095, row_length=m, col_length=n))
    np.testing.assert_array_equal(got[:m, :n], want)
    assert got[m:].sum() == 0 and got[:, n:].sum() == 0

    want_mut = oracles.csm_to_binary_mutual_np(D, 0.15)
    got_mut = np.asarray(
        crp.csm_to_binary_mutual(Dp, 0.15, row_length=m, col_length=n))
    np.testing.assert_array_equal(got_mut[:m, :n], want_mut)
    assert got_mut[m:].sum() == 0 and got_mut[:, n:].sum() == 0


def test_chrompwr_preserves_norm(rng):
    X = rng.random((12, 50)).astype(np.float32)
    X[:, 7] = 0.0
    got = np.asarray(crp.chrompwr(X, 1.96, axis=0))
    np.testing.assert_allclose(
        np.linalg.norm(got, axis=0), np.linalg.norm(X, axis=0), atol=1e-4)
    # P = 1 is the identity
    np.testing.assert_allclose(
        np.asarray(crp.chrompwr(X, 1.0, axis=0)), X, atol=1e-5)


def test_csm_to_binary_zero_neighbor_rows(rng):
    """round(kappa * valid_cols) == 0 selects ZERO neighbors in the
    reference (argpartition[:, 0:0] -> all-zero CRP); the rank-threshold
    path must not clip the count up to 1."""
    D = rng.random((12, 40)).astype(np.float32)
    B = np.asarray(crp.csm_to_binary(D, 0.095,
                                     col_length=np.int32(5)))
    assert B.sum() == 0   # round(0.095 * 5) == 0
