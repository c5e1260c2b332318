"""The XLA paths that binarize CRPs and select SNF neighbours — the only
paths on every platform — against the numpy oracles, and the Serra09 /
EarlySNF tiles built on them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from acoss_jax.ops import alignment, crp, fusion
from tests import oracles


def _make(rng, B, L, d):
    # >= 20 frames: after a 9-frame window every row keeps >= 1 neighbour
    # (the numpy oracle has no zero-neighbour convention)
    l1 = rng.integers(20, L + 1, B).astype(np.int32)
    l2 = rng.integers(20, L + 1, B).astype(np.int32)
    X = rng.standard_normal((B, L, d)).astype(np.float32)
    Y = rng.standard_normal((B, L, d)).astype(np.float32)
    for b in range(B):
        X[b, l1[b]:] = 0
        Y[b, l2[b]:] = 0
    return X, Y, l1, l2


def _oracle(D, kappa, l1, l2, mutual):
    """numpy binarization of the valid block, zero elsewhere."""
    out = np.zeros(D.shape, np.uint8)
    if l1 > 0 and l2 > 0:
        fn = oracles.csm_to_binary_mutual_np if mutual else \
            oracles.csm_to_binary_np
        out[:l1, :l2] = fn(D[:l1, :l2], kappa)
    return out


def _binarize(D, kappa, l1, l2, mutual):
    fn = crp.csm_to_binary_mutual if mutual else crp.csm_to_binary
    return np.asarray(jax.vmap(lambda d, a, b: fn(d, kappa, a, b))(
        jnp.asarray(D), jnp.asarray(l1), jnp.asarray(l2)))


@pytest.mark.parametrize("metric,mutual,m", [
    ("sqeuclidean", True, 9),
    ("sqeuclidean", False, 9),
    ("sqeuclidean", True, 1),
    ("cosine", False, 1),
    ("cosine", True, 5),
])
def test_csm_sliding_binarize_matches_oracle(rng, metric, mutual, m):
    """CSM -> sliding window -> (mutual) kNN binarize, batched under vmap,
    equals the numpy binarization of the same CSMs pair by pair."""
    B, L, d, kappa = 5, 64, 12, 0.095
    X, Y, l1, l2 = _make(rng, B, L, d)
    csm_fn = crp.get_csm_cosine if metric == "cosine" else crp.get_csm

    def mats(x, y):
        D = csm_fn(x, y)
        return crp.sliding_csm_padded(D, m) if m > 1 else D

    D = np.asarray(jax.vmap(mats)(jnp.asarray(X), jnp.asarray(Y)))
    l1e, l2e = np.maximum(l1 - m + 1, 0), np.maximum(l2 - m + 1, 0)
    got = _binarize(D, kappa, l1e, l2e, mutual)
    for b in range(B):
        np.testing.assert_array_equal(
            got[b], _oracle(D[b], kappa, l1e[b], l2e[b], mutual))


def test_binarize_odd_batch(rng):
    B, L, kappa = 3, 32, 0.2
    D = rng.standard_normal((B, L, L)).astype(np.float32)
    l1 = np.array([32, 17, 29], np.int32)
    l2 = np.array([11, 32, 30], np.int32)
    got = _binarize(D, kappa, l1, l2, True)
    for b in range(B):
        np.testing.assert_array_equal(
            got[b], _oracle(D[b], kappa, l1[b], l2[b], True))


def test_binarize_zero_length_pair(rng):
    D = rng.random((2, 32, 32)).astype(np.float32)
    got = _binarize(D, 0.1, np.array([32, 0]), np.array([32, 20]), True)
    assert got[1].sum() == 0
    np.testing.assert_array_equal(got[0], _oracle(D[0], 0.1, 32, 32, True))


def test_binarize_negated_similarity(rng):
    """EarlySNF binarizes the NEGATED fused cross block, whose zeros are
    -0.0 next to +0.0: ties must be handled like the oracle's."""
    B, L, kappa = 3, 48, 0.2
    fused = rng.random((B, L, L)).astype(np.float32)
    fused[rng.random((B, L, L)) < 0.3] = 0.0
    D = -fused
    D[:, :, ::5] = np.abs(D[:, :, ::5])
    full = np.full(B, L, np.int32)
    got = _binarize(D, kappa, full, full, True)
    for b in range(B):
        np.testing.assert_array_equal(got[b],
                                      _oracle(D[b], kappa, L, L, True))


def test_binarize_zero_neighbours_and_padding(rng):
    """round(kappa * l) == 0 gives an all-zero CRP (the reference selects
    no neighbour); padding rows/columns stay zero."""
    B, L, kappa = 3, 32, 0.05
    D = np.abs(rng.standard_normal((B, L, L))).astype(np.float32)
    l1 = np.array([L, 4, L], np.int32)    # round(0.05 * 4) == 0
    l2 = np.array([L, L, 6], np.int32)
    got = _binarize(D, kappa, l1, l2, True)
    assert got[1].sum() == 0 and got[2].sum() == 0
    np.testing.assert_array_equal(got[0], _oracle(D[0], kappa, L, L, True))


def _get_s_np(W, K):
    thresh = np.sort(W, axis=1)[:, -K][:, None]    # K-th largest per row
    V = np.where(W >= thresh, W, 0.0)
    norm = V.sum(axis=1, keepdims=True)
    return V / np.where(norm == 0, 1.0, norm)


@pytest.mark.parametrize("k_static_max", [None, 9])
def test_get_s_selection(rng, k_static_max):
    """get_S keeps each row's K largest (ties included) and L1-normalizes,
    with or without the static top_k bound."""
    W = rng.random((40, 40)).astype(np.float32)
    W[rng.random((40, 40)) < 0.2] = 0.25                # planted ties
    got = np.asarray(fusion.get_S(jnp.asarray(W), 7, k_static_max))
    np.testing.assert_allclose(got, _get_s_np(W, 7), rtol=1e-6)


def test_get_s_under_vmap(rng):
    """Per-matrix traced K under vmap equals the one-by-one selection."""
    Ws = rng.random((3, 24, 24)).astype(np.float32)
    Ks = np.array([1, 5, 24], np.int32)
    got = np.asarray(jax.vmap(lambda W, K: fusion.get_S(W, K, 24))(
        jnp.asarray(Ws), jnp.asarray(Ks)))
    for f in range(3):
        np.testing.assert_allclose(got[f], _get_s_np(Ws[f], int(Ks[f])),
                                   rtol=1e-6)


def _tile(algo_cls, seed, **kw):
    from acoss_jax.data import make_synthetic_dataset

    fs = make_synthetic_dataset(n_cliques=4, clique_size=2, seed=seed)
    algo = algo_cls(chroma_type="hpcp", downsample_fac=4, **kw)
    desc = algo.extract_descriptors(fs)
    return algo, {k: v[:4] for k, v in desc.items()}, \
        {k: v[4:8] for k, v in desc.items()}


def test_serra09_tile_is_per_pair_crps_and_aligners():
    """Serra09.tile_scores == per-pair CRPs through the plain aligners."""
    from acoss_jax.benchmarking.algorithms import Serra09

    algo, row, col = _tile(Serra09, 7)
    out = jax.jit(algo.tile_scores)(row, col)
    for i in range(4):
        for j in range(4):
            r = {k: v[i] for k, v in row.items()}
            c = {k: v[j] for k, v in col.items()}
            (Bc, Bm), l1, l2 = algo._pair_crps(r, c)
            for name, B in (("chroma", Bc), ("mfcc", Bm)):
                q = alignment.qmax(B, l1, l2) / max(int(l1 + l2), 1)
                d = alignment.dmax(B, l1, l2) / max(int(l1 + l2), 1)
                assert float(out[f"{name}_qmax"][i, j]) == pytest.approx(
                    float(q), abs=1e-6)
                assert float(out[f"{name}_dmax"][i, j]) == pytest.approx(
                    float(d), abs=1e-6)


def test_early_snf_tile_is_per_pair_crps_and_aligners():
    """EarlySNF.tile_scores == its per-pair binarized matrices (incl. the
    negated SNF cross block) through the plain aligners."""
    from acoss_jax.benchmarking.algorithms import EarlySNF

    algo, row, col = _tile(EarlySNF, 11, ssm_res=16)
    out = jax.jit(algo.tile_scores)(row, col)
    assert any(k.startswith("snf_") for k in out)
    r, c = algo._center_ssms(row, col)
    crps, l1, l2 = jax.vmap(jax.vmap(algo._pair_crps, in_axes=(None, 0)),
                            in_axes=(0, None))(r, c)
    names = ["chroma", "mfcc", "ssms_scatter", "snf"]
    ml, nl = l1.reshape(-1), l2.reshape(-1)
    denom = np.maximum(np.asarray(ml + nl), 1)
    for name, B in zip(names, crps):
        S = B.reshape((-1,) + B.shape[2:])
        q = np.asarray(alignment.qmax_batch(S, ml, nl)) / denom
        np.testing.assert_allclose(np.asarray(out[f"{name}_qmax"]).ravel(),
                                   q, atol=1e-6)


def test_early_snf_default_precision_tile():
    """snf_precision="default" (reduced-precision diffusion, exact
    WCSMSSM) keeps the retrieval order of the parity setting on
    separable data."""
    from acoss_jax.benchmarking.algorithms import EarlySNF

    algo_hi, row, col = _tile(EarlySNF, 3, do_ssms=False)
    algo_lo, _, _ = _tile(EarlySNF, 3, do_ssms=False,
                          snf_precision="default")
    hi = jax.jit(algo_hi.tile_scores)(row, col)
    lo = jax.jit(algo_lo.tile_scores)(row, col)
    assert set(hi) == set(lo)
    for k in hi:
        a, b = np.asarray(hi[k]), np.asarray(lo[k])
        assert np.isfinite(b).all()
        np.testing.assert_allclose(a, b, rtol=0.02, atol=0.02)
        np.testing.assert_array_equal(np.argsort(-a, axis=1),
                                      np.argsort(-b, axis=1))
