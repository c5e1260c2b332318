"""Edge cases and robustness: degenerate inputs the reference handles
implicitly (or crashes on) — we pin the behavior."""

import numpy as np
import pytest

from acoss_jax.benchmarking.evaluation import eval_statistics
from acoss_jax.benchmarking.harness import benchmark, run_pairwise
from acoss_jax.data import FeatureSet, make_synthetic_dataset
from acoss_jax.ops import alignment, crp


def test_featureset_save_load_roundtrip(tmp_path):
    fs = make_synthetic_dataset(n_cliques=3, clique_size=2, seed=0)
    path = str(tmp_path / "store.npz")
    fs.save(path)
    fs2 = FeatureSet.load(path)
    assert fs2.n_songs == fs.n_songs
    assert list(fs2.labels) == list(fs.labels)
    for k in fs.features:
        np.testing.assert_array_equal(fs2.features[k], fs.features[k])
    for k in fs.lengths:
        np.testing.assert_array_equal(fs2.lengths[k], fs.lengths[k])
    sub = fs2.subset([1, 3, 5])
    assert sub.n_songs == 3


def test_aligners_degenerate_crps():
    ones = np.ones((32, 32), dtype=np.uint8)
    zeros = np.zeros((32, 32), dtype=np.uint8)
    # all matches: qmax accumulates +1 along any path from (2,2)
    assert float(alignment.qmax(ones)) == pytest.approx(30.0)
    assert float(alignment.qmax(zeros)) == 0.0
    assert float(alignment.dmax(zeros)) == 0.0
    assert float(alignment.swconstrained(zeros)) == 0.0
    # one-row/one-col inputs hit the early-outs
    assert float(alignment.qmax(np.ones((1, 32), np.uint8))) == 0.0
    assert float(alignment.qmax(np.ones((32, 1), np.uint8))) == 0.0


def test_csm_to_binary_kappa_variants(rng):
    D = rng.random((10, 20)).astype(np.float32)
    # integer kappa larger than the row width -> everything selected
    B = np.asarray(crp.csm_to_binary(D, 50))
    assert B.all()
    # kappa = 1 exactly -> integer branch, 1 neighbor
    B1 = np.asarray(crp.csm_to_binary(D, 1))
    assert (B1.sum(axis=1) >= 1).all()
    np.testing.assert_array_equal(B1.sum(axis=1), np.ones(10))


def test_eval_all_singletons():
    labels = np.array(["a", "b", "c"])
    D = np.zeros((3, 3), np.float32)
    stats = eval_statistics(D, labels)
    assert stats.n_scored == 0
    assert np.isnan(stats.mr) and np.isnan(stats.map)


def test_eval_giant_clique():
    labels = np.array(["x"] * 5)
    D = np.ones((5, 5), np.float32)
    rng = np.random.default_rng(0)
    D += 0.01 * rng.random((5, 5)).astype(np.float32)
    D = (D + D.T) / 2
    stats = eval_statistics(D, labels)
    assert stats.n_scored == 5
    assert stats.map == pytest.approx(1.0)  # everyone is correct


def test_harness_fewer_songs_than_tile():
    fs = make_synthetic_dataset(n_cliques=2, clique_size=2, seed=7)
    from acoss_jax.benchmarking.algorithms import Serra09
    algo = Serra09(chroma_type="hpcp", downsample_fac=4)
    desc = algo.extract_descriptors(fs)
    D = run_pairwise(algo, desc, fs.n_songs, tile=16)  # tile > n_songs
    assert D["chroma_qmax"].shape == (4, 4)
    assert np.isfinite(D["chroma_qmax"]).all()
    assert np.allclose(np.diag(D["chroma_qmax"]), 0)


def test_song_shorter_than_embedding():
    """A song whose downsampled length < m must score 0, not crash."""
    fs = make_synthetic_dataset(n_cliques=3, clique_size=2, seed=8)
    # truncate one song's features to 3 frames
    for k in ("hpcp", "mfcc_htk"):
        fs.lengths[k] = fs.lengths[k].copy()
        fs.lengths[k][0] = 3
    from acoss_jax.benchmarking.algorithms import Serra09
    algo = Serra09(chroma_type="hpcp", downsample_fac=1)
    stats = benchmark(algo, fs)
    assert np.isfinite(stats["chroma_qmax"].mr)


def test_chrompwr_np_matches_jax(rng):
    from acoss_jax.ops.crp import chrompwr, chrompwr_np
    X = rng.random((12, 30)).astype(np.float32)
    np.testing.assert_allclose(chrompwr_np(X, 1.96, axis=0),
                               np.asarray(chrompwr(X, 1.96, axis=0)),
                               atol=1e-5)


def test_uniform_median_fast_path(rng):
    from acoss_jax.ops.segment import sync_agg, uniform_downsample
    X = rng.random((103, 7))
    fast = uniform_downsample(X, 10, "median")
    slow = sync_agg(X, np.arange(0, 103, 10), "median")
    np.testing.assert_allclose(fast, slow)
    fast_m = uniform_downsample(X, 10, "mean")
    slow_m = sync_agg(X, np.arange(0, 103, 10), "mean")
    np.testing.assert_allclose(fast_m, slow_m)
