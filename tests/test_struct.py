"""End-to-end tests of the structural family on planted cliques (scaled
down: small pads, small tempogram windows, uniform downsampling)."""

import numpy as np
import pytest

from acoss_jax.benchmarking.harness import benchmark
from acoss_jax.data import make_synthetic_dataset


@pytest.fixture(scope="module")
def dataset():
    return make_synthetic_dataset(n_cliques=6, clique_size=2,
                                  n_distractors=2, seed=5)


def test_struc_ftm2d_and_shingles(dataset):
    from acoss_jax.benchmarking.algorithms.struc_ftm2d import (StrucFTM2D,
                                                               StrucShingles)
    algo = StrucFTM2D(wins_per_block=5, K=5, niters=5, PAD_LEN=128,
                      tempogram_win=96)
    stats = benchmark(algo, dataset)
    assert stats["main"].map > 0.3
    algo = StrucShingles(wins_per_block=5, K=5, niters=5, PAD_LEN=128,
                         tempogram_win=96)
    stats = benchmark(algo, dataset)
    assert stats["main"].map > 0.3


def test_struc_scattering(dataset):
    from acoss_jax.benchmarking.algorithms.struc_scattering import \
        StrucScattering
    algo = StrucScattering(wins_per_block=5, K=5, niters=5, final_size=64,
                           J=3, L=4, tempogram_win=96)
    stats = benchmark(algo, dataset)
    assert stats["main"].map > 0.3


def test_struc_laplacian(dataset):
    from acoss_jax.benchmarking.algorithms.struc_laplacian import \
        StrucLaplacian
    algo = StrucLaplacian(wins_per_block=5, K=5, niters=5, neigs=6,
                          m=6, tempogram_win=96)
    stats = benchmark(algo, dataset)
    # structure-only channel: weak but above chance (~1/13)
    assert stats["snovfn_qmax"].map > 0.12


def test_batched_fused_w_matches_per_song(dataset):
    """structural_fused_w_all (one device program per chunk, stacked
    distances from UNstacked base features) matches the per-song path to
    fp32 + SNF rank-threshold tolerance."""
    from acoss_jax.benchmarking.algorithms.struct_common import (
        structural_fused_w, structural_fused_w_all)
    kw = dict(wins_per_block=5, K=5, niters=5, tempogram_win=96)
    got = structural_fused_w_all(dataset, **kw, batch_size=4)
    for i in range(dataset.n_songs):
        Wr, onr = structural_fused_w(dataset, i, **kw)
        Wg, ong, n = got[i]
        assert Wg.shape == Wr.shape
        assert np.array_equal(onr, ong)
        # small absolute deviations are expected where a near-tie kNN
        # rank threshold flips a neighbor in/out of the SNF S matrix
        assert np.mean(np.abs(Wr - Wg)) < 1e-4
        assert np.abs(Wr - Wg).max() < 0.05 * max(np.abs(Wr).max(), 1e-9)


def test_batched_shingle_matches_host_topk():
    """Device fft2 + log-norm + top-k shingle == host per-song pipeline
    (pad, fft, `sparse_top_shingle`) on identical inputs."""
    import jax.numpy as jnp

    from acoss_jax.benchmarking.algorithms.struct_common import \
        sparse_top_shingle
    from acoss_jax.ops.structure import shingle_topk_batch
    rng = np.random.default_rng(2)
    P, n_keep = 64, 320
    Ws, lengths = [], []
    for n in (40, 55, 64):
        W = np.zeros((64, 64), np.float32)
        W[:n, :n] = rng.random((n, n), dtype=np.float32)
        Ws.append(W)
        lengths.append(n)
    for do_fft in (True, False):
        idx, val = shingle_topk_batch(
            np.stack(Ws), np.array(lengths, np.int32), P, n_keep, do_fft)
        idx, val = np.asarray(idx), np.asarray(val)
        for b, (W, n) in enumerate(zip(Ws, lengths)):
            canvas = np.zeros((P, P), np.float32)
            canvas[:n, :n] = W[:n, :n]
            flat = (np.abs(np.fft.fft2(canvas)) if do_fft
                    else canvas).astype(np.float32).ravel()
            ix_ref, v_ref = sparse_top_shingle(flat, n_keep)
            keep = idx[b] >= 0
            got = dict(zip(idx[b][keep].tolist(), val[b][keep]))
            ref = dict(zip(ix_ref.tolist(), v_ref))
            # any index kept by only one side must be a cutoff-value tie
            # straddled by fp32-vs-fp64 rounding
            cutoff = np.sort(v_ref)[::-1][n_keep - 1]
            for j in set(ref) ^ set(got):
                v = ref.get(j, got.get(j))
                assert abs(v - cutoff) < 1e-5
            err = max(abs(ref[j] - got[j]) for j in set(ref) & set(got))
            assert err < 1e-5


def test_stacked_distances_match_embedding():
    """Window-sum stacked distances == distances of the materialized
    delay embedding."""
    import jax.numpy as jnp

    from acoss_jax.ops import crp
    from acoss_jax.ops.segment import stack_memory
    from acoss_jax.ops.structure import stacked_cosine, stacked_euclidean
    rng = np.random.default_rng(0)
    for n, d, w in [(37, 13, 5), (64, 12, 20), (5, 3, 1)]:
        x = rng.normal(size=(n, d)).astype(np.float32)
        st = jnp.asarray(stack_memory(x, w, 1).astype(np.float32))
        z = jnp.asarray(
            np.vstack([np.zeros((w - 1, d), np.float32), x]))
        np.testing.assert_allclose(
            np.asarray(stacked_euclidean(z, w)),
            np.asarray(crp.get_ssm(st)), atol=2e-5)
        np.testing.assert_allclose(
            np.asarray(stacked_cosine(z, w)),
            np.asarray(crp.get_csm_cosine(st, st)), atol=2e-6)


def test_device_kmeans_recovers_planted_clusters():
    """Fixed-iteration device k-means recovers well-separated clusters
    exactly (up to label permutation), honoring the padding mask."""
    import jax

    from acoss_jax.ops.structure import _kmeans_labels
    rng = np.random.default_rng(1)
    k, npad, n = 4, 96, 80
    truth = rng.integers(0, k, size=n)
    centers = rng.normal(size=(k, 3)) * 20
    x = np.zeros((npad, 3), np.float32)
    x[:n] = centers[truth] + 0.1 * rng.normal(size=(n, 3))
    mask = np.arange(npad) < n
    labels = np.asarray(_kmeans_labels(
        x, mask, k, jax.random.PRNGKey(0), n_init=10, iters=25))[:n]
    # same partition as truth
    for c in range(k):
        got = labels[truth == c]
        assert len(set(got.tolist())) == 1
    assert len(set(labels.tolist())) == k


def test_early_fusion(dataset):
    from acoss_jax.benchmarking.algorithms.early_fusion import EarlyFusion
    algo = EarlyFusion(blocksize=8, mfccs_per_block=16,
                       chromas_per_block=12, late_K=8, late_niters=5)
    stats = benchmark(algo, dataset)
    assert stats["chromas"].map > 0.3
    assert stats["early"].map > 0.2
    assert "late" in stats and "early+late" in stats
    assert np.isfinite(stats["late"].map)
