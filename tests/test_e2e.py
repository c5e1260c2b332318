"""End-to-end planted-clique regression: synthetic covers must be retrieved
far above chance by FTM2D and Serra09 (the analog of the reference's
covers80 smoke benchmark)."""

import numpy as np
import pytest

from acoss_jax.benchmarking.algorithms import FTM2D, Serra09
from acoss_jax.benchmarking.harness import benchmark, run_pairwise
from acoss_jax.data import make_synthetic_dataset


@pytest.fixture(scope="module")
def dataset():
    return make_synthetic_dataset(n_cliques=8, clique_size=2,
                                  n_distractors=4, seed=1)


def test_ftm2d_e2e(dataset, tmp_path):
    algo = FTM2D(chroma_type="hpcp")
    stats = benchmark(algo, dataset,
                      results_csv=str(tmp_path / "results_synth.csv"))
    # 20 songs, 16 in cliques of 2: chance MAP ~= 1/19; planted >= 0.5.
    assert stats["main"].map > 0.5
    assert stats["main"].n_scored == 16


def test_serra09_e2e(dataset, tmp_path):
    algo = Serra09(chroma_type="hpcp", downsample_fac=4)
    stats = benchmark(algo, dataset)
    assert stats["chroma_qmax"].map > 0.6
    assert stats["chroma_dmax"].map > 0.6
    # mfcc channel is a weaker (but planted) signal
    assert stats["mfcc_qmax"].map > 0.2


def test_serra09_tile_size_invariance(dataset):
    """Scores must not depend on the pair-grid tiling."""
    algo = Serra09(chroma_type="hpcp", downsample_fac=4)
    desc = algo.extract_descriptors(dataset)
    D1 = run_pairwise(algo, desc, dataset.n_songs, tile=4)
    D2 = run_pairwise(algo, desc, dataset.n_songs, tile=7)
    for k in D1:
        np.testing.assert_allclose(D1[k], D2[k], atol=1e-5)


def test_device_resident_sweep_matches_host_sliced(dataset):
    """The device-resident sweep (corpus uploaded once, tiles sliced on
    device with traced offsets) must equal the host-sliced path."""
    algo = Serra09(chroma_type="hpcp", downsample_fac=4)
    desc = algo.extract_descriptors(dataset)
    D1 = run_pairwise(algo, desc, dataset.n_songs, tile=4,
                      device_resident=True)
    D2 = run_pairwise(algo, desc, dataset.n_songs, tile=4,
                      device_resident=False)
    for k in D1:
        np.testing.assert_allclose(D1[k], D2[k], atol=1e-5)


def test_checkpoint_resume(dataset, tmp_path):
    """A sweep resumed from a mid-run checkpoint gives identical scores."""
    algo = Serra09(chroma_type="hpcp", downsample_fac=4)
    desc = algo.extract_descriptors(dataset)
    ckpt = str(tmp_path / "ckpt.npz")
    full = run_pairwise(algo, desc, dataset.n_songs, tile=8)

    # run once with frequent checkpoints, then corrupt the in-memory result
    # by resuming from an earlier checkpoint state
    D1 = run_pairwise(algo, desc, dataset.n_songs, tile=8,
                      checkpoint_path=ckpt, checkpoint_every=1)
    for k in full:
        np.testing.assert_allclose(D1[k], full[k], atol=1e-6)
    # resume with everything done: must return the same matrices
    D2 = run_pairwise(algo, desc, dataset.n_songs, tile=8,
                      checkpoint_path=ckpt)
    for k in full:
        np.testing.assert_allclose(D2[k], full[k], atol=1e-6)


def test_ftm2d_patches_match_loop_oracle(rng):
    """Batched fft2 patches == per-patch scipy-style loop."""
    from acoss_jax.benchmarking.algorithms.ftm2d import fft2_mag_patches
    bt = rng.random((12, 40)).astype(np.float32)
    win = 20
    got = fft2_mag_patches(bt, win)
    for i in range(bt.shape[1] - win + 1):
        F = np.fft.fft2(bt[:, i:i + win])
        want = np.fft.fftshift(np.abs(F)).flatten()
        np.testing.assert_allclose(got[i], want, atol=1e-3)


def test_chen_fusion_e2e(dataset):
    from acoss_jax.benchmarking.algorithms.chen_fusion import ChenFusion
    algo = ChenFusion(chroma_type="hpcp", downsample_fac=4,
                      late_K=10, late_niters=5)
    stats = benchmark(algo, dataset)
    assert stats["qmax"].map > 0.5
    assert stats["dmax"].map > 0.5
    assert stats["Late"].map > 0.5


def test_serra09_ssms_e2e(dataset):
    algo = Serra09(chroma_type="hpcp", downsample_fac=4, do_ssms=True)
    stats = benchmark(algo, dataset)
    assert stats["chroma_qmax"].map > 0.6
    assert "ssms_scatter_qmax" in stats
    # mfcc-SSM-scattering channel: planted timbre structure should beat
    # chance (1/19) clearly
    assert stats["ssms_scatter_qmax"].map > 0.15


def test_early_snf_e2e(dataset):
    from acoss_jax.benchmarking.algorithms.early_snf import EarlySNF
    algo = EarlySNF(chroma_type="hpcp", downsample_fac=4)
    stats = benchmark(algo, dataset)
    assert stats["chroma_qmax"].map > 0.6
    assert stats["snf_qmax"].map > 0.4
    assert stats["snf_dmax"].map > 0.4


def test_simple_tempogram_anf_e2e(dataset):
    from acoss_jax.benchmarking.algorithms.anf_scattering import \
        ANFScattering
    from acoss_jax.benchmarking.algorithms.simple import Simple
    from acoss_jax.benchmarking.algorithms.tempogram import TGAlg

    stats = benchmark(Simple(chroma_type="hpcp", WIN=20, SKIP=10), dataset)
    assert stats["main"].map > 0.5

    stats = benchmark(TGAlg(downsample_fac=4, win_length=96), dataset)
    # tempo structure is a weak planted signal; just beat chance solidly
    assert stats["tempogram_sflux_qmax"].map > 0.15

    stats = benchmark(ANFScattering(J=5, T=2 ** 10, Q=4), dataset)
    assert stats["anfrnn"].map > 0.15


def test_ftm2d_zeropad_e2e(dataset):
    algo = FTM2D(chroma_type="hpcp", mode="zeropad", PAD_LEN=256,
                 do_log=True)
    stats = benchmark(algo, dataset)
    assert stats["main"].map > 0.4


def test_bucketed_sweep_matches_global(dataset):
    """Length-bucketed sweep == global-pad sweep (symmetric + asymmetric),
    compared on a length-sorted dataset where the symmetric orientation
    conventions coincide."""
    from acoss_jax.benchmarking.harness import run_pairwise_bucketed

    algo = Serra09(chroma_type="hpcp", downsample_fac=4, pad_to_multiple=8)
    order = np.argsort(algo.bucket_lengths(dataset), kind="stable")
    ds = dataset.subset(order)

    desc = algo.extract_descriptors(ds)
    D_ref = run_pairwise(algo, desc, ds.n_songs)
    D_b = run_pairwise_bucketed(algo, ds, n_buckets=3)
    for k in D_ref:
        np.testing.assert_allclose(D_b[k], D_ref[k], atol=2e-4)

    from acoss_jax.benchmarking.algorithms.simple import Simple
    algo = Simple(chroma_type="hpcp", WIN=20, SKIP=10, pad_to_multiple=8)
    desc = algo.extract_descriptors(ds)
    D_ref = run_pairwise(algo, desc, ds.n_songs)
    D_b = run_pairwise_bucketed(algo, ds, n_buckets=3)
    np.testing.assert_allclose(D_b["main"], D_ref["main"], atol=2e-4)


def test_bucketed_checkpoint_resume(dataset, tmp_path):
    """Killing a bucketed sweep mid-run and resuming from the bucket-block
    ledger yields the same matrices, and the merged descriptors match a
    whole-corpus extraction."""
    from acoss_jax.benchmarking.harness import run_pairwise_bucketed

    algo = Serra09(chroma_type="hpcp", downsample_fac=4, pad_to_multiple=8)
    ckpt = str(tmp_path / "bucket_ckpt.npz")
    D_full, desc_m = run_pairwise_bucketed(algo, dataset, n_buckets=3,
                                           return_desc=True)

    # simulate an interrupted run: sweep a handful of tiles, save the
    # ledger, then resume with a fresh call.
    import acoss_jax.benchmarking.harness as H
    orig = H._TileSweeper.submit
    calls = {"n": 0}

    def limited(self, ti, tj, scores):
        if calls["n"] >= 5:
            self.flush()
            self.save_ckpt()
            raise KeyboardInterrupt
        calls["n"] += 1
        return orig(self, ti, tj, scores)

    H._TileSweeper.submit = limited
    try:
        with pytest.raises(KeyboardInterrupt):
            run_pairwise_bucketed(algo, dataset, n_buckets=3,
                                  checkpoint_path=ckpt)
    finally:
        H._TileSweeper.submit = orig
    import os
    assert os.path.exists(ckpt)
    D_res = run_pairwise_bucketed(algo, dataset, n_buckets=3,
                                  checkpoint_path=ckpt)
    for k in D_full:
        np.testing.assert_allclose(D_res[k], D_full[k], atol=1e-6)

    # merged per-bucket descriptors cover the whole corpus in order
    desc_ref = algo.extract_descriptors(dataset)
    np.testing.assert_array_equal(desc_m["length"], desc_ref["length"])
    np.testing.assert_allclose(desc_m["gchroma"], desc_ref["gchroma"],
                               atol=1e-6)


def test_build_ssms_device_matches_numpy_path():
    """The device-resident ssms corpus builder is bitwise-equal to the
    per-song numpy pipeline (scatter sequence + length_match + stack)."""
    from acoss_jax.ops.ssm_features import (build_ssms_device,
                                            get_ssm_scatter_sequence,
                                            length_match, scatter_dim)
    rng = np.random.default_rng(0)
    fac, m, res = 8, 6, 16
    sdim = scatter_dim(res)
    mfccs, Ms = [], []
    for L in (400, 230, 37):       # 37 is too short for any block
        mfccs.append(rng.normal(size=(L, 13)).astype(np.float32))
        Ms.append(max(L // fac - 2, 1))
    pad_to = 64
    ref = np.zeros((3, pad_to, sdim), np.float32)
    for i, (mf, M) in enumerate(zip(mfccs, Ms)):
        seq = get_ssm_scatter_sequence(mf, fac, m, res)
        lm = length_match(seq, min(M, pad_to), sdim)
        ref[i, :lm.shape[0]] = lm
    got = np.asarray(build_ssms_device(mfccs, Ms, pad_to, fac, m, res))
    np.testing.assert_array_equal(got, ref)
