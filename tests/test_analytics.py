"""Tests for the coverstats analytics layer."""

import numpy as np
import pytest

from acoss_jax.analytics import (get_cover_pairs, get_onset_means,
                                 get_shape_dna, key_stats, key_table,
                                 lower_star_persistence,
                                 onset_pi_descriptor, onset_stdev_study,
                                 onset_timing_study, persistence_image,
                                 run_coverstats, shape_dna_study,
                                 tag_f_measure, tag_stats, tempo_stats,
                                 tempo_table)
from acoss_jax.data import make_synthetic_dataset


@pytest.fixture(scope="module")
def dataset():
    return make_synthetic_dataset(n_cliques=6, clique_size=2, seed=9)


def test_get_cover_pairs(dataset):
    pairs = get_cover_pairs(dataset, lambda fs, i: i)
    assert len(pairs) == 6
    assert all(len(v) == 2 for v in pairs.values())


def test_key_pipeline(dataset):
    df = key_table(dataset)
    assert len(df) == 6
    stats = key_stats(df, min_confidence=-1.0)   # keep all synthetic pairs
    assert stats["n_pairs_confident"] == 6
    assert 0 <= stats["frac_same_scale"] <= 1
    assert (stats["transposition_distances"] <= 6).all()


def test_tempo_pipeline(dataset):
    df = tempo_table(dataset)
    stats = tempo_stats(df)
    assert stats["n_pairs"] == 6
    # synthetic tempo factors are within [0.8, 1.25] -> ratios <= ~1.6
    assert stats["q50"] >= 1.0
    assert stats["q75"] < 2.0


def test_tag_stats():
    tags = {
        "a": [[("rock", 0.9), ("pop", 0.5)], [("rock", 0.8)]],
        "b": [[("jazz", 0.9)], [("jazz", 0.7), ("blues", 0.3)]],
        "c": [[("rock", 0.9)], [("jazz", 0.9)]],
    }
    assert tag_f_measure(tags["a"][0], tags["a"][1]) == pytest.approx(2 / 3)
    assert tag_f_measure([], [("x", 1.0)]) == np.inf
    res = tag_stats(tags)
    assert res["true_pairs"].mean() > res["false_pairs"].mean()


def test_lower_star_persistence_known():
    # W-shaped function: two local minima, one saddle
    x = np.array([2.0, 0.0, 1.5, 0.5, 3.0])
    dgm = lower_star_persistence(x)
    dgm = dgm[np.argsort(dgm[:, 0])]
    # global min 0.0 is essential (dies at max 3.0); min 0.5 dies at 1.5
    np.testing.assert_allclose(dgm, [[0.0, 3.0], [0.5, 1.5]])


def test_persistence_image_mass():
    dgm = np.array([[0.3, 0.8], [0.4, 0.6]])
    # grid wide enough that no gaussian mass is cut off
    out = persistence_image(dgm, [-1, 2, -1, 2], res=0.1)
    # total mass = sum of lifetime weights (weightfn = life)
    assert out["PI"].sum() == pytest.approx(0.5 + 0.2, abs=0.02)
    assert (out["PI"] >= -1e-9).all()


def test_onset_means(dataset):
    onsets = dataset.feature("onsets")[0, :dataset.length("onsets")[0], 0]
    curve = get_onset_means(onsets)
    assert curve.ndim == 1 and curve.size > 5
    assert abs(np.median(curve) - 1.0) < 1e-9


def test_onset_pi_descriptor(dataset):
    ons = dataset.feature("onsets")[0, :dataset.length("onsets")[0], 0]
    d = onset_pi_descriptor(ons)
    assert d.ndim == 1 and d.size > 0 and np.isfinite(d).all()
    # both halves (up + down filtration images) should carry mass for a
    # non-constant tempo curve
    half = d.size // 2
    assert d[:half].sum() > 0 and d[half:].sum() > 0
    # the reference-quirk variant zeroes the down half (up births fall
    # outside the negative grid)
    q = onset_pi_descriptor(ons, reference_quirk_up_for_down=True)
    assert q[half:].sum() == pytest.approx(0.0, abs=1e-9)
    np.testing.assert_allclose(q[:half], d[:half])


def test_onset_timing_study(dataset):
    res = onset_timing_study(dataset)
    n = len(res["labels"])
    assert n == 6
    assert res["Is1"].shape == res["Is2"].shape == (n, res["Is1"].shape[1])
    assert res["D"].shape == (n, n)
    assert res["dcover"].shape == (n,)
    assert res["dfalse"].shape == (n * n - n,)
    assert res["ks"] is not None and np.isfinite(res["ks"].statistic)
    # covers share the clique tempo-curve shape: true-pair PI distances
    # should be smaller on average than false-pair ones
    assert res["mean_cover"] < res["mean_false"]


def test_onset_stdev_study(dataset):
    res = onset_stdev_study(dataset)
    assert res["stdevs"].shape == (6, 2)
    assert (res["stdevs"] > 0).all()
    assert res["dcover"].shape == (6,)
    assert res["ks"] is not None


def test_run_coverstats_artifacts(dataset, tmp_path):
    out = tmp_path / "stats"
    tags = {str(lbl): [[["rock", 0.9]], [["rock", 0.8]]]
            for lbl in sorted(set(dataset.labels))}
    summary = run_coverstats(
        dataset, str(out), studies=("key", "tempo", "onset", "stdev",
                                    "tag"),
        pair_tags=tags)
    for fname in ("keys.csv", "tempos.csv", "onsettiming.npz",
                  "stdevs.csv", "stdevs.npz", "tags.npz", "summary.json",
                  "OnsetTimings.svg", "TempoRatios.svg",
                  "KeyConfidences.svg", "StdevDistances.svg"):
        assert (out / fname).exists(), fname
    import json

    with open(out / "summary.json") as f:
        loaded = json.load(f)
    assert loaded == summary
    assert set(summary["studies"]) == {"key", "tempo", "onset", "stdev",
                                       "tag"}
    assert summary["studies"]["onset"]["mean_cover"] < \
        summary["studies"]["onset"]["mean_false"]


def test_coverstats_cli(dataset, tmp_path):
    from acoss_jax.cli import main

    fsp = tmp_path / "fs.npz"
    dataset.save(str(fsp))
    out = tmp_path / "out"
    rc = main(["coverstats", "-d", str(fsp), "-o", str(out),
               "--studies", "tempo,stdev", "--no-figures"])
    assert rc == 0
    assert (out / "tempos.csv").exists()
    assert (out / "stdevs.csv").exists()
    assert (out / "summary.json").exists()
    assert not (out / "TempoRatios.svg").exists()

    rc = main(["coverstats", "-d", str(fsp), "-o", str(out),
               "--studies", "nope"])
    assert rc == 1


def test_shape_dna(dataset):
    h = dataset.feature("hpcp")[0, :dataset.length("hpcp")[0]]
    m = dataset.feature("mfcc_htk")[0, :dataset.length("mfcc_htk")[0]]
    res = get_shape_dna(h, m, downsample_fac=4, m=5, dim=64, neigs=10)
    assert res["w"].shape == (11,)
    assert res["w"][0] == pytest.approx(0.0, abs=2e-2)   # lambda_0 = 0
    assert np.all(np.diff(res["w"]) >= -1e-6)            # sorted

    small = dataset.subset(np.arange(8))
    study = shape_dna_study(small, downsample_fac=4, m=5, dim=64, neigs=10)
    assert study["ws"].shape == (8, 11)
    assert study["ks"] is not None
