"""Tests for the vectorized retrieval evaluation vs the reference-convention
loop oracle, plus planted-structure sanity checks."""

import numpy as np
import pytest

from acoss_jax.benchmarking import evaluation
from tests import oracles


def random_labels(rng, n_cliques, sizes):
    labels = []
    for c in range(n_cliques):
        labels += [f"W_{c}"] * sizes[c]
    labels = np.array(labels)
    rng.shuffle(labels)
    return labels


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_reference_loop(seed):
    rng = np.random.default_rng(seed)
    sizes = [5, 4, 3, 2, 2, 1, 1, 1]  # mixed cliques + singletons
    labels = random_labels(rng, len(sizes), sizes)
    N = len(labels)
    D = rng.normal(size=(N, N)).astype(np.float32)
    D = (D + D.T) / 2

    got = evaluation.eval_statistics(D, labels, topsidx=(1, 5, 10))
    want = oracles.eval_statistics_np(D, labels, topsidx=(1, 5, 10))
    assert got.mr == pytest.approx(want["mr"], rel=1e-6)
    assert got.mrr == pytest.approx(want["mrr"], rel=1e-6)
    assert got.mdr == pytest.approx(want["mdr"], rel=1e-6)
    assert got.map == pytest.approx(want["map"], rel=1e-6)
    assert got.tops == want["tops"]
    assert got.n_scored == sum(s for s in sizes if s >= 2)


def test_perfect_retrieval():
    """Planted perfect similarity: every clique member scores 1 with its
    clique, 0 elsewhere -> MAP = 1, MR = mean over clique sizes."""
    sizes = [3, 3, 2]
    labels = np.array([f"c{i}" for i, s in enumerate(sizes) for _ in range(s)])
    N = len(labels)
    D = (labels[:, None] == labels[None, :]).astype(np.float32)
    stats = evaluation.eval_statistics(D, labels, topsidx=(1, 10))
    assert stats.map == pytest.approx(1.0)
    assert stats.mr == pytest.approx(1.0)
    assert stats.tops[1] == N


def test_worst_case_ranks():
    """Anti-planted: covers are the LEAST similar -> first hits rank last."""
    labels = np.array(["a", "a", "b", "b"])
    D = 1.0 - (labels[:, None] == labels[None, :]).astype(np.float32)
    rng = np.random.default_rng(3)
    D += 0.01 * rng.random((4, 4)).astype(np.float32)  # break ties
    D = (D + D.T) / 2
    stats = evaluation.eval_statistics(D, labels, topsidx=(1,))
    assert stats.mr == pytest.approx(3.0)  # correct hit always ranks 3rd of 3


def test_mrr_divides_by_full_n():
    """Reference convention: MRR normalizes by the FULL dataset size,
    including excluded singleton songs (CoverAlgorithm.py:395)."""
    labels = np.array(["a", "a", "s1", "s2"])  # 2 scored, 2 singletons
    D = (labels[:, None] == labels[None, :]).astype(np.float32)
    rng = np.random.default_rng(4)
    D += 0.01 * rng.random((4, 4)).astype(np.float32)
    stats = evaluation.eval_statistics(D, labels, topsidx=(1,))
    # both scored songs have rank 1 -> sum(1/r) = 2, / N=4 -> 0.5
    assert stats.mrr == pytest.approx(2.0 / 4.0)


def test_csv_schema(tmp_path):
    labels = np.array(["a", "a", "b", "b"])
    D = (labels[:, None] == labels[None, :]).astype(np.float32)
    stats = evaluation.eval_statistics(D, labels)
    path = str(tmp_path / "results_test.csv")
    evaluation.write_results_csv(path, "FTM2D", "main", stats)
    evaluation.write_results_csv(path, "FTM2D", "alt", stats)
    lines = open(path).read().strip().split("\n")
    assert lines[0] == "name, MR, MRR, MDR, MAP,Top-1,Top-10,Top-100,Top-1000"
    assert len(lines) == 3
    assert lines[1].startswith("FTM2D_main,")
