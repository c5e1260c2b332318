"""CoverIndex serving layer: 1xN retrieval against a pinned corpus.

The reference is batch-only (`CoverAlgorithm.py:156-192` recomputes the
whole pair grid); the serving layer answers held-out queries against a
prebuilt index. Contract pinned here: query scores == the corresponding
rows of a full batch sweep, ranking surfaces the planted cover, the
index persists/reloads, and quantized indexes keep the ranking.
"""

import subprocess
import sys

import numpy as np
import pytest

from acoss_jax.benchmarking.algorithms import Serra09
from acoss_jax.benchmarking.harness import run_pairwise
from acoss_jax.data import make_synthetic_dataset
from acoss_jax.serving import CoverIndex


@pytest.fixture(scope="module")
def corpus_and_queries():
    fs = make_synthetic_dataset(n_cliques=6, clique_size=2,
                                n_distractors=2, seed=13)
    # hold out one member of each of the first 3 cliques as queries
    qidx = np.array([0, 2, 4])
    cidx = np.setdiff1d(np.arange(fs.n_songs), qidx)
    return fs, fs.subset(cidx), fs.subset(qidx), cidx, qidx


def _algo():
    return Serra09(chroma_type="hpcp", downsample_fac=4,
                   pad_to_multiple=8)


def test_query_rows_match_batch_sweep(corpus_and_queries):
    """Index query scores == the query-vs-corpus rows of a full batch
    sweep over the union (same kernels, tile layout differences only)."""
    fs, cfs, qfs, cidx, qidx = corpus_and_queries
    algo = _algo()
    desc = algo.extract_descriptors(fs)
    D = run_pairwise(algo, desc, fs.n_songs, tile=4)

    index = CoverIndex.build(algo, cfs, tile=4)
    scores = index.query(qfs)
    assert set(scores) == set(algo.SIMILARITY_TYPES)
    for k, S in scores.items():
        assert S.shape == (len(qidx), len(cidx))
        want = np.asarray(D[k])[np.ix_(qidx, cidx)]
        np.testing.assert_allclose(S, want, atol=2e-4, err_msg=k)


def test_top_k_finds_planted_covers(corpus_and_queries):
    fs, cfs, qfs, cidx, qidx = corpus_and_queries
    index = CoverIndex.build(_algo(), cfs, tile=4)
    ranked = index.top_k(qfs, k=3, similarity_type="chroma_qmax")
    for qi, rows in enumerate(ranked):
        mate = rows[0]
        assert fs.labels[cidx[mate["index"]]] == fs.labels[qidx[qi]], \
            (qi, rows)
        assert mate["score"] >= rows[-1]["score"]


def test_index_save_load_roundtrip(tmp_path, corpus_and_queries):
    _, cfs, qfs, _, _ = corpus_and_queries
    algo = _algo()
    index = CoverIndex.build(algo, cfs, tile=4)
    ref = index.query(qfs)

    index.save(str(tmp_path / "idx"))
    loaded = CoverIndex.load(_algo(), str(tmp_path / "idx"))
    assert loaded.ids == index.ids
    got = loaded.query(qfs)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5)

    # wrong algorithm class is rejected
    from acoss_jax.benchmarking.algorithms import FTM2D
    with pytest.raises(ValueError):
        CoverIndex.load(FTM2D(), str(tmp_path / "idx"))


def test_quantized_index_keeps_ranking(corpus_and_queries):
    _, cfs, qfs, cidx, _ = corpus_and_queries
    algo = _algo()
    ref = CoverIndex.build(algo, cfs, tile=4).top_k(
        qfs, k=1, similarity_type="chroma_qmax")
    for quant in ("half", "int8"):
        idx = CoverIndex.build(_algo(), cfs, quant=quant, tile=4)
        # force quantization despite the tiny corpus dims
        from acoss_jax.serving import _quantize_desc
        qd = _quantize_desc(
            {k: np.asarray(v) for k, v in
             algo.extract_descriptors(cfs).items()},
            quant, min_bytes=256)
        assert any(v.dtype in (np.float16, np.int8)
                   for v in qd.values()), quant
        idx = CoverIndex(_algo(), qd, cfs.n_songs, tile=4)
        got = idx.top_k(qfs, k=1, similarity_type="chroma_qmax")
        for r, g in zip(ref, got):
            assert r[0]["index"] == g[0]["index"], quant


def test_query_padding_and_batch_shapes(corpus_and_queries):
    """nq < tile pads to one tile; nq > tile spans two scan widths; both
    agree with the per-song queries."""
    _, cfs, qfs, _, _ = corpus_and_queries
    index = CoverIndex.build(_algo(), cfs, tile=4)
    all3 = index.query(qfs)
    for i in range(qfs.n_songs):
        one = index.query(qfs.subset(np.array([i])))
        for k in all3:
            np.testing.assert_allclose(one[k][0], all3[k][i], atol=1e-5)


def test_cli_query_roundtrip(tmp_path):
    fs = make_synthetic_dataset(n_cliques=4, clique_size=2, seed=3)
    qidx = np.array([0])
    cidx = np.setdiff1d(np.arange(fs.n_songs), qidx)
    fs.subset(cidx).save(str(tmp_path / "corpus.npz"))
    fs.subset(qidx).save(str(tmp_path / "query.npz"))
    out = subprocess.run(
        [sys.executable, "-m", "acoss_jax", "query", "-a", "Serra09",
         "-d", str(tmp_path / "corpus.npz"),
         "-q", str(tmp_path / "query.npz"),
         "--index-dir", str(tmp_path / "idx"), "--top", "2",
         "--similarity-type", "chroma_qmax"],
        capture_output=True, text=True, timeout=600,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    import json
    hits = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    assert len(hits) == 1 and len(hits[0]["top"]) == 2
    # the planted cover (same clique as query 0) ranks first
    top = hits[0]["top"][0]
    assert fs.labels[cidx[top["index"]]] == fs.labels[qidx[0]]

    # second invocation reuses the saved index
    out2 = subprocess.run(
        [sys.executable, "-m", "acoss_jax", "query", "-a", "Serra09",
         "-d", "/nonexistent",
         "-q", str(tmp_path / "query.npz"),
         "--index-dir", str(tmp_path / "idx"), "--top", "2",
         "--similarity-type", "chroma_qmax"],
        capture_output=True, text=True, timeout=600,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"})
    assert out2.returncode == 0, out2.stderr[-2000:]
    assert "loading index" in out2.stdout


def test_load_rejects_parameter_drift(tmp_path, corpus_and_queries):
    """Same class, different constructor params: load must refuse — the
    query-side extraction would not match the pinned corpus."""
    _, cfs, _, _, _ = corpus_and_queries
    index = CoverIndex.build(_algo(), cfs, tile=4)
    index.save(str(tmp_path / "idx"))
    drifted = Serra09(chroma_type="crema", downsample_fac=4,
                      pad_to_multiple=8)
    with pytest.raises(ValueError, match="chroma_type"):
        CoverIndex.load(drifted, str(tmp_path / "idx"))
    # identical params still load
    CoverIndex.load(_algo(), str(tmp_path / "idx"))


def test_save_replaces_prior_index_atomically(tmp_path,
                                              corpus_and_queries):
    """Re-saving over a PRIOR INDEX must replace it wholesale (stale
    .npy memmaps with old dtypes/widths or orphan keys must not leak
    into the new store), via the temp-dir + swap so `path` never holds
    a half-written mix."""
    _, cfs, qfs, _, _ = corpus_and_queries
    path = tmp_path / "idx"
    index = CoverIndex.build(_algo(), cfs, tile=4)
    ref = index.query(qfs)
    index.save(str(path))
    # corrupt the saved index the way an older differently-configured
    # save would have left it: wrong-dtype leaf + an orphan key
    np.save(path / "chroma.npy",
            np.zeros((cfs.n_songs, 3), np.int8))
    np.save(path / "orphan.npy", np.zeros((cfs.n_songs, 2), np.float32))
    index.save(str(path))
    assert not list(tmp_path.glob("idx.tmp-*"))
    assert not list(tmp_path.glob("idx.old-*"))
    loaded = CoverIndex.load(_algo(), str(path))
    assert "orphan" not in loaded._corpus
    got = loaded.query(qfs)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, err_msg=k)


def test_save_refuses_foreign_npy_directory(tmp_path,
                                            corpus_and_queries):
    """A directory holding .npy data WITHOUT an index meta is someone
    else's data — save() must refuse rather than delete it."""
    _, cfs, _, _, _ = corpus_and_queries
    path = tmp_path / "notanindex"
    path.mkdir()
    np.save(path / "precious.npy", np.arange(5))
    index = CoverIndex.build(_algo(), cfs, tile=4)
    with pytest.raises(ValueError, match="not a CoverIndex"):
        index.save(str(path))
    assert np.array_equal(np.load(path / "precious.npy"), np.arange(5))


def test_load_warns_not_refuses_on_scoring_only_drift(
        tmp_path, corpus_and_queries):
    """Scoring-only knobs (SCORING_ONLY_PARAMS) don't change the pinned
    descriptors; load warns and proceeds instead of refusing."""
    from acoss_jax.benchmarking.algorithms import EarlySNF

    _, cfs, _, _, _ = corpus_and_queries
    algo = EarlySNF(chroma_type="hpcp", downsample_fac=4,
                    pad_to_multiple=8, do_ssms=False)
    index = CoverIndex.build(algo, cfs, tile=4)
    index.save(str(tmp_path / "idx"))
    drifted = EarlySNF(chroma_type="hpcp", downsample_fac=4,
                       pad_to_multiple=8, do_ssms=False,
                       snf_precision="default")
    with pytest.warns(UserWarning, match="snf_precision"):
        CoverIndex.load(drifted, str(tmp_path / "idx"))
