"""Tests for manifests, h5 interop, legacy similarity API, utils, CLI."""

import os

import numpy as np
import pytest

from acoss_jax.data import make_synthetic_dataset
from acoss_jax.data.manifest import (covers80_list, create_collection_files,
                                     label_of, load_subset_json,
                                     subset_paths, track_id_of)
from acoss_jax.data.store import FeatureSet


def test_manifest_roundtrip(tmp_path):
    import json
    subset = {"W_1": ["W_1/P_a.mp3", "W_1/P_b.mp3"],
              "W_2": ["W_2/P_c.mp3"]}
    p = tmp_path / "subset.json"
    p.write_text(json.dumps(subset))
    loaded = load_subset_json(str(p))
    paths = subset_paths(loaded)
    assert paths == ["W_1/P_a.mp3", "W_1/P_b.mp3", "W_2/P_c.mp3"]
    assert label_of(paths[0]) == "W_1"
    assert track_id_of(paths[0]) == "P_a"
    outs = create_collection_files(paths, str(tmp_path / "c"), 2)
    assert len(outs) == 2
    lines = sum((open(o).read().split() for o in outs), [])
    assert lines == paths


def test_covers80_list(tmp_path):
    d = tmp_path / "covers32k"
    d.mkdir()
    (d / "list1.list").write_text("A_+_B/one\nC_+_D/two\n")
    (d / "list2.list").write_text("A_+_B/one2\nC_+_D/two2\n")
    paths, labels = covers80_list(str(d))
    assert len(paths) == 4
    assert labels == ["A_+_B", "C_+_D", "A_+_B", "C_+_D"]


def test_h5_interop(tmp_path):
    import h5py

    from acoss_jax.data.h5io import feature_set_from_h5_dir
    rng = np.random.default_rng(0)
    for i in range(3):
        with h5py.File(tmp_path / f"t{i}.h5", "w") as f:
            f["hpcp"] = rng.random((50 + i, 12)).astype(np.float32)
            f["mfcc_htk"] = rng.random((13, 50 + i)).astype(np.float32)
            g = f.create_group("madmom_features")
            g["onsets"] = np.arange(0, 50, 5)
            g["novfn"] = rng.random(50 + i).astype(np.float32)
            g["snovfn"] = rng.random(50 + i).astype(np.float32)
            f["label"] = f"W_{i // 2}"
            f["track_id"] = f"P_{i}"
    fs = feature_set_from_h5_dir(str(tmp_path))
    assert fs.n_songs == 3
    assert fs.feature("mfcc_htk").shape[2] == 13   # transposed frames-first
    assert list(fs.labels) == ["W_0", "W_0", "W_1"]


def test_legacy_similarity(rng):
    from acoss_jax.ops.similarity_legacy import (
        cross_recurrent_plot, optimal_transposition_index,
        serra_cover_similarity_measures, to_embedding, transpose_by_oti)
    A = rng.random((120, 12))
    B = np.roll(A, 5, axis=1) + 0.02 * rng.random((120, 12))
    oti = optimal_transposition_index(A, B)
    # rolling B by oti should undo the transposition (7 + 5 = 12)
    assert (oti + 5) % 12 == 0
    emb = to_embedding(A, tau=1, m=9)
    assert emb.shape == (111, 108)
    crp = cross_recurrent_plot(A, B)
    assert set(np.unique(crp)).issubset({0.0, 1.0})
    # covers have a strong diagonal -> low distance vs a random pair
    d_cover = serra_cover_similarity_measures(crp.astype(np.uint8))
    C = rng.random((120, 12))
    crp2 = cross_recurrent_plot(A, C)
    d_rand = serra_cover_similarity_measures(crp2.astype(np.uint8))
    assert d_cover < d_rand


def test_utils(tmp_path):
    from acoss_jax.utils import ErrorFile, get_logger, timeit
    log = get_logger("t", str(tmp_path / "log.txt"))
    log.info("hello")
    ef = ErrorFile(str(tmp_path / "errors.txt"))
    ef.add("song1.mp3", "boom")
    ef.add("song2.mp3")
    assert ef.tracks() == ["song1.mp3", "song2.mp3"]

    @timeit
    def f(x):
        return x + 1
    assert f(1) == 2


def test_cli_benchmark(tmp_path, monkeypatch):
    from acoss_jax.cli import main
    fs = make_synthetic_dataset(n_cliques=4, clique_size=2, seed=2)
    store = tmp_path / "feat.npz"
    fs.save(str(store))
    monkeypatch.chdir(tmp_path)
    rc = main(["benchmark", "-a", "FTM2D", "-d", str(store),
               "-s", "synthtest"])
    assert rc == 0
    assert os.path.exists(tmp_path / "results_synthtest.csv")


def test_profiling_stage_times_and_trace(tmp_path):
    import jax.numpy as jnp

    from acoss_jax.utils import profiling

    st = profiling.StageTimes()
    st.enabled = True          # stage() is a no-op context when disabled
    with st.stage("a"):
        st.block(jnp.ones(8) * 2)
    with st.stage("a"):
        pass
    with st.stage("b"):
        pass
    assert st.count["a"] == 2 and st.count["b"] == 1
    rep = st.report()
    assert "a" in rep and "per_call_ms" in rep

    logdir = str(tmp_path / "trace")
    with profiling.device_trace(logdir):
        with profiling.step_annotation("tile", ti=0, tj=0):
            jnp.dot(jnp.ones((8, 8)), jnp.ones((8, 8))).block_until_ready()
    import os
    assert os.path.isdir(logdir) and os.listdir(logdir)
    with profiling.device_trace(None):   # no-op path
        pass


def test_stage_times_disabled_noop():
    from acoss_jax.utils import profiling

    st = profiling.StageTimes()
    with st.stage("x"):
        pass
    assert not st.total and not st.count


def test_errorfile_multiline_errors(tmp_path):
    """A traceback payload must stay ONE ledger row; tracks() never
    returns traceback fragments as track names."""
    from acoss_jax.utils.logging import ErrorFile

    ef = ErrorFile(str(tmp_path / "err.txt"))
    ef.add("song_a.mp3", "Traceback (most recent call last):\n"
           "  File \"x.py\", line 1\nValueError: boom")
    ef.add("song_b.mp3", "short")
    assert ef.tracks() == ["song_a.mp3", "song_b.mp3"]


def test_get_logger_late_logfile(tmp_path):
    """A logfile request after the logger already exists (console-only)
    still attaches the file handler — once."""
    import logging as _logging

    from acoss_jax.utils.logging import get_logger

    name = "acoss_jax_test_late"
    get_logger(name)                       # console-only first
    lf = str(tmp_path / "run.log")
    lg = get_logger(name, logfile=lf)
    lg.info("hello")
    get_logger(name, logfile=lf)           # no duplicate handler
    n_file = sum(isinstance(h, _logging.FileHandler)
                 for h in lg.handlers)
    assert n_file == 1
    for h in lg.handlers:
        h.flush()
    assert "hello" in open(lf).read()
