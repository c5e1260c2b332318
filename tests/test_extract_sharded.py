"""Sharded / parallel extraction: the reference's `-m cluster` array-job
mode (`/root/reference/preprocess/extractors.py:81-146`) and the `-n`
thread fan-out. N-way sharded extraction + merge must be bit-identical
to the serial run."""

import wave

import numpy as np
import pytest

from acoss_jax.cli import main
from acoss_jax.data.store import FeatureSet, concat_feature_sets
from acoss_jax.features.pipeline import batch_extract

SR = 44100
FEATURES = ["hpcp", "madmom_features"]   # keep the test light


def _write_wav(path, freq, dur=2.0):
    t = np.arange(int(SR * dur)) / SR
    y = 0.5 * np.sin(2 * np.pi * freq * t)
    # clicks so onset/beat stages have structure
    for c in np.arange(0.25, dur, 0.5):
        i = int(c * SR)
        y[i:i + 200] += 0.4
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((np.clip(y, -1, 1) * 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("audio")
    freqs = [220.0, 261.63, 329.63, 392.0, 440.0]
    for i, f in enumerate(freqs):
        d = root / f"W_{i % 2}"
        d.mkdir(exist_ok=True)
        _write_wav(d / f"song{i}.wav", f)
    return root


def _assert_fs_equal(a: FeatureSet, b: FeatureSet):
    assert sorted(a.features) == sorted(b.features)
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.track_ids, b.track_ids)
    for k in a.features:
        np.testing.assert_array_equal(a.feature(k), b.feature(k), err_msg=k)
        np.testing.assert_array_equal(a.length(k), b.length(k), err_msg=k)


def test_thread_pool_matches_serial(wav_dir):
    import glob

    paths = sorted(glob.glob(str(wav_dir / "**" / "*.wav"),
                             recursive=True))[:3]
    labels = ["W_0", "W_0", "W_1"]
    serial = batch_extract(paths, labels, features=FEATURES)
    pooled = batch_extract(paths, labels, features=FEATURES, n_workers=3)
    _assert_fs_equal(serial, pooled)


def test_cluster_shard_merge_bit_identical(wav_dir, tmp_path,
                                           monkeypatch):
    from acoss_jax.features import pipeline

    monkeypatch.setitem(pipeline.PROFILE, "features", FEATURES)

    full = tmp_path / "full.npz"
    assert main(["extract", "-i", str(wav_dir), "-o", str(full)]) == 0

    out = tmp_path / "merged.npz"
    for sid in range(3):
        rc = main(["extract", "-i", str(wav_dir), "-o", str(out),
                   "-m", "cluster", "--num-shards", "3",
                   "--shard-id", str(sid), "-n", "2"])
        assert rc == 0
        assert (tmp_path / f"merged.part_{sid}_3.npz").exists()

    # merge refuses while a shard is missing
    part1 = tmp_path / "merged.part_1_3.npz"
    stash = part1.read_bytes()
    part1.unlink()
    assert main(["extract", "--merge-shards", "-o", str(out)]) == 1
    part1.write_bytes(stash)

    assert main(["extract", "--merge-shards", "-o", str(out)]) == 0
    _assert_fs_equal(FeatureSet.load(str(full)), FeatureSet.load(str(out)))


def test_extract_arg_validation(tmp_path):
    # missing -i without --merge-shards
    assert main(["extract", "-o", str(tmp_path / "x.npz")]) == 1
    # bad shard id
    assert main(["extract", "-i", str(tmp_path), "-o",
                 str(tmp_path / "x.npz"), "-m", "cluster",
                 "--num-shards", "2", "--shard-id", "2"]) == 1
    # merge with no parts
    assert main(["extract", "--merge-shards",
                 "-o", str(tmp_path / "none.npz")]) == 1


def test_concat_feature_sets_validation():
    a = FeatureSet(features={"x": np.zeros((2, 4, 3), np.float32)},
                   lengths={"x": np.array([4, 2], np.int32)},
                   labels=np.array(["a", "a"]),
                   track_ids=np.array(["t0", "t1"]))
    b = FeatureSet(features={"y": np.zeros((1, 4, 3), np.float32)},
                   lengths={"y": np.array([4], np.int32)},
                   labels=np.array(["b"]), track_ids=np.array(["t2"]))
    with pytest.raises(ValueError):
        concat_feature_sets([a, b])
    with pytest.raises(ValueError):
        concat_feature_sets([])

    # ragged re-pad: different Lmax per shard
    c = FeatureSet(features={"x": np.ones((1, 7, 3), np.float32)},
                   lengths={"x": np.array([7], np.int32)},
                   labels=np.array(["c"]), track_ids=np.array(["t3"]))
    m = concat_feature_sets([a, c])
    assert m.feature("x").shape == (3, 7, 3)
    assert m.feature("x")[0, 4:].sum() == 0          # re-padded with zeros
    np.testing.assert_array_equal(m.length("x"), [4, 2, 7])
    np.testing.assert_array_equal(m.labels, ["a", "a", "c"])
