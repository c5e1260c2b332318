"""Regression tests for the sweep-engine safety guards: checkpoint
meta mode-matching, symmetrized-flag invalidation, resume streaming
cost, and the deterministic half-precision key decision."""

import os

import numpy as np

from acoss_jax.benchmarking.harness import _TileSweeper, run_pairwise
from tests.test_descstore import DotAlg, _fake_fs


def test_plain_sweeper_rejects_bucketed_ledger(tmp_path):
    """A plain sweep must NOT adopt a checkpoint written by a sweep mode
    with extra meta (e.g. the bucketed sweep, whose ledger indexes the
    length-SORTED song order): the extra-key sets must match exactly in
    BOTH directions."""
    ckpt = str(tmp_path / "ckpt.npz")
    a = _TileSweeper(("main",), 32, 8, True, None, ckpt,
                     ckpt_extra={"n_buckets": 2, "bucketed": 1})
    a.done[:] = True
    a.save_ckpt()

    # plain sweeper (empty ckpt_extra): the bucketed ledger is foreign
    b = _TileSweeper(("main",), 32, 8, True, None, ckpt)
    assert not b.done.any()

    # and the reverse: a bucketed sweeper must reject a plain ledger
    b.done[:] = True
    b.save_ckpt()
    c = _TileSweeper(("main",), 32, 8, True, None, ckpt,
                     ckpt_extra={"n_buckets": 2, "bucketed": 1})
    assert not c.done.any()

    # same-mode resume still works
    a.save_ckpt()
    d = _TileSweeper(("main",), 32, 8, True, None, ckpt,
                     ckpt_extra={"n_buckets": 2, "bucketed": 1})
    assert d.done.all()


def test_stale_symmetrized_flag_invalidated(tmp_path):
    """Reusing a scores_dir after the ledger was reset must re-mirror the
    recomputed lower triangle — the old symmetrized.flag may not leave a
    stale upper triangle in place."""
    fs1, fs2 = _fake_fs(12, seed=0), _fake_fs(12, seed=1)
    alg = DotAlg()
    sdir = str(tmp_path / "scores")
    ckpt = str(tmp_path / "ckpt.npz")

    d1 = alg.extract_descriptors(fs1)
    run_pairwise(alg, d1, 12, tile=4, scores_dir=sdir,
                 checkpoint_path=ckpt)
    assert os.path.exists(os.path.join(sdir, "symmetrized.flag"))

    # ledger invalidated (e.g. deleted / different mode), same scores_dir,
    # DIFFERENT descriptors: the result must equal a fresh sweep
    os.remove(ckpt)
    d2 = alg.extract_descriptors(fs2)
    D = run_pairwise(alg, d2, 12, tile=4, scores_dir=sdir,
                     checkpoint_path=ckpt)
    ref = run_pairwise(alg, d2, 12, tile=4)
    np.testing.assert_allclose(np.asarray(D["main"]),
                               np.asarray(ref["main"]), atol=1e-6)

    # a completed resume (all enumerated tiles done) keeps the flag —
    # strict-upper ledger entries are never set for symmetric sweeps,
    # so the check must look at the lower triangle only
    flag = os.path.join(sdir, "symmetrized.flag")
    assert os.path.exists(flag)
    D3 = run_pairwise(alg, d2, 12, tile=4, scores_dir=sdir,
                      checkpoint_path=ckpt)
    assert os.path.exists(flag)
    np.testing.assert_allclose(np.asarray(D3["main"]),
                               np.asarray(ref["main"]), atol=1e-6)


def test_completed_resume_streams_nothing(tmp_path, monkeypatch):
    """A resume whose ledger is already complete must not upload a single
    descriptor row tile (at Da-TACOS scale that is the whole store
    through a thin link)."""
    import acoss_jax.benchmarking.harness as H

    fs = _fake_fs(16)
    alg = DotAlg()
    ckpt = str(tmp_path / "ckpt.npz")
    desc = alg.extract_descriptors(fs)
    full = run_pairwise(alg, desc, 16, tile=4, checkpoint_path=ckpt,
                        device_resident=False)

    calls = {"n": 0}
    real_put = H.jax.device_put

    def counting_put(*a, **kw):
        calls["n"] += 1
        return real_put(*a, **kw)

    monkeypatch.setattr(H.jax, "device_put", counting_put)
    D = run_pairwise(alg, desc, 16, tile=4, checkpoint_path=ckpt,
                     device_resident=False)
    assert calls["n"] == 0
    np.testing.assert_allclose(np.asarray(D["main"]),
                               np.asarray(full["main"]), atol=1e-6)


def test_process_shard_full_scores_algorithm(tmp_path):
    """One-shot (full_scores) algorithms cannot be tile-sharded: process
    0 computes the whole matrix, other shards contribute EMPTY partials,
    and the merge equals the single-process result (previously every
    shard computed the full matrix and the merge summed N copies)."""
    from acoss_jax.parallel.distributed import (merge_partials,
                                                run_process_shard)

    class FullAlg(DotAlg):
        NAME = "FullDot"

        def full_scores(self, desc):
            v = np.asarray(desc["vec"], np.float64)
            return {"main": (v @ v.T).astype(np.float32)}

    fs = _fake_fs(10)
    alg = FullAlg()
    desc = alg.extract_descriptors(fs)
    from acoss_jax.benchmarking.harness import run_pairwise as rp
    ref = rp(alg, desc, 10)

    paths = [run_process_shard(alg, desc, 10, p, 3, str(tmp_path))
             for p in range(3)]
    Ds = merge_partials(paths, symmetric=alg.SYMMETRIC)
    np.testing.assert_allclose(np.asarray(Ds["main"]),
                               np.asarray(ref["main"]), atol=1e-6)


def test_bucket_truncation_keeps_valid_zero_frames():
    """A song whose trailing VALID frames are all-zero (e.g. silence ->
    zero features) must not be truncated below its length: those zero
    frames are real kNN candidates the plain sweep sees, and the
    bucketed sweep must score identically."""
    from acoss_jax.benchmarking.harness import _split_desc_buckets

    rng = np.random.default_rng(0)
    n, L, d = 8, 200, 4
    feats = rng.random((n, L, d)).astype(np.float32)
    lengths = np.full(n, L, np.int32)
    feats[:, 150:] = 0.0            # valid frames 150..199 are zero
    desc = {"vec": feats, "length": lengths}
    (bucket,) = _split_desc_buckets(desc, np.array([0, n]))
    assert bucket["vec"].shape[1] >= L


def test_extract_streamed_clears_stale_store(tmp_path):
    """Debris from an interrupted extraction (memmaps without META) must
    not be reopened with stale widths."""
    import os

    from acoss_jax.data.descstore import DescriptorStore, extract_streamed
    from tests.test_descstore import RaggedAlg

    fs = _fake_fs(12)
    path = str(tmp_path / "store")
    # fake an interrupted run: a too-narrow memmap, no META
    os.makedirs(path)
    np.lib.format.open_memmap(os.path.join(path, "vec.npy"), mode="w+",
                              dtype=np.float32, shape=(12, 2))
    desc = extract_streamed(RaggedAlg(), fs, path, chunk_songs=5)
    assert desc["vec"].shape[1] > 2   # real widths, not the stale memmap
    assert os.path.exists(os.path.join(path, DescriptorStore.META))
