"""Disk-backed descriptor store + streamed Da-TACOS-scale sweep."""

import numpy as np
import pytest

from acoss_jax.benchmarking.harness import CoverAlgorithm, run_pairwise
from acoss_jax.data.descstore import DescriptorStore, extract_streamed
from acoss_jax.data.store import FeatureSet


def _fake_fs(n, d=4, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, 1, d)).astype(np.float32)
    return FeatureSet(
        features={"vec": feats}, lengths={},
        labels=np.array([f"W{i // 2}" for i in range(n)]),
        track_ids=np.array([f"t{i}" for i in range(n)]))


class DotAlg(CoverAlgorithm):
    NAME = "DotAlg"
    SIMILARITY_TYPES = ("main",)
    SYMMETRIC = True
    TILE = 1024

    def extract_descriptors(self, fs):
        return {"vec": np.asarray(fs.feature("vec")[:, 0, :])}

    def tile_scores(self, row, col):
        return {"main": row["vec"] @ col["vec"].T}


class RaggedAlg(DotAlg):
    """Chunk-local descriptor widths differ (like bucket-padded pipelines);
    the store must reconcile to the global max width."""

    def extract_descriptors(self, fs):
        v = np.asarray(fs.feature("vec")[:, 0, :])
        w = int(v[:, 0].size % 3) + 2
        return {"vec": np.pad(v, [(0, 0), (0, w)])}


def test_extract_streamed_matches_in_ram(tmp_path):
    fs = _fake_fs(37)
    alg = DotAlg()
    ref = alg.extract_descriptors(fs)
    desc = extract_streamed(alg, fs, str(tmp_path / "store"),
                            chunk_songs=10)
    assert isinstance(desc["vec"], np.memmap)
    np.testing.assert_array_equal(np.asarray(desc["vec"]), ref["vec"])


def test_extract_streamed_pads_ragged_chunks(tmp_path):
    fs = _fake_fs(25)
    desc = extract_streamed(RaggedAlg(), fs, str(tmp_path / "store"),
                            chunk_songs=7)
    ref = RaggedAlg().extract_descriptors(fs)
    w = desc["vec"].shape[1]
    assert w >= ref["vec"].shape[1] - 2
    np.testing.assert_array_equal(np.asarray(desc["vec"][:, :4]),
                                  ref["vec"][:, :4])


def test_memmap_sweep_matches_ram_sweep(tmp_path):
    fs = _fake_fs(100)
    alg = DotAlg()
    ref = run_pairwise(alg, alg.extract_descriptors(fs), 100, tile=16)
    desc = extract_streamed(alg, fs, str(tmp_path / "store"),
                            chunk_songs=33)
    got = run_pairwise(alg, desc, 100, tile=16,
                       scores_dir=str(tmp_path / "scores"))
    assert isinstance(got["main"], np.memmap)
    np.testing.assert_allclose(np.asarray(got["main"]), ref["main"],
                               atol=1e-5)
    # re-invocation with the completed scores_dir must NOT double the
    # matrices (symmetrize guard) once the ledger marks tiles done
    ck = str(tmp_path / "ck.npz")
    got2 = run_pairwise(alg, desc, 100, tile=16,
                        scores_dir=str(tmp_path / "scores2"),
                        checkpoint_path=ck)
    got3 = run_pairwise(alg, desc, 100, tile=16,
                        scores_dir=str(tmp_path / "scores2"),
                        checkpoint_path=ck)
    np.testing.assert_allclose(np.asarray(got3["main"]),
                               np.asarray(got2["main"]), atol=1e-6)


@pytest.mark.slow
def test_da_tacos_scale_dry_run(tmp_path):
    """The Da-TACOS benchmark's 15,000-song pair grid (~1.1e8 symmetric
    pairs), swept end-to-end with disk-backed descriptors and memmapped
    score matrices: tiles stream through RAM; nothing whole-corpus is
    materialized on the host."""
    n = 15000
    fs = _fake_fs(n)
    alg = DotAlg()
    desc = extract_streamed(alg, fs, str(tmp_path / "store"),
                            chunk_songs=4096)
    assert isinstance(desc["vec"], np.memmap)
    Ds = run_pairwise(alg, desc, n, tile=1024,
                      scores_dir=str(tmp_path / "scores"),
                      checkpoint_path=str(tmp_path / "ledger.npz"))
    D = Ds["main"]
    assert isinstance(D, np.memmap) and D.shape == (n, n)
    # spot-check entries against direct computation
    rng = np.random.default_rng(0)
    V = np.asarray(desc["vec"])
    for _ in range(20):
        i, j = rng.integers(0, n, 2)
        if i == j:
            continue
        expect = float(V[i] @ V[j])
        assert abs(float(D[i, j]) - expect) < 1e-4
    assert abs(float(D[123, 123])) < 1e-6

def test_bucketed_streamed_composed(tmp_path):
    """Buckets + per-bucket disk stores + memmapped scores + ledger in
    ONE call (round-3 unified sweep), equal to the plain sweep; a second
    invocation reuses the stores and the idempotent symmetrize flag."""
    from acoss_jax.benchmarking.algorithms import Serra09
    from acoss_jax.benchmarking.harness import run_pairwise_bucketed
    from acoss_jax.data import make_synthetic_dataset

    fs = make_synthetic_dataset(n_cliques=5, clique_size=2, seed=9)
    algo = Serra09(chroma_type="hpcp", downsample_fac=4,
                   pad_to_multiple=8)
    # length-sort up front so the symmetric orientation conventions of
    # the two sweeps coincide (same caveat as the plain bucketed test)
    order = np.argsort(algo.bucket_lengths(fs), kind="stable")
    fs = fs.subset(order)
    desc = algo.extract_descriptors(fs)
    D_ref = run_pairwise(algo, desc, fs.n_songs, tile=4)

    sd = str(tmp_path / "stream")
    ck = str(tmp_path / "ledger.npz")
    Ds, desc_m, perm = run_pairwise_bucketed(
        algo, fs, n_buckets=3, tile=4, stream_dir=sd,
        checkpoint_path=ck, return_desc=True, return_perm=True)
    assert isinstance(Ds[next(iter(Ds))], np.memmap)
    # matrices are in length-sorted order == caller order here
    np.testing.assert_array_equal(perm, np.arange(fs.n_songs))
    for k in D_ref:
        np.testing.assert_allclose(np.asarray(Ds[k]), D_ref[k],
                                   atol=2e-4)
    # merged small keys serve post_process without re-extraction
    np.testing.assert_array_equal(desc_m["length"], desc["length"])

    # resume/reuse: bucket stores + done ledger + symmetrize flag make a
    # second invocation a cheap no-op with identical results
    Ds2 = run_pairwise_bucketed(algo, fs, n_buckets=3, tile=4,
                                stream_dir=sd, checkpoint_path=ck)
    for k in D_ref:
        np.testing.assert_allclose(np.asarray(Ds2[k]), D_ref[k],
                                   atol=2e-4)


def test_hybrid_panel_sweep_matches_plain(tmp_path):
    """The hybrid device-panel / disk-column sweep == plain run_pairwise
    on a real algorithm, with memmapped scores + ledger resume."""
    from acoss_jax.benchmarking.algorithms import Serra09
    from acoss_jax.benchmarking.harness import run_pairwise_hybrid
    from acoss_jax.data import make_synthetic_dataset

    fs = make_synthetic_dataset(n_cliques=6, clique_size=2, seed=11)
    algo = Serra09(chroma_type="hpcp", downsample_fac=4,
                   pad_to_multiple=8)
    desc = algo.extract_descriptors(fs)
    D_ref = run_pairwise(algo, desc, fs.n_songs, tile=4)

    store = extract_streamed(algo, fs, str(tmp_path / "store"),
                             chunk_songs=5)
    Ds = run_pairwise_hybrid(
        algo, store, fs.n_songs, panel_songs=8, tile=4,
        scores_dir=str(tmp_path / "scores"),
        checkpoint_path=str(tmp_path / "ledger.npz"))
    for k in D_ref:
        np.testing.assert_allclose(np.asarray(Ds[k]), D_ref[k],
                                   atol=2e-4)
    # resume is a no-op with identical results
    Ds2 = run_pairwise_hybrid(
        algo, store, fs.n_songs, panel_songs=8, tile=4,
        scores_dir=str(tmp_path / "scores"),
        checkpoint_path=str(tmp_path / "ledger.npz"))
    for k in D_ref:
        np.testing.assert_allclose(np.asarray(Ds2[k]), D_ref[k],
                                   atol=2e-4)


class WideDotAlg(DotAlg):
    """Heavy descriptor (>= 64 KB/song) to exercise the half-precision
    store layout; 'length' stays int32 (small/int keys are never
    downcast)."""

    def extract_descriptors(self, fs):
        v = np.asarray(fs.feature("vec")[:, 0, :])
        rng = np.random.default_rng(3)
        W = rng.normal(size=(v.shape[1], 20000)).astype(np.float32)
        return {"vec": (v @ W) / np.float32(np.sqrt(v.shape[1])),
                "length": np.full(len(v), 1, np.int32)}


def test_half_store_layout_and_sweep_error(tmp_path):
    """extract_streamed(half=True): heavy fp32 keys land as float16 on
    disk, small/int keys stay exact, and the sweeps upcast on device so
    scores differ from the fp32 store only by input quantization
    (~1e-3 relative)."""
    fs = _fake_fs(20)
    alg = WideDotAlg()
    ref = run_pairwise(alg, alg.extract_descriptors(fs), 20, tile=4)

    desc = extract_streamed(alg, fs, str(tmp_path / "store"),
                            chunk_songs=7, half=True)
    assert desc["vec"].dtype == np.float16
    assert desc["length"].dtype == np.int32
    scale = np.abs(ref["main"]).max()

    # plain streamed sweep over the half store
    got = run_pairwise(alg, desc, 20, tile=4)
    np.testing.assert_allclose(got["main"], ref["main"],
                               atol=5e-3 * scale)

    # hybrid panel sweep over the half store (fp16 panel pinned in HBM,
    # fp16 column tiles, upcast inside panel_vs_tile)
    from acoss_jax.benchmarking.harness import run_pairwise_hybrid
    Ds = run_pairwise_hybrid(alg, desc, 20, panel_songs=8, tile=4)
    np.testing.assert_allclose(np.asarray(Ds["main"]), ref["main"],
                               atol=5e-3 * scale)


def test_half_store_real_algorithm_map_unchanged(tmp_path):
    """Serra09 over a half-precision store: retrieval stats on the
    planted-clique corpus match the fp32 store bit-for-bit (descriptor
    quantization is far below the kNN-binarize decision margins)."""
    from acoss_jax.benchmarking.algorithms import Serra09
    from acoss_jax.benchmarking.evaluation import eval_statistics
    from acoss_jax.data import make_synthetic_dataset

    fs = make_synthetic_dataset(n_cliques=5, clique_size=2, seed=21)
    algo = Serra09(chroma_type="hpcp", downsample_fac=4,
                   pad_to_multiple=8)
    D_ref = run_pairwise(algo, algo.extract_descriptors(fs),
                         fs.n_songs, tile=4)
    # tiny synthetic songs sit below the 64 KB/song default threshold;
    # force even chroma/mfcc to fp16 — a stronger quantization test
    store = extract_streamed(algo, fs, str(tmp_path / "store"),
                             chunk_songs=5, half=True,
                             half_min_bytes=256)
    assert any(v.dtype == np.float16 for v in store.values())
    assert store["length"].dtype != np.float16
    Ds = run_pairwise(algo, store, fs.n_songs, tile=4)
    for k in D_ref:
        s_ref = eval_statistics(D_ref[k], fs.labels)
        s_half = eval_statistics(Ds[k], fs.labels)
        assert s_half.map == s_ref.map, k


def test_hybrid_process_shards_merge_to_plain(tmp_path):
    """Multi-process hybrid sweep: panels sharded across processes from
    one shared disk store, memmap partials merged == plain run_pairwise
    (the Da-TACOS heaviest-channel multi-chip mode)."""
    from acoss_jax.benchmarking.algorithms import Serra09
    from acoss_jax.parallel.distributed import (merge_partials,
                                                run_process_shard_hybrid)
    from acoss_jax.data import make_synthetic_dataset

    fs = make_synthetic_dataset(n_cliques=6, clique_size=2, seed=12)
    algo = Serra09(chroma_type="hpcp", downsample_fac=4,
                   pad_to_multiple=8)
    desc = algo.extract_descriptors(fs)
    D_ref = run_pairwise(algo, desc, fs.n_songs, tile=4)

    store = extract_streamed(algo, fs, str(tmp_path / "store"),
                             chunk_songs=5)
    paths = [
        run_process_shard_hybrid(
            algo, store, fs.n_songs, pid, 2, str(tmp_path / "partials"),
            panel_songs=8, tile=4)
        for pid in (0, 1)]
    assert paths[0] != paths[1]
    Ds = merge_partials(paths, symmetric=algo.SYMMETRIC)
    for k in D_ref:
        np.testing.assert_allclose(np.asarray(Ds[k]), D_ref[k],
                                   atol=2e-4)


class ChunkWidthAlg(DotAlg):
    """Descriptor whose chunk-local padded width straddles the
    half_min_bytes threshold: odd chunks pad wider than even ones."""

    def __init__(self):
        super().__init__()
        self._chunk = -1

    def extract_descriptors(self, fs):
        self._chunk += 1
        v = np.asarray(fs.feature("vec")[:, 0, :])
        w = 40 if self._chunk % 2 else 24   # 160 B vs 96 B per song
        return {"vec": np.pad(v, [(0, 0), (0, w - v.shape[1])])}


def test_half_key_decision_is_first_chunk_only(tmp_path):
    """half=True must decide the fp16 key set ONCE (first chunk): a
    near-threshold key whose chunk-local padded width straddles
    half_min_bytes may not end up quantized in some chunks and exact in
    others (nor may the store dtype depend on which chunk ran last)."""
    fs = _fake_fs(20)

    # first chunk below the threshold -> the key stays fp32 everywhere,
    # even though later (wider) chunks cross it
    desc = extract_streamed(ChunkWidthAlg(), fs,
                            str(tmp_path / "store_lo"),
                            chunk_songs=7, half=True, half_min_bytes=100)
    assert desc["vec"].dtype == np.float32
    ref = ChunkWidthAlg().extract_descriptors(fs.subset(np.arange(7)))
    np.testing.assert_array_equal(desc["vec"][:7, :24],
                                  ref["vec"][:, :24])

    # first chunk above the threshold -> fp16 everywhere
    desc2 = extract_streamed(ChunkWidthAlg(), fs,
                             str(tmp_path / "store_hi"),
                             chunk_songs=7, half=True, half_min_bytes=64)
    assert desc2["vec"].dtype == np.float16


# ---------------------------------------------------------------------------
# int8 quantized streaming (--stream-int8)
# ---------------------------------------------------------------------------

def test_quantize_int8_roundtrip_bound():
    from acoss_jax.data.descstore import quantize_int8

    rng = np.random.default_rng(11)
    v = rng.standard_normal((6, 30, 40)).astype(np.float32) * \
        (10.0 ** rng.integers(-3, 3, size=(6, 1, 1)))
    q, s = quantize_int8(v)
    assert q.dtype == np.int8 and s.shape == (6,)
    back = q.astype(np.float32) * s[:, None, None]
    amax = np.abs(v).reshape(6, -1).max(axis=1)
    # symmetric 127-level quantization: error <= scale/2 per element
    assert (np.abs(back - v).reshape(6, -1).max(axis=1)
            <= amax / 127.0 / 2 + 1e-7).all()
    # all-zero songs dequantize to exact zeros
    qz, sz = quantize_int8(np.zeros((2, 4, 4), np.float32))
    np.testing.assert_array_equal(qz, 0)
    np.testing.assert_array_equal(sz, 1.0)


def test_upcast_stream_dequantizes_and_drops_companions():
    import jax.numpy as jnp

    from acoss_jax.data.descstore import quantize_int8, upcast_stream

    rng = np.random.default_rng(5)
    v = rng.standard_normal((4, 8, 8)).astype(np.float32)
    q, s = quantize_int8(v)
    d = {"ssms": jnp.asarray(q), "ssms@qscale": jnp.asarray(s),
         "half": jnp.asarray(v[:, 0], jnp.float16),
         "length": jnp.full(4, 7, jnp.int32)}
    out = upcast_stream(d)
    assert set(out) == {"ssms", "half", "length"}
    assert out["ssms"].dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(out["ssms"]), v, atol=2e-2)
    assert out["half"].dtype == jnp.float32
    assert out["length"].dtype == jnp.int32


def test_int8_store_layout_and_sweeps(tmp_path):
    """extract_streamed(quant='int8'): heavy fp32 keys land as int8 +
    @qscale companions, and the plain/hybrid sweeps dequantize on device
    so scores differ from fp32 only by input quantization."""
    fs = _fake_fs(20)
    alg = WideDotAlg()
    ref = run_pairwise(alg, alg.extract_descriptors(fs), 20, tile=4)

    desc = extract_streamed(alg, fs, str(tmp_path / "store"),
                            chunk_songs=7, quant="int8")
    assert desc["vec"].dtype == np.int8
    assert desc["vec@qscale"].dtype == np.float32
    assert desc["length"].dtype == np.int32
    scale = np.abs(ref["main"]).max()

    got = run_pairwise(alg, desc, 20, tile=4)
    np.testing.assert_allclose(got["main"], ref["main"],
                               atol=2e-2 * scale)

    from acoss_jax.benchmarking.harness import run_pairwise_hybrid
    Ds = run_pairwise_hybrid(alg, desc, 20, panel_songs=8, tile=4)
    np.testing.assert_allclose(np.asarray(Ds["main"]), ref["main"],
                               atol=2e-2 * scale)


def test_int8_store_real_algorithm_map_unchanged(tmp_path):
    """Serra09 over an int8 store: retrieval stats on the planted-clique
    corpus match the fp32 store (quantization sits far below the
    kNN-binarize decision margins)."""
    from acoss_jax.benchmarking.algorithms import Serra09
    from acoss_jax.benchmarking.evaluation import eval_statistics
    from acoss_jax.data import make_synthetic_dataset

    fs = make_synthetic_dataset(n_cliques=5, clique_size=2, seed=21)
    algo = Serra09(chroma_type="hpcp", downsample_fac=4,
                   pad_to_multiple=8)
    D_ref = run_pairwise(algo, algo.extract_descriptors(fs),
                         fs.n_songs, tile=4)
    store = extract_streamed(algo, fs, str(tmp_path / "store"),
                             chunk_songs=5, quant="int8",
                             half_min_bytes=256)
    assert any(v.dtype == np.int8 for v in store.values())
    assert store["length"].dtype == np.int32
    Ds = run_pairwise(algo, store, fs.n_songs, tile=4)
    for k in D_ref:
        s_ref = eval_statistics(D_ref[k], fs.labels)
        s_q = eval_statistics(Ds[k], fs.labels)
        assert s_q.map == s_ref.map, k


def test_stream_consistency_matrix(tmp_path):
    """check_stream_consistency: reusing a store at HIGHER precision
    than it holds raises; lower just notes and proceeds."""
    from acoss_jax.data.descstore import (check_stream_consistency,
                                          store_quant)

    fs = _fake_fs(10)
    alg = WideDotAlg()
    stores = {
        None: extract_streamed(alg, fs, str(tmp_path / "s32"),
                               chunk_songs=5),
        "half": extract_streamed(alg, fs, str(tmp_path / "s16"),
                                 chunk_songs=5, quant="half"),
        "int8": extract_streamed(alg, fs, str(tmp_path / "s8"),
                                 chunk_songs=5, quant="int8"),
    }
    rank = {None: 0, "half": 1, "int8": 2}
    for have, d in stores.items():
        assert store_quant(d) == have
        for want in (None, "half", "int8"):
            if rank[have] > rank[want]:
                with pytest.raises(ValueError):
                    check_stream_consistency(d, want, "p")
            else:
                check_stream_consistency(d, want, "p")


def test_bucketed_streamed_int8(tmp_path):
    """Buckets + per-bucket int8 disk stores (stream_quant='int8'):
    cross-bucket axis-1 padding must skip the 1-D @qscale companions and
    retrieval stats must match the fp32 bucketed sweep."""
    from acoss_jax.benchmarking.algorithms import Serra09
    from acoss_jax.benchmarking.evaluation import eval_statistics
    from acoss_jax.benchmarking.harness import run_pairwise_bucketed
    from acoss_jax.data import make_synthetic_dataset

    fs = make_synthetic_dataset(n_cliques=5, clique_size=2, seed=9)
    algo = Serra09(chroma_type="hpcp", downsample_fac=4,
                   pad_to_multiple=8)
    order = np.argsort(algo.bucket_lengths(fs), kind="stable")
    fs = fs.subset(order)
    D_ref, _, _ = run_pairwise_bucketed(
        algo, fs, n_buckets=3, tile=4,
        stream_dir=str(tmp_path / "s32"), return_desc=True,
        return_perm=True)

    Ds, _, _ = run_pairwise_bucketed(
        algo, fs, n_buckets=3, tile=4, stream_dir=str(tmp_path / "s8"),
        stream_quant="int8", stream_chunk=4, stream_min_bytes=256,
        return_desc=True, return_perm=True)
    from acoss_jax.data.descstore import DescriptorStore
    b0 = DescriptorStore.open(
        str(tmp_path / "s8" / "desc" / "bucket_0000"))
    assert any(k.endswith("@qscale") for k in b0), sorted(b0)
    for k in D_ref:
        s_ref = eval_statistics(np.asarray(D_ref[k]), fs.labels)
        s_q = eval_statistics(np.asarray(Ds[k]), fs.labels)
        assert s_q.map == s_ref.map, k


class RaggedDotAlg(CoverAlgorithm):
    """Descriptor width follows the subset's max length (like every real
    algorithm), so per-bucket streamed stores pad to different widths."""

    NAME = "RaggedDotAlg"
    SIMILARITY_TYPES = ("main",)
    SYMMETRIC = True
    TILE = 2

    def extract_descriptors(self, fs):
        import numpy as np
        lens = np.asarray(fs.length("vec"))
        w = int(lens.max())
        v = np.asarray(fs.feature("vec")[:, :w], np.float32)
        mask = np.arange(w)[None, :] < lens[:, None]
        return {"vec": v * mask[..., None],
                "length": lens.astype(np.int32)}

    def tile_scores(self, row, col):
        import jax.numpy as jnp
        return {"main": jnp.einsum("ild,jld->ij",
                                   row["vec"], col["vec"])}


def test_bucketed_streamed_mixed_quant_buckets(tmp_path):
    """A near-threshold key can be int8-quantized in the LONG bucket but
    fp32 in the SHORT one (the quantized-key decision uses bucket-local
    padded widths). Cross-bucket tiles must then reconcile one-sided
    @qscale companions instead of raising KeyError / silently dropping
    the companion (regression: `_pad_tile_pair_axis1` union iteration)."""
    from acoss_jax.benchmarking.harness import run_pairwise_bucketed

    rng = np.random.default_rng(3)
    n, Lmax, d = 8, 64, 8
    lens = np.array([16, 16, 16, 16, 64, 64, 64, 64], np.int32)
    vec = rng.normal(size=(n, Lmax, d)).astype(np.float32)
    vec *= (np.arange(Lmax)[None, :, None] < lens[:, None, None])
    fs = FeatureSet(features={"vec": vec}, lengths={"vec": lens},
                    labels=np.array([f"W{i // 2}" for i in range(n)]),
                    track_ids=np.array([f"t{i}" for i in range(n)]))

    alg = RaggedDotAlg()
    ref = alg.extract_descriptors(fs)
    from acoss_jax.benchmarking.harness import run_pairwise
    D_ref = run_pairwise(alg, ref, n, tile=2)

    # threshold between the short bucket's row bytes (16*8*4 = 512) and
    # the long bucket's (64*8*4 = 2048)
    Ds, desc, perm = run_pairwise_bucketed(
        alg, fs, n_buckets=2, tile=2,
        stream_dir=str(tmp_path / "mixed"), stream_quant="int8",
        stream_chunk=8, stream_min_bytes=1024,
        return_desc=True, return_perm=True)
    b0 = DescriptorStore.open(str(tmp_path / "mixed/desc/bucket_0000"))
    b1 = DescriptorStore.open(str(tmp_path / "mixed/desc/bucket_0001"))
    assert not any(k.endswith("@qscale") for k in b0), sorted(b0)
    assert any(k.endswith("@qscale") for k in b1), sorted(b1)

    got = np.asarray(Ds["main"])
    want = np.asarray(D_ref["main"])[np.ix_(perm, perm)]
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 0.02 * scale
    # cross-bucket blocks specifically (short rows x long cols) must be
    # populated, not zero/garbage
    assert np.abs(got[:4, 4:] - want[:4, 4:]).max() <= 0.02 * scale
    # merged small keys are dequantized fp32, never scaled int8
    assert desc["length"].dtype == np.int32
    assert not any(k.endswith("@qscale") for k in desc)
