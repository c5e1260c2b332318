"""Multi-chip sharding tests on the virtual 8-device CPU mesh: the sharded
pair sweep must agree with the single-device harness sweep."""

import jax
import numpy as np
import pytest

from acoss_jax.benchmarking.algorithms import Serra09
from acoss_jax.benchmarking.harness import run_pairwise
from acoss_jax.data import make_synthetic_dataset
from acoss_jax.parallel import make_pair_mesh, sharded_pair_scores


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (1, 8)])
def test_sharded_matches_single_device(shape):
    fs = make_synthetic_dataset(n_cliques=6, clique_size=2,
                                n_distractors=2, seed=3)
    algo = Serra09(chroma_type="hpcp", downsample_fac=4)
    desc = algo.extract_descriptors(fs)

    D_ref = run_pairwise(algo, desc, fs.n_songs, tile=8)
    mesh = make_pair_mesh(shape=shape)
    D_sh = sharded_pair_scores(algo.tile_scores, desc, fs.n_songs, mesh,
                               col_tile=4)
    tril = np.tril_indices(fs.n_songs, -1)
    for k in D_ref:
        # Scores are orientation-dependent (OTI direction), so compare the
        # strict lower triangle, which both paths compute as (row i, col j).
        np.testing.assert_allclose(D_sh[k][tril], D_ref[k][tril], atol=1e-5)


@pytest.mark.parametrize(
    "backend", ["xla", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_sharded_with_aligner_backend_in_graph(request, backend):
    """The selected aligner backend must trace + run INSIDE shard_map (the
    CUDA kernels are an FFI call there, checked on a card with -m gpu)."""
    if backend == "cuda":
        request.getfixturevalue("gpu")
    fs = make_synthetic_dataset(n_cliques=4, clique_size=2, seed=5)
    algo = Serra09(chroma_type="hpcp", downsample_fac=4)
    algo.aligner = backend
    desc = algo.extract_descriptors(fs)

    mesh = make_pair_mesh(shape=(1, len(jax.devices())))
    D_sh = sharded_pair_scores(algo.tile_scores, desc, fs.n_songs, mesh,
                               col_tile=2)
    D_ref = run_pairwise(algo, desc, fs.n_songs, tile=8)
    tril = np.tril_indices(fs.n_songs, -1)
    for k in D_ref:
        np.testing.assert_allclose(D_sh[k][tril], D_ref[k][tril], atol=1e-5)


@pytest.mark.parametrize("n_devices", [8, 4])
def test_triangular_sharded_matches_single_device(n_devices):
    """The fold-balanced triangular mesh sweep (half the rectangular
    FLOPs) must equal the single-device harness sweep exactly."""
    from acoss_jax.parallel import sharded_pair_scores_triangular

    fs = make_synthetic_dataset(n_cliques=6, clique_size=2,
                                n_distractors=2, seed=3)
    algo = Serra09(chroma_type="hpcp", downsample_fac=4)
    desc = algo.extract_descriptors(fs)

    D_ref = run_pairwise(algo, desc, fs.n_songs, tile=8)
    D_tr = sharded_pair_scores_triangular(
        algo.tile_scores, desc, fs.n_songs,
        devices=jax.devices()[:n_devices], col_tile=4)
    for k in D_ref:
        np.testing.assert_allclose(D_tr[k], D_ref[k], atol=1e-5)


def test_sharded_half_precision_descriptors():
    """fp16 descriptors (the --stream-half store layout) through both
    mesh sweeps: upcast to fp32 on device, scores within quantization
    error of the fp32 run."""
    from acoss_jax.parallel import sharded_pair_scores_triangular

    fs = make_synthetic_dataset(n_cliques=4, clique_size=2, seed=7)
    algo = Serra09(chroma_type="hpcp", downsample_fac=4)
    desc = algo.extract_descriptors(fs)
    half = {k: np.asarray(v).astype(np.float16)
            if np.asarray(v).dtype == np.float32 else np.asarray(v)
            for k, v in desc.items()}

    D_ref = run_pairwise(algo, desc, fs.n_songs, tile=8)
    mesh = make_pair_mesh(shape=(2, 4))
    D_sh = sharded_pair_scores(algo.tile_scores, half, fs.n_songs, mesh,
                               col_tile=4)
    D_tr = sharded_pair_scores_triangular(
        algo.tile_scores, half, fs.n_songs, col_tile=4)
    tril = np.tril_indices(fs.n_songs, -1)
    for k in D_ref:
        assert D_sh[k].dtype == np.float32
        np.testing.assert_allclose(D_sh[k][tril], D_ref[k][tril],
                                   atol=5e-2)
        np.testing.assert_allclose(D_tr[k][tril], D_ref[k][tril],
                                   atol=5e-2)


def test_triangular_fold_balance():
    """Every device owns exactly 2D+1 equal-size blocks (constant work)."""
    D = 4
    two_d = 2 * D
    for d in range(D):
        n_blocks = (d + 1) + (two_d - d)
        assert n_blocks == two_d + 1


def test_process_sharding_matches_full(tmp_path):
    """3 simulated processes x file merge == single-process sweep."""
    from acoss_jax.benchmarking.algorithms import Serra09
    from acoss_jax.parallel.distributed import (assign_block_rows,
                                                merge_partials,
                                                run_process_shard)

    fs = make_synthetic_dataset(n_cliques=6, clique_size=2, seed=4)
    algo = Serra09(chroma_type="hpcp", downsample_fac=4)
    desc = algo.extract_descriptors(fs)
    D_full = run_pairwise(algo, desc, fs.n_songs, tile=4)

    rows = assign_block_rows(3, 3)
    assert sorted(np.concatenate(rows).tolist()) == [0, 1, 2]

    paths = [run_process_shard(algo, desc, fs.n_songs, p, 3,
                               str(tmp_path), tile=4) for p in range(3)]
    merged = merge_partials(paths, symmetric=True)
    for k in D_full:
        np.testing.assert_allclose(merged[k], D_full[k], atol=1e-6)


def test_process_sharding_memmap_partials(tmp_path):
    """Memmap-partial shards (directories of .npy) merge into memmapped
    matrices equal to the single-process sweep — nothing dense in RAM."""
    from acoss_jax.parallel.distributed import (merge_partials,
                                                run_process_shard)

    fs = make_synthetic_dataset(n_cliques=6, clique_size=2, seed=4)
    algo = Serra09(chroma_type="hpcp", downsample_fac=4)
    desc = algo.extract_descriptors(fs)
    D_full = run_pairwise(algo, desc, fs.n_songs, tile=4)

    paths = [run_process_shard(algo, desc, fs.n_songs, p, 2,
                               str(tmp_path), tile=4,
                               memmap_scores=True) for p in range(2)]
    import os
    assert all(os.path.isdir(p) for p in paths)
    merged = merge_partials(paths, symmetric=True,
                            out_dir=str(tmp_path / "merged"))
    for k in D_full:
        assert isinstance(merged[k], np.memmap)
        np.testing.assert_allclose(np.asarray(merged[k]), D_full[k],
                                   atol=1e-6)
