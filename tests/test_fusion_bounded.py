"""Bounded-selection fusion paths are bit-identical to the full-sort paths.

`fusion._smallest_sorted` with a static bound materializes the exact k
smallest row values via `lax.top_k` (same values, same ascending order a
full row sort yields), so every consumer — get_W / get_WCSM / get_WCSMSSM
/ get_S / snf_ws — must produce bitwise-identical output with and without
`k_static_max`. These tests pin that contract, including ties, padding
masks, traced K, and the host-int auto-derivation.
"""

import jax
import jax.numpy as jnp
import numpy as np

from acoss_jax.ops import fusion
from acoss_jax.ops.structure import fused_w_batch


def _rand(rng, m, n, ties=True):
    D = rng.random((m, n)).astype(np.float32)
    if ties:
        D = np.round(D * 8.0) / 8.0  # heavy duplicate values
    return D


def test_smallest_sorted_prefix_of_sort():
    rng = np.random.default_rng(0)
    D = jnp.asarray(_rand(rng, 40, 64))
    full = fusion._smallest_sorted(D, None)
    part = fusion._smallest_sorted(D, 9)
    np.testing.assert_array_equal(np.asarray(full)[:, :9], np.asarray(part))
    # bound >= width falls back to the full sort
    np.testing.assert_array_equal(
        np.asarray(full), np.asarray(fusion._smallest_sorted(D, 64)))


def test_get_w_bounded_matches_sort_traced_k():
    rng = np.random.default_rng(1)
    D = jnp.asarray(_rand(rng, 96, 96))
    for K in (1, 7, 13):
        ref = fusion.get_W(D, jnp.int32(K))              # traced K: sort
        got = fusion.get_W(D, jnp.int32(K), k_static_max=K)
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


def test_get_w_bounded_with_length_mask():
    rng = np.random.default_rng(2)
    D = jnp.asarray(_rand(rng, 64, 64))
    ref = fusion.get_W(D, jnp.int32(5), length=jnp.int32(41))
    got = fusion.get_W(D, jnp.int32(5), length=jnp.int32(41),
                       k_static_max=6)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


def test_get_w_auto_bound_from_host_int():
    rng = np.random.default_rng(3)
    D = jnp.asarray(_rand(rng, 48, 48))
    ref = fusion.get_W(D, jnp.int32(6))                  # sort path
    got = fusion.get_W(D, 6)                             # auto top_k path
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


def test_get_wcsm_bounded_matches_sort():
    rng = np.random.default_rng(4)
    C = jnp.asarray(_rand(rng, 56, 72))
    k1, k2 = jnp.int32(4), jnp.int32(9)
    ref = fusion.get_WCSM(C, k1, k2, row_length=jnp.int32(50),
                          col_length=jnp.int32(61))
    got = fusion.get_WCSM(C, k1, k2, row_length=jnp.int32(50),
                          col_length=jnp.int32(61), k_static_max=9)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))
    # host-int k1/k2 auto-derive the bound
    auto = fusion.get_WCSM(C, 4, 9, row_length=jnp.int32(50),
                           col_length=jnp.int32(61))
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(auto))


def test_get_s_bounded_matches_sort():
    rng = np.random.default_rng(5)
    W = jnp.asarray(_rand(rng, 80, 80))
    ref = fusion.get_S(W, jnp.int32(11))
    got = fusion.get_S(W, jnp.int32(11), k_static_max=11)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


def test_wcsmssm_snf_pipeline_bounded_matches_sort():
    """EarlySNF-shaped pipeline: padded SSMs/CSM, traced K, both update
    orders — fused output must be bitwise identical with the bound."""
    rng = np.random.default_rng(6)
    Lp = 48
    m_len, n_len = jnp.int32(37), jnp.int32(43)
    kappa = 0.095
    K = jnp.int32(int(kappa * (37 + 43)))
    kmax = int(np.ceil(kappa * 2 * Lp)) + 1

    def mk_ssm(seed):
        x = np.zeros((Lp, Lp), np.float32)
        v = _rand(np.random.default_rng(seed), Lp, Lp)
        x[:] = 0.5 * (v + v.T)
        return jnp.asarray(x)

    ssma, ssmb = mk_ssm(7), mk_ssm(8)
    csm = jnp.asarray(_rand(rng, Lp, Lp))
    for sequential in (False, True):
        Ws_ref = [fusion.get_WCSMSSM(ssma, ssmb, csm, K,
                                     m_len=m_len, n_len=n_len)]
        Ws_got = [fusion.get_WCSMSSM(ssma, ssmb, csm, K,
                                     m_len=m_len, n_len=n_len,
                                     k_static_max=kmax)]
        ref = fusion.snf_ws(jnp.stack(Ws_ref * 2), K=K, niters=3,
                            reg_diag=True, sequential=sequential)
        got = fusion.snf_ws(jnp.stack(Ws_got * 2), K=K, niters=3,
                            reg_diag=True, sequential=sequential,
                            k_static_max=kmax)
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


def test_snf_host_int_k_auto_bound():
    """Late-fusion shape: snf over an (F, n, n) distance stack with a
    host-int K auto-derives the bound and matches the sort path."""
    rng = np.random.default_rng(9)
    Ds = np.stack([_rand(rng, 64, 64) for _ in range(3)])
    Ds = 0.5 * (Ds + np.transpose(Ds, (0, 2, 1)))
    _, ref = fusion.snf(jnp.asarray(Ds), K=jnp.int32(20), niters=4,
                        sequential=True)                 # traced K: sort
    _, got = fusion.snf(jnp.asarray(Ds), K=20, niters=4,
                        sequential=True)                 # auto bound
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


def test_snf_padded_bounded_matches_sort():
    rng = np.random.default_rng(10)
    Ds = np.stack([_rand(rng, 56, 56) for _ in range(2)])
    Ds = 0.5 * (Ds + np.transpose(Ds, (0, 2, 1)))
    ref = fusion.snf_padded(jnp.asarray(Ds), jnp.int32(6), niters=3,
                            length=jnp.int32(39), sequential=True)
    got = fusion.snf_padded(jnp.asarray(Ds), jnp.int32(6), niters=3,
                            length=jnp.int32(39), sequential=True,
                            k_static_max=6)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


def test_fused_w_batch_bounded_matches_sort():
    rng = np.random.default_rng(11)
    B, npad, win, d = 3, 32, 4, 6
    P = npad + win - 1
    feats = (jnp.asarray(rng.random((B, P, d)).astype(np.float32)),
             jnp.asarray(rng.random((B, P, d)).astype(np.float32)))
    lengths = jnp.asarray([32, 21, 17], jnp.int32)
    Ks = jnp.asarray([10, 9, 8], jnp.int32)
    kinds = ("euclidean", "cosine")
    ref = fused_w_batch(feats, lengths, Ks, kinds, win, niters=3)
    got = fused_w_batch(feats, lengths, Ks, kinds, win, niters=3,
                        k_static_max=10)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


def test_bounded_path_under_vmap_and_jit():
    """The EarlySNF call pattern: bound inside a vmapped, jitted program."""
    rng = np.random.default_rng(12)
    Ds = jnp.asarray(np.stack(
        [0.5 * (x + x.T) for x in
         (_rand(rng, 40, 40) for _ in range(4))]))
    Ks = jnp.asarray([3, 4, 5, 6], jnp.int32)

    @jax.jit
    def bounded(Ds, Ks):
        return jax.vmap(
            lambda D, K: fusion.get_W(D, K, k_static_max=6))(Ds, Ks)

    @jax.jit
    def unbounded(Ds, Ks):
        return jax.vmap(lambda D, K: fusion.get_W(D, K))(Ds, Ks)

    np.testing.assert_array_equal(np.asarray(unbounded(Ds, Ks)),
                                  np.asarray(bounded(Ds, Ks)))


def test_snf_precision_throughput_mode_keeps_retrieval():
    """`snf_ws(precision='default')` is the bf16-diffusion throughput
    mode (CLI --snf-precision). Contract: same fused-similarity RANKING
    as the parity setting — MAP/MR identical on a planted-clique corpus
    (on CPU the two precisions are bitwise equal, which also pins the
    plumbing; the hardware MAP check lives in scripts/covers80_scale.py
    `earlysnf_fast`)."""
    import numpy as np

    from acoss_jax.benchmarking.algorithms import EarlySNF
    from acoss_jax.benchmarking.evaluation import eval_statistics
    from acoss_jax.benchmarking.harness import run_pairwise
    from acoss_jax.data import make_synthetic_dataset

    fs = make_synthetic_dataset(n_cliques=4, clique_size=2, seed=5)
    ref_alg = EarlySNF(chroma_type="hpcp", downsample_fac=4,
                       pad_to_multiple=8, ssm_res=16)
    fast_alg = EarlySNF(chroma_type="hpcp", downsample_fac=4,
                        pad_to_multiple=8, ssm_res=16,
                        snf_precision="default")
    D_ref = run_pairwise(ref_alg, ref_alg.extract_descriptors(fs),
                         fs.n_songs, tile=4)
    D_fast = run_pairwise(fast_alg, fast_alg.extract_descriptors(fs),
                          fs.n_songs, tile=4)
    assert set(D_fast) == set(D_ref)
    for k in ("snf_qmax", "snf_dmax"):
        s_ref = eval_statistics(np.asarray(D_ref[k]), fs.labels)
        s_fast = eval_statistics(np.asarray(D_fast[k]), fs.labels)
        assert s_fast.map == s_ref.map, k
        assert s_fast.mr == s_ref.mr, k
