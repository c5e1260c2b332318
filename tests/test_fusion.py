"""SNF fusion parity vs numpy loop oracles (reference-convention), plus
padded-vs-unpadded invariance and a planted-structure synthetic test (the
analog of the reference's doSNFSyntheticTest)."""

import numpy as np
import pytest

from acoss_jax.ops import fusion

# ---------- numpy oracles (reference conventions, written independently) --


def get_w_np(D, K, Mu=0.5):
    n = D.shape[0]
    DSym = 0.5 * (D + D.T)
    np.fill_diagonal(DSym, 0)
    mean_dist = np.array([
        np.mean(np.sort(DSym[i])[:K + 1]) for i in range(n)
    ]) * (K + 1) / K
    eps = (mean_dist[:, None] + mean_dist[None, :] + DSym) / 3
    denom = 2 * (Mu * eps) ** 2
    denom[denom == 0] = 1
    return np.exp(-DSym ** 2 / denom)


def get_wcsm_np(C, k1, k2, Mu=0.5):
    m1 = np.array([np.mean(np.sort(C[i])[:k2]) for i in range(C.shape[0])])
    m2 = np.array([np.mean(np.sort(C[:, j])[:k1])
                   for j in range(C.shape[1])])
    eps = (m1[:, None] + m2[None, :] + C) / 3
    return np.exp(-C ** 2 / (2 * (Mu * eps) ** 2))


def get_p_np(W, reg_diag):
    n = W.shape[0]
    if reg_diag:
        Wn = W.copy()
        np.fill_diagonal(Wn, 0)
        row = Wn.sum(1)
        row[row == 0] = 1
        return 0.5 * np.eye(n) + 0.5 * Wn / row[:, None]
    row = W.sum(1)
    row[row == 0] = 1
    return W / row[:, None]


def get_s_np(W, K):
    n = W.shape[0]
    S = np.zeros_like(W)
    for i in range(n):
        thresh = np.sort(W[i])[::-1][K - 1]
        sel = W[i] >= thresh
        vals = np.where(sel, W[i], 0.0)
        norm = vals.sum()
        S[i] = vals / (norm if norm else 1.0)
    return S


def snf_ws_np(Ws, K, niters, reg_diag=True):
    Ps = [get_p_np(W, reg_diag) for W in Ws]
    Ss = [get_s_np(W, K) for W in Ws]
    F = len(Ws)
    for _ in range(niters):
        nxt = []
        for i in range(F):
            mean_others = sum(Ps[k] for k in range(F) if k != i) / (F - 1)
            P = Ss[i] @ mean_others @ Ss[i].T
            if reg_diag:
                P = get_p_np(P, True)
            nxt.append(P)
        Ps = nxt
    return sum(Ps) / F


def snf_ws_seq_np(Ws, K, niters, reg_diag=True):
    """The reference's ACTUAL update order (`SimilarityFusion.py:246-272`):
    iteration 1 writes a fresh list (Jacobi), then `Pts = nextPts` aliases
    the lists so later iterations update in place in index order."""
    Ps = [get_p_np(W, reg_diag) for W in Ws]
    Ss = [get_s_np(W, K) for W in Ws]
    F = len(Ws)
    for it in range(niters):
        tgt = [None] * F if it == 0 else Ps
        for i in range(F):
            mean_others = sum(Ps[k] for k in range(F) if k != i) / (F - 1)
            P = Ss[i] @ mean_others @ Ss[i].T
            if reg_diag:
                P = get_p_np(P, True)
            tgt[i] = P
        Ps = tgt
    return sum(Ps) / F


# ------------------------------------------------------------- tests -----


def test_get_w(rng):
    D = rng.random((20, 20)).astype(np.float32)
    got = np.asarray(fusion.get_W(D, 5))
    np.testing.assert_allclose(got, get_w_np(D, 5), rtol=1e-5)


def test_get_wcsm(rng):
    C = rng.random((15, 11)).astype(np.float32) + 0.1
    got = np.asarray(fusion.get_WCSM(C, 4, 3))
    np.testing.assert_allclose(got, get_wcsm_np(C, 4, 3), rtol=1e-5)


@pytest.mark.parametrize("reg", [False, True])
def test_get_p(rng, reg):
    W = rng.random((12, 12)).astype(np.float32)
    got = np.asarray(fusion.get_P(W, reg))
    np.testing.assert_allclose(got, get_p_np(W, reg), rtol=1e-5)
    np.testing.assert_allclose(got.sum(1), np.ones(12), rtol=1e-5)


def test_get_s(rng):
    W = rng.random((12, 12)).astype(np.float32)
    got = np.asarray(fusion.get_S(W, 4))
    np.testing.assert_allclose(got, get_s_np(W, 4), rtol=1e-5)
    assert (np.count_nonzero(got, axis=1) == 4).all()


def test_snf_ws_matches_oracle(rng):
    n = 24
    Ds = [rng.random((n, n)).astype(np.float32) for _ in range(3)]
    Ws = [get_w_np(D, 5) for D in Ds]
    want = snf_ws_np(Ws, K=5, niters=4)
    got = np.asarray(fusion.snf_ws(np.stack(Ws), K=5, niters=4))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_snf_ws_sequential_matches_reference_order(rng):
    """sequential=True replicates the reference's Gauss-Seidel aliasing."""
    n = 24
    Ws = [get_w_np(np.abs(rng.standard_normal((n, n))) + 0.1, K=5)
          for _ in range(3)]
    Ws = [0.5 * (W + W.T) for W in Ws]
    want = snf_ws_seq_np(Ws, K=5, niters=4)
    got = np.asarray(fusion.snf_ws(np.stack(Ws), K=5, niters=4,
                                   sequential=True))
    np.testing.assert_allclose(got, want, atol=1e-5)
    jacobi = np.asarray(fusion.snf_ws(np.stack(Ws), K=5, niters=4))
    assert np.abs(jacobi - want).max() > 1e-7  # the orders really differ


def test_snf_planted_structure(rng):
    """Reference's synthetic sanity (`SimilarityFusion.py:290-317`): plant a
    different structure in each of two distance matrices; the fusion must
    contain BOTH (higher similarity on the planted sets than background)."""
    n = 60
    D1 = rng.random((n, n)).astype(np.float32) + 0.5
    D2 = rng.random((n, n)).astype(np.float32) + 0.5
    i1 = np.arange(0, 20)
    D1[i1, i1[::-1]] = 0.01          # anti-diagonal block in D1
    i2 = np.arange(30, 50)
    D2[i2, i2[::-1]] = 0.01          # different one in D2
    D1 = 0.5 * (D1 + D1.T)
    D2 = 0.5 * (D2 + D2.T)
    _, fused = fusion.snf(np.stack([D1, D2]), K=5, niters=10)
    fused = np.asarray(fused)
    off = ~np.eye(n, dtype=bool)
    bg = fused[off].mean()
    assert fused[i1, i1[::-1]].mean() > 3 * bg
    assert fused[i2, i2[::-1]].mean() > 3 * bg


def test_wcsmssm_padded_matches_unpadded(rng):
    """get_WCSMSSM on zero-padded inputs with true lengths must equal the
    unpadded computation on the real blocks (padded layout: A at [0:Lp),
    B at [Lp:2Lp))."""
    m, n, Lp = 17, 13, 24
    SSMA = rng.random((m, m)).astype(np.float32)
    SSMA = 0.5 * (SSMA + SSMA.T)
    np.fill_diagonal(SSMA, 0)
    SSMB = rng.random((n, n)).astype(np.float32)
    SSMB = 0.5 * (SSMB + SSMB.T)
    np.fill_diagonal(SSMB, 0)
    CSM = rng.random((m, n)).astype(np.float32) + 0.1
    K = 8

    W_small = np.asarray(fusion.get_WCSMSSM(SSMA, SSMB, CSM, K))

    Ap = np.zeros((Lp, Lp), np.float32)
    Ap[:m, :m] = SSMA
    Bp = np.zeros((Lp, Lp), np.float32)
    Bp[:n, :n] = SSMB
    Cp = np.zeros((Lp, Lp), np.float32)
    Cp[:m, :n] = CSM
    W_pad = np.asarray(fusion.get_WCSMSSM(Ap, Bp, Cp, K, m_len=m, n_len=n))

    np.testing.assert_allclose(W_pad[:m, :m], W_small[:m, :m], rtol=1e-4)
    np.testing.assert_allclose(W_pad[Lp:Lp + n, Lp:Lp + n],
                               W_small[m:, m:], rtol=1e-4)
    np.testing.assert_allclose(W_pad[:m, Lp:Lp + n],
                               W_small[:m, m:], rtol=1e-4)
    # padding region must be exactly zero
    assert W_pad[m:Lp, :].sum() == 0
    assert W_pad[:, m:Lp].sum() == 0
    assert W_pad[Lp + n:, :].sum() == 0


def test_get_wcsm_zero_block_no_nan(rng):
    """An exactly-zero cross block (degenerate all-zero descriptors)
    yields affinity 1 with get_W's zero-denominator convention — the
    reference NaNs here (`SimilarityFusion.py:89` has no guard) and the
    NaN would silently poison the whole SNF."""
    C = np.zeros((12, 10), np.float32)
    W = np.asarray(fusion.get_WCSM(C, 4, 3))
    assert np.all(np.isfinite(W))
    np.testing.assert_allclose(W, 1.0)

    # non-degenerate inputs are untouched by the guard
    C2 = rng.random((15, 11)).astype(np.float32) + 0.1
    got = np.asarray(fusion.get_WCSM(C2, 4, 3))
    np.testing.assert_allclose(got, get_wcsm_np(C2, 4, 3), rtol=1e-5)
