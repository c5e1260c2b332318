"""Parity tests for the wavefront aligners: JAX scan kernels vs (a) the
slow numpy DP oracle and (b) the native C++ CPU implementation."""

import numpy as np
import pytest

from acoss_jax import native
from acoss_jax.ops import alignment
from tests import oracles


def random_crp(rng, m, n, density=0.1):
    return (rng.random((m, n)) < density).astype(np.uint8)


@pytest.mark.parametrize("shape", [(16, 16), (37, 23), (23, 37), (64, 64)])
@pytest.mark.parametrize("density", [0.05, 0.25, 0.9])
def test_qmax_vs_oracle(rng, shape, density):
    S = random_crp(rng, *shape, density)
    want = oracles.qmax_np(S)
    got = float(alignment.qmax(S))
    assert got == pytest.approx(want, abs=1e-4)
    assert native.qmax_cpu(S) == pytest.approx(want, abs=1e-4)


@pytest.mark.parametrize("shape", [(16, 16), (37, 23), (23, 37)])
@pytest.mark.parametrize("density", [0.05, 0.25, 0.9])
def test_dmax_vs_oracle(rng, shape, density):
    S = random_crp(rng, *shape, density)
    want = oracles.dmax_np(S)
    got = float(alignment.dmax(S))
    assert got == pytest.approx(want, abs=1e-4)
    assert native.dmax_cpu(S) == pytest.approx(want, abs=1e-4)


@pytest.mark.parametrize("shape", [(16, 16), (37, 23), (23, 37)])
@pytest.mark.parametrize("density", [0.05, 0.25, 0.9])
def test_swconstrained_vs_oracle(rng, shape, density):
    S = random_crp(rng, *shape, density)
    want = oracles.swconstrained_np(S)
    got = float(alignment.swconstrained(S))
    assert got == pytest.approx(want, abs=1e-4)
    assert native.swconstrained_cpu(S) == pytest.approx(want, abs=1e-4)


def test_distinct_gap_penalties(rng):
    """Exercise the state-dependent gamma path (gap_onset != gap_extension)."""
    S = random_crp(rng, 32, 32, 0.2)
    want = oracles.qmax_np(S, go=0.4, ge=0.8)
    got = float(alignment.qmax(S, gap_onset=0.4, gap_extension=0.8))
    assert got == pytest.approx(want, abs=1e-4)
    assert native.qmax_cpu(S, 0.4, 0.8) == pytest.approx(want, abs=1e-4)
    want = oracles.dmax_np(S, go=0.3, ge=0.9)
    got = float(alignment.dmax(S, gap_onset=0.3, gap_extension=0.9))
    assert got == pytest.approx(want, abs=1e-4)


def test_small_size_early_outs():
    S = np.ones((2, 10), dtype=np.uint8)
    assert float(alignment.qmax(S)) == 0.0
    assert float(alignment.swconstrained(S)) == 0.0
    S = np.ones((3, 3), dtype=np.uint8)
    assert float(alignment.dmax(S)) == 0.0   # dmax needs >= 4
    assert float(alignment.qmax(S)) > 0.0    # qmax needs only >= 3
    S = np.ones((10, 3), dtype=np.uint8)
    assert float(alignment.dmax(S)) == 0.0


def test_batched_padded_matches_per_pair(rng):
    """Padded batch of ragged pairs == per-pair unpadded scores."""
    M = N = 48
    sizes = [(48, 48), (31, 40), (17, 23), (5, 48), (2, 10)]
    B = len(sizes)
    S = np.zeros((B, M, N), dtype=np.uint8)
    for b, (m, n) in enumerate(sizes):
        S[b, :m, :n] = random_crp(rng, m, n, 0.15)
    m_len = np.array([s[0] for s in sizes])
    n_len = np.array([s[1] for s in sizes])

    for batch_fn, single_np in [
        (alignment.qmax_batch, oracles.qmax_np),
        (alignment.dmax_batch, oracles.dmax_np),
        (alignment.swconstrained_batch, oracles.swconstrained_np),
    ]:
        got = np.asarray(batch_fn(S, m_len, n_len))
        want = np.array(
            [single_np(S[b, :m, :n]) for b, (m, n) in enumerate(sizes)],
            dtype=np.float32)
        np.testing.assert_allclose(got, want, atol=1e-4)

    # Native batched path agrees too.
    np.testing.assert_allclose(
        native.qmax_batch_cpu(S, m_len, n_len),
        np.array([oracles.qmax_np(S[b, :m, :n])
                  for b, (m, n) in enumerate(sizes)]), atol=1e-4)
    np.testing.assert_allclose(
        native.dmax_batch_cpu(S, m_len, n_len),
        np.array([oracles.dmax_np(S[b, :m, :n])
                  for b, (m, n) in enumerate(sizes)]), atol=1e-4)
    np.testing.assert_allclose(
        native.swconstrained_batch_cpu(S, m_len, n_len),
        np.array([oracles.swconstrained_np(S[b, :m, :n])
                  for b, (m, n) in enumerate(sizes)]), atol=1e-4)


def test_structured_match_scores():
    """A clean diagonal of matches scores ~length on qmax."""
    S = np.zeros((32, 32), dtype=np.uint8)
    np.fill_diagonal(S, 1)
    got = float(alignment.qmax(S))
    # Cells (2,2)..(31,31) each add +1 along the diagonal.
    assert got == pytest.approx(30.0)


def test_negative_gap_uses_masked_scan(rng):
    """Negative gap penalties through the *_best dispatchers stay equal to
    the length-masked XLA scan on the unpadded CRP (padded cells must never
    raise a score, whatever the gap's sign)."""
    import jax.numpy as jnp

    S = np.zeros((2, 48, 48), np.uint8)
    S[0, :30, :40] = random_crp(rng, 30, 40, 0.15)
    S[1, :48, :25] = random_crp(rng, 48, 25, 0.15)
    ml = np.array([30, 48], np.int32)
    nl = np.array([40, 25], np.int32)
    got = np.asarray(alignment.qmax_batch_best(
        jnp.asarray(S), ml, nl, gap_onset=-0.5, gap_extension=-0.5))
    gotd = np.asarray(alignment.dmax_batch_best(
        jnp.asarray(S), ml, nl, gap_onset=-0.5, gap_extension=-0.5))
    for b in range(2):
        q = alignment.qmax_batch(S[b:b + 1, :ml[b], :nl[b]],
                                 ml[b:b + 1], nl[b:b + 1],
                                 gap_onset=-0.5, gap_extension=-0.5)
        np.testing.assert_allclose(got[b], np.asarray(q)[0], atol=1e-4)
        d = alignment.dmax_batch(S[b:b + 1, :ml[b], :nl[b]],
                                 ml[b:b + 1], nl[b:b + 1],
                                 gap_onset=-0.5, gap_extension=-0.5)
        np.testing.assert_allclose(gotd[b], np.asarray(d)[0], atol=1e-4)
