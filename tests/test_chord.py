"""Chord-template HMM chroma (the `crema` slot substitute).

The VERDICT-mandated acceptance test: on planted-chord synthetic AUDIO,
the chord chroma must beat `chroma_cqt_processed` on retrieval MAP
(reference analog: the CREMA chord model's chord_pitch output,
`/root/reference/preprocess/features.py:277-296`).
"""

import numpy as np
import pytest

SR, HOP = 22050, 512


def _chord_audio(states, durs, transpose, noise, rng):
    out = []
    for s, d in zip(states, durs):
        root = (s // 2 + transpose) % 12
        third = 4 if s % 2 == 0 else 3
        n = int(d * SR)
        t = np.arange(n) / SR
        sig = np.zeros(n)
        for iv in (0, third, 7):
            for octv in (3, 4, 5):
                f = 440.0 * 2 ** (((root + iv) - 9) / 12 + (octv - 4))
                sig += np.sin(2 * np.pi * f * t +
                              rng.uniform(0, 6.28)) / (octv - 2)
        out.append(sig / np.abs(sig).max())
    y = np.concatenate(out)
    y = y + noise * rng.normal(size=y.size)
    return (y / np.abs(y).max()).astype(np.float32)


def test_chord_hmm_denoises_and_decodes():
    from acoss_jax.features.chord import (chord_chroma, chord_posteriors,
                                          chord_templates)
    rng = np.random.default_rng(0)
    tmpl = chord_templates()
    states = rng.integers(0, 24, size=6)
    clean = np.concatenate([np.tile(tmpl[s], (80, 1)) for s in states])
    noisy = np.maximum(clean + 0.9 * rng.random(clean.shape), 0)

    dec = np.argmax(chord_posteriors(noisy), axis=1)
    assert (dec == np.repeat(states, 80)).mean() > 0.95

    cc = chord_chroma(noisy)

    def mean_cos(x):
        xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-9)
        cn = clean / np.maximum(
            np.linalg.norm(clean, axis=1, keepdims=True), 1e-9)
        return float((xn * cn).sum(1).mean())

    assert mean_cos(cc) > 0.98 > mean_cos(noisy)
    # transposition covariance (OTI correctness depends on it)
    r = chord_chroma(np.roll(noisy, 3, axis=1))
    np.testing.assert_allclose(np.roll(cc, 3, axis=1), r, atol=1e-5)


@pytest.mark.slow
def test_chord_chroma_beats_processed_chroma_on_retrieval():
    """Planted noisy chord-progression audio: crema (chord HMM) chroma
    must rank covers better than chroma_cqt_processed."""
    import jax
    import jax.numpy as jnp

    from acoss_jax.benchmarking.evaluation import eval_statistics
    from acoss_jax.features import chroma as chroma_mod
    from acoss_jax.features.chord import chord_chroma
    from acoss_jax.ops import alignment, crp
    from acoss_jax.ops.segment import uniform_downsample

    rng = np.random.default_rng(0)
    songs, labels = [], []
    for c in range(4):
        states = rng.integers(0, 24, size=5)
        durs = 0.7 + 0.6 * rng.random(5)
        for p in range(2):
            tp = int(rng.integers(0, 12)) if p else 0
            fac = float(rng.uniform(0.8, 1.25)) if p else 1.0
            songs.append(_chord_audio(states, durs * fac, tp, 1.2, rng))
            labels.append(f"W{c}")

    def retrieval_map(feats):
        ds = [uniform_downsample(f, 8).astype(np.float32) for f in feats]
        L = -(-max(d.shape[0] for d in ds) // 16) * 16
        X = np.zeros((len(ds), L, 12), np.float32)
        lens = np.zeros(len(ds), np.int32)
        for i, d in enumerate(ds):
            X[i, :d.shape[0]] = d
            lens[i] = d.shape[0]
        G = X.sum(axis=1)

        @jax.jit
        def row_scores(xi, gi, li, Xb, Gb, lb):
            def one(xj, gj, lj):
                csm = crp.get_csm_blocked_oti(xi, xj, gi, gj, crp.get_csm)
                B = crp.csm_to_binary(csm, 0.095, li, lj)
                q = alignment.qmax_batch_best(
                    B[None], jnp.asarray([li]), jnp.asarray([lj]))[0]
                return q / jnp.maximum(li + lj, 1).astype(jnp.float32)
            return jax.vmap(one)(Xb, Gb, lb)

        N = len(ds)
        D = np.zeros((N, N), np.float32)
        for i in range(N):
            D[i] = np.asarray(row_scores(X[i], G[i], lens[i], X, G, lens))
        np.fill_diagonal(D, 0)
        return eval_statistics(D, np.array(labels)).map

    map_chord = retrieval_map(
        [chord_chroma(chroma_mod.chroma_cqt(y, SR, HOP)) for y in songs])
    map_proc = retrieval_map(
        [chroma_mod.chroma_cqt_processed(y, SR, HOP) for y in songs])
    assert map_chord > 0.8
    assert map_chord > map_proc + 0.2
