"""LazySyntheticCorpus: deterministic on-demand Da-TACOS-geometry corpus
(the 15k benchmark generator — `scripts/datacos15k.py`)."""

import numpy as np

from acoss_jax.data.synthetic import LazySyntheticCorpus


def _corpus(**kw):
    kw.setdefault("n_cliques", 3)
    kw.setdefault("clique_size", 3)
    kw.setdefault("n_distractors", 2)
    kw.setdefault("base_duration", 6.0)
    kw.setdefault("beat_period", 4.0)
    return LazySyntheticCorpus(**kw)


def test_datacos_layout():
    c = _corpus()
    assert c.n_songs == 3 * 3 + 2
    assert list(c.labels[:3]) == ["W_0"] * 3
    assert c.labels[-1] == "W_d1"
    assert c.track_ids[4] == "W_1/P_1"


def test_chunking_is_deterministic():
    """Any subset() produces bit-identical songs — the property chunked
    extraction relies on (chunk boundaries can split cliques)."""
    c = _corpus()
    full = c.subset(np.arange(c.n_songs))
    a = c.subset(np.arange(0, 4))
    b = c.subset(np.arange(4, c.n_songs))
    for k in full.features:
        fa = full.features[k]
        # per-chunk padded widths differ; compare valid prefixes
        for i in range(4):
            la = full.lengths.get(k, np.full(c.n_songs, 0))
            n = int(la[i]) if k in full.lengths else None
            va = fa[i][:n] if n is not None else fa[i]
            vb = a.features[k][i][:n] if n is not None \
                else a.features[k][i]
            np.testing.assert_array_equal(va, vb, err_msg=f"{k}[{i}]")
        for i in range(4, c.n_songs):
            n = int(full.lengths[k][i]) if k in full.lengths else None
            va = fa[i][:n] if n is not None else fa[i]
            vb = b.features[k][i - 4][:n] if n is not None \
                else b.features[k][i - 4]
            np.testing.assert_array_equal(va, vb, err_msg=f"{k}[{i}]")


def test_covers_share_clique_latents_but_differ():
    """Members of one clique share the chord sequence (high chroma
    correlation after de-transposition is NOT asserted — just that
    member 0 is canonical and members differ), distractors differ."""
    c = _corpus()
    fs = c.subset(np.arange(c.n_songs))
    h = fs.features["hpcp"]
    ln = fs.lengths["hpcp"]
    assert not np.array_equal(h[0][:ln[0]], h[1][:ln[1]])
    # member 0 of each clique is untransposed, unwarped (tempo 1.0):
    # rendering it twice is identical
    again = c.subset(np.array([0]))
    np.testing.assert_array_equal(h[0][:ln[0]],
                                  again.features["hpcp"][0][:ln[0]])
