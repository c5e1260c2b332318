""""What is a cover?" statistical studies on cover pairs.

Parity target: `/root/reference/coverstats/coverstats.py:10-241` — key
statistics (same-scale / same-key proportions, transposition-distance
distribution), tempo-ratio statistics, and auto-tag F-measure KS tests,
computed over a pairs dataset (the Da-TACOS `whatisacover` subset in the
reference).

Differences by design: the reference globs per-track h5 files and writes
CSVs + seaborn SVGs; here the inputs are a `FeatureSet` (keys/tempos are
derived from stored features on the fly) and the outputs are pandas
DataFrames + plain dict summaries (callers own presentation).
"""

from __future__ import annotations

import numpy as np
import pandas as pd
from scipy.stats import ks_2samp

from acoss_jax.data.store import FeatureSet
from acoss_jax.features.key import key_extractor
from acoss_jax.features.onsets import estimate_tempo

_KEY2IDX = {"C": 0, "C#": 1, "D": 2, "D#": 3, "Eb": 3, "E": 4, "F": 5,
            "F#": 6, "G": 7, "G#": 8, "Ab": 8, "A": 9, "A#": 10,
            "Bb": 10, "B": 11}


def get_cover_pairs(fs: FeatureSet, extractor) -> dict:
    """label -> [extractor(song_index), ...] over all songs
    (`coverstats.py:10-37` with the FeatureSet replacing the h5 glob)."""
    pairs: dict = {}
    for i in range(fs.n_songs):
        pairs.setdefault(fs.labels[i], []).append(extractor(fs, i))
    return pairs


def key_table(fs: FeatureSet, chroma_type: str = "hpcp") -> pd.DataFrame:
    """Per-pair key info table (the reference's keys.csv,
    `coverstats.py:44-58`)."""
    def extract(fs, i):
        chroma = fs.feature(chroma_type)[i, :fs.length(chroma_type)[i]]
        try:
            res = key_extractor(chroma)
        except ValueError:
            # degenerate track (empty / non-finite chroma):
            # key_extractor refuses to fabricate a key; drop the track
            # from the table instead of aborting the whole study
            res = None
        if res is not None:
            res["track_id"] = str(fs.track_ids[i])
        return res

    pairs = get_cover_pairs(fs, extract)
    rows, index = [], []
    for label, members in pairs.items():
        members = [m for m in members if m is not None]
        if len(members) < 2:
            continue
        s1, s2 = members[0], members[1]
        index.append(label)
        rows.append([s1["track_id"], s1["key"], s1["scale"],
                     s1["strength"], s2["track_id"], s2["key"],
                     s2["scale"], s2["strength"]])
    return pd.DataFrame(rows, index=index, columns=[
        "ID1", "Key1", "Scale1", "Strength1",
        "ID2", "Key2", "Scale2", "Strength2"])


def key_stats(df: pd.DataFrame, min_confidence: float = 0.75) -> dict:
    """Same-scale / same-key proportions + transposition distances
    (`coverstats.py:60-125`)."""
    strengths = df[["Strength1", "Strength2"]].values.astype(float)
    keep = np.min(strengths, axis=1) > min_confidence
    scale = df[["Scale1", "Scale2"]].values[keep]
    same_scale = scale[:, 0] == scale[:, 1]
    keys = df[["Key1", "Key2"]].values[keep]
    same_key = same_scale & (keys[:, 0] == keys[:, 1])
    keyidx = np.array([[_KEY2IDX[k] for k in row] for row in keys]) \
        if len(keys) else np.zeros((0, 2), int)
    transposed = (~same_key) & same_scale
    dist = np.abs(keyidx[transposed, 0] - keyidx[transposed, 1]) \
        if len(keys) else np.array([])
    dist = np.minimum(dist, 12 - dist)
    n = max(int(keep.sum()), 1)
    return {
        "n_pairs_confident": int(keep.sum()),
        "frac_same_scale": float(same_scale.sum()) / n,
        "frac_same_key": float(same_key.sum()) / n,
        "transposition_distances": dist,
    }


def tempo_table(fs: FeatureSet, novfn: str = "snovfn",
                sr: int = 44100, hop_length: int = 512) -> pd.DataFrame:
    """Per-pair strongest-tempo table (the reference's tempos.csv,
    `coverstats.py:132-146`; tempo re-estimated from the stored novelty
    function instead of madmom's stored candidates)."""
    def extract(fs, i):
        env = fs.feature(novfn)[i, :fs.length(novfn)[i], 0]
        return (estimate_tempo(env, sr, hop_length), 1.0)

    pairs = get_cover_pairs(fs, extract)
    rows, index = [], []
    for label, members in pairs.items():
        if len(members) < 2:
            continue
        index.append(label)
        rows.append(list(members[0]) + list(members[1]))
    return pd.DataFrame(rows, index=index, columns=[
        "Tempo1", "Strength1", "Tempo2", "Strength2"])


def tempo_stats(df: pd.DataFrame, min_confidence: float = 0.0) -> dict:
    """Tempo-ratio distribution quantiles (`coverstats.py:147-177`)."""
    keep = np.min(df[["Strength1", "Strength2"]].values.astype(float),
                  axis=1) > min_confidence
    t = df[["Tempo1", "Tempo2"]].values.astype(float)[keep]
    ratios = t[:, 1] / np.maximum(t[:, 0], 1e-9)
    ratios[ratios < 1] = 1.0 / ratios[ratios < 1]
    return {
        "n_pairs": int(keep.sum()),
        "ratios": ratios,
        "q25": float(np.quantile(ratios, 0.25)) if len(ratios) else np.nan,
        "q50": float(np.quantile(ratios, 0.50)) if len(ratios) else np.nan,
        "q75": float(np.quantile(ratios, 0.75)) if len(ratios) else np.nan,
    }


def tag_f_measure(tags1, tags2, cutoff: float = 0.062) -> float:
    """F-measure between two (tag, confidence) lists
    (`coverstats.py:179-197`, including the inf-on-empty convention)."""
    t1 = {s for s, f in tags1 if float(f) > cutoff}
    t2 = {s for s, f in tags2 if float(f) > cutoff}
    if not t1 or not t2:
        return np.inf
    r = len(t1 & t2) / len(t1)
    p = len(t2 & t1) / len(t2)
    if r == 0 or p == 0:
        return 0.0
    return 2 * r * p / (r + p)


def tag_stats(pair_tags: dict, cutoff: float = 0.062) -> dict:
    """True-pair vs false-pair tag F-measure distributions + KS test
    (`coverstats.py:199-241`). `pair_tags`: label -> [tags1, tags2]."""
    keys = list(pair_tags.keys())
    true_pairs = np.array([
        tag_f_measure(pair_tags[k][0], pair_tags[k][1], cutoff)
        for k in keys])
    false_pairs = []
    for k in keys:
        for k2 in keys:
            if k != k2:
                false_pairs.append(tag_f_measure(
                    pair_tags[k][0], pair_tags[k2][1], cutoff))
    false_pairs = np.array(false_pairs)
    true_pairs = true_pairs[np.isfinite(true_pairs)]
    false_pairs = false_pairs[np.isfinite(false_pairs)]
    ks = ks_2samp(true_pairs, false_pairs) if (
        len(true_pairs) and len(false_pairs)) else None
    return {"true_pairs": true_pairs, "false_pairs": false_pairs,
            "ks": ks}
