"""Whole-song feature extraction pipeline (the reference's L1 entry).

Replaces `AudioFeatures` + `compute_features`
(`/root/reference/preprocess/features.py:13-591`,
`/root/reference/preprocess/extractors.py:22-114`): one call turns a
waveform into the per-track feature dict of the reference's h5 schema
(`extractors.py:43-53`), and the batch extractor streams a list of files
into a `FeatureSet`.

Substitutions (documented per SURVEY.md section 7.7):
- madmom RNN+DBN beats -> superflux novelty + Ellis DP tracker
  (`acoss_jax.features.onsets`);
- crema chord-model chroma -> chord-template HMM chroma
  (`acoss_jax.features.chord`): Viterbi-class forward-backward smoothing
  of CQT chroma under maj/min triad templates — like CREMA's chord_pitch
  output, a harmony-quantized, temporally-smoothed chroma (no pretrained
  model in this image);
- essentia KeyExtractor -> Krumhansl-Schmuckler correlation on HPCP.
"""

from __future__ import annotations

import traceback

import numpy as np

from acoss_jax.data.store import FeatureSet
from acoss_jax.features import chroma as chroma_mod
from acoss_jax.features.audio import load_audio
from acoss_jax.features.hpcp import hpcp
from acoss_jax.features.key import key_extractor
from acoss_jax.features.mfcc import mfcc_htk, mfcc_librosa
from acoss_jax.features.onsets import madmom_features_substitute

#: the reference's default extraction profile (`extractors.py:22-29`)
PROFILE = {
    "sample_rate": 44100,
    "hop_length": 512,
    "features": ["hpcp", "key_extractor", "madmom_features", "mfcc_htk",
                 "crema"],
}


def two_d_fft_mag(feature: np.ndarray) -> np.ndarray:
    """fft2 -> abs -> fftshift of a feature matrix
    (`features.py:298-328`)."""
    return np.fft.fftshift(np.abs(np.fft.fft2(feature)))


def compute_features(audio: np.ndarray, sr: int = 44100,
                     hop_length: int = 512,
                     features: list | None = None) -> dict:
    """Per-track features following the reference's h5 schema:
    hpcp (T, 12), crema (T, 12), mfcc_htk (13, T), key_extractor dict,
    madmom_features dict."""
    # an explicitly-passed empty list means "extract nothing" — only
    # None falls back to the default profile
    features = PROFILE["features"] if features is None else features
    out = {}
    if "hpcp" in features or "key_extractor" in features:
        H = hpcp(audio, sr, hop_length=hop_length)
        if "hpcp" in features:
            out["hpcp"] = H
        if "key_extractor" in features:
            out["key_extractor"] = key_extractor(H)
    if "crema" in features:
        from acoss_jax.features.chord import crema_substitute
        out["crema"] = crema_substitute(audio, sr, hop_length)
    if "chroma_cqt_processed" in features:
        out["chroma_cqt_processed"] = chroma_mod.chroma_cqt_processed(
            audio, sr, hop_length)
    if "chroma_stft" in features:
        out["chroma_stft"] = chroma_mod.chroma_stft(audio, sr,
                                                    hop_length=hop_length)
    if "chroma_cqt" in features:
        out["chroma_cqt"] = chroma_mod.chroma_cqt(audio, sr, hop_length)
    if "chroma_cens" in features:
        out["chroma_cens"] = chroma_mod.chroma_cens(audio, sr, hop_length)
    if "cqt_nsg" in features:
        from acoss_jax.features.nsgcq import cqt_nsg
        out["cqt_nsg"] = cqt_nsg(audio, sr)
    if "mfcc_htk" in features:
        out["mfcc_htk"] = mfcc_htk(audio, sr, hop_length=hop_length)
    if "mfcc_librosa" in features:
        out["mfcc_librosa"] = mfcc_librosa(audio, sr,
                                           hop_length=hop_length)
    if "madmom_features" in features:
        out["madmom_features"] = madmom_features_substitute(
            audio, sr, hop_length)
    return out


def song_dict_for_store(feats: dict) -> dict:
    """Flatten a compute_features dict into FeatureSet feature arrays
    (frames-first; onsets/novelties as (n, 1) columns)."""
    out = {}
    if "hpcp" in feats:
        out["hpcp"] = np.asarray(feats["hpcp"], np.float32)
    if "crema" in feats:
        out["crema"] = np.asarray(feats["crema"], np.float32)
    if "mfcc_htk" in feats:
        out["mfcc_htk"] = np.asarray(feats["mfcc_htk"], np.float32).T
    m = feats.get("madmom_features")
    if m is not None:
        out["onsets"] = np.asarray(m["onsets"],
                                   np.int32).reshape(-1, 1)
        out["novfn"] = np.asarray(m["novfn"], np.float32).reshape(-1, 1)
        out["snovfn"] = np.asarray(m["snovfn"], np.float32).reshape(-1, 1)
    return out


def batch_extract(paths: list[str], labels: list[str],
                  track_ids: list[str] | None = None,
                  sr: int = 44100, hop_length: int = 512,
                  features: list | None = None,
                  error_log: str | None = None,
                  n_workers: int = 1) -> FeatureSet:
    """Extract a whole collection into one FeatureSet.

    Per-song failures are logged and the song skipped — the reference's
    fault-tolerance contract (`extractors.py:57-78`, `utils.py:80-93`).

    `n_workers` > 1 runs per-song decode + feature computation on a host
    thread pool (the reference's `-n` joblib fan-out,
    `extractors.py:81-115`): audio decode and the numpy stages
    parallelize across cores while the jitted device stages serialize on
    the accelerator. Song order — and therefore the resulting
    FeatureSet — is identical to the serial run.
    """
    track_ids = track_ids or paths

    def one(args):
        path, label, tid = args
        try:
            audio = load_audio(path, sr)
            feats = compute_features(audio, sr, hop_length, features)
            return song_dict_for_store(feats), label, tid, None
        except Exception:
            return None, label, tid, f"{path}\n{traceback.format_exc()}"

    jobs = list(zip(paths, labels, track_ids))
    if n_workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            results = list(pool.map(one, jobs))
    else:
        results = [one(j) for j in jobs]

    songs, keep_labels, keep_ids, errors = [], [], [], []
    for song, label, tid, err in results:
        if err is not None:
            errors.append(err)
        else:
            songs.append(song)
            keep_labels.append(label)
            keep_ids.append(tid)
    if errors and error_log:
        with open(error_log, "a") as f:
            f.write("\n".join(errors) + "\n")
    if not songs:
        raise RuntimeError("no songs extracted successfully")
    return FeatureSet.from_songs(
        songs, keep_labels, keep_ids,
        ragged_features=tuple(songs[0].keys()))
