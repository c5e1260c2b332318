"""Batched audio feature extraction in JAX (the reference's L1 layer).

Capability map (SURVEY.md section 2.2):
  spectral  -> STFT / mel / DCT plumbing under everything
  chroma    -> chroma_stft / chroma_cqt / chroma_cens /
               chroma_cqt_processed (+ the CQT itself)
  hpcp      -> essentia HPCP pipeline (peaks + whitening + harmonics)
  mfcc      -> mfcc_htk (essentia/HTK) and mfcc_librosa
  onsets    -> superflux novelty, Ellis DP beat tracking, the
               madmom_features substitute dict
  rhythm    -> autocorrelation tempogram
  key       -> Krumhansl-Schmuckler key extractor
  audio     -> WAV/ffmpeg decode, polyphase resample, slicing
  pipeline  -> compute_features / batch_extract (the extractors.py analog)
"""

from acoss_jax.features.chroma import (  # noqa: F401
    chroma_cens, chroma_cqt, chroma_cqt_processed, chroma_stft, cqt)
from acoss_jax.features.hpcp import hpcp  # noqa: F401
from acoss_jax.features.key import key_extractor  # noqa: F401
from acoss_jax.features.mfcc import mfcc_htk, mfcc_librosa  # noqa: F401
from acoss_jax.features.onsets import (  # noqa: F401
    beat_track_dp, madmom_features_substitute, onset_strength)
from acoss_jax.features.pipeline import (  # noqa: F401
    PROFILE, batch_extract, compute_features, two_d_fft_mag)
from acoss_jax.features.rhythm import tempogram  # noqa: F401
