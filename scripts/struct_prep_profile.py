"""Decompose the Struc* `struct:host_prep` stage (the measured 71% of
StrucLaplacian covers80-scale wall: 136.9 s of 193.4 s, RESULTS.md).

Times, on the same covers80-geometry corpus covers80_scale.py builds:
  tempogram   tempogram_aggregated_batch over all songs (device, batched)
  prep_loop   the per-song _prep_base_features loop (host sync_agg etc.)
    - split into feature reads, sync_agg(mean), sync_agg(median)

Usage: python scripts/struct_prep_profile.py [--songs 160] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--songs", type=int, default=160)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"

    from acoss_jax.benchmarking.algorithms.struct_common import (
        _prep_base_features)
    from acoss_jax.data import make_synthetic_dataset
    from acoss_jax.features.rhythm import tempogram_aggregated_batch
    from acoss_jax.ops.segment import sync_agg

    t0 = time.time()
    fs = make_synthetic_dataset(
        n_cliques=args.songs // 2, clique_size=2, n_states=48,
        base_duration=300.0, beat_period=30.0, seed=0)
    print(f"corpus: {fs.n_songs} songs in {time.time() - t0:.1f}s",
          flush=True)

    t0 = time.time()
    envs, bnds = [], []
    for i in range(fs.n_songs):
        envs.append(fs.feature("snovfn")[i, :fs.length("snovfn")[i], 0])
        olen = fs.length("onsets")[i]
        bnds.append(fs.feature("onsets")[i, :olen, 0].astype(np.int64))
    print(f"env/onset reads: {time.time() - t0:.1f}s", flush=True)

    t0 = time.time()
    tgs = tempogram_aggregated_batch(envs, bnds, 384)
    print(f"tempogram_aggregated_batch: {time.time() - t0:.1f}s",
          flush=True)

    # the per-song prep loop, with the tempogram precomputed (as
    # structural_fused_w_all runs it)
    t0 = time.time()
    for i in range(fs.n_songs):
        _prep_base_features(fs, i, "hpcp", True, 40,
                            ("mfcc", "hpcp", "tempogram"), 384,
                            tempogram_precomputed=tgs[i])
    print(f"prep loop (precomputed tg): {time.time() - t0:.1f}s",
          flush=True)

    # split the loop body
    t_read = t_mean = t_med = 0.0
    for i in range(fs.n_songs):
        t0 = time.time()
        clen = fs.length("hpcp")[i]
        mlen = fs.length("mfcc_htk")[i]
        hpcp = fs.feature("hpcp")[i, :clen]
        mfcc = np.nan_to_num(fs.feature("mfcc_htk")[i, :mlen],
                             nan=0.0, posinf=0.0, neginf=0.0)
        olen = fs.length("onsets")[i]
        onsets = fs.feature("onsets")[i, :olen, 0].astype(np.int64)
        t_read += time.time() - t0
        t0 = time.time()
        sync_agg(mfcc, onsets, "mean")
        t_mean += time.time() - t0
        t0 = time.time()
        sync_agg(hpcp, onsets, "median")
        t_med += time.time() - t0
    print(f"  reads: {t_read:.1f}s  sync_agg mean: {t_mean:.1f}s  "
          f"sync_agg median: {t_med:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
