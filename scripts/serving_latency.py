"""Measure warm 1xN query latency of the serving CoverIndex on the
real chip: covers80-geometry corpus (160 songs, 3-8 min songs), Serra09
channels. Reports index build time, cold (compile) latency, and warm
per-query latency / queries-per-second.

Usage: python scripts/serving_latency.py [--songs 160] [--queries 16]
       [--quant int8] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--songs", type=int, default=160)
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--quant", choices=("half", "int8"), default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import numpy as np

    from acoss_jax.benchmarking.algorithms import Serra09
    from acoss_jax.data import make_synthetic_dataset
    from acoss_jax.serving import CoverIndex

    print(f"device: {jax.devices()[0]}")
    # covers80 geometry (the capstone corpus: 3-8 min songs at hop 512)
    fs = make_synthetic_dataset(
        n_cliques=(args.songs + args.queries) // 2, clique_size=2,
        n_states=48, base_duration=300.0, beat_period=30.0, seed=0)
    fs = fs.subset(np.arange(args.songs + args.queries))
    qfs = fs.subset(np.arange(args.queries))
    cfs = fs.subset(np.arange(args.queries, args.queries + args.songs))

    algo = Serra09(chroma_type="hpcp")
    t0 = time.time()
    index = CoverIndex.build(algo, cfs, quant=args.quant)
    print(f"index build ({args.songs} songs, quant={args.quant}): "
          f"{time.time() - t0:.1f}s")

    one = qfs.subset(np.arange(1))
    t0 = time.time()
    index.query(one)
    print(f"cold 1-song query (compile): {time.time() - t0:.1f}s")

    t0 = time.time()
    for _ in range(args.reps):
        index.query(one)
    per = (time.time() - t0) / args.reps
    print(f"warm 1-song query: {per * 1e3:.1f} ms "
          f"({args.songs / per:.0f} scored pairs/s)")

    t0 = time.time()
    index.query(qfs)   # new batch shape -> second compile
    print(f"cold {args.queries}-song batch (compile): "
          f"{time.time() - t0:.1f}s")
    t0 = time.time()
    for _ in range(args.reps):
        index.query(qfs)
    per = (time.time() - t0) / args.reps
    print(f"warm {args.queries}-song batch: {per * 1e3:.1f} ms "
          f"({per * 1e3 / args.queries:.1f} ms/query, "
          f"{args.songs * args.queries / per:.0f} scored pairs/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
