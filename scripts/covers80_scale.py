"""covers80-scale end-to-end benchmark on a synthetic planted-clique corpus.

Builds a 160-song corpus with REAL covers80 geometry (80 cliques of 2,
songs of ~12.8k-20.4k frames = 3-8 minutes at hop 512, beat period ~30
frames) and runs the full benchmark (descriptor extraction + pair sweep +
evaluation) for the requested algorithms, printing wall-clock + MAP per
similarity type. This is the source of the covers80-scale table in
RESULTS.md.

Usage:
    python scripts/covers80_scale.py [--cpu] [--songs N] alg [alg ...]
    python scripts/covers80_scale.py --list
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def make_algorithms():
    from acoss_jax.benchmarking.algorithms import ALL_ALGORITHMS, EarlySNF
    from acoss_jax.benchmarking.algorithms.serra09 import Serra09
    algos = {name.lower(): (lambda cls=cls: cls())
             for name, cls in ALL_ALGORITHMS.items()}
    algos["serra09_full"] = lambda: Serra09(do_ssms=True)
    # the reduced-precision diffusion throughput mode (fusion.snf_ws)
    algos["earlysnf_fast"] = lambda: EarlySNF(snf_precision="default")
    return algos


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("algorithms", nargs="*", help="algorithm keys")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    ap.add_argument("--songs", type=int, default=160)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stage-times", action="store_true",
                    help="print the per-stage timing table per algorithm")
    ap.add_argument("--n-buckets", type=int, default=1,
                    help="length buckets for the sweep (unified bucketed "
                         "path when > 1)")
    ap.add_argument("--tempo-aligned", action="store_true",
                    help="covers share the global tempo exactly "
                         "(diagnostic corpus: isolates tempo-warp "
                         "effects per channel)")
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        jax.config.update("jax_platforms", "cpu")

    algos = make_algorithms()
    if args.list or not args.algorithms:
        print("available:", " ".join(sorted(algos)))
        return

    from acoss_jax.benchmarking.harness import benchmark
    from acoss_jax.data.synthetic import make_synthetic_dataset

    t0 = time.time()
    fs = make_synthetic_dataset(
        n_cliques=args.songs // 2, clique_size=2, n_states=48,
        base_duration=300.0, beat_period=30.0, seed=args.seed,
        cover_tempo_range=(1.0, 1.0) if args.tempo_aligned
        else (0.8, 1.25))
    lens = fs.length("hpcp")
    print(f"corpus: {fs.n_songs} songs, frames {lens.min()}-{lens.max()}, "
          f"built in {time.time() - t0:.1f}s", flush=True)

    from acoss_jax.utils.profiling import stages

    stages.enabled = bool(args.stage_times)
    for name in args.algorithms:
        alg = algos[name]()
        stages.reset()
        t0 = time.time()
        stats = benchmark(alg, fs, n_buckets=args.n_buckets)
        wall = time.time() - t0
        out = {k: round(float(v.map), 4) for k, v in stats.items()}
        print(json.dumps({"algorithm": name, "wall_s": round(wall, 1),
                          "map": out}), flush=True)
        if args.stage_times:
            print(stages.report(), flush=True)


if __name__ == "__main__":
    main()
