"""Da-TACOS-scale dry-run of the hybrid device-panel / disk-column sweep
(`harness.run_pairwise_hybrid`) for the heaviest channel (EarlySNF /
Serra09-FULL, whose 15k ssms corpus is ~557 GB — fits neither HBM nor
host RAM nor, in this environment, disk).

Two modes:

- `--mode loop15k`: builds a 15,000-song synthetic EarlySNF-SCHEMA
  descriptor store with small feature dims (~1 GB disk), then runs the
  REAL hybrid sweep loop (panel pinning, column streaming, memmapped
  scores, tile ledger) over the first `--panels` panels, reporting host
  RSS and the per-tile loop overhead. Validates the 15k-scale machinery:
  ledger shape (1875^2 tiles), 8 x 15k^2 memmap scores, bounded memory.

- `--mode measure`: builds a `--songs`-song store at the REAL Da-TACOS
  descriptor dims (L=448 frames, 20736-dim ssms blocks ~ 37 MB/song),
  sweeps `--panels` panels on the real chip with the full EarlySNF
  tile kernel, and extrapolates the measured s/tile to the 1.1e8-pair
  15k sweep.

Usage: python scripts/hybrid_dryrun.py --mode loop15k --panels 2
       python scripts/hybrid_dryrun.py --mode measure --songs 256 --panels 1
"""

from __future__ import annotations

import argparse
import os
import resource
import shutil
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def _make_store(path: str, n: int, L: int, ssm_dim: int,
                chunk: int | None = None, seed: int = 0,
                quant: str | None = None) -> dict:
    """Synthetic EarlySNF-schema DescriptorStore written chunkwise.

    `quant` stores the dominant ssms key quantized (the
    `extract_streamed(quant=...)` layouts): at Da-TACOS dims 'half'
    halves and 'int8' quarters the disk store and every
    column-tile/panel upload."""
    from acoss_jax.data.descstore import DescriptorStore, quantize_int8

    if chunk is None:   # keep one chunk's ssms under ~2 GB of RAM
        chunk = max(1, min(512, int(2e9 / (L * ssm_dim * 4))))
    store = DescriptorStore(path, n)
    rng = np.random.default_rng(seed)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        m = hi - lo
        store.write("chroma", lo,
                    rng.random((m, L, 12), dtype=np.float32))
        store.write("mfcc", lo,
                    rng.standard_normal((m, L, 13), dtype=np.float32))
        ssms = rng.random((m, L, ssm_dim), dtype=np.float32)
        if quant == "int8":
            q, s = quantize_int8(ssms)
            store.write("ssms", lo, q)
            store.write("ssms@qscale", lo, s)
        else:
            store.write("ssms", lo, ssms.astype(
                np.float16 if quant == "half" else np.float32))
        store.write("gchroma", lo,
                    rng.random((m, 12), dtype=np.float32))
        store.write("length", lo,
                    rng.integers(L // 2, L, size=m).astype(np.int32))
    store.flush()
    return DescriptorStore.open(path)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("loop15k", "measure"),
                    default="loop15k")
    ap.add_argument("--songs", type=int, default=256)
    ap.add_argument("--panels", type=int, default=1)
    ap.add_argument("--panel-songs", type=int, default=128)
    ap.add_argument("--tile", type=int, default=8)
    ap.add_argument("--workdir", default="/tmp/hybrid_dryrun")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--half", action="store_true",
                    help="store the ssms key as float16 (the "
                         "--stream-half layout)")
    ap.add_argument("--int8", action="store_true",
                    help="store the ssms key as per-song-scaled int8 "
                         "(the --stream-int8 layout)")
    ap.add_argument("--snf-precision", default="highest",
                    choices=("highest", "default"),
                    help="SNF diffusion einsum precision (the CLI's "
                         "--snf-precision throughput mode)")
    ap.add_argument("--no-panel-prefetch", action="store_true",
                    help="disable the next-panel HBM upload overlap "
                         "(to measure the prefetch win / for panels "
                         "that nearly fill HBM)")
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        jax.config.update("jax_platforms", "cpu")

    from acoss_jax.benchmarking.algorithms import EarlySNF
    from acoss_jax.benchmarking.harness import run_pairwise_hybrid

    os.makedirs(args.workdir, exist_ok=True)
    if args.mode == "loop15k":
        n, L, sdim = 15000, 64, 256
        pad_mult = 64
    else:
        n, L, sdim = args.songs, 448, 20736
        pad_mult = 64

    quant = "int8" if args.int8 else ("half" if args.half else None)
    suffix = f"_{quant}" if quant else ""
    store_path = os.path.join(args.workdir, f"store_{args.mode}{suffix}")
    from acoss_jax.data.descstore import DescriptorStore
    if not os.path.exists(os.path.join(store_path, DescriptorStore.META)):
        t0 = time.time()
        desc = _make_store(store_path, n, L, sdim, quant=quant)
        print(f"store built: {n} songs, L={L}, ssm_dim={sdim} "
              f"({time.time() - t0:.1f}s)")
    else:
        desc = DescriptorStore.open(store_path)
        print(f"reusing store {store_path}")
    gb = sum(v.nbytes for v in desc.values()) / 1e9
    print(f"store size: {gb:.2f} GB on disk")

    algo = EarlySNF(chroma_type="hpcp", pad_to_multiple=pad_mult,
                    snf_precision=args.snf_precision)
    tiles_per_panel = args.panel_songs // args.tile
    n_tiles = -(-n // args.tile)

    # sweep only the first `--panels` panels via the resumable ledger:
    # pre-mark everything else done, exactly how a resumed partial run
    # would see it
    scores_dir = os.path.join(args.workdir, f"scores_{args.mode}")
    ckpt = os.path.join(args.workdir, f"ledger_{args.mode}.npz")
    for p in (scores_dir, ckpt):
        if os.path.isdir(p):
            shutil.rmtree(p)
        elif os.path.exists(p):
            os.remove(p)
    done = np.ones((n_tiles, n_tiles), dtype=bool)
    # clamp to the actual grid: a corpus smaller than `panels` panels
    # would otherwise overstate n_swept (and understate s/tile + the 15k
    # extrapolation) by counting rows that don't exist
    lim = min(args.panels * tiles_per_panel, n_tiles)
    done[:lim, :] = False
    np.savez(ckpt, done=done, tile=args.tile, n_songs=n,
             hybrid_panel=-(-args.panel_songs // args.tile) * args.tile)

    n_swept = sum(ti + 1 for ti in range(lim))   # lower tiles incl. diag
    panel_times: list = []
    t0 = time.time()
    run_pairwise_hybrid(algo, desc, n, panel_songs=args.panel_songs,
                        tile=args.tile, scores_dir=scores_dir,
                        checkpoint_path=ckpt, verbose=True,
                        skip_symmetrize=True,
                        prefetch_panels=not args.no_panel_prefetch,
                        panel_times=panel_times)
    dt = time.time() - t0
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    per_tile = dt / max(n_swept, 1)
    total_tiles = n_tiles * (n_tiles + 1) // 2
    # extrapolate to the full 15k sweep (1875x1875-tile lower triangle)
    full_tiles = (15000 // args.tile) * (15000 // args.tile + 1) // 2
    print(f"\nswept {n_swept} tiles in {dt:.1f}s "
          f"({per_tile * 1e3:.1f} ms/tile incl. streaming), "
          f"peak host RSS {rss:.2f} GB")
    print(f"ledger: {n_tiles}x{n_tiles} tiles; this corpus full sweep = "
          f"{total_tiles} tiles -> {total_tiles * per_tile / 3600:.2f} h")
    print(f"15k extrapolation at this per-tile cost: {full_tiles} tiles "
          f"-> {full_tiles * per_tile / 3600:.1f} h/chip")
    if len(panel_times) >= 2:
        # last panel = warm per-tile (the first panel absorbs the
        # per-process compiles and program first-executions); at 15k the
        # warm share is ~100%, so this is the honest extrapolation basis
        tpp = args.panel_songs // args.tile
        last_rows = range((len(panel_times) - 1) * tpp, lim)
        last_tiles = sum(ti + 1 for ti in last_rows)
        warm = (panel_times[-1] - panel_times[-2]) / max(last_tiles, 1)
        print(f"warm (last panel): {last_tiles} tiles at "
              f"{warm * 1e3:.1f} ms/tile -> 15k "
              f"{full_tiles * warm / 3600:.1f} h/chip")
    if not args.keep:
        shutil.rmtree(args.workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
