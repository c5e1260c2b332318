"""Smoke test of the pair-sweep main path on an NVIDIA GPU.

Run from the root of a checkout, on a machine with a card:

    python chip_smoke.py           # phases a-e, one card
    python chip_smoke.py --four    # phase f only, four cards

One process, which opens the card(s) once and starts no other JAX
process. Each phase prints its findings on lines of its own, tagged with
its letter:

  a  device: JAX's platform must be "gpu" (there is no CPU fallback); the
     card's name and power limit from nvidia-smi.
  b  aligners at the bench workload (512 pairs, L = 512, ragged lengths
     320-512, match density 0.095): the default aligner backend lowers
     the kernel for the card and the scan for the CPU; the CUDA qmax /
     dmax / SW kernels
     against the C++ oracle (64 pairs) and the XLA scan (all 512), both
     exactly; each kernel's compiled memory analysis; kernel and scan
     times (readings of at least READING_S of back-to-back calls).
  c  Serra09 end to end through `cli.main(["benchmark", ...])` on a
     160-song corpus at covers80 geometry (80 cliques of 2, 48 states,
     ~11k-18k frames, padded to L = 512 after the /40 downsample): MAP
     per channel; one 16x16 tile recomputed on the CPU device of the same
     process, where the default aligner backend lowers the XLA scan (CRP
     disagreement and score difference per channel); the tile's stage
     times (binarize share) and kernel against scan inside it.
  d  one EarlySNF tile at Da-TACOS dims (8x8 = 64 pairs, L = 448,
     20736-dim ssms, snf_precision="highest") against the CPU.
  e  serving: a CoverIndex over the 160 songs answers 8 queries through
     `cli.main(["query", ...])`; each top-1 is checked against the same
     query scored by the harness.
  f  (--four only) the Serra09 sweep on a 2x2 mesh and with the
     triangular fold, each against a single-device sweep of the same
     tile shapes, exactly.

Tolerances of the CPU comparisons (c, d): the CSM, the SNF diffusion and
their sums run in fp32 in another order on the GPU than on the CPU, so a
CRP cell can flip where a k-th-neighbour distance is within a few ulps
of the next one. Per pair and channel, at most 1e-3 of the valid cells
may flip, and the score may move by at most 1.5 per flipped cell over
(m + n): one flipped cell changes the qmax/dmax DP by at most
1 + gap = 1.5 along any path, since a monotone path meets at most one
cell whose value the flip injects into. The bound holds only for scores
of the very CRPs compared, so each device computes both in one program
(two programs may sum a CSM in different orders, e.g. through different
GEMM algorithms, and flip other cells). Pairs with identical CRPs have
identical DP scores; their normalized scores (score / (m + n)) may differ
by 2 ulp, since XLA on the GPU may divide as x * (1 / y).

Exits non-zero if any phase fails. Only then is the last line of stdout
not {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
KAPPA = 0.095
FLIP_FRACTION = 1e-3        # per pair and channel, of the valid cells
FLIP_STEP = 1.5             # DP change per flipped cell: 1 + gap
MIN_MAP = 0.8               # planted cliques; chance is ~0.02
SERVE_TOL = 0.01            # normalized score, CLI query vs harness
READING_S = 0.2             # host seconds per timing reading, at least


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def timed(fn, *args, reps: int = 5):
    """(median, spread) seconds per call over `reps` readings; a reading
    is as many back-to-back calls as fill READING_S, ended by
    block_until_ready. Compiles before timing."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    inner = max(1, int(np.ceil(READING_S / (time.perf_counter() - t0))))
    vals = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*args)
        jax.block_until_ready(out)
        vals.append((time.perf_counter() - t0) / inner)
    med = float(np.median(vals))
    return med, (max(vals) - min(vals)) / med


def ms(t) -> str:
    return f"{t[0] * 1e3:.4f} ms (spread {t[1] * 100:.1f}%)"


def memory(compiled) -> dict:
    ma = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: getattr(ma, k, None) for k in keys}


def run_cli(phase: str, argv: list[str], cwd: str) -> str:
    """`acoss_jax.cli.main(argv)` in this process; its stdout is echoed
    with the phase tag and returned."""
    from acoss_jax import cli

    buf = io.StringIO()
    prev = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        os.chdir(prev)
    out = buf.getvalue()
    for line in out.splitlines():
        say(phase, f"| {line}")
    check(rc == 0, f"cli {argv[0]} returned {rc}")
    return out


# --------------------------------------------------------------- corpora

def covers80_corpus(seed: int):
    """(corpus of 160 songs, 8 query covers): 80 planted cliques of 3 at
    covers80 geometry; members 0 and 1 form the corpus, the third
    member of cliques 0-7 are the queries."""
    from acoss_jax.data.synthetic import make_synthetic_dataset

    fs = make_synthetic_dataset(n_cliques=80, clique_size=3, n_states=48,
                                base_duration=300.0, beat_period=30.0,
                                seed=seed)
    idx = np.arange(fs.n_songs)
    return fs.subset(idx[idx % 3 != 2]), fs.subset(idx[idx % 3 == 2][:8])


def tile_of(desc: dict, lo: int, hi: int) -> dict:
    return {k: np.asarray(v)[lo:hi] for k, v in desc.items()}


# ----------------------------------------------------------- comparisons

def crps_and_scores(algo, row, col, device):
    """CRP stacks and tile scores of one tile on `device`, from one
    program (`tile_scores` = `crp_scores` of `tile_crps`), so the scores
    are those of the CRPs returned; the algorithm's default aligner
    backend follows the device's platform."""
    import jax

    row, col = jax.device_put((row, col), device)

    def tile(r, c):
        crps = algo.tile_crps(r, c)
        return crps, algo.crp_scores(*crps)

    (Bs, l1e, l2e), scores = jax.jit(tile)(row, col)
    return ([np.asarray(B) for B in Bs], np.asarray(l1e), np.asarray(l2e),
            {k: np.asarray(v) for k, v in scores.items()})


def compare_tile(phase, algo, row, col) -> None:
    """GPU (CUDA aligners) against CPU (XLA scan) on one tile, under the
    flip tolerance of the module docstring."""
    import jax

    check(algo.aligner == "auto", f"aligner {algo.aligner!r}")
    t0 = time.perf_counter()
    Bg, l1, l2, Sg = crps_and_scores(algo, row, col, jax.devices()[0])
    tg = time.perf_counter() - t0
    t0 = time.perf_counter()
    Bc, _, _, Sc = crps_and_scores(algo, row, col, jax.devices("cpu")[0])
    tc = time.perf_counter() - t0
    say(phase, f"tile {Bg[0].shape[0]}x{Bg[0].shape[1]}: GPU {tg:.1f} s, "
               f"CPU {tc:.1f} s (compile included)")
    say(phase, f"tolerance: per pair and channel at most {FLIP_FRACTION:g} "
               f"of the valid CRP cells flip, and |score diff| <= "
               f"{FLIP_STEP} x flips / (m + n) + 2 ulp (fp32 sums run in "
               f"another order on the GPU, so a near-tie k-th neighbour "
               f"can flip; one flip moves the DP by at most 1 + gap)")
    cells = np.maximum(l1, 0) * np.maximum(l2, 0)
    denom = np.maximum(l1 + l2, 1)
    for ch, g, c in zip(algo._channels(), Bg, Bc):
        flips = (g != c).reshape(g.shape[0], g.shape[1], -1).sum(-1)
        worst = float((flips / np.maximum(cells, 1)).max())
        say(phase, f"{ch}: CRP cells differing {int(flips.sum())} of "
                   f"{int(cells.sum())} ({flips.sum() / cells.sum():.2e}); "
                   f"worst pair {worst:.2e} (limit {FLIP_FRACTION:g})")
        check(worst <= FLIP_FRACTION, f"{ch}: CRP disagreement {worst:.2e}")
        for k in (f"{ch}_qmax", f"{ch}_dmax"):
            d = np.abs(Sg[k].astype(np.float64) - Sc[k])
            allowed = (FLIP_STEP * flips / denom
                       + 2 * np.spacing(np.abs(Sc[k]).astype(np.float32)))
            say(phase, f"{k}: max |score diff| {d.max():.3e}; pairs "
                       f"differing {int((d > 0).sum())} of {d.size}; "
                       f"pairs over the flip bound "
                       f"{int((d > allowed).sum())}")
            check(bool((d <= allowed).all()),
                  f"{k}: score differs beyond the flip bound")


# ---------------------------------------------------------------- phases

def phase_device(n_cards: int):
    import jax

    devs = jax.devices()
    d = devs[0]
    say("a", f"JAX platform={d.platform} device_kind={d.device_kind} "
             f"count={len(devs)}")
    check(d.platform == "gpu", f"needs an NVIDIA GPU; JAX found "
                               f"platform {d.platform!r}")
    check(len(devs) >= n_cards, f"needs {n_cards} cards, found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    for line in smi.stdout.strip().splitlines():
        say("a", f"nvidia-smi: {line}")
    return devs


def phase_aligners(seed: int, B: int = 512, L: int = 512,
                   min_len: int = 320, n_oracle: int = 64) -> None:
    import jax

    from acoss_jax import native
    from acoss_jax.data.synthetic import make_random_crps
    from acoss_jax.ops import alignment, alignment_cuda

    t0 = time.perf_counter()
    so = alignment_cuda.build()
    say("b", f"CUDA aligners: {os.path.relpath(so, ROOT)} "
             f"(ready in {time.perf_counter() - t0:.1f} s)")
    rng = np.random.default_rng(seed)
    S, ml, nl = make_random_crps(rng, B, L, KAPPA, min_len=min_len)
    args = jax.device_put((S, ml, nl))
    say("b", f"workload: {B} pairs, L={L}, lengths {min_len}-{L}, "
             f"density {S.mean():.4f}")
    # the default backend ("auto") lowers the kernel for the card and the
    # scan for the CPU, in this one process
    for dev, want in ((jax.devices()[0], True),
                      (jax.devices("cpu")[0], False)):
        small = jax.device_put((S[:2], ml[:2], nl[:2]), dev)
        hlo = jax.jit(alignment.qmax_batch_best).lower(*small).as_text()
        has = "acoss_qmax_cuda" in hlo
        say("b", f"backend auto lowered for {dev.platform}: CUDA kernel in "
                 f"the program {has} (required {want})")
        check(has == want, f"auto backend on {dev.platform}")
    cases = (
        ("qmax", alignment_cuda.qmax_batch_cuda, alignment.qmax_batch,
         native.qmax_batch_cpu),
        ("dmax", alignment_cuda.dmax_batch_cuda, alignment.dmax_batch,
         native.dmax_batch_cpu),
        ("sw", alignment_cuda.swconstrained_batch_cuda,
         alignment.swconstrained_batch, native.swconstrained_batch_cpu),
    )
    for name, kernel, scan, oracle in cases:
        t0 = time.perf_counter()
        compiled = jax.jit(kernel).lower(*args).compile()
        say("b", f"{name}: kernel compiled in "
                 f"{time.perf_counter() - t0:.1f} s; memory_analysis "
                 f"{memory(compiled)}")
        scan_fn = jax.jit(scan)
        got = np.asarray(compiled(*args))
        ref = np.asarray(scan_fn(*args))
        ora = oracle(S[:n_oracle], ml[:n_oracle], nl[:n_oracle])
        bad_scan = int((got != ref).sum())
        bad_oracle = int((got[:n_oracle] != ora).sum())
        say("b", f"{name}: vs XLA scan {bad_scan} of {B} differ; vs C++ "
                 f"oracle {bad_oracle} of {n_oracle} differ (exact "
                 f"match required); score range {got.min():g}-"
                 f"{got.max():g}")
        check(bad_scan == 0 and bad_oracle == 0, f"{name}: not exact")
        tk = timed(compiled, *args)
        ts = timed(scan_fn, *args)
        say("b", f"{name}: CUDA kernel {ms(tk)}, XLA scan {ms(ts)}; "
                 f"scan/kernel {ts[0] / tk[0]:.1f}x; kernel "
                 f"{B / tk[0]:,.0f} pairs/s")


def phase_serra09(seed: int, work: str, corpus, queries) -> None:
    import jax

    from acoss_jax.benchmarking.algorithms import Serra09
    from acoss_jax.ops import crp

    path = os.path.join(work, "corpus.npz")
    corpus.save(path)
    lens = corpus.length("hpcp")
    say("c", f"corpus: {corpus.n_songs} songs, frames {lens.min()}-"
             f"{lens.max()}")
    t0 = time.perf_counter()
    out = run_cli("c", ["benchmark", "-a", "Serra09", "-d", path,
                        "-s", "smoke", "--cachedir",
                        os.path.join(work, "cache"), "--no-checkpoint",
                        "--stage-times"], work)
    say("c", f"cli benchmark wall {time.perf_counter() - t0:.1f} s "
             f"(compile included)")
    maps = dict(re.findall(r"^Serra09_(\w+): .* MAP=(\S+)", out, re.M))
    say("c", f"MAP per channel {maps} (limit >= {MIN_MAP})")
    check(len(maps) == 4 and all(float(v) >= MIN_MAP
                                 for v in maps.values()),
          f"MAP {maps}")

    algo = Serra09()
    desc = algo.extract_descriptors(corpus)
    L = desc["chroma"].shape[1]
    compare_tile("c", algo, tile_of(desc, 0, 16), tile_of(desc, 16, 32))

    # stage times of one sweep tile (TILE x TILE pairs) on the card
    t = algo.TILE
    row, col = jax.device_put((tile_of(desc, 0, t), tile_of(desc, t, 2 * t)))

    def sliding(r, c):
        m = algo.m
        ch1 = crp.transpose_chroma(r["chroma"], crp.get_oti(r["gchroma"],
                                                            c["gchroma"]))
        return (crp.sliding_csm_padded(crp.get_csm(ch1, c["chroma"]), m),
                crp.sliding_csm_padded(
                    crp.get_csm_centered(r["mfcc"], c["mfcc"]), m),
                r["length"] - m + 1, c["length"] - m + 1)

    grid = jax.vmap(jax.vmap(sliding, in_axes=(None, 0)), in_axes=(0, None))
    Dc, Dm, l1, l2 = jax.jit(grid)(row, col)

    def binarize(Dc, Dm, l1, l2):
        f = jax.vmap(jax.vmap(lambda D, a, b: crp.csm_to_binary_mutual(
            D, algo.kappa, a, b)))
        return f(Dc, l1, l2), f(Dm, l1, l2)

    crps = jax.jit(algo.tile_crps)(row, col)
    times = {}
    for backend in ("auto", "cuda", "xla"):
        tile_algo = Serra09()
        tile_algo.aligner = backend
        times[f"tile ({backend} aligners)"] = timed(
            jax.jit(tile_algo.tile_scores), row, col)
        times[f"aligners ({backend})"] = timed(
            jax.jit(tile_algo.crp_scores), *crps)
    times["CSM + sliding window"] = timed(jax.jit(grid), row, col)
    times["binarize"] = timed(jax.jit(binarize), Dc, Dm, l1, l2)
    times["CRPs (CSM + sliding + binarize)"] = timed(
        jax.jit(algo.tile_crps), row, col)
    for k, v in times.items():
        say("c", f"tile {t}x{t} ({2 * t * t} CRPs of {L}x{L}): {k} {ms(v)}")
    full = times["tile (auto aligners)"][0]
    say("c", f"binarize share of the tile: "
             f"{times['binarize'][0] / full:.3f}; aligner share "
             f"{times['aligners (auto)'][0] / full:.3f}; tile with XLA "
             f"scan / with auto (CUDA kernel) "
             f"{times['tile (xla aligners)'][0] / full:.2f}x")


def phase_early_snf(seed: int, tile: int = 8, L: int = 448,
                    ssm_dim: int = 20736) -> None:
    from acoss_jax.benchmarking.algorithms import EarlySNF

    rng = np.random.default_rng(seed)

    def side():
        return {
            "chroma": rng.random((tile, L, 12), np.float32),
            "mfcc": rng.standard_normal((tile, L, 13)).astype(np.float32),
            "ssms": rng.random((tile, L, ssm_dim), np.float32),
            "gchroma": rng.random((tile, 12), np.float32),
            "length": rng.integers(L // 2, L, size=tile).astype(np.int32),
        }

    algo = EarlySNF(snf_precision="highest")
    say("d", f"EarlySNF tile {tile}x{tile}, L={L}, ssms dim {ssm_dim}, "
             f"snf_precision=highest")
    compare_tile("d", algo, side(), side())


def phase_serving(work: str, corpus, queries) -> None:
    from acoss_jax.benchmarking.algorithms import Serra09
    from acoss_jax.benchmarking.harness import run_pairwise
    from acoss_jax.data.store import concat_feature_sets

    cpath = os.path.join(work, "corpus.npz")
    if not os.path.exists(cpath):
        corpus.save(cpath)
    qpath = os.path.join(work, "queries.npz")
    queries.save(qpath)
    algo = Serra09()
    stype = algo.SIMILARITY_TYPES[0]
    t0 = time.perf_counter()
    out = run_cli("e", ["query", "-a", "Serra09", "-d", cpath, "-q", qpath,
                        "--index-dir", os.path.join(work, "index"),
                        "--similarity-type", stype, "--top", "3"], work)
    say("e", f"cli query wall {time.perf_counter() - t0:.1f} s (index "
             f"build and compile included)")
    ranked = [json.loads(line) for line in out.splitlines()
              if line.startswith("{")]
    check(len(ranked) == queries.n_songs, f"{len(ranked)} answers")

    both = concat_feature_sets([corpus, queries])
    desc = algo.extract_descriptors(both)
    n = corpus.n_songs
    first = n // algo.TILE      # the query rows' block-row
    Ds = run_pairwise(algo, desc, both.n_songs,
                      tile_filter=lambda ti, tj: ti >= first)
    D = Ds[stype][n:, :n]
    for q, ans in enumerate(ranked):
        top = ans["top"][0]
        j = int(np.argmax(D[q]))
        same = corpus.labels[top["index"]] == queries.labels[q]
        diff = abs(top["score"] - float(D[q, j]))
        say("e", f"query {ans['query']} ({stype}): served top-1 {top['id']} "
                 f"({top['score']:.5f}); harness top-1 "
                 f"{corpus.track_ids[j]} ({D[q, j]:.5f}); |diff| "
                 f"{diff:.2e} (limit {SERVE_TOL}); same clique "
                 f"{bool(same)} (same top-1 and clique required)")
        check(top["index"] == j and same and diff <= SERVE_TOL,
              f"query {ans['query']}")


def single_device_sweep(tile_fn, desc, n_pad, row_block, col_tile,
                        device):
    """The full (n_pad, n_pad) score matrices from `tile_fn` on one device,
    over (row_block x col_tile) tiles (the shapes a mesh program runs)."""
    import jax

    from acoss_jax.parallel.mesh import _pad_desc_np

    desc = _pad_desc_np(desc, n_pad)
    fn = jax.jit(tile_fn)
    out = {}
    for i in range(0, n_pad, row_block):
        row = jax.device_put(tile_of(desc, i, i + row_block), device)
        for j in range(0, n_pad, col_tile):
            col = jax.device_put(tile_of(desc, j, j + col_tile), device)
            for k, v in fn(row, col).items():
                out.setdefault(k, np.zeros((n_pad, n_pad), np.float32))
                out[k][i:i + row_block, j:j + col_tile] = np.asarray(v)
    return out


def phase_sharded(devices, algo, desc, n: int) -> None:
    import math

    from acoss_jax.parallel import (make_pair_mesh, sharded_pair_scores,
                                    sharded_pair_scores_triangular)

    ct = algo.TILE
    mesh = make_pair_mesh(devices=devices, shape=(2, 2))
    t0 = time.perf_counter()
    out = sharded_pair_scores(algo.tile_scores, desc, n, mesh, col_tile=ct)
    say("f", f"2x2 mesh sweep of {n} songs: {time.perf_counter() - t0:.1f}"
             f" s (compile included)")
    n_pad = -(-n // math.lcm(2, 2 * ct)) * math.lcm(2, 2 * ct)
    ref = single_device_sweep(algo.tile_scores, desc, n_pad, n_pad // 2, ct,
                              devices[0])
    for k in sorted(out):
        bad = int((out[k] != ref[k][:n, :n]).sum())
        say("f", f"mesh {k}: {bad} of {n * n} cells differ from the "
                 f"single-device sweep (exact match required)")
        check(bad == 0, f"mesh {k}")

    t0 = time.perf_counter()
    tri = sharded_pair_scores_triangular(algo.tile_scores, desc, n,
                                         devices=devices, col_tile=ct)
    say("f", f"triangular fold over {len(devices)} devices: "
             f"{time.perf_counter() - t0:.1f} s (compile included)")
    two_d = 2 * len(devices)
    chunk = max(-(-n // two_d), ct)
    chunk = -(-chunk // ct) * ct
    ref = single_device_sweep(algo.tile_scores, desc, two_d * chunk, chunk,
                              ct, devices[0])
    low = np.tril_indices(n, k=-1)
    for k in sorted(tri):
        bad = int((tri[k][low] != ref[k][:n, :n][low]).sum())
        say("f", f"triangular {k}: {bad} of {low[0].size} lower-triangle "
                 f"cells differ from the single-device sweep (exact match "
                 f"required); mirrored {bool((tri[k] == tri[k].T).all())}")
        check(bad == 0 and (tri[k] == tri[k].T).all(), f"triangular {k}")


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only phase f, the Serra09 sweep sharded over "
                         "four cards, against the single-device sweep")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import acoss_jax  # noqa: F401  (sets the compile cache before jax runs)

    devs = phase_device(4 if args.four else 1)
    work = os.path.join(ROOT, "work", f"chip_smoke_{os.getpid()}")
    os.makedirs(work, exist_ok=True)
    failed = []

    def run(letter, fn, *a):
        t0 = time.perf_counter()
        try:
            fn(*a)
            say(letter, f"passed in {time.perf_counter() - t0:.1f} s")
        except Exception:
            failed.append(letter)
            for line in traceback.format_exc().splitlines():
                say(letter, f"FAIL {line}")

    try:
        corpus, queries = covers80_corpus(args.seed)
        if args.four:
            from acoss_jax.benchmarking.algorithms import Serra09

            algo = Serra09()
            desc = algo.extract_descriptors(corpus)
            run("f", phase_sharded, devs[:4], algo, desc, corpus.n_songs)
        else:
            run("b", phase_aligners, args.seed)
            run("c", phase_serra09, args.seed, work, corpus, queries)
            run("d", phase_early_snf, args.seed)
            run("e", phase_serving, work, corpus, queries)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if failed:
        print(f"FAILED phases: {', '.join(failed)}", flush=True)
        return 1
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
