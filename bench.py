"""Benchmark: qmax pair-alignment throughput on an NVIDIA GPU.

Prints ONE JSON line naming the device it ran on:
  {"metric": "qmax_pairs_per_sec_per_chip", "value": ..., "unit":
   "song-pairs/sec/chip", "vs_baseline": ..., "device": {...},
   "serra09_scored_pairs_per_sec": ...}

`value` is the aligner kernel's rate (the CUDA qmax kernel on a GPU);
`serra09_scored_pairs_per_sec` is the FULLY-SCORED rate of the Serra09
tile program (OTI -> CSM -> CRP -> qmax+dmax on 2 channels per pair).

vs_baseline is the multiplier over the native single-core C++ qmax
(the analog of the reference's C kernel,
`/root/reference/benchmarking/SequenceAlignment.c:113-143`), measured in
this same process on the same CRP workload.

Workload: covers80-scale binary CRPs — L = 512 padded frames (a ~3.5-minute
song at hop 512 downsampled x40 gives ~430 frames), kappa = 0.095 match
density, ragged lengths drawn from [320, 512].

Timing: each reading runs the jitted program back to back as many times
as fill READING_S seconds (so a sub-millisecond kernel is resolved over
hundreds of calls, not dominated by host dispatch) and ends with
`block_until_ready`; the median of REPEATS readings is reported with
their spread. Fails (exit 1, no result line) when JAX finds no GPU.
"""

import json
import subprocess
import sys
import time

import numpy as np

L = 512            # padded CRP side
BATCH = 512        # pairs per device call
CPU_PAIRS = 12     # pairs timed for the CPU baseline
KAPPA = 0.095
READING_S = 0.2    # host seconds per reading, at least
REPEATS = 7        # median-of-k readings; spread reported alongside


def _rate(fn, args, items: int) -> tuple[float, float]:
    """(median items/s, spread %) of `fn(*args)`."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    niter = max(1, int(np.ceil(READING_S / (time.perf_counter() - t0))))
    rates = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(niter):
            out = fn(*args)
        jax.block_until_ready(out)
        rates.append(items * niter / (time.perf_counter() - t0))
    med = float(np.median(rates))
    return med, 100.0 * (max(rates) - min(rates)) / med


def main() -> int:
    import jax

    import acoss_jax  # noqa: F401  (sets the compile cache before compiling)

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    if dev.platform != "gpu":
        print(f"bench.py needs an NVIDIA GPU; JAX found {device}",
              file=sys.stderr)
        return 1
    # name and power limit: a card set below its maximum runs slower
    device["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    from acoss_jax import native
    from acoss_jax.data.synthetic import make_random_crps
    from acoss_jax.ops.alignment import (dmax_batch_best, qmax_batch_best,
                                         swconstrained_batch_best)

    rng = np.random.default_rng(0)
    S, m_len, n_len = make_random_crps(rng, BATCH, L, KAPPA, min_len=320)

    # --- CPU baseline: native single-core C++ (rolling-row qmax).
    native.qmax_cpu(S[0, :64, :64])  # warm the .so build
    t0 = time.perf_counter()
    for b in range(CPU_PAIRS):
        native.qmax_cpu(S[b, :m_len[b], :n_len[b]])
    cpu_pps = CPU_PAIRS / (time.perf_counter() - t0)

    args = jax.device_put((S, m_len, n_len))
    pps, spread = _rate(jax.jit(qmax_batch_best), args, BATCH)

    # the device scores equal the C++ oracle exactly, for all three
    # aligners
    for fn, oracle in ((qmax_batch_best, native.qmax_batch_cpu),
                       (dmax_batch_best, native.dmax_batch_cpu),
                       (swconstrained_batch_best,
                        native.swconstrained_batch_cpu)):
        np.testing.assert_array_equal(
            np.asarray(jax.jit(fn)(*args))[:8],
            oracle(S[:8], m_len[:8], n_len[:8]))

    s_pps, s_spread = _serra09_scored_pps()
    print(json.dumps({
        "metric": "qmax_pairs_per_sec_per_chip",
        "value": round(pps, 2),
        "unit": "song-pairs/sec/chip",
        "vs_baseline": round(pps / cpu_pps, 2),
        "readings_k": REPEATS,
        "spread_pct": round(spread, 1),
        "serra09_scored_pairs_per_sec": round(s_pps, 2),
        "serra09_spread_pct": round(s_spread, 1),
        "device": device,
    }))
    print(f"# CPU baseline: {cpu_pps:.1f} pairs/s (1 core)", file=sys.stderr)
    return 0


def _serra09_scored_pps(tile: int = 16) -> tuple[float, float]:
    """(median pairs/s, spread %) of the full Serra09 tile program on 32
    synthetic songs at covers80-realistic CRP dims (descriptor lengths
    160-480, padded to 512, matching the L = 512 aligner workload)."""
    import jax

    from acoss_jax.benchmarking.algorithms import Serra09
    from acoss_jax.data import make_synthetic_dataset

    fs = make_synthetic_dataset(n_cliques=tile, clique_size=2, seed=1)
    algo = Serra09(chroma_type="hpcp", downsample_fac=1)
    desc = algo.extract_descriptors(fs)
    row = jax.device_put({k: np.asarray(v)[:tile] for k, v in desc.items()})
    col = jax.device_put({k: np.asarray(v)[tile:2 * tile]
                          for k, v in desc.items()})
    return _rate(jax.jit(algo.tile_scores), (row, col), tile * tile)


if __name__ == "__main__":
    sys.exit(main())
