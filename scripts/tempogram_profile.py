"""Decompose `tempogram_aggregated_batch` cost at covers80-scale dims.

The StrucLaplacian stage table puts struct:host_prep at 71% of wall,
and struct_prep_profile.py pins ~all of it on the batched tempogram
(173.5 s cold for 160 songs). This times the device program's pieces
warm — gather-frames, window, rfft/irfft autocorrelation, inf-norm,
segment-sum — so the cut goes at the measured hot spot.

Usage: python scripts/tempogram_profile.py [--B 16] [--L 16384]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def _sync(out):
    import jax
    import numpy as np

    return sum(float(np.asarray(leaf).ravel()[0])
               for leaf in jax.tree.leaves(out))


def _amortized(fn, inputs, reps):
    for w in range(3):
        _sync(fn(*inputs[w % len(inputs)]))
    t1 = time.time()
    _sync(fn(*inputs[0]))
    t1 = time.time() - t1
    t0 = time.time()
    outs = [fn(*inputs[r % len(inputs)]) for r in range(reps + 1)]
    _sync(outs[-1])
    tn = time.time() - t0
    return (tn - t1) / max(reps, 1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--B", type=int, default=16)
    ap.add_argument("--L", type=int, default=16384)      # n_frames
    ap.add_argument("--win", type=int, default=384)
    ap.add_argument("--nseg", type=int, default=576)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp

    from acoss_jax.features import rhythm

    B, L, win, nseg = args.B, args.L, args.win, args.nseg
    print(f"device: {jax.devices()[0]}  B={B} n_frames={L} win={win} "
          f"nseg={nseg}", flush=True)

    def inputs(seed):
        r = np.random.default_rng(seed)
        P = r.random((B, L + win), np.float32)
        S = np.repeat(np.arange(L // 28 + 1), 28)[:L].astype(np.int32)
        S = np.broadcast_to(S, (B, L)).copy()
        return jnp.asarray(P), jnp.asarray(S)

    tiles = [inputs(s) for s in range(2)]
    timings = {}

    full = lambda P, S: rhythm._tempogram_segsum_batch(
        P, S, win, L, nseg)
    timings["full"] = _amortized(full, tiles, args.reps)
    print(f"full segsum batch:   {timings['full'] * 1e3:9.1f} ms",
          flush=True)

    @jax.jit
    def gather_only(P, S):
        idx = jnp.arange(L)[:, None] + jnp.arange(win)[None, :]
        return jax.vmap(lambda p: p[idx].sum(1))(P)

    timings["gather"] = _amortized(gather_only, tiles, args.reps)
    print(f"frame gather:        {timings['gather'] * 1e3:9.1f} ms",
          flush=True)

    @jax.jit
    def fft_only(P, S):
        idx = jnp.arange(L)[:, None] + jnp.arange(win)[None, :]

        def one(p):
            frames = p[idx]
            spec = jnp.fft.rfft(frames, n=2 * win, axis=-1)
            ac = jnp.fft.irfft(spec * jnp.conj(spec), n=2 * win, axis=-1)
            return ac[:, :win].sum(1)

        return jax.vmap(one)(P)

    timings["gather+fft"] = _amortized(fft_only, tiles, args.reps)
    print(f"gather+fft autocorr: {timings['gather+fft'] * 1e3:9.1f} ms",
          flush=True)

    @jax.jit
    def segsum_only(P, S):
        X = jnp.broadcast_to(P[:, :L, None], (B, L, win)) * 1.0

        def one(x, s):
            return jax.ops.segment_sum(x, s, num_segments=nseg)

        return jax.vmap(one)(X, S)

    timings["segment_sum"] = _amortized(segsum_only, tiles, args.reps)
    print(f"segment_sum:         "
          f"{timings['segment_sum'] * 1e3:9.1f} ms", flush=True)

    print("\nsummary (ms):", {k: round(v * 1e3, 1)
                              for k, v in timings.items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
