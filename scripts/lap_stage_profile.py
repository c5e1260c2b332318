"""Decompose `laplacian_profile_batch` cost at realistic dims.

StrucLaplacian is the slowest covers80-scale consumer (443 s for 160
songs, RESULTS.md round-4 re-run) and its device stage is one fused
program: rw-Laplacian eigh -> 9x masked k-means (n_init restarts x
Lloyd iters) -> meet matrix -> SVD. This times each component
standalone on the chip — amortized (T(n+1) - T(1)) / n with distinct
buffers — so the next cut goes at the measured hot spot.

Components (B songs per batch, npad beats, meet_pad meet grid):
  full       laplacian_profile_batch (the whole fused program)
  eigh       rw_laplacian_eigs_padded alone (B x npad^2)
  kmeans     the 9 spectral k-means sweeps alone (k=2..10)
  meet       label -> meet-matrix assembly alone
  svd        jnp.linalg.svd of the (meet_pad)^2 meet matrix alone
  svd_eigh   eigh-based symmetric SVD of the same matrix (candidate)

Usage: python scripts/lap_stage_profile.py [--B 8] [--npad 384]
                                           [--meet-pad 512] [--cpu]
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
    ap.add_argument("--B", type=int, default=8)
    ap.add_argument("--npad", type=int, default=384)
    ap.add_argument("--meet-pad", type=int, default=512)
    ap.add_argument("--neigs", type=int, default=10)
    ap.add_argument("--n-init", type=int, default=50)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp

    from acoss_jax.ops import structure

    B, npad, mp, ne = args.B, args.npad, args.meet_pad, args.neigs
    print(f"device: {jax.devices()[0]}  B={B} npad={npad} "
          f"meet_pad={mp} neigs={ne} n_init={args.n_init} "
          f"iters={args.iters}", flush=True)

    def batch_inputs(seed):
        r = np.random.default_rng(seed)
        n = r.integers(npad * 3 // 4, npad, size=B).astype(np.int32)
        A = r.random((B, npad, npad), np.float32)
        W = jnp.asarray(0.5 * (A + A.transpose(0, 2, 1)))
        times = np.full((B, npad), 1e18, np.float32)
        for b in range(B):
            t = np.sort(r.uniform(0.3, 0.7, size=n[b])).cumsum()
            times[b, :n[b]] = t
        return W, jnp.asarray(n), jnp.asarray(times)

    tiles = [batch_inputs(s) for s in range(2)]
    timings = {}

    full = lambda W, n, t: structure.laplacian_profile_batch(
        W, n, t, ne, mp, n_init=args.n_init, iters=args.iters)
    timings["full"] = _amortized(full, tiles, args.reps)
    print(f"full profile_batch:  {timings['full'] * 1e3:9.1f} ms",
          flush=True)

    eigh = jax.jit(jax.vmap(structure.rw_laplacian_eigs_padded))
    timings["eigh"] = _amortized(
        lambda W, n, t: eigh(W, n), tiles, args.reps)
    print(f"rw eigh:             {timings['eigh'] * 1e3:9.1f} ms",
          flush=True)

    @jax.jit
    def kmeans_only(W, n, t):
        def per_song(Wi, ni, song_idx):
            vs = Wi[:, :ne]    # stand-in eigenvectors, same dims
            valid = jnp.arange(npad) < ni
            key = jax.random.fold_in(jax.random.PRNGKey(0), song_idx)
            acc = 0.0
            for k in range(2, ne + 1):
                lab = structure._kmeans_labels(
                    vs[:, :k], valid, k, jax.random.fold_in(key, k),
                    args.n_init, args.iters)
                acc = acc + lab.sum()
            return acc
        return jax.vmap(per_song)(W, n, jnp.arange(B))

    timings["kmeans_x9"] = _amortized(kmeans_only, tiles, args.reps)
    print(f"kmeans x9:           {timings['kmeans_x9'] * 1e3:9.1f} ms",
          flush=True)

    @jax.jit
    def meet_only(W, n, t):
        def per_song(Wi, ni, ti):
            beat = jnp.clip(
                jnp.searchsorted(
                    ti, (jnp.arange(mp) + 0.5) * 0.4, side="right") - 1,
                0, npad - 1)
            ok = jnp.arange(mp) < mp
            meet = jnp.zeros((mp, mp), jnp.float32)
            for level, k in enumerate(range(2, ne + 1), 1):
                lab = (Wi[:, k] * k).astype(jnp.int32)[beat]
                same = (lab[:, None] == lab[None, :]) & \
                    ok[:, None] & ok[None, :]
                meet = jnp.where(same, float(level), meet)
            return meet.sum()
        return jax.vmap(per_song)(W, n, t)

    timings["meet"] = _amortized(meet_only, tiles, args.reps)
    print(f"meet assembly:       {timings['meet'] * 1e3:9.1f} ms",
          flush=True)

    def meet_batch(seed):
        r = np.random.default_rng(100 + seed)
        lv = r.integers(0, ne, size=(B, mp, mp)).astype(np.float32)
        M = np.tril(lv) + np.tril(lv, -1).transpose(0, 2, 1)
        return (jnp.asarray(M),)

    mtiles = [meet_batch(s) for s in range(2)]

    @jax.jit
    def svd_only(M):
        U, s, _ = jnp.linalg.svd(M, full_matrices=False)
        return (U[:, :, :ne] * s[:, None, :ne]).sum()

    timings["svd"] = _amortized(svd_only, mtiles, args.reps)
    print(f"svd (meet_pad^2):    {timings['svd'] * 1e3:9.1f} ms",
          flush=True)

    @jax.jit
    def svd_eigh_only(M):
        lam, V = jnp.linalg.eigh(M)
        order = jnp.argsort(-jnp.abs(lam), axis=1)
        s = jnp.take_along_axis(jnp.abs(lam), order[:, :ne], axis=1)
        U = jnp.take_along_axis(
            V, order[:, None, :ne].repeat(mp, axis=1), axis=2)
        return (U * s[:, None, :]).sum()

    timings["svd_eigh"] = _amortized(svd_eigh_only, mtiles, args.reps)
    print(f"eigh-SVD candidate:  {timings['svd_eigh'] * 1e3:9.1f} ms",
          flush=True)

    print("\nsummary (ms):", {k: round(v * 1e3, 1)
                              for k, v in timings.items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
