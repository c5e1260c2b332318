"""Decompose the EarlySNF tile cost at real Da-TACOS descriptor dims.

This script times the tile's component programs standalone on the
device — each over distinct input buffers, ended by block_until_ready —
so optimization effort goes at the measured hot spot, not the guessed
one.

Components, each jitted whole at tile dims (tile=8 -> 64 pairs,
L=448, ssm_dim=20736):
  full        tile_scores (the whole per-tile program)
  no_ssms     tile_scores with the ssms channel off (Serra09 channels)
  wcsmssm     the two get_WCSMSSM affinity builds (vmapped, 64 pairs)
  snf         snf_ws cross-diffusion alone (F=2, 3 iters, 896^2)
  binarize    csm_to_binary_mutual x4 channels
  csm_ssms    the 20736-dim pair CSM (the big matmul)
  align       qmax+dmax over the 4 stacked binary CRPs

Usage: python scripts/esnf_tile_profile.py [--reps 4] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def _amortized(fn, inputs, reps):
    """Seconds per call: compile and warm up, then `reps` back-to-back
    calls over DISTINCT buffers, ended by block_until_ready."""
    import jax

    for w in range(2):
        jax.block_until_ready(fn(*inputs[w % len(inputs)]))
    t0 = time.perf_counter()
    outs = [fn(*inputs[r % len(inputs)]) for r in range(reps)]
    jax.block_until_ready(outs)
    return (time.perf_counter() - t0) / max(reps, 1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--tile", type=int, default=8)
    ap.add_argument("--L", type=int, default=448)
    ap.add_argument("--ssm-dim", type=int, default=20736)
    ap.add_argument("--snf-precision", default="highest",
                    choices=("highest", "default"))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    from acoss_jax.benchmarking.algorithms.early_snf import EarlySNF
    from acoss_jax.ops import alignment, crp, fusion

    t8, L, sdim = args.tile, args.L, args.ssm_dim
    algo = EarlySNF(chroma_type="hpcp", snf_precision=args.snf_precision)
    print(f"device: {jax.devices()[0]}  tile={t8} L={L} ssm_dim={sdim} "
          f"snf_precision={args.snf_precision}")

    rng = np.random.default_rng(0)

    def tile_inputs(seed):
        r = np.random.default_rng(seed)

        def side():
            return {
                "chroma": jnp.asarray(
                    r.random((t8, L, 12), np.float32)),
                "mfcc": jnp.asarray(
                    r.standard_normal((t8, L, 13)).astype(np.float32)),
                "ssms": jnp.asarray(
                    r.random((t8, L, sdim), np.float32)),
                "gchroma": jnp.asarray(
                    r.random((t8, 12), np.float32)),
                "length": jnp.asarray(
                    r.integers(L // 2, L, size=t8).astype(np.int32)),
            }
        return side(), side()

    n_bufs = 2
    tiles = [tile_inputs(s) for s in range(n_bufs)]

    timings = {}

    full = jax.jit(lambda r, c: algo.tile_scores(r, c))
    timings["full"] = _amortized(full, tiles, args.reps)
    print(f"full tile_scores:      {timings['full'] * 1e3:9.1f} ms",
          flush=True)

    algo_ns = EarlySNF(chroma_type="hpcp", do_ssms=False,
                       snf_precision=args.snf_precision)
    ns_tiles = [({k: v for k, v in r.items() if k != "ssms"},
                 {k: v for k, v in c.items() if k != "ssms"})
                for r, c in tiles]
    no_ssms = jax.jit(lambda r, c: algo_ns.tile_scores(r, c))
    timings["no_ssms"] = _amortized(no_ssms, ns_tiles, args.reps)
    print(f"no-ssms tile_scores:   {timings['no_ssms'] * 1e3:9.1f} ms",
          flush=True)

    m = algo.m
    kappa = algo.kappa

    def pair_grid(fn):
        return jax.jit(jax.vmap(jax.vmap(fn, in_axes=(None, 0)),
                                in_axes=(0, None)))

    def wcsmssm_pair(r, c):
        l1e = r["length"] - m + 1
        l2e = c["length"] - m + 1
        K = (kappa * (l1e + l2e)).astype(jnp.int32)
        csm_c = crp.sliding_csm_padded(
            crp.get_csm(r["chroma"], c["chroma"]), m)
        ssma_c = crp.sliding_csm_padded(
            crp.get_csm(r["chroma"], r["chroma"]), m)
        ssmb_c = crp.sliding_csm_padded(
            crp.get_csm(c["chroma"], c["chroma"]), m)
        kmax = int(np.ceil(kappa * (2 * L))) + 1
        W1 = fusion.get_WCSMSSM(ssma_c, ssmb_c, csm_c, K,
                                m_len=l1e, n_len=l2e, k_static_max=kmax)
        csm_s = crp.get_csm(r["ssms"], c["ssms"])
        W2 = fusion.get_WCSMSSM(crp.get_ssm(r["ssms"]),
                                crp.get_ssm(c["ssms"]), csm_s, K,
                                m_len=l1e, n_len=l2e, k_static_max=kmax)
        return W1.sum() + W2.sum()

    timings["wcsmssm"] = _amortized(pair_grid(wcsmssm_pair), tiles,
                                    args.reps)
    print(f"2x get_WCSMSSM:        {timings['wcsmssm'] * 1e3:9.1f} ms",
          flush=True)

    def snf_pair(r, c):
        l1e = r["length"] - m + 1
        l2e = c["length"] - m + 1
        K = (kappa * (l1e + l2e)).astype(jnp.int32)
        kmax = int(np.ceil(kappa * (2 * L))) + 1
        # synthetic (F=2, 2L, 2L) affinity stack at the fused dims; the
        # data dependency on the inputs keeps XLA from folding it away
        W = (jnp.ones((2, 2 * L, 2 * L), jnp.float32)
             * (1.0 + 0.01 * r["gchroma"][:1])
             + 0.001 * c["gchroma"][0])
        return fusion.snf_ws(W, K=K, niters=3, reg_diag=True,
                             sequential=True, k_static_max=kmax).sum()

    timings["snf"] = _amortized(pair_grid(snf_pair), tiles, args.reps)
    print(f"snf_ws (3 it, {2 * L}^2): {timings['snf'] * 1e3:8.1f} ms",
          flush=True)

    def binarize_pair(r, c):
        l1e = r["length"] - m + 1
        l2e = c["length"] - m + 1
        csm = crp.sliding_csm_padded(
            crp.get_csm(r["chroma"], c["chroma"]), m)
        out = 0.0
        for _ in range(4):
            out = out + crp.csm_to_binary_mutual(
                csm, kappa, l1e, l2e).sum()
            csm = csm + 1e-3
        return out

    timings["binarize_x4"] = _amortized(pair_grid(binarize_pair), tiles,
                                        args.reps)
    print(f"binarize x4 (XLA):     "
          f"{timings['binarize_x4'] * 1e3:9.1f} ms", flush=True)

    def csm_ssms_pair(r, c):
        return crp.get_csm(r["ssms"], c["ssms"]).sum()

    timings["csm_ssms"] = _amortized(pair_grid(csm_ssms_pair), tiles,
                                     args.reps)
    print(f"ssms pair CSM:         {timings['csm_ssms'] * 1e3:9.1f} ms",
          flush=True)

    def align_tile(r, c):
        bi = r["length"].shape[0]
        bj = c["length"].shape[0]
        S = (jnp.einsum("ilk,jmk->ijlm", r["chroma"], c["chroma"])
             > 0.5).astype(jnp.uint8)
        S = jnp.tile(S.reshape(-1, L, L), (4, 1, 1))
        ml = jnp.tile(jnp.repeat(r["length"], bj), 4)
        nl = jnp.tile(jnp.tile(c["length"], bi), 4)
        q = alignment.qmax_batch_best(S, ml, nl)
        d = alignment.dmax_batch_best(S, ml, nl)
        return q.sum() + d.sum()

    timings["align"] = _amortized(jax.jit(align_tile), tiles, args.reps)
    print(f"qmax+dmax x4ch:        {timings['align'] * 1e3:9.1f} ms",
          flush=True)

    print("\nsummary (ms):", {k: round(v * 1e3, 1)
                              for k, v in timings.items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
