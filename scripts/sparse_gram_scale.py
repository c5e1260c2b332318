"""Measure the StrucFTM2D/StrucShingles sparse Gram at Da-TACOS scale.

The reference computes its shingle similarity with one host-side sparse
Gram (`/root/reference/benchmarking/StrucFTM2D.py:173-189`: X @ X.T over
a (n, PAD_LEN^2) CSR with 5 * PAD_LEN nonzeros per row). acoss_jax kept
that host path and ROADMAP estimated it "fine to ~15k songs" — untested
beyond covers80 scale (VERDICT round 2, weak #7). SpGEMM cost is
sum_c n_c^2 over column counts n_c, so it depends entirely on how much
the shingles' support CONCENTRATES: if every song keeps roughly the same
low-frequency FFT bins, cost approaches nnz_per_row * n^2 and the host
path dies at 15k.

This script settles it by measurement:

  phase "concentration": extract REAL StrucFTM2D + StrucShingles
    descriptors from a synthetic planted corpus (CPU) and report
    nnz/song, global column-union size, mean pairwise support overlap,
    and the column-count histogram; saves the empirical column
    distribution for phase 2.

  phase "spgemm": synthesize n-row CSRs whose columns are drawn from the
    measured distribution, time scipy X @ X.T (+ densify + exp) at
    increasing n, and extrapolate to 15k via the sum_c n_c^2 model.

  phase "device": synthesize n rows the same way and time the device
    dense-over-union Gram (`ops/sparse_gram.sparse_gram_scores`) on the
    default device, including the H2D of the compact form and the D2H of
    the score tiles.

Usage:
    python scripts/sparse_gram_scale.py concentration [--songs N]
    python scripts/sparse_gram_scale.py spgemm [--sizes 1000,2000,4000]
    python scripts/sparse_gram_scale.py device [--sizes 4000,15000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# phases "concentration" and "spgemm" are host-side and force the CPU
# backend; phase "device" runs on whatever jax.devices() provides.

DIST_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "..", "artifacts", "shingle_column_dist.npz")


def cmd_concentration(args):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    from acoss_jax.benchmarking.algorithms.struc_ftm2d import (
        StrucFTM2D, StrucShingles)
    from acoss_jax.data.synthetic import make_synthetic_dataset

    fs = make_synthetic_dataset(
        n_cliques=args.songs // 2, clique_size=2, n_states=48,
        base_duration=300.0, beat_period=30.0, seed=0)
    out = {}
    for cls in (StrucFTM2D, StrucShingles):
        algo = cls()
        t0 = time.time()
        desc = algo.extract_descriptors(fs)
        dt = time.time() - t0
        idxs = desc["idx"]
        nnz = np.array([len(ix) for ix in idxs])
        all_idx = np.concatenate(idxs)
        union, counts = np.unique(all_idx, return_counts=True)
        # mean pairwise support overlap from column counts:
        # E[|row_i ∩ row_j|] = sum_c C(n_c,2) / C(n,2)
        n = len(idxs)
        mean_overlap = float((counts * (counts - 1.0)).sum()
                             / (n * (n - 1.0)))
        stats = {
            "n_songs": n,
            "extract_s": round(dt, 1),
            "nnz_per_song": [int(nnz.min()), int(nnz.max())],
            "dim": int(desc["dim"]),
            "union_cols": int(union.size),
            "union_frac_of_nnz": round(union.size / float(nnz.sum()), 4),
            "mean_pairwise_overlap": round(mean_overlap, 1),
            "cols_in_all_songs": int((counts == n).sum()),
            "cols_in_half_plus": int((counts >= n / 2).sum()),
        }
        out[cls.NAME] = stats
        print(cls.NAME, json.dumps(stats), flush=True)
        np.savez_compressed(
            DIST_PATH.replace(".npz", f"_{cls.NAME}.npz"),
            cols=union, counts=counts, n_songs=n,
            nnz_per_song=nnz, dim=desc["dim"])
    return out


def synth_rows(n, rng, cols, probs, nnz_row, fresh_per_row=0, dim=0):
    """Draw per-row sorted unique index sets from the measured column
    distribution (with-replacement draw + unique + top-up keeps the
    heavy atoms' hit rates right), plus `fresh_per_row` columns drawn
    uniformly from the full dim — the measured singleton rate — so the
    union KEEPS GROWING with corpus size like a real corpus's does."""
    rows = []
    k_dist = max(1, nnz_row - fresh_per_row)
    for _ in range(n):
        draw = rng.choice(cols, size=int(k_dist * 1.3), p=probs)
        u = np.unique(draw)
        # top-up: in the concentrated regime the with-replacement draw
        # collapses under unique(); under-filled rows would understate
        # nnz and the SpGEMM cost the script exists to measure
        tries = 0
        while u.size < k_dist and tries < 50:
            extra = rng.choice(cols, size=k_dist - u.size, p=probs)
            u = np.union1d(u, extra)
            tries += 1   # bounded: the distribution may have < k atoms
        if u.size >= k_dist:
            u = u[rng.permutation(u.size)[:k_dist]]
        if fresh_per_row:
            u = np.union1d(u, rng.integers(0, dim, fresh_per_row))
        else:
            u.sort()
        rows.append(u.astype(np.int64))
    return rows


def cmd_spgemm(args):
    from scipy import sparse
    sizes = [int(s) for s in args.sizes.split(",")]
    for name in ("StrucFTM2D", "StrucShingles"):
        path = DIST_PATH.replace(".npz", f"_{name}.npz")
        if not os.path.exists(path):
            print(f"{name}: run `concentration` first ({path} missing)")
            continue
        d = np.load(path)
        cols, counts = d["cols"], d["counts"].astype(np.float64)
        nnz_row = int(np.median(d["nnz_per_song"]))
        probs = counts / counts.sum()
        rng = np.random.default_rng(0)
        results = []
        for n in sizes:
            rows = synth_rows(n, rng, cols, probs, nnz_row)
            indptr = np.cumsum([0] + [len(r) for r in rows])
            X = sparse.csr_matrix(
                (np.ones(indptr[-1], np.float32), np.concatenate(rows),
                 indptr), shape=(n, int(d["dim"])))
            t0 = time.time()
            G = X @ X.T
            t_gram = time.time() - t0
            t0 = time.time()
            Gd = np.asarray(G.todense())
            sq = np.asarray(X.power(2).sum(axis=1)).ravel()
            D = np.exp(-np.maximum(
                sq[:, None] + sq[None, :] - 2.0 * Gd, 0.0))
            t_post = time.time() - t0
            # measured per-column model for extrapolation
            col_counts = np.bincount(X.indices)
            cost = float((col_counts.astype(np.float64) ** 2).sum())
            results.append((n, t_gram, t_post, cost))
            print(f"{name} n={n}: spgemm {t_gram:.1f}s "
                  f"post {t_post:.1f}s model-cost {cost:.3g}",
                  flush=True)
            del X, G, Gd, D
        if len(results) >= 2:
            # cost scales ~n^2 (shared columns): fit t = a * cost
            a = np.mean([r[1] / r[3] for r in results[-2:]])
            n15 = 15000
            cost15 = results[-1][3] * (n15 / results[-1][0]) ** 2
            post15 = results[-1][2] * (n15 / results[-1][0]) ** 2
            print(f"{name} EXTRAPOLATED n=15000: spgemm ~"
                  f"{a * cost15:.0f}s + post ~{post15:.0f}s "
                  f"(model cost {cost15:.3g})", flush=True)


def cmd_device(args):
    from acoss_jax.ops.sparse_gram import sparse_gram_scores
    sizes = [int(s) for s in args.sizes.split(",")]
    for name in ("StrucFTM2D", "StrucShingles"):
        path = DIST_PATH.replace(".npz", f"_{name}.npz")
        if not os.path.exists(path):
            print(f"{name}: run `concentration` first ({path} missing)")
            continue
        d = np.load(path)
        cols, counts = d["cols"], d["counts"].astype(np.float64)
        nnz_row = int(np.median(d["nnz_per_song"]))
        probs = counts / counts.sum()
        # measured singleton rate -> per-row fresh columns, so the union
        # grows with n like a real corpus's
        fresh = int(round(int((d["counts"] == 1).sum())
                          / int(d["n_songs"])))
        rng = np.random.default_rng(0)
        for n in sizes:
            t0 = time.time()
            rows = synth_rows(n, rng, cols, probs, nnz_row,
                              fresh_per_row=fresh, dim=int(d["dim"]))
            vals = [rng.random(r.size, dtype=np.float32) + 0.1
                    for r in rows]
            t_synth = time.time() - t0
            union = np.unique(np.concatenate(rows)).size
            t0 = time.time()
            S = sparse_gram_scores(rows, vals, int(d["dim"]))
            dt = time.time() - t0
            print(f"{name} n={n}: device gram {dt:.1f}s "
                  f"(synth {t_synth:.1f}s, union {union}) "
                  f"S[0,0]={S[0, 0]:.4f} mean={S.mean():.3g}", flush=True)
            del S, rows, vals


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("phase", choices=["concentration", "spgemm", "device"])
    ap.add_argument("--songs", type=int, default=16)
    ap.add_argument("--sizes", default="1000,2000,4000")
    args = ap.parse_args()
    if args.phase == "concentration":
        cmd_concentration(args)
    elif args.phase == "spgemm":
        cmd_spgemm(args)
    else:
        cmd_device(args)


if __name__ == "__main__":
    main()
