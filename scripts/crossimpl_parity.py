"""Cross-implementation parity harness (VERDICT round-2 item #1).

Runs the reference's OWN scoring path — imported `CRPUtils` /
`SimilarityFusion` + the compiled `SequenceAlignment.c` aligners — and
`acoss_jax`'s device scoring path on IDENTICAL descriptors, and diffs
per-pair scores and per-channel MAP. See
`acoss_jax.benchmarking.crossimpl` for the machinery.

Usage:
    python scripts/crossimpl_parity.py [--cpu] [--n-cliques N]
        [--algos Serra09,TGAlg,ChenFusion,EarlySNF]
        [--out artifacts/crossimpl_parity.csv]
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run the acoss_jax side on the CPU backend")
    ap.add_argument("--n-cliques", type=int, default=12)
    ap.add_argument("--clique-size", type=int, default=2)
    ap.add_argument("--n-distractors", type=int, default=6)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--algos",
                    default="Serra09,TGAlg,ChenFusion,EarlySNF,"
                            "StrucFTM2D,StrucShingles,"
                            "FTM2D,Simple,EarlyFusion")
    ap.add_argument("--out", default="artifacts/crossimpl_parity.csv")
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        jax.config.update("jax_platforms", "cpu")

    from acoss_jax.benchmarking import crossimpl
    from acoss_jax.benchmarking.algorithms import (ChenFusion,
                                                   EarlyFusion, EarlySNF,
                                                   Serra09, Simple, TGAlg)
    from acoss_jax.benchmarking.harness import run_pairwise
    from acoss_jax.data import make_synthetic_dataset

    if not crossimpl.reference_available():
        print("reference mount not available; nothing to compare",
              file=sys.stderr)
        return 1

    fs = make_synthetic_dataset(
        n_cliques=args.n_cliques, clique_size=args.clique_size,
        n_distractors=args.n_distractors, seed=args.seed)
    n = fs.n_songs
    print(f"corpus: {n} songs "
          f"({args.n_cliques}x{args.clique_size} + "
          f"{args.n_distractors} distractors)")

    # synthetic songs are 160-480 frames, so x4 downsampling gives the
    # 40-120-sample descriptor range the reference sees on covers80
    configs = {
        "Serra09": lambda: Serra09(chroma_type="hpcp", downsample_fac=4,
                                   do_ssms=True),
        "TGAlg": lambda: TGAlg(downsample_fac=4, win_length=96),
        "ChenFusion": lambda: ChenFusion(chroma_type="hpcp",
                                         downsample_fac=4),
        "EarlySNF": lambda: EarlySNF(chroma_type="hpcp",
                                     downsample_fac=4),
        # WIN/SKIP scaled to the synthetic 160-480-frame songs (the
        # covers80 defaults 200/100 would leave < SSLEN pooled frames);
        # the pooling is descriptor-side and SHARED, the compared
        # scoring (`Simple.oti` + `simple_sim`) depends only on SSLEN
        "Simple": lambda: Simple(chroma_type="hpcp", WIN=20, SKIP=10),
        "EarlyFusion": lambda: EarlyFusion(chroma_type="hpcp"),
    }

    all_rows = []
    for name in args.algos.split(","):
        if name in ("StrucFTM2D", "StrucShingles"):
            # Struc* shingle channel: the whole scoring stage downstream
            # of the fused W is reference "glue" (no importable library
            # call — `StrucFTM2D.py:132-142` + `all_pairwise:173-189`),
            # so both stacks run from SHARED fused-W matrices; the
            # upstream W construction needs librosa on the reference
            # side (absent here) and is covered by the EarlySNF SNF
            # comparisons above.
            from acoss_jax.benchmarking.algorithms.struct_common import \
                structural_fused_w_all

            pad_len = 128
            t0 = time.time()
            Ws = [w for (w, _on, _n) in structural_fused_w_all(
                fs, "hpcp", 5, 5, 5, True, 4,
                fuse_features=("mfcc", "hpcp"), tempogram_win=96)]
            t_desc = time.time() - t0
            do_fft = name == "StrucFTM2D"
            t0 = time.time()
            S_ours = crossimpl.acoss_struc_shingle_scores(Ws, pad_len,
                                                         do_fft)
            t_ours = time.time() - t0
            t0 = time.time()
            S_ref = crossimpl.ref_struc_shingle_scores(Ws, pad_len,
                                                       do_fft)
            t_ref = time.time() - t0
            print(f"[{name}] fused-W {t_desc:.1f}s, acoss "
                  f"{t_ours:.1f}s, reference {t_ref:.1f}s")
            for r in crossimpl.compare_channels(
                    {"main": S_ref}, {"main": S_ours}, fs.labels):
                r["algorithm"] = name
                all_rows.append(r)
                print(f"  {r['channel']:<22} "
                      f"max|d|={r['max_abs_dscore']:.3e} "
                      f"mean|d|={r['mean_abs_dscore']:.3e} "
                      f"<=1e-3: {100 * r['frac_within_1e3']:.1f}%  "
                      f"MAP ref={r['map_ref']:.4f} "
                      f"ours={r['map_jax']:.4f} dMAP={r['dmap']:+.4f}")
            continue
        if name == "FTM2D":
            # FTM2D (+ the 5 ablation variants): shared input is the
            # per-song beat-synced median chroma; the compared math is
            # the imported chrompwr/btchroma_to_fftmat + per-variant
            # shingle glue + exp(-dSqr) (`FTM2D.py:9-48,90-98,126-129`).
            # WIN=25: the synthetic songs have 40-120 beats (< the
            # covers80 default WIN=75); WIN is a plain parameter of
            # both stacks.
            from acoss_jax.benchmarking.algorithms import FTM2D
            from acoss_jax.ops.segment import sync_agg

            clen = fs.length("hpcp")
            olen = fs.length("onsets")
            bts = []
            for i in range(n):
                on = fs.feature("onsets")[i, :olen[i], 0]
                bts.append(sync_agg(fs.feature("hpcp")[i, :clen[i]],
                                    on, "median").T)
            variants = {
                "main": {},
                "noLog": {"do_log": False},
                "noNorm": {"do_norm": False},
                "noNormNoLog": {"do_log": False, "do_norm": False},
                "zeroPad": {"mode": "zeropad", "do_log": False,
                            "PAD_LEN": 256},
                "zeroPadLog": {"mode": "zeropad", "do_log": True,
                               "PAD_LEN": 256},
            }
            for vname, vkw in variants.items():
                algo = FTM2D(chroma_type="hpcp", WIN=25, **vkw)
                t0 = time.time()
                ours = np.stack([algo.shingle_from_bt(bt) for bt in bts])
                S_ours = np.asarray(algo.full_scores(
                    {"shingle": ours})["main"])
                t_ours = time.time() - t0
                t0 = time.time()
                refs = np.stack([crossimpl.ref_ftm2d_shingle(
                    bt, PWR=algo.PWR, WIN=25, C=algo.C,
                    do_log=algo.do_log, do_norm=algo.do_norm,
                    mode=algo.mode, PAD_LEN=algo.PAD_LEN)
                    for bt in bts])
                S_ref = crossimpl.ref_ftm2d_scores(refs)
                t_ref = time.time() - t0
                print(f"[FTM2D:{vname}] acoss {t_ours:.1f}s, "
                      f"reference {t_ref:.1f}s")
                for r in crossimpl.compare_channels(
                        {"main": S_ref}, {"main": S_ours}, fs.labels):
                    r["algorithm"] = f"FTM2D_{vname}" \
                        if vname != "main" else "FTM2D"
                    all_rows.append(r)
                    print(f"  {r['channel']:<22} "
                          f"max|d|={r['max_abs_dscore']:.3e} "
                          f"mean|d|={r['mean_abs_dscore']:.3e} "
                          f"<=1e-3: {100 * r['frac_within_1e3']:.1f}%  "
                          f"MAP ref={r['map_ref']:.4f} "
                          f"ours={r['map_jax']:.4f} dMAP={r['dmap']:+.4f}")
            continue
        algo = configs[name]()
        t0 = time.time()
        desc = algo.extract_descriptors(fs)
        t_desc = time.time() - t0

        t0 = time.time()
        Ds_ours = run_pairwise(algo, desc, n)
        Ds_ours = {k: np.asarray(v) for k, v in Ds_ours.items()}
        t_ours = time.time() - t0

        t0 = time.time()
        kw = {}
        if name != "Simple":
            kw["kappa"] = algo.kappa
        if name in ("Serra09", "EarlySNF"):
            kw["m"] = algo.m
        if name == "Serra09":
            kw["do_ssms"] = algo.do_ssms
        if name == "Simple":
            kw["sslen"] = algo.SSLEN
        if name == "EarlyFusion":
            kw["K"] = algo.K
        Ds_ref = crossimpl.reference_scores(name, desc, n, verbose=True,
                                            **kw)
        t_ref = time.time() - t0
        print(f"[{name}] extract {t_desc:.1f}s, acoss sweep {t_ours:.1f}s, "
              f"reference sweep {t_ref:.1f}s")

        rows = crossimpl.compare_channels(Ds_ref, Ds_ours, fs.labels,
                                          algo.DISTANCE_TYPES)
        if name in ("Serra09", "EarlySNF", "TGAlg", "ChenFusion",
                    "EarlyFusion"):
            # diagnostic pass: the same reference glue under the
            # TIE-INCLUSIVE kNN policy — isolates argpartition's
            # arbitrary tie choices (on the duplicate ssms rows the
            # reference's repeat-padding creates) from real divergence
            Ds_ti = crossimpl.reference_scores(name, desc, n,
                                               tie_inclusive=True, **kw)
            for r in crossimpl.compare_channels(Ds_ti, Ds_ours, fs.labels,
                                                algo.DISTANCE_TYPES):
                r["channel"] += "[tie-incl]"
                rows.append(r)
        if name == "ChenFusion":
            # post passes compared too: normalize_by_length + late SNF
            post_ref = crossimpl.ref_chenfusion_post(Ds_ref, desc)
            post_ours = algo.post_process(dict(Ds_ours), desc)
            post_ours = {k: np.asarray(v) for k, v in post_ours.items()}
            for r in crossimpl.compare_channels(post_ref, post_ours,
                                                fs.labels):
                r["channel"] = "post_" + r["channel"]
                rows.append(r)
        if name == "EarlyFusion":
            # do_late_fusion post pass (`EarlySNF_Old.py:235-241`)
            post_ref = crossimpl.ref_earlyfusion_post(
                Ds_ref, late_K=algo.late_K, late_niters=algo.late_niters)
            post_ours = algo.post_process(dict(Ds_ours), desc)
            post_ours = {k: np.asarray(v) for k, v in post_ours.items()}
            for r in crossimpl.compare_channels(
                    {k: post_ref[k] for k in ("late", "early+late")},
                    {k: post_ours[k] for k in ("late", "early+late")},
                    fs.labels):
                r["channel"] = "post_" + r["channel"]
                rows.append(r)
        for r in rows:
            r["algorithm"] = name
            all_rows.append(r)
            print(f"  {r['channel']:<22} max|d|={r['max_abs_dscore']:.3e} "
                  f"mean|d|={r['mean_abs_dscore']:.3e} "
                  f"<=1e-3: {100 * r['frac_within_1e3']:.1f}%  "
                  f"MAP ref={r['map_ref']:.4f} ours={r['map_jax']:.4f} "
                  f"dMAP={r['dmap']:+.4f}")

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    cols = ["algorithm", "channel", "n_pairs", "max_abs_dscore",
            "mean_abs_dscore", "frac_within_1e3", "map_ref", "map_jax",
            "dmap"]
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        for r in all_rows:
            w.writerow({c: r[c] for c in cols})
    print(f"\nwrote {args.out} ({len(all_rows)} channels)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
