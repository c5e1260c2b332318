"""Command-line entry points.

Mirrors the reference's CLI surface with its flag names:
- `python -m acoss_jax.cli benchmark -a Serra09 -d <features> -s covers80
   -c hpcp [-t tile] [--n_buckets N] [--mesh RxC]
   [--num-processes N --process-id I] [--merge]` — the per-algorithm
  `__main__` analog (e.g. `Serra09.py:198-244`): `--mesh` shards the pair
  grid over a device mesh, `--num-processes/--process-id` runs one
  process shard writing a partial file (the reference's `-r` array-job
  mode), `--merge` aggregates partials (the reference's `-b`),
  `--hybrid-panel P` (with `--stream-dir`) runs the device-panel /
  disk-column sweep for descriptors that exceed HBM, sharding whole
  panels across processes. `-d` accepts either a FeatureSet .npz or a
  directory of reference-format per-track h5 files.
- `python -m acoss_jax.cli extract -i <audio dir or collection txt> -o
   <features.npz> [-m cpu] [-n N]` — the `extractors.py:117-154` analog.
- `python -m acoss_jax.cli coverstats -d <features> -o <outdir>
   [--studies key,tempo,onset,stdev,shapedna,tag]` — runs the "what is a
  cover?" studies end-to-end and writes CSV/.npz/SVG artifacts plus
  summary.json (the reference's runnable `coverstats/` scripts:
  `coverstats.py:245-251`, `OnsetTiming.py:303-306`).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys


def _load_featureset(datapath: str):
    from acoss_jax.data.h5io import feature_set_from_h5_dir
    from acoss_jax.data.store import FeatureSet

    if os.path.isdir(datapath):
        return feature_set_from_h5_dir(datapath)
    return FeatureSet.load(datapath)


def _stream_quant(args) -> str | None:
    """--stream-int8 / --stream-half -> the extract_streamed quant mode."""
    if getattr(args, "stream_int8", False):
        return "int8"
    return "half" if args.stream_half else None


def _check_store_quant(desc: dict, args, path: str) -> None:
    from acoss_jax.data.descstore import check_stream_consistency

    check_stream_consistency(desc, _stream_quant(args), path)


def _eval_and_report(algo, Ds, desc, fs, csv):
    from acoss_jax.benchmarking.evaluation import (eval_statistics,
                                                   write_results_csv)

    Ds = algo.post_process(Ds, desc)
    for k, D in Ds.items():
        S = -D if k in algo.DISTANCE_TYPES else D
        s = eval_statistics(S, fs.labels)
        print(f"{algo.NAME}_{k}: MR={s.mr:.4g} MRR={s.mrr:.4g} "
              f"MDR={s.mdr:.4g} MAP={s.map:.4g} "
              f"Top-1={s.tops.get(1)} Top-10={s.tops.get(10)}")
        if csv:
            write_results_csv(csv, algo.NAME, k, s)
    if csv:
        print(f"results appended to {csv}")


def cmd_benchmark(args) -> int:
    from acoss_jax.utils import profiling

    profiling.stages.enabled = bool(args.stage_times)
    profiling.stages.reset()
    with profiling.device_trace(args.profile):
        rc = _cmd_benchmark_inner(args)
    if args.stage_times:
        print(profiling.stages.report())
    if args.profile:
        print(f"device trace written to {args.profile}")
    return rc


def _cmd_benchmark_inner(args) -> int:
    import numpy as np

    from acoss_jax.benchmarking.algorithms import ALL_ALGORITHMS
    from acoss_jax.benchmarking.harness import benchmark

    cls = ALL_ALGORITHMS[args.algorithm]
    kwargs = {}
    if args.chroma_type and "chroma_type" in cls.__init__.__code__.co_varnames:
        kwargs["chroma_type"] = args.chroma_type
    if getattr(args, "snf_precision", "highest") != "highest":
        if "snf_precision" not in cls.__init__.__code__.co_varnames:
            print(f"--snf-precision is not supported by "
                  f"{args.algorithm}", file=sys.stderr)
            return 1
        kwargs["snf_precision"] = args.snf_precision
    algo = cls(**kwargs)
    fs = _load_featureset(args.datapath)
    os.makedirs(args.cachedir, exist_ok=True)
    csv = f"results_{args.shortname}.csv"

    if args.merge:
        # Aggregation run: scatter-add the partial-score files written by
        # the per-process shards (the reference's `-b` / `load_batches`).
        import glob as _glob

        from acoss_jax.parallel.distributed import merge_partials

        paths = sorted(
            p for p in _glob.glob(os.path.join(
                args.partial_dir, f"{algo.NAME}_part_*"))
            if p.endswith(".npz") or os.path.isdir(p))
        if not paths:
            print(f"no partial files under {args.partial_dir}",
                  file=sys.stderr)
            return 1
        # Shard-set validation: the stems encode pid/nproc
        # (NAME_part_<pid>_<nproc>). A missing shard would silently
        # zero its block-rows in the merged matrices; a stale partial
        # from a different-nproc run would double-add tiles.
        import re as _re

        tags = []
        for p in paths:
            m = _re.search(r"_part_(\d+)_(\d+)(?:\.npz)?$", p)
            if not m:
                print(f"unrecognized partial name {p}", file=sys.stderr)
                return 1
            tags.append((int(m.group(1)), int(m.group(2))))
        nprocs = {t[1] for t in tags}
        if len(nprocs) != 1:
            print(f"partials from different shardings {sorted(nprocs)} "
                  f"in {args.partial_dir}; clean out stale runs",
                  file=sys.stderr)
            return 1
        nproc = nprocs.pop()
        missing = set(range(nproc)) - {t[0] for t in tags}
        if missing:
            print(f"missing shard(s) {sorted(missing)} of {nproc}; "
                  f"rerun them before merging", file=sys.stderr)
            return 1
        print(f"merging {len(paths)} partials")
        out_dir = (os.path.join(args.stream_dir, "merged")
                   if args.stream_dir else None)
        Ds = merge_partials(paths, symmetric=algo.SYMMETRIC,
                            out_dir=out_dir)
        # post_process only ever needs the descriptors (ChenFusion's
        # per-song lengths) — reuse a streamed store when one exists
        # instead of re-running the most expensive host stage in the
        # aggregation job
        from acoss_jax.data.descstore import DescriptorStore

        desc_path = (os.path.join(args.stream_dir, "desc")
                     if args.stream_dir else None)
        if desc_path and os.path.exists(
                os.path.join(desc_path, DescriptorStore.META)):
            print(f"reusing descriptor store {desc_path}")
            desc = DescriptorStore.open(desc_path)
        else:
            desc = algo.extract_descriptors(fs)
        _eval_and_report(algo, Ds, desc, fs, csv)
        return 0

    if args.num_processes > 1:
        # One shard of a multi-process sweep (the reference's `-r`): write
        # a partial file; a later --merge run aggregates and evaluates.
        from acoss_jax.parallel.distributed import run_process_shard

        if not 0 <= args.process_id < args.num_processes:
            # schedulers often hand out 1-BASED task ids; failing fast
            # here beats an IndexError deep in the shard assignment (and
            # a merge that would silently zero shard 0's block-rows)
            print(f"--process-id must be in [0, {args.num_processes}) — "
                  f"got {args.process_id}; task ids are 0-based here",
                  file=sys.stderr)
            return 1

        # with --stream-dir, descriptors come from the disk store and the
        # partial is a directory of .npy memmaps (nothing dense in RAM)
        if args.stream_dir:
            from acoss_jax.data.descstore import (DescriptorStore,
                                                  extract_streamed)

            desc_path = os.path.join(args.stream_dir, "desc")
            meta = os.path.join(desc_path, DescriptorStore.META)
            if os.path.exists(meta):
                desc = DescriptorStore.open(desc_path)
                _check_store_quant(desc, args, desc_path)
            elif args.process_id == 0:
                # exactly ONE process may build the shared store
                # (concurrent extract_streamed calls would race on the
                # .chunks staging files and half-written memmaps); the
                # META file is written only after the final copy pass,
                # so its appearance is the completion barrier the other
                # shards wait on
                desc = extract_streamed(algo, fs, desc_path,
                                        chunk_songs=args.stream_chunk,
                                        verbose=True,
                                        quant=_stream_quant(args))
            else:
                import time as _time

                # generous deadline: a Da-TACOS-scale extraction takes
                # hours, but if process 0 died the other N-1 shards must
                # eventually FAIL, not hang an array job forever
                deadline = _time.time() + 24 * 3600.0
                print(f"waiting for process 0 to build {desc_path} ...")
                while not os.path.exists(meta):
                    if _time.time() > deadline:
                        print(f"gave up waiting for {meta} after 24 h — "
                              f"did process 0 die?", file=sys.stderr)
                        return 1
                    _time.sleep(5.0)
                desc = DescriptorStore.open(desc_path)
                _check_store_quant(desc, args, desc_path)
        else:
            desc = algo.extract_descriptors(fs)
        if args.hybrid_panel:
            from acoss_jax.parallel.distributed import \
                run_process_shard_hybrid

            path = run_process_shard_hybrid(
                algo, desc, fs.n_songs, args.process_id,
                args.num_processes, args.partial_dir,
                panel_songs=args.hybrid_panel, tile=args.tile,
                verbose=True,
                prefetch_panels=not args.no_panel_prefetch)
        else:
            path = run_process_shard(
                algo, desc, fs.n_songs, args.process_id,
                args.num_processes, args.partial_dir,
                tile=args.tile, verbose=True,
                memmap_scores=bool(args.stream_dir))
        print(f"partial scores written to {path}")
        return 0

    if args.mesh:
        # Mesh-sharded sweep: every device owns blocks of the pair grid.
        from acoss_jax.parallel import (make_pair_mesh,
                                        sharded_pair_scores,
                                        sharded_pair_scores_triangular)

        r, c = (int(x) for x in args.mesh.lower().split("x"))
        mesh = make_pair_mesh(shape=(r, c))
        desc = algo.extract_descriptors(fs)
        if algo.SYMMETRIC:
            # triangular fold decomposition: half the FLOPs of the
            # rectangular sweep (`CoverAlgorithm.py:228-244` analog)
            Ds = sharded_pair_scores_triangular(
                algo.tile_scores, desc, fs.n_songs,
                devices=mesh.devices.flatten(),
                col_tile=args.tile or algo.TILE)
        else:
            Ds = sharded_pair_scores(algo.tile_scores, desc, fs.n_songs,
                                     mesh, col_tile=args.tile or algo.TILE)
            for D in Ds.values():
                np.fill_diagonal(D, 0.0)
        _eval_and_report(algo, Ds, desc, fs, csv)
        return 0

    ckpt = os.path.join(
        args.cachedir, f"{algo.NAME}_{args.shortname}_ckpt.npz") \
        if not args.no_checkpoint else None

    if args.stream_dir:
        # Da-TACOS-scale: disk-backed descriptors + memmapped scores.
        from acoss_jax.benchmarking.harness import run_pairwise
        from acoss_jax.data.descstore import (DescriptorStore,
                                              extract_streamed)

        if algo.full_scores is not None:
            print(f"algorithm {args.algorithm} computes scores in one "
                  f"shot (full_scores) and does not support --stream-dir",
                  file=sys.stderr)
            return 1

        if args.n_buckets > 1:
            # buckets + streaming + memmapped scores + resume in ONE
            # invocation: per-bucket disk stores, matrices stay in
            # length-sorted order and labels are permuted for eval
            # (retrieval stats are permutation-invariant)
            from acoss_jax.benchmarking.harness import \
                run_pairwise_bucketed

            Ds, desc, perm = run_pairwise_bucketed(
                algo, fs, n_buckets=args.n_buckets, tile=args.tile,
                verbose=True, checkpoint_path=ckpt,
                stream_dir=args.stream_dir,
                stream_chunk=args.stream_chunk,
                stream_quant=_stream_quant(args),
                return_desc=True, return_perm=True)
            _eval_and_report(algo, Ds, desc, fs.subset(perm), csv)
            return 0

        desc_path = os.path.join(args.stream_dir, "desc")
        if os.path.exists(os.path.join(desc_path, DescriptorStore.META)):
            print(f"reusing descriptor store {desc_path}")
            desc = DescriptorStore.open(desc_path)
            _check_store_quant(desc, args, desc_path)
        else:
            desc = extract_streamed(algo, fs, desc_path,
                                    chunk_songs=args.stream_chunk,
                                    verbose=True,
                                    quant=_stream_quant(args))
        if args.hybrid_panel:
            from acoss_jax.benchmarking.harness import run_pairwise_hybrid

            Ds = run_pairwise_hybrid(
                algo, desc, fs.n_songs,
                panel_songs=args.hybrid_panel, tile=args.tile,
                checkpoint_path=ckpt, verbose=True,
                scores_dir=os.path.join(args.stream_dir, "scores"),
                prefetch_panels=not args.no_panel_prefetch)
        else:
            Ds = run_pairwise(
                algo, desc, fs.n_songs, tile=args.tile,
                checkpoint_path=ckpt, verbose=True,
                scores_dir=os.path.join(args.stream_dir, "scores"))
        _eval_and_report(algo, Ds, desc, fs, csv)
        return 0

    stats = benchmark(algo, fs, tile=args.tile, results_csv=csv,
                      checkpoint_path=ckpt, verbose=True,
                      n_buckets=args.n_buckets)
    for k, s in stats.items():
        print(f"{algo.NAME}_{k}: MR={s.mr:.4g} MRR={s.mrr:.4g} "
              f"MDR={s.mdr:.4g} MAP={s.map:.4g} "
              f"Top-1={s.tops.get(1)} Top-10={s.tops.get(10)}")
    print(f"results appended to {csv}")
    return 0


def _shard_stem(output: str) -> str:
    """The shared naming stem for shard part files — single source for
    both the writer (`_shard_part_path`) and the `--merge-shards` glob."""
    return output[:-4] if output.endswith(".npz") else output


def _shard_part_path(output: str, shard_id: int, num_shards: int) -> str:
    return f"{_shard_stem(output)}.part_{shard_id}_{num_shards}.npz"


def cmd_extract(args) -> int:
    import numpy as np

    from acoss_jax.data.manifest import (label_of, read_txt_list,
                                         track_id_of)
    from acoss_jax.data.store import FeatureSet, concat_feature_sets
    from acoss_jax.features.pipeline import batch_extract

    if args.merge_shards:
        # Aggregate shard FeatureSets written by `-m cluster` array jobs
        # (the store-merge analog of the reference's shared h5 dir).
        import re as _re

        stem = _shard_stem(args.output)
        paths = sorted(glob.glob(glob.escape(stem) + ".part_*_*.npz"))
        tags = []
        for p in paths:
            m = _re.search(r"\.part_(\d+)_(\d+)\.npz$", p)
            if m:
                tags.append((int(m.group(1)), int(m.group(2)), p))
        if not tags:
            print(f"no shard files matching {stem}.part_*_*.npz",
                  file=sys.stderr)
            return 1
        nshards = {t[1] for t in tags}
        if len(nshards) != 1:
            print(f"shards from different shardings {sorted(nshards)}; "
                  f"clean out stale runs", file=sys.stderr)
            return 1
        n = nshards.pop()
        missing = set(range(n)) - {t[0] for t in tags}
        if missing:
            print(f"missing shard(s) {sorted(missing)} of {n}; rerun "
                  f"them before merging", file=sys.stderr)
            return 1
        tags.sort()
        fs = concat_feature_sets([FeatureSet.load(p) for _, _, p in tags])
        fs.save(args.output)
        print(f"merged {n} shards ({fs.n_songs} songs) -> {args.output}")
        return 0

    if not args.input:
        print("-i/--input is required unless --merge-shards",
              file=sys.stderr)
        return 1
    if os.path.isdir(args.input):
        paths = sorted(
            glob.glob(os.path.join(args.input, "**", "*.wav"),
                      recursive=True)
            + glob.glob(os.path.join(args.input, "**", "*.mp3"),
                        recursive=True))
    else:
        paths = read_txt_list(args.input)
    if not paths:
        print("no audio files found", file=sys.stderr)
        return 1

    output = args.output
    if args.mode == "cluster":
        # One array-job shard (the reference's `-m cluster`,
        # `extractors.py:145-146`): extract a contiguous block of the
        # collection and write a shard FeatureSet; a later
        # --merge-shards run concatenates them bit-identically to a
        # serial extraction.
        if not 0 <= args.shard_id < args.num_shards:
            print(f"--shard-id must be in [0, {args.num_shards}) — got "
                  f"{args.shard_id}", file=sys.stderr)
            return 1
        blocks = np.array_split(np.arange(len(paths)), args.num_shards)
        idx = blocks[args.shard_id]
        paths = [paths[i] for i in idx]
        output = _shard_part_path(args.output, args.shard_id,
                                  args.num_shards)
        if not paths:
            print(f"shard {args.shard_id} is empty ({args.num_shards} "
                  f"shards over fewer files)", file=sys.stderr)
            return 1

    labels = [label_of(p) for p in paths]
    ids = [track_id_of(p) for p in paths]
    fs = batch_extract(paths, labels, ids, error_log=args.error_log,
                       n_workers=args.n_threads)
    fs.save(output)
    print(f"extracted {fs.n_songs}/{len(paths)} songs -> {output}")
    return 0


def cmd_coverstats(args) -> int:
    from acoss_jax.analytics.studies import ALL_STUDIES, run_coverstats

    fs = _load_featureset(args.datapath)
    studies = tuple(s.strip() for s in args.studies.split(",") if s.strip())
    unknown = set(studies) - set(ALL_STUDIES)
    if unknown:
        print(f"unknown studies {sorted(unknown)}; "
              f"choose from {list(ALL_STUDIES)}", file=sys.stderr)
        return 1
    pair_tags = None
    if args.tags:
        import json as _json

        with open(args.tags) as f:
            pair_tags = _json.load(f)
    elif "tag" in studies:
        print("the 'tag' study needs --tags <pair-tags.json> "
              "(`coverstats.py:199-241` consumes per-pair auto-tag "
              "dicts, which are not derivable from a FeatureSet)",
              file=sys.stderr)
        return 1
    summary = run_coverstats(
        fs, args.output, studies=studies, chroma_type=args.chroma_type,
        figures=not args.no_figures, pair_tags=pair_tags, verbose=True)
    import json as _json

    print(_json.dumps(summary, indent=2))
    return 0


def cmd_query(args) -> int:
    import json as _json

    from acoss_jax.benchmarking.algorithms import ALL_ALGORITHMS
    from acoss_jax.serving import CoverIndex

    cls = ALL_ALGORITHMS[args.algorithm]
    kwargs = {}
    if args.chroma_type and \
            "chroma_type" in cls.__init__.__code__.co_varnames:
        kwargs["chroma_type"] = args.chroma_type
    algo = cls(**kwargs)

    if args.index_dir and os.path.exists(
            os.path.join(args.index_dir, CoverIndex.META)):
        print(f"loading index from {args.index_dir}")
        index = CoverIndex.load(algo, args.index_dir)
    else:
        fs = _load_featureset(args.datapath)
        print(f"building index over {fs.n_songs} songs")
        index = CoverIndex.build(algo, fs, quant=args.quant,
                                 tile=args.tile)
        if args.index_dir:
            index.save(args.index_dir)
            print(f"index saved to {args.index_dir}")

    qfs = _load_featureset(args.querypath)
    ranked = index.top_k(qfs, k=args.top,
                         similarity_type=args.similarity_type)
    for qi, rows in enumerate(ranked):
        qid = str(qfs.track_ids[qi])
        print(_json.dumps({"query": qid, "top": rows}))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="acoss_jax")
    sub = parser.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("benchmark", help="run a cover-song benchmark")
    b.add_argument("-a", "--algorithm", required=True)
    b.add_argument("-d", "--datapath", required=True,
                   help="FeatureSet .npz or a directory of track h5 files")
    b.add_argument("-s", "--shortname", default="covers80")
    b.add_argument("-c", "--chroma_type", default="hpcp")
    b.add_argument("-t", "--tile", type=int, default=None)
    b.add_argument("--n_buckets", type=int, default=1,
                   help="length buckets for the sweep (>1 cuts padding "
                        "waste on corpora with a wide length spread)")
    b.add_argument("--cachedir", default="cache")
    b.add_argument("--no-checkpoint", action="store_true")
    b.add_argument("--mesh", default=None, metavar="RxC",
                   help="shard the pair grid over an RxC device mesh "
                        "(e.g. 2x4)")
    b.add_argument("--num-processes", type=int, default=1,
                   help="total processes in a multi-process sweep (the "
                        "reference's array-job sharding, Serra09.py:210). "
                        "Each process must have a card of its own: on a "
                        "host with several GPUs, start process I with "
                        "CUDA_VISIBLE_DEVICES=I (a JAX process reserves "
                        "most of every card it sees)")
    b.add_argument("--process-id", type=int, default=0,
                   help="this process's shard index (0-based)")
    b.add_argument("--partial-dir", default="partials",
                   help="directory for per-process partial score files")
    b.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="capture a jax.profiler device trace of the run "
                        "into LOGDIR (view in TensorBoard / perfetto)")
    b.add_argument("--stage-times", action="store_true",
                   help="print accumulated per-stage wall timings "
                        "(extract / sweep:tile / eval / ...)")
    b.add_argument("--stream-dir", default=None, metavar="DIR",
                   help="Da-TACOS-scale mode: chunked descriptor "
                        "extraction into a disk-backed store under "
                        "DIR/desc and memmapped N x N score matrices "
                        "under DIR/scores (host RAM stays bounded by "
                        "the tile size)")
    b.add_argument("--stream-chunk", type=int, default=256,
                   help="songs per extraction chunk with --stream-dir")
    b.add_argument("--snf-precision", default="highest",
                   choices=("highest", "default"),
                   help="matmul precision of the SNF diffusion einsums: "
                        "'highest' (parity, fp32-accurate) or 'default' "
                        "(reduced-precision throughput mode, TF32 on the "
                        "GPU — like --stream-int8, not for parity runs)")
    b.add_argument("--stream-half", action="store_true",
                   help="with --stream-dir: store heavy float32 "
                        "descriptors as float16 (half the disk store, "
                        "host->device traffic and HBM; compute upcasts "
                        "to fp32 on device — a throughput mode, not for "
                        "full-precision parity runs)")
    b.add_argument("--stream-int8", action="store_true",
                   help="with --stream-dir: store heavy float32 "
                        "descriptors as per-song-scaled int8 (quarter "
                        "the disk store, host->device traffic and HBM; "
                        "compute dequantizes to fp32 on device — a "
                        "throughput mode, not for full-precision parity "
                        "runs; absolute error ~0.4%% of each song's "
                        "max-abs)")
    b.add_argument("--hybrid-panel", type=int, default=0, metavar="P",
                   help="with --stream-dir: hybrid device-panel / "
                        "disk-column sweep pinning P songs' descriptors "
                        "in HBM per panel (the heaviest-channel mode "
                        "when descriptors exceed HBM; composes with "
                        "--num-processes, which shards whole panels)")
    b.add_argument("--no-panel-prefetch", action="store_true",
                   help="with --hybrid-panel: don't overlap the next "
                        "panel's HBM upload with the current panel's "
                        "sweep (use when one panel already fills most "
                        "of HBM)")
    b.add_argument("--merge", action="store_true",
                   help="aggregate partial files from --partial-dir and "
                        "evaluate (the reference's -b/load_batches)")
    b.set_defaults(fn=cmd_benchmark)

    e = sub.add_parser("extract", help="extract features from audio")
    e.add_argument("-i", "--input", default=None,
                   help="audio directory or collection txt (not needed "
                        "with --merge-shards)")
    e.add_argument("-o", "--output", default="features.npz")
    e.add_argument("-m", "--mode", default="cpu",
                   choices=["cpu", "cluster"],
                   help="'cluster' extracts one shard of the collection "
                        "(with --num-shards/--shard-id) for array jobs "
                        "(the reference's -m cluster, "
                        "extractors.py:145-146)")
    e.add_argument("-n", "--n_threads", type=int, default=1,
                   help="host threads for per-song decode + feature "
                        "computation (the reference's joblib -n)")
    e.add_argument("--num-shards", type=int, default=1,
                   help="total shards in cluster mode")
    e.add_argument("--shard-id", type=int, default=0,
                   help="this job's shard index (0-based)")
    e.add_argument("--merge-shards", action="store_true",
                   help="concatenate <output>.part_*_*.npz shard "
                        "FeatureSets into <output>")
    e.add_argument("--error-log", default="errors.txt")
    e.set_defaults(fn=cmd_extract)

    c = sub.add_parser(
        "coverstats",
        help="run the 'what is a cover?' studies and write artifacts "
             "(the reference's coverstats/ scripts)")
    c.add_argument("-d", "--datapath", required=True,
                   help="FeatureSet .npz or a directory of track h5 files")
    c.add_argument("-o", "--output", default="coverstats_out",
                   help="artifact directory (CSVs, .npz arrays, SVG "
                        "figures, summary.json)")
    c.add_argument("--studies", default=",".join(
        ("key", "tempo", "onset", "stdev", "shapedna")),
        help="comma-separated subset of key,tempo,onset,stdev,shapedna,"
             "tag (tag needs --tags)")
    c.add_argument("-c", "--chroma_type", default="hpcp")
    c.add_argument("--tags", default=None, metavar="JSON",
                   help="label -> [tags1, tags2] JSON for the tag study "
                        "(each tags_i a list of [tag, confidence])")
    c.add_argument("--no-figures", action="store_true",
                   help="skip SVG figure emission")
    c.set_defaults(fn=cmd_coverstats)

    q = sub.add_parser(
        "query",
        help="serve 1xN cover-song retrieval against a prebuilt corpus "
             "index (build once, query many times)")
    q.add_argument("-a", "--algorithm", required=True)
    q.add_argument("-d", "--datapath", required=True,
                   help="corpus FeatureSet .npz or h5 dir (ignored when "
                        "--index-dir already holds a built index)")
    q.add_argument("-q", "--querypath", required=True,
                   help="query FeatureSet .npz or h5 dir")
    q.add_argument("-c", "--chroma_type", default="hpcp")
    q.add_argument("-t", "--tile", type=int, default=None)
    q.add_argument("--index-dir", default=None,
                   help="persist/reuse the index here (skips corpus "
                        "extraction on later invocations)")
    q.add_argument("--quant", choices=("half", "int8"), default=None,
                   help="quantize the pinned corpus descriptors "
                        "(2x/4x HBM; on-device dequant)")
    q.add_argument("--top", type=int, default=10)
    q.add_argument("--similarity-type", default=None,
                   help="channel to rank by (default: the algorithm's "
                        "first similarity type)")
    q.set_defaults(fn=cmd_query)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
