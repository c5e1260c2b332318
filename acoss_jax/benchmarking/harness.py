"""The pair-grid benchmark harness.

JAX re-design of the reference's `CoverAlgorithm` harness
(`/root/reference/benchmarking/CoverAlgorithm.py:25-317`). The reference
loops over (i, j) pairs in joblib workers writing into np.memmap matrices;
here the N x N pair grid is cut into (tile x tile) blocks, each block's
scores are computed by ONE jitted call over a batch of pairs (vmapped
kernels on the device), and blocks stream back into a host score
matrix. The lower-triangular + transpose-add symmetry trick
(`CoverAlgorithm.py:165-182`) and the resumable block ledger
(`CoverAlgorithm.py:262-292`) are preserved.

Algorithms implement:
  - ``extract_descriptors(fs) -> dict[str, np.ndarray]``: per-song compact
    descriptors (batched arrays, leading dim N).
  - ``tile_scores(row_desc, col_desc) -> dict[type, (bi, bj) array]``: pure,
    jittable scoring of the full cross product of a row block against a
    column block of songs.
  - optionally ``full_scores(desc) -> dict[type, (N, N)]``: a one-shot
    vectorized path (the analog of StrucFTM2D's overridden all_pairwise,
    `StrucFTM2D.py:173-189`).
"""

from __future__ import annotations

import os
import time

import jax
import numpy as np

from acoss_jax.benchmarking.evaluation import (EvalStats, eval_statistics,
                                               write_results_csv)
from acoss_jax.data.descstore import upcast_half as _upcast_half
from acoss_jax.data.store import FeatureSet
from acoss_jax.utils import profiling as _prof


class CoverAlgorithm:
    """Base class for cover-song scoring algorithms."""

    NAME = "base"
    SIMILARITY_TYPES: tuple = ("main",)
    #: similarity types holding DISTANCES (lower = more similar); these are
    #: negated before ranking (the reference's ANFScattering stores
    #: distances, `ANFScattering.py:54-67`).
    DISTANCE_TYPES: tuple = ()
    SYMMETRIC = True
    TILE = 16
    #: instance attributes that only tune SCORING throughput/numerics
    #: (SNF precision / update order, ...) and do not change the
    #: extracted descriptors — a serving `CoverIndex` built under one
    #: value answers queries correctly under another, so `CoverIndex.
    #: load` warns instead of refusing when these drift.
    SCORING_ONLY_PARAMS: frozenset = frozenset(
        {"sequential", "snf_precision", "aligner"})
    #: backend of the qmax/dmax/SW aligners in `tile_scores` (see
    #: `ops.alignment.ALIGNER_BACKENDS`): "auto" runs the CUDA kernels
    #: where a tile is lowered for a GPU and the XLA scan elsewhere.
    aligner: str = "auto"

    def extract_descriptors(self, fs: FeatureSet) -> dict:
        raise NotImplementedError

    def tile_scores(self, row_desc: dict, col_desc: dict) -> dict:
        raise NotImplementedError

    full_scores = None  # optional override

    def post_process(self, Ds: dict, desc: dict) -> dict:
        """Optional hook applied to the full score matrices after the
        sweep (the analog of ChenFusion's normalize_by_length +
        do_late_fusion post-passes, `ChenFusion.py:71-85`)."""
        return Ds

    def bucket_lengths(self, fs: FeatureSet) -> np.ndarray:
        """Per-song length proxy used by the bucketed sweep; defaults to
        the first ragged feature's lengths."""
        if fs.lengths:
            return fs.lengths[sorted(fs.lengths)[0]]
        return np.full(fs.n_songs, 1, np.int32)


def _pad_desc(desc: dict, n_to: int) -> dict:
    out = {}
    for k, v in desc.items():
        pad = [(0, n_to - v.shape[0])] + [(0, 0)] * (v.ndim - 1)
        if isinstance(v, jax.Array):
            # already device-resident (e.g. Serra09 ssms): pad on device —
            # pulling it to the host defeats the point
            out[k] = jax.numpy.pad(v, pad)
        else:
            out[k] = np.pad(v, pad)
    return out


def _tile_slice(desc: dict, lo: int, hi: int, tile: int) -> dict:
    """Materialize rows [lo, hi) of each descriptor (copying out of a
    disk memmap if the store is disk-backed) padded up to `tile` rows —
    host memory never holds more than the active tiles."""
    out = {}
    for k, v in desc.items():
        s = np.asarray(v[lo:hi])
        if s.shape[0] < tile:
            s = np.pad(s, [(0, tile - s.shape[0])]
                       + [(0, 0)] * (s.ndim - 1))
        out[k] = s
    return out


def _symmetrize_from_lower(D, block: int = 4096) -> None:
    """Mirror the strict lower triangle of D onto the upper triangle in
    place, blockwise (works on np.memmap without materializing the
    matrix — the Da-TACOS-scale analog of the reference's `D += D.T`,
    `CoverAlgorithm.py:180-182`, which is valid because tiles only ever
    write strictly-lower entries). Pure assignment, so the pass is
    IDEMPOTENT: a crash mid-symmetrize followed by a resume re-derives
    the same upper triangle instead of double-adding."""
    n = D.shape[0]
    for i0 in range(0, n, block):
        i1 = min(i0 + block, n)
        A = np.tril(np.array(D[i0:i1, i0:i1]), -1)
        D[i0:i1, i0:i1] = A + A.T
        for j0 in range(0, i0, block):
            j1 = min(j0 + block, n)
            D[j0:j1, i0:i1] = np.array(D[i0:i1, j0:j1]).T


class _TileSweeper:
    """Shared engine behind the pair-grid sweeps: score-matrix storage
    (RAM or `scores_dir` .npy memmaps), the resumable tile ledger, the
    async-dispatch pending buffer with batched readback flushes, and the
    idempotent lower-triangle symmetrization. `run_pairwise` and
    `run_pairwise_bucketed` differ only in how they enumerate tiles and
    compute each tile's scores; everything else lives here."""

    def __init__(self, sim_types, n_songs: int, tile: int,
                 symmetric: bool, scores_dir: str | None,
                 checkpoint_path: str | None, checkpoint_every: int = 16,
                 flush_every: int = 128, ckpt_extra: dict | None = None):
        self.sim_types = tuple(sim_types)
        self.n_songs = n_songs
        self.tile = tile
        self.symmetric = symmetric
        self.scores_dir = scores_dir
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.flush_every = flush_every
        self.ckpt_extra = dict(ckpt_extra or {})
        n_tiles = -(-n_songs // tile)
        self.n_tiles = n_tiles

        if scores_dir is not None:
            os.makedirs(scores_dir, exist_ok=True)
            self.Ds = {}
            for k in self.sim_types:
                fn = os.path.join(scores_dir, f"{k}.npy")
                if os.path.exists(fn):
                    m = np.lib.format.open_memmap(fn, mode="r+")
                    if m.shape != (n_songs, n_songs) or \
                            m.dtype != np.float32:
                        # a scores_dir reused across corpora would
                        # silently mix stale and new scores (or die
                        # mid-sweep on an IndexError)
                        raise ValueError(
                            f"{fn} holds a {m.dtype} {m.shape} matrix "
                            f"but this sweep needs float32 "
                            f"({n_songs}, {n_songs}); delete the "
                            f"scores_dir or use a fresh one")
                    self.Ds[k] = m
                else:
                    self.Ds[k] = np.lib.format.open_memmap(
                        fn, mode="w+", dtype=np.float32,
                        shape=(n_songs, n_songs))
        else:
            self.Ds = {k: np.zeros((n_songs, n_songs), np.float32)
                       for k in self.sim_types}
        self.done = np.zeros((n_tiles, n_tiles), dtype=bool)

        if checkpoint_path and os.path.exists(checkpoint_path):
            with np.load(checkpoint_path) as z:
                # the extra-meta key sets must match EXACTLY in both
                # directions: a plain sweep must not adopt a bucketed
                # sweep's ledger (whose tiles index the length-SORTED
                # order) just because its own ckpt_extra is empty
                base = {"done", "tile", "n_songs"}
                extra = {k for k in z.files
                         if k not in base and not k.startswith("D::")}
                meta_ok = (int(z["tile"]) == tile
                           and int(z["n_songs"]) == n_songs
                           and extra == set(self.ckpt_extra)
                           and all(int(z[k]) == int(v)
                                   for k, v in self.ckpt_extra.items()))
                if meta_ok:
                    self.done = z["done"]
                    if scores_dir is None:
                        for k in self.Ds:
                            self.Ds[k] = z[f"D::{k}"]

        # `symmetrized.flag` certifies the memmaps' upper triangle
        # mirrors the CURRENT lower triangle. If this sweep is going to
        # (re)write any tile — fresh run over a reused scores_dir, or a
        # partial resume — that certificate is stale: drop it so
        # finalize() re-mirrors.
        if scores_dir is not None and self.symmetric:
            flag = os.path.join(scores_dir, "symmetrized.flag")
            # only the tiles a symmetric sweep actually enumerates count
            # as work: strict-upper ledger entries are never set, so
            # done.all() would be unreachable and the flag would be
            # dropped (and the matrices re-mirrored) on EVERY resume
            pending = ~self.done[np.tril_indices(n_tiles)]
            if os.path.exists(flag) and pending.any():
                os.remove(flag)

        self._row_idx = np.arange(tile)
        self._pending: list = []
        self._n_done_this_run = 0

    def save_ckpt(self) -> None:
        if not self.checkpoint_path:
            return
        payload = {"done": self.done, "tile": self.tile,
                   "n_songs": self.n_songs, **self.ckpt_extra}
        if self.scores_dir is None:
            for k, D in self.Ds.items():
                payload[f"D::{k}"] = D
        else:
            for D in self.Ds.values():
                D.flush()
        tmp = self.checkpoint_path + ".tmp.npz"
        np.savez(tmp, **payload)
        os.replace(tmp, self.checkpoint_path)

    def flush(self) -> None:
        """Read back all pending tile results in ONE stacked transfer per
        similarity type and scatter them into the matrices."""
        import jax.numpy as jnp

        if not self._pending:
            return
        with _prof.stages.stage("sweep:flush"):
            stacked = {
                k: np.asarray(jnp.stack([p[2][k] for p in self._pending]))
                for k in self.sim_types}
        for b, (ti, tj, _) in enumerate(self._pending):
            ij = np.meshgrid(self._row_idx + ti * self.tile,
                             self._row_idx + tj * self.tile,
                             indexing="ij")
            keep = (ij[0] < self.n_songs) & (ij[1] < self.n_songs)
            if self.symmetric:
                keep &= ij[0] > ij[1]
            else:
                keep &= ij[0] != ij[1]
            for k in stacked:
                self.Ds[k][ij[0][keep], ij[1][keep]] = stacked[k][b][keep]
            self.done[ti, tj] = True
            self._n_done_this_run += 1
        self._pending.clear()

    def submit(self, ti: int, tj: int, scores) -> None:
        """Queue one tile's (still device-resident) scores; flushes in
        batches so jax's async dispatch keeps the device busy."""
        self._pending.append((ti, tj, scores))
        if len(self._pending) >= self.flush_every:
            self.flush()
        if self.checkpoint_path and \
                self._n_done_this_run // self.checkpoint_every != \
                (self._n_done_this_run + len(self._pending)) \
                // self.checkpoint_every:
            self.flush()
            self.save_ckpt()

    def finalize(self, skip_symmetrize: bool = False) -> dict:
        self.flush()
        self.save_ckpt()
        if self.symmetric and not skip_symmetrize:
            # idempotent mirror (assignment from the strict lower
            # triangle): safe to re-run after a crash at any point
            flag = (os.path.join(self.scores_dir, "symmetrized.flag")
                    if self.scores_dir is not None else None)
            if flag is None or not os.path.exists(flag):
                for k in self.Ds:
                    if self.scores_dir is not None:
                        _symmetrize_from_lower(self.Ds[k])
                    else:
                        L = np.tril(self.Ds[k], -1)
                        self.Ds[k] = L + L.T
                if flag is not None:
                    with open(flag, "w") as f:
                        f.write("1")
        return self.Ds


def run_pairwise(
    algorithm: CoverAlgorithm,
    desc: dict,
    n_songs: int,
    tile: int | None = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 16,
    verbose: bool = False,
    tile_filter=None,
    skip_symmetrize: bool = False,
    scores_dir: str | None = None,
    device_resident: bool | None = None,
) -> dict:
    """Sweep the pair grid, returning {similarity_type: (N, N) np.float32}.

    Symmetric algorithms compute only tiles with block-row >= block-col and
    keep the strict lower triangle, then add the transpose — exactly the
    reference's combinations + D += D.T (`CoverAlgorithm.py:165-182`).

    With `checkpoint_path`, a ledger of completed tiles plus the partial
    score matrices is saved every `checkpoint_every` tiles and the sweep
    resumes from it (`do_batch`'s checkpoint/resume,
    `CoverAlgorithm.py:262-292`).

    `desc` values may be disk memmaps (`data.descstore.DescriptorStore`);
    tiles are sliced + padded on demand, so host memory stays bounded by
    the tile size. With `scores_dir`, the output score matrices are
    `.npy` memmaps in that directory instead of RAM arrays (the
    reference's memmap score files, `CoverAlgorithm.py:48-51`) and the
    checkpoint ledger stores only the done map.

    `device_resident` (default: on, unless the descriptors are disk
    memmaps) uploads the padded descriptor corpus to the device ONCE and
    slices tiles on device with traced offsets — one compile serves every
    tile and no descriptor bytes cross the host<->device link during the
    sweep. This is what makes heavy-descriptor channels (Serra09's
    20736-dim ssms_scatter, EarlySNF) feasible through a thin link; with
    fast links it still removes the per-tile transfer + dispatch cost.
    """
    if algorithm.full_scores is not None:
        Ds = {k: np.array(v, dtype=np.float32)
              for k, v in algorithm.full_scores(desc).items()}
        for D in Ds.values():
            np.fill_diagonal(D, 0.0)
        return Ds

    tile = tile or algorithm.TILE
    n_tiles = -(-n_songs // tile)

    sweep = _TileSweeper(algorithm.SIMILARITY_TYPES, n_songs, tile,
                         algorithm.SYMMETRIC, scores_dir,
                         checkpoint_path, checkpoint_every)
    done = sweep.done

    if device_resident is None:
        device_resident = not any(isinstance(v, np.memmap)
                                  for v in desc.values())
    desc_dev = None
    if device_resident:
        desc_dev = jax.device_put(_pad_desc(desc, n_tiles * tile))

        def _build_tile_at():
            @jax.jit
            def tile_at(dd, ti, tj):
                row = {k: jax.lax.dynamic_slice_in_dim(v, ti * tile, tile)
                       for k, v in dd.items()}
                col = {k: jax.lax.dynamic_slice_in_dim(v, tj * tile, tile)
                       for k, v in dd.items()}
                # corpus may be pinned in HBM at half precision; upcast
                # per tile so compute stays fp32
                return algorithm.tile_scores(_upcast_half(row),
                                             _upcast_half(col))
            return tile_at

        tile_at = _instance_jit(algorithm, f"tile_at:{tile}",
                                _build_tile_at)

    tile_fn = _instance_jit(
        algorithm, "tile_fn",
        lambda: jax.jit(lambda r, c: algorithm.tile_scores(
            _upcast_half(r), _upcast_half(c))))

    t0 = time.time()
    # Asynchronous dispatch pipelining (see _TileSweeper.submit/flush):
    # tile results stay ON DEVICE and are read back in batched flushes,
    # so the submit loop races ahead and the device executes tiles
    # back-to-back — without this, a per-tile blocking readback inserts
    # one host-link round trip between every two tiles (ruinous on thin
    # links: a 2,000-song sweep is ~31k tiles).
    for ti in range(n_tiles):
        # Zigzag column order maximizes feature-block reuse, mirroring the
        # reference's traversal (`CoverAlgorithm.py:294-295`).
        cols = range(ti + 1) if algorithm.SYMMETRIC else range(n_tiles)
        cols = list(cols)
        if ti % 2 == 1:
            cols = cols[::-1]
        cols = [tj for tj in cols
                if not done[ti, tj]
                and (tile_filter is None or tile_filter(ti, tj))]
        if not cols:
            continue
        # streaming mode: pin the row tile on device for the whole
        # block-row (it would otherwise re-cross the host link once per
        # column tile); skipped entirely when the ledger/filter leaves
        # nothing in this row — a resume or process shard must not
        # stream descriptors it will never score
        row = None if device_resident else jax.device_put(
            _tile_slice(desc, ti * tile, (ti + 1) * tile, tile))
        for tj in cols:
            with _prof.stages.stage("sweep:tile"), \
                    _prof.step_annotation("tile", ti=ti, tj=tj):
                if device_resident:
                    scores = tile_at(desc_dev, np.int32(ti), np.int32(tj))
                else:
                    col = _tile_slice(desc, tj * tile, (tj + 1) * tile,
                                      tile)
                    scores = tile_fn(row, col)
            sweep.submit(ti, tj, scores)
        if verbose:
            sweep.flush()
            print(f"[{algorithm.NAME}] block-row {ti + 1}/{n_tiles} "
                  f"({time.time() - t0:.1f}s)")
    return sweep.finalize(skip_symmetrize)


def _instance_jit(algorithm, key: str, build):
    """Per-algorithm-instance cache of jitted sweep programs. A fresh
    `jax.jit(...)` wrapper per sweep call would RE-TRACE every tile
    program on every invocation (~1 s per program; the bucketed sweep
    has O(n_buckets^2) of them), turning repeat runs tracing-bound."""
    cache = algorithm.__dict__.setdefault("_jit_cache", {})
    key = (key, getattr(algorithm, "aligner", "auto"))
    fn = cache.get(key)
    if fn is None:
        fn = cache[key] = build()
    return fn


def _bucket_edges(n_songs: int, n_buckets: int, tile: int) -> np.ndarray:
    """Equal song splits with every INTERIOR boundary rounded to a tile
    multiple, so each (tile x tile) tile of the global grid lies entirely
    inside one bucket-block. Returns boundaries [0, ..., n_songs]."""
    raw = np.cumsum([len(a) for a in
                     np.array_split(np.arange(n_songs), n_buckets)])[:-1]
    interior = [int(round(e / tile)) * tile for e in raw]
    edges = np.unique([0] + interior + [n_songs])
    return edges[(edges >= 0) & (edges <= n_songs)]




def _pad_tile_pair_axis1(row: dict, col: dict):
    """Pad each >=2-D descriptor of a cross-bucket tile pair up to the
    pair's max axis-1 extent (static under jit: one trace per bucket-pair
    shape combination).

    Iterates the UNION of the two key sets: per-bucket streamed stores
    decide the quantized-key set from bucket-local padded widths
    (`extract_streamed`), so a near-threshold key can carry a `@qscale`
    companion in one bucket but not the other. One-sided keys pass
    through on their own side — `_upcast_half` then dequantizes each
    side independently, so mixed-precision bucket pairs score exactly."""
    import jax.numpy as jnp

    out_r, out_c = {}, {}
    for k in sorted(set(row) | set(col)):
        r, c = row.get(k), col.get(k)
        if r is not None and c is not None \
                and r.ndim >= 2 and r.shape[1] != c.shape[1]:
            L = max(r.shape[1], c.shape[1])
            if r.shape[1] < L:
                r = jnp.pad(r, [(0, 0), (0, L - r.shape[1])]
                            + [(0, 0)] * (r.ndim - 2))
            if c.shape[1] < L:
                c = jnp.pad(c, [(0, 0), (0, L - c.shape[1])]
                            + [(0, 0)] * (c.ndim - 2))
        if r is not None:
            out_r[k] = r
        if c is not None:
            out_c[k] = c
    return out_r, out_c


def _split_desc_buckets(desc: dict, edges: np.ndarray,
                        round_to: int = 64) -> list[dict]:
    """Split ONE whole-corpus (length-sorted) descriptor extraction into
    per-bucket dicts: rows sliced per bucket, axis 1 truncated to the
    bucket's trailing-nonzero extent (rounded up to `round_to`). The
    tile kernels are invariant to the amount of trailing zero padding
    (the bucketed-vs-plain equality tests pin this), so this recovers
    the per-bucket padding win WITHOUT re-running extraction once per
    bucket — extraction's fixed costs were 4x the plain sweep's at
    covers80 scale."""
    out = []
    for b in range(len(edges) - 1):
        lo, hi = int(edges[b]), int(edges[b + 1])
        # Content truncation alone is unsound: a song's trailing VALID
        # frames can be all-zero (silence -> zero chroma/mfcc), and in
        # the plain sweep those zero frames are real kNN candidates the
        # tile kernels see. Bound the truncation from below by the
        # per-song LENGTH keys in the bucket (the 'length*' naming
        # convention every algorithm uses) — not by arbitrary integer
        # descriptors, which could inflate the bound and forfeit the
        # padding win.
        len_maxes = []
        for k, v in desc.items():
            if not k.startswith("length"):
                continue
            a = np.asarray(v[lo:hi])
            if a.ndim == 1 and np.issubdtype(a.dtype, np.integer) \
                    and a.size:
                len_maxes.append(int(a.max()))
        d = {}
        for k, v in desc.items():
            s = v[lo:hi]
            if hasattr(s, "ndim") and s.ndim >= 2 and s.shape[1] > 1:
                axes = (0,) + tuple(range(2, s.ndim))
                if isinstance(s, jax.Array):
                    # reduce on device; only the (L,) mask crosses the link
                    import jax.numpy as jnp
                    colmask = np.asarray(jnp.any(s != 0, axis=axes))
                else:
                    colmask = np.asarray(s != 0).any(axis=axes)
                nz = np.flatnonzero(colmask)
                width = int(nz[-1]) + 1 if nz.size else 1
                width = max([width] + [m for m in len_maxes
                                       if m <= s.shape[1]])
                width = min(-(-width // round_to) * round_to, s.shape[1])
                s = s[:, :width]
            d[k] = s
        out.append(d)
    return out


def _merge_bucket_descs(descs: list[dict], inv: np.ndarray,
                        keys=None) -> dict:
    """Concatenate per-bucket descriptor dicts back into `inv` song order
    (axis-1 padded up to the widest bucket) so `post_process` can consume
    them without a second whole-corpus extraction. `keys` restricts the
    merge (e.g. to the small 1-D/2-D keys when buckets are disk
    stores)."""
    out = {}
    for k in (keys if keys is not None else descs[0]):
        arrs = [np.asarray(d[k]) for d in descs]
        width = max(a.shape[1] for a in arrs if a.ndim >= 2) \
            if arrs[0].ndim >= 2 else None
        if width is not None:
            arrs = [np.pad(a, [(0, 0), (0, width - a.shape[1])]
                           + [(0, 0)] * (a.ndim - 2)) for a in arrs]
        out[k] = np.concatenate(arrs, axis=0)[inv]
    return out


def run_pairwise_bucketed(
    algorithm: CoverAlgorithm,
    fs: FeatureSet,
    n_buckets: int = 4,
    tile: int | None = None,
    verbose: bool = False,
    checkpoint_path: str | None = None,
    return_desc: bool = False,
    scores_dir: str | None = None,
    stream_dir: str | None = None,
    stream_chunk: int = 256,
    stream_half: bool = False,
    stream_quant: str | None = None,
    stream_min_bytes: int = 65536,
    device_resident: bool | None = None,
    checkpoint_every: int = 16,
    return_perm: bool = False,
):
    """Length-bucketed pair sweep on the SAME machinery as `run_pairwise`:
    device-resident per-bucket descriptor corpora sliced with traced
    offsets, async-dispatch pipelining with batched readback flushes, a
    tile-granular resumable ledger, and (optionally) `.npy`-memmapped
    score matrices.

    Songs are length-sorted and split into buckets whose boundaries are
    rounded to tile multiples, so every tile of the global grid lies in
    exactly ONE bucket-block: descriptors are extracted per bucket at the
    bucket's own padded length (the reference's ~10x song-length spread
    otherwise pads every pair to the global max — SURVEY.md section 5),
    and cross-bucket tiles pad the shorter side up to the pair's max
    INSIDE the jitted tile program (one compile per bucket-pair shape,
    O(n_buckets^2) programs total).

    `stream_dir`: Da-TACOS-scale mode — each bucket's descriptors live in
    a disk-backed `DescriptorStore` under `stream_dir/desc/bucket_NNNN`
    (reused on resume: a fifth checkpoint tier), tiles are sliced from
    the memmaps with the row tile pinned on device per block-row, and
    scores go to `stream_dir/scores` memmaps unless `scores_dir`
    overrides.

    Ordering: with in-RAM scores (scores_dir is None and no stream_dir)
    the returned matrices are unpermuted back to the caller's song order.
    With memmapped scores they STAY in length-sorted order (unpermuting
    would materialize RAM copies); pass `return_perm=True` to get the
    sort permutation and evaluate with `labels[perm]` — retrieval stats
    are permutation-invariant. `return_desc` appends the merged
    descriptors (caller order for RAM scores, sorted order otherwise) —
    SMALL keys only (<= 64 KB/song): the merge exists to feed
    post_process hooks, which read lengths/global vectors; bulk
    descriptors are deliberately not pulled host-side (a device-resident
    ssms corpus would cost minutes of D2H for unread data). A
    post_process needing a bulk key must use the unbucketed path.

    Returns Ds [, merged_desc][, perm].
    """
    tile = tile or algorithm.TILE
    n = fs.n_songs
    lengths = np.asarray(algorithm.bucket_lengths(fs))
    perm = np.argsort(lengths, kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    fss = fs.subset(perm)
    edges = _bucket_edges(n, n_buckets, tile)
    nb = len(edges) - 1
    if scores_dir is None and stream_dir is not None:
        scores_dir = os.path.join(stream_dir, "scores")

    descs: list[dict] = []
    quant = stream_quant or ("half" if stream_half else None)
    if stream_dir is not None:
        from acoss_jax.data.descstore import (DescriptorStore,
                                              extract_streamed)

        for b in range(nb):
            lo, hi = int(edges[b]), int(edges[b + 1])
            path = os.path.join(stream_dir, "desc", f"bucket_{b:04d}")
            if os.path.exists(os.path.join(path, DescriptorStore.META)):
                if verbose:
                    print(f"[{algorithm.NAME}] reusing bucket store "
                          f"{path}")
                d = DescriptorStore.open(path)
                # same precision contract as the CLI's plain-store reuse
                from acoss_jax.data.descstore import \
                    check_stream_consistency
                check_stream_consistency(d, quant, path)
                descs.append(d)
            else:
                with _prof.stages.stage("extract:bucket"):
                    descs.append(extract_streamed(
                        algorithm, fss.subset(np.arange(lo, hi)), path,
                        chunk_songs=stream_chunk, verbose=verbose,
                        quant=quant, half_min_bytes=stream_min_bytes))
    else:
        # ONE whole-corpus extraction on the sorted fs, then split into
        # buckets by row slice + trailing-zero axis-1 truncation —
        # identical arrays to per-bucket extraction (extraction is
        # per-song) without paying extraction's fixed costs per bucket
        with _prof.stages.stage("extract"):
            desc_all = algorithm.extract_descriptors(fss)
        descs = _split_desc_buckets(desc_all, edges)

    if device_resident is None:
        device_resident = stream_dir is None and not any(
            isinstance(v, np.memmap) for d in descs for v in d.values())

    n_tiles = -(-n // tile)
    tile0 = edges[:-1] // tile
    bucket_of = np.searchsorted(edges, np.arange(n_tiles) * tile,
                                side="right") - 1

    dev = None
    if device_resident:
        dev = [jax.device_put(_pad_desc(
            dict(d), -(-(int(edges[b + 1] - edges[b])) // tile) * tile))
            for b, d in enumerate(descs)]

        def _build_tile_at():
            @jax.jit   # traces once per bucket-pair shape combination
            def tile_at(dd_i, dd_j, ti_loc, tj_loc):
                row = {k: jax.lax.dynamic_slice_in_dim(
                    v, ti_loc * tile, tile) for k, v in dd_i.items()}
                col = {k: jax.lax.dynamic_slice_in_dim(
                    v, tj_loc * tile, tile) for k, v in dd_j.items()}
                row, col = _pad_tile_pair_axis1(row, col)
                return algorithm.tile_scores(_upcast_half(row),
                                             _upcast_half(col))
            return tile_at

        tile_at = _instance_jit(algorithm, f"bucket_tile_at:{tile}",
                                _build_tile_at)

    tile_fn = _instance_jit(
        algorithm, "bucket_tile_fn",
        lambda: jax.jit(
            lambda r, c: algorithm.tile_scores(*map(
                _upcast_half, _pad_tile_pair_axis1(r, c)))))

    sweep = _TileSweeper(algorithm.SIMILARITY_TYPES, n, tile,
                         algorithm.SYMMETRIC, scores_dir,
                         checkpoint_path, checkpoint_every,
                         ckpt_extra={"n_buckets": nb, "bucketed": 1})
    done = sweep.done
    t0 = time.time()
    for ti in range(n_tiles):
        bi = int(bucket_of[ti])
        cols = list(range(ti + 1)) if algorithm.SYMMETRIC \
            else list(range(n_tiles))
        if ti % 2 == 1:
            cols = cols[::-1]
        cols = [tj for tj in cols if not done[ti, tj]]
        if not cols:
            continue
        row_host = None
        if not device_resident:
            # only streamed when this row actually has work (a resume
            # must not re-stream the whole store)
            lo_i = ti * tile - int(edges[bi])
            row_host = jax.device_put(
                _tile_slice(descs[bi], lo_i, lo_i + tile, tile))
        for tj in cols:
            bj = int(bucket_of[tj])
            with _prof.stages.stage("sweep:tile"), \
                    _prof.step_annotation("tile", ti=ti, tj=tj):
                if device_resident:
                    scores = tile_at(dev[bi], dev[bj],
                                     np.int32(ti - tile0[bi]),
                                     np.int32(tj - tile0[bj]))
                else:
                    lo_j = tj * tile - int(edges[bj])
                    col = _tile_slice(descs[bj], lo_j, lo_j + tile, tile)
                    scores = tile_fn(row_host, col)
            sweep.submit(ti, tj, scores)
        if verbose:
            sweep.flush()
            print(f"[{algorithm.NAME}] block-row {ti + 1}/{n_tiles} "
                  f"(bucket {bi + 1}/{nb}, {time.time() - t0:.1f}s)")
    Ds = sweep.finalize()

    sorted_order = scores_dir is not None
    if not sorted_order:
        Ds = {k: D[np.ix_(inv, inv)] for k, D in Ds.items()}
    ret = [Ds]
    if return_desc:
        order = np.arange(n) if sorted_order else inv
        # merge only the small keys into RAM: post_process hooks read
        # lengths/global vectors, never the bulk descriptors (e.g.
        # ChenFusion's `length`, `ChenFusion.py:71-80`). Pulling a
        # device-resident ssms corpus host-side here would cost minutes
        # of D2H for data nobody reads. Smallness is judged on the
        # fp32-EQUIVALENT row size and each bucket's small dict is
        # dequantized BEFORE the merge: per-bucket streamed stores may
        # quantize different key sets, and concatenating a scaled-int8
        # bucket with an fp32 one would corrupt the merged values.
        from acoss_jax.data.descstore import QSCALE, upcast_stream
        smalls = []
        for d in descs:
            sd = {k: np.asarray(v) for k, v in d.items()
                  if not k.endswith(QSCALE)
                  and v[:1].size * 4 <= 65536}
            for k in list(sd):
                if sd[k].dtype == np.int8 and k + QSCALE in d:
                    sd[k + QSCALE] = np.asarray(d[k + QSCALE])
            smalls.append(upcast_stream(sd))
        keys = sorted(set.intersection(*[set(s) for s in smalls]))
        ret.append(_merge_bucket_descs(smalls, order, keys=keys))
    if return_perm:
        ret.append(perm)
    return ret[0] if len(ret) == 1 else tuple(ret)


def run_pairwise_hybrid(
    algorithm: CoverAlgorithm,
    desc: dict,
    n_songs: int,
    panel_songs: int = 128,
    tile: int | None = None,
    scores_dir: str | None = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 64,
    verbose: bool = False,
    skip_symmetrize: bool = False,
    panel_filter=None,
    prefetch_panels: bool = True,
    panel_times: list | None = None,
) -> dict:
    """Hybrid device-panel / disk-column sweep for corpora whose
    descriptors fit neither HBM nor host RAM (Serra09-FULL / EarlySNF at
    Da-TACOS scale: 15k x 448 x 20736 ssms ~ 557 GB on disk).

    A PANEL of `panel_songs` songs' descriptors is pinned in HBM for its
    whole row sweep; column tiles stream from the disk store
    (`data.descstore.DescriptorStore` memmaps) and each uploaded column
    tile is scored against EVERY row tile of the panel in one jitted
    vmapped call — so each descriptor byte crosses the host->device link
    once per panel instead of once per row tile (a panel_songs/tile x
    traffic reduction over the plain streamed sweep). Zigzag column
    order across panels keeps the tail of one panel's columns hot in the
    host page cache for the next. This is the two-level-cache analog of
    the reference's per-song disk caches (`Serra09.py:116-140`) with HBM
    as level 1 and the memmap store as level 2.

    HBM usage: one panel (panel_songs rows of descriptors) + up to three
    in-flight column tiles + tile working set — TWO panels while
    `prefetch_panels` overlaps the next panel's upload with the current
    panel's sweep tail (turn it off when a single panel already fills
    most of HBM). Host RAM: one column tile + flush buffers.
    Resume/ledger/memmap-scores semantics are `run_pairwise`'s
    (`_TileSweeper`).

    `panel_filter(p) -> bool` restricts the sweep to a subset of panels —
    the multi-process decomposition unit (each process streams from the
    SHARED disk store and uploads only its own panels; see
    `parallel.distributed.run_process_shard_hybrid`).
    """
    tile = tile or algorithm.TILE
    panel_songs = -(-panel_songs // tile) * tile
    n_tiles = -(-n_songs // tile)
    tiles_per_panel = panel_songs // tile
    n_panels = -(-n_tiles // tiles_per_panel)

    sweep = _TileSweeper(algorithm.SIMILARITY_TYPES, n_songs, tile,
                         algorithm.SYMMETRIC, scores_dir,
                         checkpoint_path, checkpoint_every,
                         ckpt_extra={"hybrid_panel": panel_songs})
    done = sweep.done

    def _build_panel_vs_tile():
        @jax.jit
        def panel_vs_tile(panel_dev, col_dev):
            tiled = {k: v.reshape((tiles_per_panel, tile) + v.shape[1:])
                     for k, v in panel_dev.items()}

            # lax.scan (not vmap) over the panel's row tiles: tile
            # kernels may materialize per-tile working copies of the
            # column tile (e.g. the tile-centered ssms), and a vmap
            # would hold tiles_per_panel of them in HBM at once
            col32 = _upcast_half(col_dev)

            def body(_, r):
                return None, algorithm.tile_scores(_upcast_half(r), col32)

            _, out = jax.lax.scan(body, None, tiled)
            return out
        return panel_vs_tile

    panel_vs_tile = _instance_jit(
        algorithm, f"panel_vs_tile:{tile}:{tiles_per_panel}",
        _build_panel_vs_tile)

    # Two-deep column prefetcher: the disk read + host->device copy of a
    # column tile BLOCK the issuing thread for the whole transfer (the
    # link is the bottleneck at these sizes — 296 MB/tile at Da-TACOS
    # dims), so the next TWO tiles' loads run on worker threads while
    # the main thread dispatches the current tile's compute. Depth 2
    # (vs the round-3 one-slot design) keeps a transfer in flight even
    # when compute runs longer than one upload (the fp16 / 256-song
    # panel regime); HBM cost is two extra in-flight column tiles.
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    def _load_col(tj):
        return jax.device_put(_tile_slice(
            desc, tj * tile, (tj + 1) * tile, tile))

    def _load_panel(t_lo, t_hi):
        return jax.device_put(_tile_slice(
            desc, t_lo * tile, t_hi * tile, tiles_per_panel * tile))

    # Plan the active panels up front (tiles belong to exactly one
    # panel's rows, so `done` for a later panel can't change while an
    # earlier one sweeps) — the plan is what lets panel p+1's multi-GB
    # HBM upload overlap the tail of panel p's column sweep.
    plan = []
    for p in range(n_panels):
        if panel_filter is not None and not panel_filter(p):
            continue
        t_lo = p * tiles_per_panel
        t_hi = min(t_lo + tiles_per_panel, n_tiles)
        row_tiles = list(range(t_lo, t_hi))
        max_col = t_hi if algorithm.SYMMETRIC else n_tiles
        cols = list(range(max_col))
        if p % 2 == 1:
            cols = cols[::-1]
        needed = [tj for tj in cols
                  if any(not done[ti, tj] and
                         (not algorithm.SYMMETRIC or tj <= ti)
                         for ti in row_tiles)]
        if needed:
            plan.append((p, t_lo, t_hi, row_tiles, needed))

    prefetch = ThreadPoolExecutor(2)
    panel_pool = ThreadPoolExecutor(1)
    panel_fut = None
    t0 = time.time()
    for pi, (p, t_lo, t_hi, row_tiles, needed) in enumerate(plan):
        with _prof.stages.stage("hybrid:panel_upload"):
            panel_dev = (panel_fut.result() if panel_fut is not None
                         else _load_panel(t_lo, t_hi))
        if prefetch_panels and pi + 1 < len(plan):
            # overlap the NEXT panel's upload with this panel's sweep;
            # peak HBM holds two panels (disable via prefetch_panels
            # when one panel already fills most of HBM)
            _, nlo, nhi, _, _ = plan[pi + 1]
            panel_fut = panel_pool.submit(_load_panel, nlo, nhi)
        else:
            panel_fut = None
        futs = deque(prefetch.submit(_load_col, tj)
                     for tj in needed[:2])
        for ci, tj in enumerate(needed):
            with _prof.stages.stage("hybrid:col_tile"), \
                    _prof.step_annotation("hybrid", panel=p, tj=tj):
                col_dev = futs.popleft().result()
                if ci + 2 < len(needed):
                    futs.append(prefetch.submit(_load_col,
                                                needed[ci + 2]))
                stack = panel_vs_tile(panel_dev, col_dev)
            for i, ti in enumerate(row_tiles):
                if done[ti, tj]:
                    continue
                if algorithm.SYMMETRIC and tj > ti:
                    continue
                sweep.submit(ti, tj,
                             {k: v[i] for k, v in stack.items()})
        del panel_dev
        sweep.flush()
        if panel_times is not None:
            # cumulative seconds at each panel boundary: callers derive
            # warm per-tile costs from the LAST panel's delta (the first
            # panel absorbs the per-process compiles and program
            # first-executions)
            panel_times.append(time.time() - t0)
        if verbose:
            print(f"[{algorithm.NAME}] panel {p + 1}/{n_panels} "
                  f"({time.time() - t0:.1f}s)")
    prefetch.shutdown(wait=True)
    panel_pool.shutdown(wait=True)
    return sweep.finalize(skip_symmetrize)


def benchmark(
    algorithm: CoverAlgorithm,
    fs: FeatureSet,
    tile: int | None = None,
    results_csv: str | None = None,
    checkpoint_path: str | None = None,
    verbose: bool = False,
    n_buckets: int = 1,
) -> dict[str, EvalStats]:
    """End-to-end: descriptors -> pair sweep -> retrieval metrics (+CSV).

    n_buckets > 1 uses the length-bucketed sweep (recommended for corpora
    with a wide song-length spread); both sweeps checkpoint/resume when
    `checkpoint_path` is given.
    """
    if n_buckets > 1 and algorithm.full_scores is None:
        with _prof.stages.stage("extract+sweep:bucketed"):
            Ds, desc = run_pairwise_bucketed(
                algorithm, fs, n_buckets=n_buckets, tile=tile,
                verbose=verbose, checkpoint_path=checkpoint_path,
                return_desc=True)
    else:
        with _prof.stages.stage("extract"):
            desc = algorithm.extract_descriptors(fs)
            _prof.stages.block(
                [v for v in desc.values() if isinstance(v, jax.Array)])
        with _prof.stages.stage("sweep"):
            Ds = run_pairwise(algorithm, desc, fs.n_songs, tile=tile,
                              checkpoint_path=checkpoint_path,
                              verbose=verbose)
    with _prof.stages.stage("post_process"):
        Ds = algorithm.post_process(Ds, desc)
    out = {}
    for k, D in Ds.items():
        S = -D if k in algorithm.DISTANCE_TYPES else D
        with _prof.stages.stage("eval"):
            stats = eval_statistics(S, fs.labels)
        out[k] = stats
        if verbose:
            print(f"[{algorithm.NAME}:{k}] MR={stats.mr:.3g} "
                  f"MRR={stats.mrr:.3g} MDR={stats.mdr:.3g} "
                  f"MAP={stats.map:.3g}")
        if results_csv:
            write_results_csv(results_csv, algorithm.NAME, k, stats)
    return out
