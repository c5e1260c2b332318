"""Sharding the N x N pair grid over a device mesh.

The reference's "distributed backend" is joblib + SGE array jobs writing
disjoint memmap cells / HDF5 batch files (`CoverAlgorithm.py:138-317`). The
analog here is a 2D device mesh over the pair grid itself:

  mesh axes ('rows', 'cols');  row-song descriptors sharded over 'rows'
  (replicated over 'cols'), column-song descriptors sharded over 'cols'
  (replicated over 'rows').

Every device then owns an (N/r x N/c) block of pairs and computes it with
ZERO communication — the outer-product structure of the pair sweep makes
the sharding itself the whole distribution strategy (collectives are only
needed to regather the score matrix, which XLA inserts when the host reads
the output). This is the direct analog of `do_batch_subbatch`'s block
arithmetic (`CoverAlgorithm.py:203-247`) with the filesystem replaced by
the device interconnect. The cards of one host are joined all to all, so
the mesh shape follows the pair grid alone.

Inside each device block, column tiles are processed under `lax.scan` so the
per-step CRP working set stays bounded in device memory, mirroring the
reference's sub-block traversal (`CoverAlgorithm.py:276-295`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# half-precision descriptors (--stream-half) upcast on device before
# compute — the ONE definition of that contract lives with the store
from acoss_jax.data.descstore import upcast_half as _upcast_half


def make_pair_mesh(devices=None, shape: tuple[int, int] | None = None) -> Mesh:
    """A 2D ('rows', 'cols') mesh over the pair grid.

    With no arguments uses all local devices in an (r, c) grid with r <= c,
    r * c = n_devices.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if shape is None:
        r = int(np.floor(np.sqrt(n)))
        while n % r:
            r -= 1
        shape = (r, n // r)
    return Mesh(devices.reshape(shape), ("rows", "cols"))


def _pad_desc_np(desc: dict, n_to: int) -> dict:
    out = {}
    for k, v in desc.items():
        v = np.asarray(v)
        pad = [(0, n_to - v.shape[0])] + [(0, 0)] * (v.ndim - 1)
        out[k] = np.pad(v, pad)
    return out


def sharded_pair_scores(
    tile_scores_fn,
    desc: dict,
    n_songs: int,
    mesh: Mesh,
    col_tile: int = 8,
) -> dict:
    """Compute the full N x N score matrices over a device mesh.

    Args:
      tile_scores_fn: ``(row_desc, col_desc) -> {type: (bi, bj)}`` — an
        algorithm's pure tile kernel (e.g. ``Serra09.tile_scores``).
      desc: per-song descriptors, host arrays with leading dim n_songs.
      mesh: from `make_pair_mesh`.
      col_tile: column-tile width scanned inside each device block.

    Returns {type: (N, N) np.float32} for the first n_songs rows/cols
    (scores involving padding songs are garbage and are cropped; the
    self-pair diagonal is NOT zeroed here — harness-level concern).
    """
    r, c = mesh.devices.shape
    # Pad the song axis so both shardings and the col tiling divide evenly.
    import math
    quantum = math.lcm(r, c * col_tile)
    n_pad = -(-n_songs // quantum) * quantum
    desc = _pad_desc_np(desc, n_pad)

    row_sharding = jax.tree.map(
        lambda _: NamedSharding(mesh, P("rows")), desc)
    col_sharding = jax.tree.map(
        lambda _: NamedSharding(mesh, P("cols")), desc)
    row_desc = jax.device_put(desc, row_sharding)
    col_desc = jax.device_put(desc, col_sharding)

    # check_vma=False: the per-block kernels may call the CUDA aligners
    # (`jax.ffi.ffi_call` with a plain `jax.ShapeDtypeStruct` result),
    # which carries no varying-manual-axes annotation. The blocks are
    # embarrassingly parallel (no collectives inside), so the check buys
    # nothing here.
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("rows"), P("cols")),
        out_specs=P("rows", "cols"),
        check_vma=False,
    )
    def block(row_d, col_d):
        nloc = jax.tree.leaves(col_d)[0].shape[0]
        n_tiles = nloc // col_tile
        tiles = jax.tree.map(
            lambda v: v.reshape((n_tiles, col_tile) + v.shape[1:]), col_d)
        row_d = _upcast_half(row_d)

        def body(_, col_t):
            return None, tile_scores_fn(row_d, _upcast_half(col_t))

        _, outs = jax.lax.scan(body, None, tiles)
        # outs: {type: (n_tiles, n_rows_local, col_tile)}
        return jax.tree.map(
            lambda v: jnp.moveaxis(v, 0, 1).reshape(v.shape[1], -1), outs)

    out = jax.jit(block)(row_desc, col_desc)
    return {k: np.asarray(v)[:n_songs, :n_songs] for k, v in out.items()}


def sharded_pair_scores_triangular(
    tile_scores_fn,
    desc: dict,
    n_songs: int,
    devices=None,
    col_tile: int = 8,
) -> dict:
    """Symmetric pair sweep over a 1D device mesh computing ONLY the
    lower-triangular block grid — half the FLOPs of the rectangular
    `sharded_pair_scores`.

    Load balance by FOLDING: songs are cut into 2D chunks and device d
    owns row-chunks {d, 2D-1-d}. Chunk d contributes d+1 lower-triangle
    blocks and chunk 2D-1-d contributes 2D-d, so every device computes
    exactly 2D+1 equal-size blocks — the mesh analog of the reference's
    balanced pair-block linearization (`CoverAlgorithm.py:228-244`).
    Column descriptors are replicated (each device needs arbitrary column
    chunks); row descriptors are sharded. Every device runs the SAME
    compiled program: its block list is derived from `axis_index` with
    traced dynamic slices, so the sweep compiles once.

    Returns {type: (N, N) np.float32} with the strict lower triangle
    filled and mirrored (diagonal zeroed) — ready for evaluation.
    """
    devices = list(devices if devices is not None else jax.devices())
    D = len(devices)
    mesh = Mesh(np.asarray(devices), ("d",))
    two_d = 2 * D
    chunk = max(-(-n_songs // two_d), col_tile)
    chunk = -(-chunk // col_tile) * col_tile
    n_pad = two_d * chunk
    desc = _pad_desc_np(desc, n_pad)

    # fold permutation: device d's rows (chunks d and 2D-1-d) contiguous
    order = np.concatenate([
        np.r_[np.arange(d * chunk, (d + 1) * chunk),
              np.arange((two_d - 1 - d) * chunk, (two_d - d) * chunk)]
        for d in range(D)])
    rows_host = {k: v[order] for k, v in desc.items()}
    row_desc = jax.device_put(
        rows_host, jax.tree.map(
            lambda _: NamedSharding(mesh, P("d")), rows_host))
    col_desc = jax.device_put(
        desc, jax.tree.map(lambda _: NamedSharding(mesh, P()), desc))

    n_blocks = two_d + 1          # per device, exactly balanced
    n_ct = chunk // col_tile

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("d"), P()),
        out_specs=P("d"),
        check_vma=False,
    )
    def device_blocks(row_d, col_full):
        my = jax.lax.axis_index("d")
        rows2 = jax.tree.map(
            lambda v: v.reshape((2, chunk) + v.shape[1:]), row_d)

        def one_block(_, k):
            top = k <= my                       # chunk `my`: cols 0..my
            row_sel = jnp.where(top, 0, 1)
            cidx = jnp.where(top, k, k - my - 1)
            row_blk = jax.tree.map(
                lambda v: jax.lax.dynamic_index_in_dim(
                    v, row_sel, keepdims=False), rows2)

            def col_tile_body(_, t):
                col_t = jax.tree.map(
                    lambda v: jax.lax.dynamic_slice_in_dim(
                        v, cidx * chunk + t * col_tile, col_tile),
                    col_full)
                return None, tile_scores_fn(_upcast_half(row_blk),
                                            _upcast_half(col_t))

            _, outs = jax.lax.scan(col_tile_body, None,
                                   jnp.arange(n_ct))
            block = jax.tree.map(
                lambda v: jnp.moveaxis(v, 0, 1).reshape(chunk, chunk),
                outs)
            return None, block

        _, blocks = jax.lax.scan(one_block, None, jnp.arange(n_blocks))
        return blocks               # {type: (n_blocks, chunk, chunk)}

    out = jax.jit(device_blocks)(row_desc, col_desc)
    out = {k: np.asarray(v) for k, v in out.items()}

    # host scatter: device-major stacking -> (d, k) -> (row_chunk, col)
    Ds = {}
    for k, v in out.items():
        v = v.reshape(D, n_blocks, chunk, chunk)
        M = np.zeros((n_pad, n_pad), np.float32)
        for d in range(D):
            for kk in range(n_blocks):
                r = d if kk <= d else two_d - 1 - d
                c = kk if kk <= d else kk - d - 1
                M[r * chunk:(r + 1) * chunk,
                  c * chunk:(c + 1) * chunk] = v[d, kk]
        L = np.tril(M, -1)
        Ds[k] = (L + L.T)[:n_songs, :n_songs]
    return Ds
