"""Disk-backed descriptor store for Da-TACOS-scale sweeps.

The in-RAM descriptor dict works to a few thousand songs, but EarlySNF's
per-block scattering descriptors (~20736-dim per beat block) at the
Da-TACOS benchmark's 15,000 songs are hundreds of GB — the reference
handles this with a per-song two-level disk cache re-read inside the pair
loop (the reference's `benchmarking/Serra09.py:116-140`). The analog
here: every descriptor key is ONE on-disk `.npy` memmap with leading
dim N, written chunk-by-chunk at extraction time and sliced tile-by-tile
during the sweep, so host memory holds only the active tile rows.

Works with `harness.run_pairwise`, which slices + pads PER TILE (never
materializing a whole padded corpus) and can also memmap its output score
matrices (`scores_dir`), the analog of the reference's N x N memmap
score files (`CoverAlgorithm.py:48-51`).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np


class DescriptorStore:
    """Directory of per-key `.npy` memmaps with leading dimension N."""

    META = "descstore.json"

    def __init__(self, path: str, n_songs: int):
        self.path = path
        self.n_songs = n_songs
        self._maps: dict = {}
        os.makedirs(path, exist_ok=True)

    # -- writing ----------------------------------------------------------
    def ensure(self, key: str, tail_shape: tuple, dtype) -> np.memmap:
        """Create (or open for writing) the memmap behind `key`."""
        if key not in self._maps:
            fn = os.path.join(self.path, f"{key}.npy")
            if os.path.exists(fn):
                self._maps[key] = np.lib.format.open_memmap(fn, mode="r+")
            else:
                self._maps[key] = np.lib.format.open_memmap(
                    fn, mode="w+", dtype=np.dtype(dtype),
                    shape=(self.n_songs,) + tuple(tail_shape))
        return self._maps[key]

    def write(self, key: str, start: int, values: np.ndarray) -> None:
        """Write rows [start, start + len(values)) of `key`, padding the
        trailing axes up to the store's width."""
        m = self.ensure(key, values.shape[1:], values.dtype)
        if values.shape[1:] != m.shape[1:]:
            pad = [(0, 0)] + [(0, t - s) for s, t in
                              zip(values.shape[1:], m.shape[1:])]
            if any(p[1] < 0 for p in pad):
                raise ValueError(
                    f"{key}: chunk wider than store "
                    f"{values.shape[1:]} > {m.shape[1:]}")
            values = np.pad(values, pad)
        m[start:start + len(values)] = values

    def flush(self) -> None:
        for m in self._maps.values():
            m.flush()
        meta = {"n_songs": self.n_songs,
                "keys": sorted(os.path.splitext(f)[0]
                               for f in os.listdir(self.path)
                               if f.endswith(".npy"))}
        with open(os.path.join(self.path, self.META), "w") as f:
            json.dump(meta, f)

    # -- reading ----------------------------------------------------------
    @classmethod
    def open(cls, path: str) -> dict:
        """Read-only descriptor dict of memmaps (drop-in for the in-RAM
        desc dict: `harness.run_pairwise` slices it per tile)."""
        with open(os.path.join(path, cls.META)) as f:
            meta = json.load(f)
        return {k: np.load(os.path.join(path, f"{k}.npy"), mmap_mode="r")
                for k in meta["keys"]}

    def delete(self) -> None:
        self._maps.clear()
        shutil.rmtree(self.path, ignore_errors=True)


QSCALE = "@qscale"      # companion-leaf suffix for int8 quantization


def quantize_int8(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-song symmetric int8 quantization: (int8 values, float32
    scale of shape (n_songs,)) with v ~= int8 * scale[:, None, ...].
    All-zero songs get scale 1 so the dequant stays exact zeros."""
    v = np.asarray(v, dtype=np.float32)
    amax = np.abs(v).reshape(v.shape[0], -1).max(axis=1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.round(v / scale.reshape((-1,) + (1,) * (v.ndim - 1)))
    return np.clip(q, -127, 127).astype(np.int8), scale


def upcast_stream(d: dict) -> dict:
    """Restore full-precision float32 descriptor leaves INSIDE a jitted
    tile program. Descriptors may be stored/streamed/pinned quantized
    (`extract_streamed(quant=...)`) to shrink the disk store, the
    host->device tile traffic and the HBM corpus footprint — the
    bandwidth-bound resources of a Da-TACOS-scale sweep (the 15k ssms
    corpus is ~557 GB in fp32):

    - 'half': float16 leaves, upcast with `.astype` (2x smaller);
    - 'int8': int8 leaves + a per-song `<key>@qscale` float32 companion,
      dequantized as int8 * scale (4x smaller, ~0.4% of each song's
      max-abs in absolute error).

    Compute stays fp32: the dequant is a fused elementwise op on bytes
    already on device. The ONE definition of the quantized-stream
    contract — every sweep (harness single-process/bucketed/hybrid,
    parallel mesh) imports it from here. Companion leaves are consumed
    (dropped from the returned dict)."""
    import jax.numpy as jnp

    out = {}
    for k, v in d.items():
        if k.endswith(QSCALE):
            continue
        if v.dtype in (jnp.float16, jnp.bfloat16):
            v = v.astype(jnp.float32)
        elif v.dtype == jnp.int8 and k + QSCALE in d:
            s = d[k + QSCALE].astype(jnp.float32)
            v = v.astype(jnp.float32) * s.reshape(
                s.shape + (1,) * (v.ndim - s.ndim))
        out[k] = v
    return out


# the historical name (pre-int8) — same function, every call site keeps
# working
upcast_half = upcast_stream


def store_quant(desc: dict) -> str | None:
    """The quantization mode a store was written with: 'int8' if any
    leaf has a `@qscale` companion, 'half' if any leaf is float16,
    else None."""
    if any(k.endswith(QSCALE) for k in desc):
        return "int8"
    if any(getattr(v, "dtype", None) == np.float16
           for v in desc.values()):
        return "half"
    return None


def check_stream_consistency(desc: dict, quant: str | None,
                             path: str) -> None:
    """A REUSED store must match the requested precision mode: feeding
    a quantized store to a higher-precision run silently violates the
    quant contract ('not for full-precision parity runs'), so that
    direction raises; the reverse only forfeits the throughput win and
    just notes it. Called by every store-reuse path (CLI plain stores,
    bucketed per-bucket stores)."""
    import sys

    rank = {None: 0, "half": 1, "int8": 2}
    have = store_quant(desc)
    if rank[have] > rank[quant]:
        raise ValueError(
            f"{path} holds {have}-quantized descriptors but a "
            f"{quant or 'full'}-precision run was requested; delete the "
            f"store or request --stream-{have}")
    if rank[have] < rank[quant]:
        print(f"note: {quant} precision requested but {path} is "
              f"{have or 'full'} precision; reusing it as-is",
              file=sys.stderr)


def check_half_consistency(desc: dict, want_half: bool,
                           path: str) -> None:
    """Pre-int8 name for `check_stream_consistency(desc, 'half', ...)`."""
    check_stream_consistency(desc, "half" if want_half else None, path)


def extract_streamed(algorithm, fs, store_path: str,
                     chunk_songs: int = 256, verbose: bool = False,
                     half: bool = False,
                     half_min_bytes: int = 65536,
                     quant: str | None = None) -> dict:
    """Chunked descriptor extraction into a DescriptorStore.

    Each chunk of songs is extracted with the algorithm's ordinary
    `extract_descriptors` on a FeatureSet subset; because chunk-local
    padded widths differ, chunks are staged to temporary files on the
    first pass (tracking per-key maximum widths), then copied into the
    final fixed-width memmaps. Peak host memory is one chunk's
    descriptors. Returns the read-only descriptor dict.

    `quant` (or the pre-int8 spelling `half=True` == quant='half')
    stores float32 descriptors whose PER-SONG slice is at least
    `half_min_bytes` in a compressed dtype — a throughput mode for the
    bandwidth-bound Da-TACOS sweeps shrinking the disk store (the 15k
    ssms corpus is ~557 GB in fp32), the host->device tile traffic and
    the HBM footprint:

    - 'half': float16 (2x, ~1e-3 relative error);
    - 'int8': per-song symmetric int8 + a float32 `<key>@qscale`
      companion leaf (4x, absolute error ~0.4% of each song's max-abs).

    The sweeps restore fp32 on device before any compute
    (`upcast_stream`); small keys (lengths, global chroma) stay exact.
    Opt-in: full-precision parity paths must leave it off.
    """
    if half and quant is None:
        quant = "half"
    if quant not in (None, "half", "int8"):
        raise ValueError(f"unknown quant mode {quant!r}")
    n = fs.n_songs
    # extract_streamed always builds the store from scratch (there is no
    # chunk-level resume), so clear any pre-existing memmaps: debris from
    # an interrupted prior run has stale widths/dtypes that ensure()
    # would silently reopen — the re-run would then die with 'chunk
    # wider than store' AFTER re-extracting the whole corpus, or produce
    # wrong-width descriptors. (Callers that want reuse check for META
    # and DescriptorStore.open() instead, as the CLI does.)
    if os.path.isdir(store_path):
        for fn in os.listdir(store_path):
            if fn.endswith(".npy") or fn == DescriptorStore.META:
                os.remove(os.path.join(store_path, fn))
    tmp_dir = store_path + ".chunks"
    os.makedirs(tmp_dir, exist_ok=True)
    widths: dict = {}
    dtypes: dict = {}
    half_keys: set = set()
    starts = list(range(0, n, chunk_songs))
    for ci, lo in enumerate(starts):
        hi = min(lo + chunk_songs, n)
        desc = algorithm.extract_descriptors(
            fs.subset(np.arange(lo, hi)))
        payload = {}
        for k, v in desc.items():
            v = np.asarray(v)
            if v.dtype == object or v.ndim == 0 or v.shape[0] != hi - lo:
                raise ValueError(
                    f"algorithm {type(algorithm).__name__} does not "
                    f"support streamed extraction: descriptor {k!r} is "
                    f"not a fixed-rank array with leading dim n_songs "
                    f"(got dtype={v.dtype}, shape={v.shape})")
            # the quantized-key set is decided ONCE, on the first chunk:
            # chunk-local padded widths differ, and a near-threshold key
            # must not end up compressed in some chunks and fp32 in
            # others (the store dtype would then depend on chunk order)
            if (quant and ci == 0 and v.dtype == np.float32
                    and v[:1].nbytes >= half_min_bytes):
                half_keys.add(k)
            if k in half_keys and v.dtype == np.float32:
                if quant == "int8":
                    v, payload[k + QSCALE] = quantize_int8(v)
                else:
                    v = v.astype(np.float16)
            payload[k] = v
        for k, v in payload.items():   # incl. @qscale companions
            prev = widths.get(k)
            widths[k] = (v.shape[1:] if prev is None else
                         tuple(max(a, b)
                               for a, b in zip(prev, v.shape[1:])))
            dtypes[k] = v.dtype
        np.savez(os.path.join(tmp_dir, f"chunk_{ci}.npz"), **payload)
        if verbose:
            print(f"[extract_streamed] chunk {ci + 1}/{len(starts)} "
                  f"({hi}/{n} songs)")
    store = DescriptorStore(store_path, n)
    for k in widths:
        store.ensure(k, widths[k], dtypes[k])
    for ci, lo in enumerate(starts):
        fn = os.path.join(tmp_dir, f"chunk_{ci}.npz")
        with np.load(fn) as z:
            for k in z.files:
                store.write(k, lo, z[k])
        # drop each staged chunk as soon as it lands in the final
        # memmaps: transient disk stays ~one chunk above the store's
        # final size instead of doubling it (matters at the hundreds-of-GB
        # Da-TACOS scale this module targets)
        os.remove(fn)
    store.flush()
    shutil.rmtree(tmp_dir, ignore_errors=True)
    return DescriptorStore.open(store_path)
