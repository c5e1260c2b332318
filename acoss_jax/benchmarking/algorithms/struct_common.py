"""Shared pipeline of the structural algorithm family (Struc*).

Parity target: the common `load_features` preamble of
`StrucFTM2D.py:70-120`, `StrucShingles.py`, `StrucLaplacian.py:60-120`,
`StrucScattering.py`: beat-synchronous (or uniformly downsampled) HPCP /
MFCC / tempogram stacks (wins_per_block history embedding), their
SSM / cosine-CSM distance matrices, and SNF fusion into one W.

NOTE (reference quirk, not replicated): the reference zero-pads the
matrices in the `Ds` LIST when they are smaller than 2K
(`StrucFTM2D.py:107-112`) but then passes the ORIGINAL unpadded variables
to the fusion call (`StrucFTM2D.py:119`), making the pad dead code. We pad
the matrices actually fused (the evident intent).
"""

from __future__ import annotations

import numpy as np

from acoss_jax.data.store import FeatureSet
from acoss_jax.features.rhythm import (tempogram_aggregated,
                                       tempogram_aggregated_batch)
from acoss_jax.ops import crp, fusion
from acoss_jax.ops.segment import stack_memory, sync_agg
from acoss_jax.ops.structure import fused_w_batch


def autotune_k(K: int, n: int) -> int:
    """K = -1 -> 2 * log2(n) (`StrucFTM2D.py:114-117`)."""
    if K == -1:
        return int(np.round(2 * np.log(n) / np.log(2)))
    return K


def structural_fused_w(
    fs: FeatureSet,
    i: int,
    chroma_type: str = "hpcp",
    wins_per_block: int = 20,
    K: int = 10,
    niters: int = 10,
    do_sync: bool = True,
    downsample_fac: int = 40,
    fuse_features: tuple = ("mfcc", "hpcp", "tempogram"),
    tempogram_win: int = 384,
    sequential: bool = True,
):
    """Fused structural affinity matrix for song `i`.

    Returns (WFused (n, n) np.float32, onsets (n,) int64).
    """
    # same load/sync/nan-cleanup as the batched path — ONE definition
    # (_prep_base_features); stacked-then-cropped equals cropped-then-
    # stacked because the delay embedding only looks backward (verified:
    # stack_memory(y[:n]) == stack_memory(y)[:n] elementwise)
    base, onsets, n = _prep_base_features(
        fs, i, chroma_type, do_sync, downsample_fac, fuse_features,
        tempogram_win)
    Ds = []
    for name in fuse_features:
        st = stack_memory(base[name], wins_per_block, 1).astype(
            np.float32)
        if name == "hpcp":
            Ds.append(np.asarray(crp.get_csm_cosine(st, st)))
        else:
            Ds.append(np.asarray(crp.get_ssm(st)))
    pK = autotune_k(K, n)
    # Bucket-pad the fusion input so a whole corpus compiles O(few) jitted
    # SNF shapes (per-song n would otherwise recompile the diffusion scan
    # for every song); padding is masked exactly inside snf_padded.
    bucket = 128
    npad = max(-(-n // bucket) * bucket, 2 * pK, bucket)
    padded = np.zeros((len(Ds), npad, npad), dtype=np.float32)
    for k_, D in enumerate(Ds):
        padded[k_, :n, :n] = D[:n, :n]
    WFused = fusion.snf_padded(padded, pK, niters=niters, length=n,
                               sequential=sequential)
    return np.asarray(WFused, dtype=np.float32)[:n, :n], onsets[:n]


def _prep_base_features(
    fs: FeatureSet,
    i: int,
    chroma_type: str,
    do_sync: bool,
    downsample_fac: int,
    fuse_features: tuple,
    tempogram_win: int,
    tempogram_precomputed: np.ndarray | None = None,
):
    """Host prep of song i's synced (UNstacked) base features.

    Returns ({name: (n, d_name) float32}, onsets (n,) int64, n) with every
    feature truncated to the common minimum segment count (the stacked
    distance matrices of the truncation equal the [:n, :n] crop of the
    full ones — delay embedding only looks backward).
    """
    clen = fs.length(chroma_type)[i]
    mlen = fs.length("mfcc_htk")[i]
    hpcp = fs.feature(chroma_type)[i, :clen]
    mfcc = np.nan_to_num(fs.feature("mfcc_htk")[i, :mlen],
                         nan=0.0, posinf=0.0, neginf=0.0)
    if do_sync:
        olen = fs.length("onsets")[i]
        onsets = fs.feature("onsets")[i, :olen, 0].astype(np.int64)
    else:
        onsets = np.arange(0, mfcc.shape[0], downsample_fac)

    base = {}
    for name in fuse_features:
        if name == "mfcc":
            y = sync_agg(mfcc, onsets, "mean")
        elif name == "hpcp":
            y = sync_agg(hpcp, onsets, "median")
        elif name == "tempogram":
            if tempogram_precomputed is not None:
                y = tempogram_precomputed
            else:
                snovfn = fs.feature("snovfn")[i,
                                              :fs.length("snovfn")[i], 0]
                y = tempogram_aggregated(snovfn, onsets, tempogram_win)
        else:
            raise ValueError(name)
        base[name] = np.nan_to_num(
            np.asarray(y, np.float32), nan=0.0, posinf=0.0, neginf=0.0)
    n = min(b.shape[0] for b in base.values())
    base = {k: v[:n] for k, v in base.items()}
    return base, onsets[:n], n


def structural_fused_w_all(
    fs: FeatureSet,
    chroma_type: str = "hpcp",
    wins_per_block: int = 20,
    K: int = 10,
    niters: int = 10,
    do_sync: bool = True,
    downsample_fac: int = 40,
    fuse_features: tuple = ("mfcc", "hpcp", "tempogram"),
    tempogram_win: int = 384,
    sequential: bool = True,
    bucket: int = 128,
    batch_size: int = 16,
    consume=None,
):
    """Fused structural W for EVERY song, batched on device.

    The corpus is bucketed by padded segment count and swept in batches of
    `batch_size` songs; each batch is ONE `fused_w_batch` dispatch (base
    distance matrices + SNF fused on device, `ops/structure.py`). Numerics
    match per-song `structural_fused_w` to float32 tolerance.

    Either returns [(W (n, n) np.float32, onsets, n), ...] in song order,
    or — when `consume(W_device (B, npad, npad), lengths (B,), onsets
    list)` is given — feeds each chunk's DEVICE-RESIDENT padded W batch to
    `consume` (so downstream batched device programs chain without a host
    round trip) and scatters the per-song results `consume` returns back
    into song order.
    """
    from acoss_jax.utils.profiling import stages

    kinds = tuple("cosine" if f == "hpcp" else "euclidean"
                  for f in fuse_features)
    with stages.stage("struct:host_prep"):
        tgs = [None] * fs.n_songs
        if "tempogram" in fuse_features:
            # all songs' synced tempograms in a few batched device calls
            envs, bnds = [], []
            for i in range(fs.n_songs):
                envs.append(
                    fs.feature("snovfn")[i, :fs.length("snovfn")[i], 0])
                if do_sync:
                    olen = fs.length("onsets")[i]
                    bnds.append(fs.feature("onsets")[i, :olen, 0]
                                .astype(np.int64))
                else:
                    bnds.append(np.arange(0, fs.length("mfcc_htk")[i],
                                          downsample_fac))
            tgs = tempogram_aggregated_batch(envs, bnds, tempogram_win)
        preps = [
            _prep_base_features(fs, i, chroma_type, do_sync,
                                downsample_fac, fuse_features,
                                tempogram_win, tempogram_precomputed=tgs[i])
            for i in range(fs.n_songs)
        ]
    results = [None] * fs.n_songs
    npads = [max(-(-n // bucket) * bucket,
                 2 * autotune_k(K, max(n, 2)), bucket)
             for _, _, n in preps]
    by_npad: dict = {}
    for i, npad in enumerate(npads):
        by_npad.setdefault(npad, []).append(i)

    for npad, idxs in sorted(by_npad.items()):
        for lo in range(0, len(idxs), batch_size):
            chunk = idxs[lo:lo + batch_size]
            # fixed batch width: short final chunks repeat their first
            # song (outputs dropped) so each npad group compiles ONCE
            B = min(batch_size, len(idxs))
            padded_chunk = chunk + [chunk[0]] * (B - len(chunk))
            P = npad + wins_per_block - 1
            feats = []
            for name in fuse_features:
                d = preps[chunk[0]][0][name].shape[1]
                arr = np.zeros((B, P, d), np.float32)
                for b, si in enumerate(padded_chunk):
                    x = preps[si][0][name]
                    arr[b, wins_per_block - 1:
                        wins_per_block - 1 + x.shape[0]] = x
                feats.append(arr)
            lengths = np.array([preps[si][2] for si in padded_chunk],
                               np.int32)
            Ks = np.array(
                [autotune_k(K, max(int(n), 2)) for n in lengths], np.int32)
            with stages.stage("struct:fused_w"):
                # bound Ks by the npad-group maximum (monotone in n), so
                # the static bound is constant per compiled shape group
                W = stages.block(fused_w_batch(
                    tuple(feats), lengths, Ks, kinds, wins_per_block,
                    niters=niters, sequential=sequential,
                    k_static_max=autotune_k(K, npad)))
            if consume is not None:
                with stages.stage("struct:consume"):
                    outs = consume(W, lengths,
                                   [preps[si][1] for si in padded_chunk])
                for b, si in enumerate(chunk):
                    results[si] = outs[b]
            else:
                Wh = np.asarray(W, np.float32)
                for b, si in enumerate(chunk):
                    n = int(lengths[b])
                    results[si] = (Wh[b, :n, :n], preps[si][1], n)
    return results


def sparse_top_shingle(flat: np.ndarray, n_keep: int):
    """log(flat / ||flat|| + 1), zeroing everything below the n_keep-th
    largest value (`StrucFTM2D.py:133-143`; like the reference, ties AT
    the cutoff are all kept, so nnz can slightly exceed n_keep).
    Returns (indices, values) sorted by index.

    The cutoff is the EXACT n_keep-th largest (partition at kth =
    n_keep - 1). The reference's own idiom
    (`-np.partition(-shingle, PAD_LEN*5)[PAD_LEN*5-1]`) reads an
    UNORDERED slot of the left partition — an arbitrary-among-top-k
    value that occasionally (~1.5% of random inputs) sits above the
    true k-th largest, against its stated intent ('the 5*PAD_LEN
    largest elements', `StrucFTM2D.py:139`). We implement the intent:
    this host fallback then agrees with the device path
    (`ops.structure.shingle_topk_batch`, exact top-k) instead of
    diverging on introselect's arbitrary choices. The literal
    reference behavior lives only in the parity harness
    (`crossimpl.ref_struc_shingle_scores`)."""
    n = np.sqrt(np.sum(flat.astype(np.float64) ** 2))
    s = np.log(flat / (n if n > 0 else 1.0) + 1)
    if n_keep >= s.size:
        idx = np.arange(s.size)
    else:
        cutoff = -np.partition(-s, n_keep - 1)[n_keep - 1]
        idx = np.flatnonzero(s >= cutoff)
    return idx.astype(np.int64), s[idx].astype(np.float32)
