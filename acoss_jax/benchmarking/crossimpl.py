"""Cross-implementation parity: the reference's OWN scoring code vs ours.

Everything downstream of feature prep in the reference's four alignment
drivers is either pure numpy/scipy (`CRPUtils.py`, `SimilarityFusion.py`)
or a small C file (`SequenceAlignment.c`) — all runnable in this
environment. This module loads those modules FROM THE READ-ONLY MOUNT
(no reference code is copied into the repo), compiles the C aligners at
run time, re-types only the ~20-line per-pair driver glue of each
algorithm (`Serra09.py:158-196`, `ChenFusion.py:57-85`,
`Tempogram.py:53-70`, `EarlySNF.py:44-97`) on top of those imported
reference functions, and feeds BOTH stacks the IDENTICAL descriptors that
`acoss_jax`'s algorithms extract. The result converts "parity by
construction" into "parity by measurement": per-pair score deltas and
per-channel MAP deltas between the reference's scoring path and this
repo's JAX scoring path, on shared inputs.

Orientation note: for a pair (i, j) with i > j the harness scores with
song i as the FIRST song (OTI-rolled song, CSM rows), matching how
`harness.run_pairwise` fills the strict lower triangle (row = larger
index). The reference driver's own first/second choice comes from its
`itertools.combinations` order (`CoverAlgorithm.py:165-182`) — an
arbitrary convention for the symmetric sweep; what is compared here is
the per-pair scoring function itself on a fixed orientation.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import types

import numpy as np

REF_DIR = "/root/reference/benchmarking"

_REF_MODULES: dict = {}
_REF_LIB = None


def reference_available() -> bool:
    return os.path.exists(os.path.join(REF_DIR, "CRPUtils.py"))


def load_reference():
    """Import the reference's `CRPUtils` and `SimilarityFusion` from the
    read-only mount. `SimilarityFusion` imports librosa/matplotlib at
    module scope but the functions used here (`get_W*`, `snf_ws`, `snf`)
    never call librosa, so a stub module satisfies the import; matplotlib
    is forced to the Agg backend."""
    if "CRPUtils" in _REF_MODULES:
        return _REF_MODULES["CRPUtils"], _REF_MODULES["SimilarityFusion"]
    if not reference_available():
        raise RuntimeError(f"reference mount not found at {REF_DIR}")
    os.environ.setdefault("MPLBACKEND", "Agg")
    if "librosa" not in sys.modules:
        try:
            import librosa  # noqa: F401
        except ImportError:
            stub = types.ModuleType("librosa")
            stub.feature = types.ModuleType("librosa.feature")
            stub.util = types.ModuleType("librosa.util")
            sys.modules["librosa"] = stub
    sys.path.insert(0, REF_DIR)
    try:
        import CRPUtils  # type: ignore
        import SimilarityFusion  # type: ignore
    finally:
        sys.path.remove(REF_DIR)
    _REF_MODULES["CRPUtils"] = CRPUtils
    _REF_MODULES["SimilarityFusion"] = SimilarityFusion
    return CRPUtils, SimilarityFusion


def compile_reference_aligners():
    """Compile `SequenceAlignment.c` from the mount and return
    (qmax, dmax) callables with the `pySeqAlign.pyx` calling convention:
    binary uint8 CSM in, float score out."""
    global _REF_LIB
    if _REF_LIB is None:
        src = os.path.join(REF_DIR, "SequenceAlignment.c")
        if not os.path.exists(src):
            raise RuntimeError(f"{src} not found")
        tmp = tempfile.mkdtemp(prefix="refalign_")
        so = os.path.join(tmp, "libref.so")
        subprocess.run(["gcc", "-O2", "-shared", "-fPIC", src, "-o", so],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(so)
        for name in ("qmax_c", "dmax_c", "swalignimpconstrained"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_float
            fn.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                           ctypes.POINTER(ctypes.c_float),
                           ctypes.c_int, ctypes.c_int]
        _REF_LIB = lib
    lib = _REF_LIB

    def call(name, csm):
        M, N = csm.shape
        S = np.ascontiguousarray(csm, dtype=np.uint8).ravel()
        D = np.zeros(M * N, dtype=np.float32)
        return float(getattr(lib, name)(
            S.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            D.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), M, N))

    return (lambda csm: call("qmax_c", csm),
            lambda csm: call("dmax_c", csm))


# ---------------------------------------------------------------------------
# Per-song views of the shared (acoss_jax-extracted) descriptors, shaped the
# way the reference per-pair drivers consume them.
# ---------------------------------------------------------------------------

def serra_song(desc: dict, i: int, m: int, do_ssms: bool) -> dict:
    """One song's Serra09 features in the reference's `load_features`
    layout (`Serra09.py:96-156`): chroma/mfcc as (d, n) column-per-frame
    float64, ssms rows length-matched to n - m + 1."""
    n = int(desc["length"][i])
    out = {
        "gchroma": np.asarray(desc["gchroma"][i], np.float64),
        "chroma": np.asarray(desc["chroma"][i, :n], np.float64).T,
        "mfcc": np.asarray(desc["mfcc"][i, :n], np.float64).T,
    }
    if do_ssms:
        out["ssms"] = np.asarray(desc["ssms"][i][:max(n - m + 1, 1)],
                                 np.float64)
    return out


def chen_song(desc: dict, i: int) -> dict:
    n = int(desc["length"][i])
    return {
        "gchroma": np.asarray(desc["gchroma"][i], np.float64),
        "stacked": np.asarray(desc["stacked"][i, :n], np.float64),
    }


def tempogram_song(desc: dict, i: int) -> dict:
    return {
        "tempogram_rnn":
            np.asarray(desc["rnn"][i, :int(desc["rnn_len"][i])],
                       np.float64),
        "tempogram_sflux":
            np.asarray(desc["sflux"][i, :int(desc["sflux_len"][i])],
                       np.float64),
    }


# ---------------------------------------------------------------------------
# Tie-inclusive kNN binarize (diagnostic variant)
# ---------------------------------------------------------------------------

def tie_inclusive_binary(D: np.ndarray, kappa: float) -> np.ndarray:
    """`CRPUtils.csm_to_binary` with rank-threshold tie handling: every
    entry <= the kth-smallest row value is selected, instead of
    `np.argpartition`'s ARBITRARY exact-k subset among ties. The two
    policies differ only on tied distances — which the reference's own
    repeat-padding of short scattering sequences (`Serra09.py:147-152`)
    guarantees: ~m duplicated trailing ssms rows per song give exact tie
    groups at the kth boundary. acoss_jax's deterministic kNN
    (`crp._row_knn_mask`) is tie-inclusive; this variant isolates that
    policy difference from genuine numeric divergence (measured: 0
    differing CRP cells vs acoss on tied ssms inputs where argpartition
    differs in 46)."""
    if kappa == 0:
        return np.ones_like(D, dtype=np.uint8)
    k = int(np.round(kappa * D.shape[1])) if kappa < 1 else int(kappa)
    kth = np.partition(D, k - 1, 1)[:, k - 1]
    return (D <= kth[:, None]).astype(np.uint8)


def tie_inclusive_binary_mutual(D: np.ndarray, kappa: float) -> np.ndarray:
    return tie_inclusive_binary(D, kappa) * \
        tie_inclusive_binary(D.T, kappa).T


def _binarizers(tie_inclusive: bool):
    C, _ = load_reference()
    if tie_inclusive:
        return tie_inclusive_binary, tie_inclusive_binary_mutual
    return C.csm_to_binary, C.csm_to_binary_mutual


def tie_inclusive_get_S(W: np.ndarray, K) -> np.ndarray:
    """`SimilarityFusion.get_S` (L1-normalized row-kNN, self included,
    `SimilarityFusion.py:157-177`) with rank-threshold tie handling, for
    the tie-inclusive diagnostic pass of the reference SNF. Returned
    dense (ndarray `.dot` serves the sparse interface `snf_ws` uses)."""
    K = int(K)
    thresh = -np.partition(-W, K - 1, 1)[:, K - 1]
    V = np.where(W >= thresh[:, None], W, 0.0)
    norm = V.sum(1)
    norm[norm == 0] = 1
    return V / norm[:, None]


def exact_dup_ssm(X: np.ndarray) -> np.ndarray:
    """`CRPUtils.get_ssm` with the distance between BITWISE-EQUAL rows
    snapped to exact 0, for the tie-inclusive diagnostic pass.

    The reference's repeat-padding (`Serra09.py:147-152`) gives every
    song ~m identical trailing ssms rows, and `get_ssm`'s x^2+y^2-2xy
    Gram rounds their distance to ~1e-6 dust instead of 0. That dust is
    then SELF-REFERENTIAL in `get_W`'s adaptive bandwidth: when a row's
    k nearest neighbors all sit at the same dust distance d, Eps = d and
    W = exp(-d^2 / (2*(d/2)^2)) = exp(-2) — a value determined entirely
    by rounding noise (exact zeros would give W = 1 through the
    denom==0 -> 1 substitution, which is what acoss_jax's exact-0
    centered path produces). Snapping duplicates to 0 removes only that
    noise-determined degeneracy."""
    C, _ = load_reference()
    D = C.get_ssm(X)
    _, inv = np.unique(X, axis=0, return_inverse=True)
    D[inv[:, None] == inv[None, :]] = 0.0
    return D


class _patched_get_S:
    """Temporarily swap the reference module's `get_S` global (which
    `snf_ws` resolves at call time) for the tie-inclusive variant."""

    def __enter__(self):
        _, SF = load_reference()
        self._SF, self._orig = SF, SF.get_S
        SF.get_S = tie_inclusive_get_S
        return self

    def __exit__(self, *exc):
        self._SF.get_S = self._orig
        return False


# ---------------------------------------------------------------------------
# Reference per-pair scoring (re-typed driver glue over imported functions)
# ---------------------------------------------------------------------------

def ref_serra09_pair(Si: dict, Sj: dict, kappa: float, m: int,
                     do_ssms: bool, tie_inclusive: bool = False) -> dict:
    """`Serra09.similarity`'s per-pair body (`Serra09.py:158-196`) on the
    imported CRPUtils + compiled C aligners."""
    C, _ = load_reference()
    qmax, dmax = compile_reference_aligners()
    _, binm = _binarizers(tie_inclusive)
    out = {}

    oti = C.get_oti(Si["gchroma"], Sj["gchroma"])
    C1 = np.roll(Si["chroma"], oti, axis=0)
    csm = C.get_csm(C1.T, Sj["chroma"].T)
    csm = C.sliding_csm(csm, m)
    csm = binm(csm, kappa)
    M, N = csm.shape
    out["chroma_qmax"] = qmax(csm) / (M + N)
    out["chroma_dmax"] = dmax(csm) / (M + N)

    csm = C.get_csm(Si["mfcc"].T, Sj["mfcc"].T)
    csm = C.sliding_csm(csm, m)
    csm = binm(csm, kappa)
    M, N = csm.shape
    out["mfcc_qmax"] = qmax(csm) / (M + N)
    out["mfcc_dmax"] = dmax(csm) / (M + N)

    if do_ssms:
        csm = C.get_csm(Si["ssms"], Sj["ssms"])
        csm = binm(csm, kappa)
        M, N = csm.shape
        out["ssms_scatter_qmax"] = qmax(csm) / (M + N)
        out["ssms_scatter_dmax"] = dmax(csm) / (M + N)
    return out


def ref_earlysnf_pair(Si: dict, Sj: dict, kappa: float, m: int,
                      snf_niters: int = 3,
                      tie_inclusive: bool = False) -> dict:
    """`EarlySNF.similarity`'s per-pair body (`EarlySNF.py:44-97`)."""
    C, SF = load_reference()
    qmax, dmax = compile_reference_aligners()
    _, binm = _binarizers(tie_inclusive)
    out = {}
    Ws = []

    oti = C.get_oti(Si["gchroma"], Sj["gchroma"])
    C1 = np.roll(Si["chroma"], oti, axis=0)
    csm = C.get_csm(C1.T, Sj["chroma"].T)
    csm = C.sliding_csm(csm, m)
    M, N = csm.shape
    K = int(kappa * (M + N))
    ssma = C.sliding_csm(C.get_csm(C1.T, C1.T), m)
    ssmb = C.sliding_csm(C.get_csm(Sj["chroma"].T, Sj["chroma"].T), m)
    Ws.append(SF.get_WCSMSSM(ssma, ssmb, csm, K))
    b = binm(csm, kappa)
    out["chroma_qmax"] = qmax(b) / (M + N)
    out["chroma_dmax"] = dmax(b) / (M + N)

    csm = C.get_csm(Si["mfcc"].T, Sj["mfcc"].T)
    csm = C.sliding_csm(csm, m)
    b = binm(csm, kappa)
    out["mfcc_qmax"] = qmax(b) / (M + N)
    out["mfcc_dmax"] = dmax(b) / (M + N)

    csm = C.get_csm(Si["ssms"], Sj["ssms"])
    get_ssm = exact_dup_ssm if tie_inclusive else C.get_ssm
    Ws.append(SF.get_WCSMSSM(get_ssm(Si["ssms"]), get_ssm(Sj["ssms"]),
                             csm, K))
    b = binm(csm, kappa)
    out["ssms_scatter_qmax"] = qmax(b) / (M + N)
    out["ssms_scatter_dmax"] = dmax(b) / (M + N)

    if tie_inclusive:
        with _patched_get_S():
            fused = SF.snf_ws(Ws, K=K, niters=snf_niters, reg_diag=True,
                              verbose_times=False)
    else:
        fused = SF.snf_ws(Ws, K=K, niters=snf_niters, reg_diag=True,
                          verbose_times=False)
    cross = -fused[0:M, M:]
    b = binm(cross, kappa)
    out["snf_qmax"] = qmax(b) / (M + N)
    out["snf_dmax"] = dmax(b) / (M + N)
    return out


def ref_chenfusion_pair(Si: dict, Sj: dict, kappa: float,
                        tie_inclusive: bool = False) -> dict:
    """`ChenFusion.similarity`'s per-pair body (`ChenFusion.py:57-67`):
    blocked-OTI CSM, NON-mutual binarize, RAW qmax/dmax."""
    C, _ = load_reference()
    qmax, dmax = compile_reference_aligners()
    bin_, _ = _binarizers(tie_inclusive)
    csm = C.get_csm_blocked_oti(Si["stacked"], Sj["stacked"],
                                Si["gchroma"], Sj["gchroma"],
                                C.get_csm_euclidean)
    csm = bin_(csm, kappa)
    return {"qmax": qmax(csm), "dmax": dmax(csm)}


def ref_tempogram_pair(Si: dict, Sj: dict, kappa: float,
                       tie_inclusive: bool = False) -> dict:
    """`TGAlg.similarity`'s per-pair body (`Tempogram.py:53-70`)."""
    C, _ = load_reference()
    qmax, dmax = compile_reference_aligners()
    bin_, _ = _binarizers(tie_inclusive)
    out = {}
    for f in ("tempogram_rnn", "tempogram_sflux"):
        csm = C.get_csm(Si[f], Sj[f])
        csm = bin_(csm, kappa)
        M, N = csm.shape
        out[f"{f}_qmax"] = qmax(csm) / (M + N)
        out[f"{f}_dmax"] = dmax(csm) / (M + N)
    return out


def ref_struc_shingle_scores(Ws, pad_len: int, do_fft: bool) -> np.ndarray:
    """The reference's Struc* shingle scoring, re-typed in fp64
    numpy/scipy exactly as written: per-song shingle construction
    (`StrucFTM2D.py:132-142` — zero-pad W to PAD_LEN^2, |fft2|, log-norm,
    zero everything below the 5*PAD_LEN cutoff; `StrucShingles.py`
    identical without the FFT) + the one-shot sparse Gram of
    `all_pairwise` (`StrucFTM2D.py:173-189`: exp(-DsSqr), no clamp).
    Input: SHARED fused-W matrices (one per song)."""
    import scipy.fftpack
    from scipy import sparse as sp

    rows = []
    for W in Ws:
        N = min(pad_len, W.shape[0])
        Wres = np.zeros((pad_len, pad_len))
        Wres[:N, :N] = np.asarray(W, np.float64)[:N, :N]
        mat = np.abs(scipy.fftpack.fft2(Wres)) if do_fft else Wres
        flat = mat.flatten()
        shingle = np.log(flat / (np.sqrt(np.sum(flat ** 2))) + 1)
        cutoff = -np.partition(-shingle, pad_len * 5)[pad_len * 5 - 1]
        shingle[shingle < cutoff] = 0
        rows.append(sp.csr_matrix(shingle))
    X = sp.vstack(rows).tocsr()
    XSqr = np.array(X.power(2).sum(1)).flatten()
    DsSqr = XSqr[:, None] + XSqr[None, :] - 2 * X.dot(X.T).toarray()
    return np.exp(-DsSqr)


def acoss_struc_shingle_scores(Ws, pad_len: int,
                               do_fft: bool) -> np.ndarray:
    """The acoss_jax path from the SAME shared fused-W inputs: device
    shingle top-k (`ops.structure.shingle_topk_batch`) + the
    dense-over-union device Gram (`ops.sparse_gram.sparse_gram_scores`)
    — exactly what `StrucFTM2D.extract_descriptors` + `full_scores` run
    downstream of the fused W."""
    import jax.numpy as jnp

    from acoss_jax.ops.sparse_gram import sparse_gram_scores
    from acoss_jax.ops.structure import shingle_topk_batch

    B = len(Ws)
    npad = max(W.shape[0] for W in Ws)
    Wb = np.zeros((B, npad, npad), np.float32)
    lengths = np.zeros(B, np.int32)
    for b, W in enumerate(Ws):
        n = W.shape[0]
        Wb[b, :n, :n] = W
        lengths[b] = n
    idx, val = shingle_topk_batch(jnp.asarray(Wb), jnp.asarray(lengths),
                                  pad_len, 5 * pad_len, do_fft)
    idx = np.asarray(idx, np.int64)
    val = np.asarray(val, np.float32)
    idx_list, val_list = [], []
    for b in range(B):
        keep = idx[b] >= 0
        ix, v = idx[b][keep], val[b][keep]
        order = np.argsort(ix)
        idx_list.append(ix[order])
        val_list.append(v[order])
    # host_max_n=0: always exercise the DEVICE Gram here — the host
    # fallback is a separately-tested scipy path
    return sparse_gram_scores(idx_list, val_list, pad_len * pad_len,
                              host_max_n=0)


# ---------------------------------------------------------------------------
# Whole-matrix reference sweeps + post passes
# ---------------------------------------------------------------------------

_SONG_FNS = {
    "Serra09": lambda desc, i, kw: serra_song(desc, i, kw["m"],
                                              kw["do_ssms"]),
    "EarlySNF": lambda desc, i, kw: serra_song(desc, i, kw["m"], True),
    "ChenFusion": lambda desc, i, kw: chen_song(desc, i),
    "TGAlg": lambda desc, i, kw: tempogram_song(desc, i),
    "Simple": lambda desc, i, kw: simple_song(desc, i),
    "EarlyFusion": lambda desc, i, kw: earlyfusion_song(desc, i),
}

_PAIR_FNS = {
    "Serra09": lambda Si, Sj, kw: ref_serra09_pair(
        Si, Sj, kw["kappa"], kw["m"], kw["do_ssms"],
        kw.get("tie_inclusive", False)),
    "EarlySNF": lambda Si, Sj, kw: ref_earlysnf_pair(
        Si, Sj, kw["kappa"], kw["m"], kw.get("snf_niters", 3),
        kw.get("tie_inclusive", False)),
    "ChenFusion": lambda Si, Sj, kw: ref_chenfusion_pair(
        Si, Sj, kw["kappa"], kw.get("tie_inclusive", False)),
    "TGAlg": lambda Si, Sj, kw: ref_tempogram_pair(
        Si, Sj, kw["kappa"], kw.get("tie_inclusive", False)),
    "Simple": lambda Si, Sj, kw: ref_simple_pair(
        Si, Sj, kw.get("sslen", 10)),
    "EarlyFusion": lambda Si, Sj, kw: ref_earlyfusion_pair(
        Si, Sj, kw["kappa"], kw["K"], kw.get("tie_inclusive", False)),
}

# algorithms whose reference driver sweeps permutations, not
# combinations (`Simple.py:149` symmetric=False)
_ASYMMETRIC = {"Simple"}


def reference_scores(name: str, desc: dict, n_songs: int,
                     verbose: bool = False, **kw) -> dict:
    """Reference-scored full matrices: strict lower triangle (i > j, song
    i first) + symmetrize — exactly the orientation `run_pairwise`
    produces — or the full permutation sweep for asymmetric algorithms.
    Per-song feature views are materialized ONCE (pulling a
    device-resident ssms corpus to the host once per song, not once per
    pair — this link moves D2H at 2-23 MB/s)."""
    pair_fn = _PAIR_FNS[name]
    song_fn = _SONG_FNS[name]
    symmetric = name not in _ASYMMETRIC
    feats = [song_fn(desc, i, kw) for i in range(n_songs)]
    Ds: dict = {}
    for i in range(n_songs):
        for j in (range(i) if symmetric else range(n_songs)):
            if j == i:
                continue
            s = pair_fn(feats[i], feats[j], kw)
            for k, v in s.items():
                if k not in Ds:
                    Ds[k] = np.zeros((n_songs, n_songs), np.float64)
                Ds[k][i, j] = v
        if verbose and (i + 1) % 8 == 0:
            print(f"[crossimpl:{name}] reference rows {i + 1}/{n_songs}")
    return {k: (D + D.T if symmetric else D) for k, D in Ds.items()}


def ref_chenfusion_post(Ds: dict, desc: dict, late_K: int = 20,
                        late_niters: int = 20) -> dict:
    """`normalize_by_length` + `do_late_fusion` (`ChenFusion.py:69-85`)
    over imported reference SNF. `doSimilarityFusion` in the reference
    source is the pre-rename spelling of `SimilarityFusion.snf` (same
    signature/return)."""
    _, SF = load_reference()
    lengths = np.asarray(desc["length"], np.float64)
    out = {}
    with np.errstate(divide="ignore"):
        for k in ("qmax", "dmax"):
            out[k] = np.sqrt(lengths)[None, :] / np.asarray(Ds[k],
                                                            np.float64)
    late = SF.snf([out["qmax"], out["dmax"]], K=late_K,
                  niters=late_niters, reg_diag=1, verbose_times=False)[1]
    res = {k: -v for k, v in out.items()}
    res["Late"] = late
    return res


# ---------------------------------------------------------------------------
# Head-to-head comparison
# ---------------------------------------------------------------------------

def compare_channels(ref: dict, ours: dict, labels: np.ndarray,
                     distance_types=()) -> list[dict]:
    """Per-channel rows: max/mean per-pair |delta| (off-diagonal) and MAP
    under both stacks (our bit-faithful `eval_statistics`)."""
    from acoss_jax.benchmarking.evaluation import eval_statistics

    rows = []
    n = len(labels)
    off = ~np.eye(n, dtype=bool)
    for k in sorted(ref):
        A = np.asarray(ref[k], np.float64)
        B = np.asarray(ours[k], np.float64)
        d = np.abs(A - B)[off]
        sign = -1.0 if k in distance_types else 1.0
        map_ref = eval_statistics(sign * A, labels).map
        map_jax = eval_statistics(sign * B, labels).map
        rows.append({
            "channel": k,
            "n_pairs": int(off.sum() // 2),
            "max_abs_dscore": float(d.max()) if d.size else 0.0,
            "mean_abs_dscore": float(d.mean()) if d.size else 0.0,
            "frac_within_1e3": float(np.mean(d <= 1e-3)),
            "map_ref": float(map_ref),
            "map_jax": float(map_jax),
            "dmap": float(map_jax - map_ref),
        })
    return rows


# ---------------------------------------------------------------------------
# Reference driver-module loader (FTM2D's chrompwr/btchroma_to_fftmat,
# Simple's simple_sim/oti) — imported from the mount with stub deps
# ---------------------------------------------------------------------------

def load_reference_module(name: str):
    """Import a reference algorithm driver module (`FTM2D`, `Simple`)
    from the mount. Their module scopes touch CoverAlgorithm (which
    imports deepdish), librosa and pySeqAlign — none of which the
    functions used here ever call — so stub modules are pre-seeded in
    sys.modules (a stub in sys.modules wins over the mount's real
    CoverAlgorithm.py on the import path)."""
    if name in _REF_MODULES:
        return _REF_MODULES[name]
    if not reference_available():
        raise RuntimeError(f"reference mount not found at {REF_DIR}")
    os.environ.setdefault("MPLBACKEND", "Agg")
    stubs = {}
    if "CoverAlgorithm" not in sys.modules:
        m = types.ModuleType("CoverAlgorithm")

        class CoverAlgorithm:  # noqa: N801 - reference spelling
            pass

        m.CoverAlgorithm = CoverAlgorithm
        stubs["CoverAlgorithm"] = m
    if "librosa" not in sys.modules:
        try:
            import librosa  # noqa: F401
        except ImportError:
            m = types.ModuleType("librosa")
            m.util = types.ModuleType("librosa.util")
            m.filters = types.ModuleType("librosa.filters")
            m.feature = types.ModuleType("librosa.feature")
            stubs["librosa"] = m
    else:
        # `load_reference()` may have left a BARE librosa stub (no
        # util/filters); `Simple.py`'s `from librosa import util,
        # filters` needs the attributes — augment in place
        m = sys.modules["librosa"]
        if m.__spec__ is None or not hasattr(m, "__file__"):
            for attr in ("util", "filters", "feature"):
                if not hasattr(m, attr):
                    setattr(m, attr,
                            types.ModuleType(f"librosa.{attr}"))
    if "pySeqAlign" not in sys.modules:
        m = types.ModuleType("pySeqAlign")
        m.qmax = m.dmax = m.swconstrained = None   # never called
        stubs["pySeqAlign"] = m
    sys.modules.update(stubs)
    sys.path.insert(0, REF_DIR)
    try:
        mod = __import__(name)
    finally:
        sys.path.remove(REF_DIR)
        for k in stubs:
            sys.modules.pop(k, None)
        sys.modules.pop(name, None)   # keep our own namespace clean
    _REF_MODULES[name] = mod
    return mod


def reference_sw_aligner():
    """`swalignimpconstrained` with the `EarlySNF_Old.py:200` calling
    convention: D sized (M+1) * (N+1), unlike qmax/dmax's M * N."""
    compile_reference_aligners()   # populates _REF_LIB
    lib = _REF_LIB

    def call(csm):
        M, N = csm.shape
        S = np.ascontiguousarray(csm, dtype=np.uint8).ravel()
        D = np.zeros((M + 1) * (N + 1), dtype=np.float32)
        return float(lib.swalignimpconstrained(
            S.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            D.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), M, N))

    return call


# ---------------------------------------------------------------------------
# FTM2D (+ ablation variants): reference shingle math on shared
# beat-synced chroma
# ---------------------------------------------------------------------------

def ref_ftm2d_shingle(bt: np.ndarray, PWR: float = 1.96, WIN: int = 75,
                      C: float = 5.0, do_log: bool = True,
                      do_norm: bool = True, mode: str = "median",
                      PAD_LEN: int = 2000) -> np.ndarray:
    """The reference's per-song FTM2D shingle from a beat-synced (12, n)
    chroma, using the IMPORTED `chrompwr`/`btchroma_to_fftmat`
    (`FTM2D.py:9-48`) plus the ~10-line per-variant glue re-typed
    verbatim: median (`FTM2D.py:90-98`), noLog (`FTM2D_noLog.py:
    115-120`), noNorm (`FTM2D_noNorm.py:116-121`), noNormNoLog
    (`FTM2D_noNormNoLog.py:115-119`), zeropad (`FTM2D_zeroPad.py:
    99-108`) and zeropad+log (`FTM2D_zeroPadLog.py:108`).

    Shared input is the beat-synced median chroma (librosa.util.sync's
    output): librosa is absent from this image, so the sync itself is
    covered by the features-layer call-parameter audit (PARITY.md),
    while everything downstream — the part `FTM2D.py` itself defines —
    is compared here measured."""
    import scipy.fftpack

    F = load_reference_module("FTM2D")
    chroma = F.chrompwr(np.asarray(bt, np.float64), PWR)
    if mode == "zeropad":
        pad = np.zeros((12, PAD_LEN))
        if chroma.shape[1] > PAD_LEN:
            chroma = chroma[:, 0:PAD_LEN]
        pad[:, 0:chroma.shape[1]] = chroma
        flat = np.abs(scipy.fftpack.fft2(pad)).flatten()
        shingle = flat / (np.sqrt(np.sum(flat ** 2)))
        if do_log:
            shingle = np.log(flat / (np.sqrt(np.sum(flat ** 2))) + 1)
        return shingle
    shingles = F.btchroma_to_fftmat(chroma, WIN)
    if shingles is None:   # < WIN beats -> zero shingle (`FTM2D.py:88`)
        return np.zeros(12 * WIN)
    shingles = shingles.T
    if do_norm:
        Norm = np.sqrt(np.sum(shingles ** 2, 1))
        Norm[Norm == 0] = 1
        if do_log:
            shingles = np.log(C * shingles / Norm[:, None] + 1)
        else:
            shingles = C * shingles / Norm[:, None]
    elif do_log:
        shingles = np.log(C * shingles + 1)
    shingle = np.median(shingles, 0)
    shingle = shingle / np.sqrt(np.sum(shingle ** 2))
    return shingle


def ref_ftm2d_scores(shingles: np.ndarray) -> np.ndarray:
    """`FTM2D.similarity`'s exp(-dSqr) per-pair loop
    (`FTM2D.py:119-130`), fp64."""
    n = shingles.shape[0]
    D = np.zeros((n, n))
    for i in range(n):
        for j in range(i):
            D[i, j] = np.exp(-np.sum((shingles[i] - shingles[j]) ** 2))
    return D + D.T


# ---------------------------------------------------------------------------
# Simple (SiMPle matrix profile): reference scoring on shared descriptors
# ---------------------------------------------------------------------------

def simple_song(desc: dict, i: int) -> np.ndarray:
    """One song's Simple descriptor in the reference layout: (12, L)
    column-per-frame fp64 (`Simple.py:30-39` returns (d, n))."""
    n = int(desc["length"][i])
    return np.asarray(desc["feat"][i, :n], np.float64).T


def ref_simple_pair(Si: np.ndarray, Sj: np.ndarray,
                    sslen: int = 10) -> dict:
    """`Simple.similarity`'s per-pair body (`Simple.py:120-126`) running
    the IMPORTED `Simple.oti` + `Simple.simple_sim` (`Simple.py:41-117`)
    on an __init__-bypassed instance (the ctor needs the h5 datapath
    machinery; the two methods only read self.SSLEN)."""
    mod = load_reference_module("Simple")
    obj = object.__new__(mod.Simple)
    obj.SSLEN = sslen
    Sj_rolled, _ = mod.Simple.oti(obj, Si, Sj)
    return {"main": -mod.Simple.simple_sim(obj, Si, Sj_rolled)}


# ---------------------------------------------------------------------------
# EarlyFusion (EarlySNF_Old): reference scoring on shared descriptors
# ---------------------------------------------------------------------------

def earlyfusion_song(desc: dict, i: int) -> dict:
    n = int(desc["length"][i])
    return {
        "mfccs": np.asarray(desc["mfccs"][i, :n], np.float64),
        "ssms": np.asarray(desc["ssms"][i, :n], np.float64),
        "chromas": np.asarray(desc["chromas"][i, :n], np.float64),
        "chroma_med": np.asarray(desc["chroma_med"][i], np.float64),
    }


def ref_earlyfusion_pair(Si: dict, Sj: dict, kappa: float, K: int,
                         tie_inclusive: bool = False) -> dict:
    """`EarlySNF_Old.similarity`'s per-pair body
    (`EarlySNF_Old.py:188-233`) over imported CRPUtils +
    SimilarityFusion + the compiled `swalignimpconstrained`. The
    source's `getWCSM(CSM, self.K, self.K)` is the pre-rename spelling
    of `SimilarityFusion.get_WCSM` (same positional signature) — the
    bit-rotted name resolved the same way `acoss_jax`'s EarlyFusion
    resolves it (SURVEY.md §2.5 latent defects)."""
    C, SF = load_reference()
    sw = reference_sw_aligner()
    bin_, _ = _binarizers(tie_inclusive)
    CSMs = {}
    CSMs["mfccs"] = C.get_csm(Si["mfccs"], Sj["mfccs"])
    CSMs["ssms"] = C.get_csm(Si["ssms"], Sj["ssms"])
    CSMs["chromas"] = C.get_csm_blocked_oti(
        Si["chromas"], Sj["chromas"], Si["chroma_med"], Sj["chroma_med"],
        C.get_csm_cosine)
    scores = {s: sw(bin_(CSMs[s], kappa)) for s in CSMs}
    WCSM_sum = np.zeros_like(CSMs["mfccs"])
    for s in ("mfccs", "ssms", "chromas"):   # the source's dict order
        WCSM_sum += SF.get_WCSM(CSMs[s], K, K)
    WCSM_sum = np.exp(-WCSM_sum)
    scores["early"] = sw(bin_(WCSM_sum, kappa))
    return scores


def ref_earlyfusion_post(Ds: dict, late_K: int = 20,
                         late_niters: int = 20) -> dict:
    """`EarlySNF_Old.do_late_fusion` (`EarlySNF_Old.py:235-241`) over
    the imported reference SNF (`doSimilarityFusion` == the pre-rename
    `SimilarityFusion.snf`)."""
    _, SF = load_reference()
    out = dict(Ds)
    out["late"] = SF.snf(
        [1.0 / (1.0 + np.asarray(Ds[s], np.float64))
         for s in ("chromas", "ssms", "mfccs")],
        K=late_K, niters=late_niters, reg_diag=1, verbose_times=False)[1]
    out["early+late"] = SF.snf(
        [1.0 / (1.0 + np.asarray(Ds[s], np.float64))
         for s in ("chromas", "ssms", "mfccs", "early")],
        K=late_K, niters=late_niters, reg_diag=1, verbose_times=False)[1]
    return out
