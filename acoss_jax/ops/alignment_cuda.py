"""CUDA aligner kernels (qmax / dmax / constrained SW) for NVIDIA Hopper.

The XLA `lax.scan` in `alignment.py` runs one step per CRP row and
re-reads and re-writes its (B, N) fp32 row carries from device memory at
every step. `native/aligners_cuda.cu` instead gives each pair one thread
block that keeps the DP rows in registers, loops over all rows inside the
block, and reads the uint8 CRP once. It computes the scan's recurrences,
masks and fp32 operation order, so its scores equal the scan's and the
C++ oracle's exactly, for any S (nothing is assumed about the padding).

The library is compiled from the repository's source with `nvcc` for
`sm_90a` on first use, into `native/build/` (git-ignored), and its three
handlers are registered as XLA FFI targets for the CUDA platform. There
is no interpret mode: the CPU tests cover `prepare` (shapes, dtype,
padding) and the dispatch in `alignment.py`; the kernels are checked
against the oracle and the scan on the card (`tests/test_alignment_cuda.py`
under `-m gpu`, and `chip_smoke.py`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "aligners_cuda.cu")
_BUILD_DIR = os.path.join(_REPO_ROOT, "native", "build")
COL_MULTIPLE = 4     # columns per thread in the kernel
MAX_N = 4096         # 1024 threads x 4 columns per block
_TARGETS = {"acoss_qmax_cuda": "AcossQmax", "acoss_dmax_cuda": "AcossDmax",
            "acoss_sw_cuda": "AcossSw"}
_lock = threading.Lock()
_registered = False


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or (
        "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, CUDA_PATH); it "
                           "is needed to build the CUDA aligner kernels")
    return path


def library_path() -> str:
    """Path of the built library; the name carries the source's hash, so
    an edited source is rebuilt and never confused with a stale build."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"libacoss_aligners_{digest}.so")


def build() -> str:
    """Compile the kernels (if not built yet) and return the library path."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), _SRC, "-o", tmp]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(
            f"CUDA aligner build failed ({' '.join(cmd)}):\n{r.stderr}")
    os.replace(tmp, so)      # atomic: concurrent builders never see half
    return so


def register() -> None:
    """Build and register the FFI targets once per process."""
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.CDLL(build())
        for name, symbol in _TARGETS.items():
            jax.ffi.register_ffi_target(
                name, jax.ffi.pycapsule(getattr(lib, symbol)),
                platform="CUDA")
        _registered = True


def prepare(S, m_len, n_len):
    """The kernel's input contract: S as uint8 (..., M, N) with N padded
    with zero columns to a multiple of `COL_MULTIPLE`, and int32 lengths
    broadcast to S's batch shape and clipped to the UNPADDED (M, N) — so
    the padding columns are never valid cells. Binary S (bool, 0/1 float)
    converts exactly; the aligners' CRPs are binary."""
    S = jnp.asarray(S)
    if S.ndim < 2:
        raise ValueError(f"S must be (..., M, N), got shape {S.shape}")
    *batch, M, N = S.shape
    if N > MAX_N:
        raise ValueError(f"the CUDA aligners take N <= {MAX_N} columns, "
                         f"got {N}; use the XLA scan (alignment.*_batch)")
    if S.dtype != jnp.uint8:
        S = S.astype(jnp.uint8)
    pad = -N % COL_MULTIPLE
    if pad:
        S = jnp.pad(S, [(0, 0)] * (S.ndim - 1) + [(0, pad)])
    batch = tuple(batch)
    m = jnp.minimum(jnp.broadcast_to(jnp.asarray(m_len, jnp.int32), batch), M)
    n = jnp.minimum(jnp.broadcast_to(jnp.asarray(n_len, jnp.int32), batch), N)
    return S, m, n


def _call(target: str, S, m_len, n_len, **attrs):
    register()
    S, m, n = prepare(S, m_len, n_len)
    out = jax.ShapeDtypeStruct(S.shape[:-2], jnp.float32)
    res = jax.ffi.ffi_call(target, out, vmap_method="broadcast_all")(
        S, m, n, **{k: np.float32(v) for k, v in attrs.items()})
    # Inside shard_map the result varies over the inputs' manual axes,
    # as the scan's does (`lax.platform_dependent` needs equal types).
    vma = tuple(jax.typeof(S).vma | jax.typeof(m).vma | jax.typeof(n).vma)
    return jax.lax.pcast(res, vma, to="varying") if vma else res


def qmax_batch_cuda(S, m_len, n_len, gap: float = 0.5):
    """`alignment.qmax_batch` with gap_onset == gap_extension == gap."""
    return _call("acoss_qmax_cuda", S, m_len, n_len, gap=gap)


def dmax_batch_cuda(S, m_len, n_len, gap: float = 0.5):
    """`alignment.dmax_batch` with gap_onset == gap_extension == gap."""
    return _call("acoss_dmax_cuda", S, m_len, n_len, gap=gap)


def swconstrained_batch_cuda(S, m_len, n_len, gap_opening: float = -0.5,
                             gap_extension: float = -0.7,
                             match_score: float = 1.0,
                             mismatch_score: float = -1.0):
    """`alignment.swconstrained_batch`."""
    return _call("acoss_sw_cuda", S, m_len, n_len, gap_opening=gap_opening,
                 gap_extension=gap_extension, match_score=match_score,
                 mismatch_score=mismatch_score)
