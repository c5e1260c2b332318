"""ctypes bridge to the native C++ runtime pieces (build-on-demand).

The reference shipped its aligners as a Cython extension built in-place
(`/root/reference/benchmarking/setup.py:45-74`). Here the native library is a
plain C++ shared object compiled on first use with g++ and loaded via ctypes;
it provides the CPU golden oracle / baseline for the device aligners.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_REPO_ROOT, "native", "alignment_cpu.cpp")
_SO = os.path.join(_REPO_ROOT, "native", "libacoss_cpu.so")
_lock = threading.Lock()
_lib = None


def _build() -> None:
    cmd = [
        "g++", "-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC",
        _SRC, "-o", _SO,
    ]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        # surface the compiler diagnostic — a bare CalledProcessError
        # ('exit status 1') from an implicit mid-benchmark build is
        # undebuggable
        raise RuntimeError(
            f"native build failed ({' '.join(cmd)}):\n{r.stderr}")


def get_lib() -> ctypes.CDLL:
    """Load (building if needed) the native CPU alignment library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_SO)) or (
            os.path.getmtime(_SO) < os.path.getmtime(_SRC)
        ):
            _build()
        lib = ctypes.CDLL(_SO)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.acoss_qmax.restype = ctypes.c_float
        lib.acoss_qmax.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_float, ctypes.c_float]
        lib.acoss_dmax.restype = ctypes.c_float
        lib.acoss_dmax.argtypes = lib.acoss_qmax.argtypes
        lib.acoss_swconstrained.restype = ctypes.c_float
        lib.acoss_swconstrained.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float]
        lib.acoss_qmax_batch.restype = None
        lib.acoss_qmax_batch.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            i32p, i32p, ctypes.c_float, ctypes.c_float, f32p]
        lib.acoss_dmax_batch.restype = None
        lib.acoss_dmax_batch.argtypes = lib.acoss_qmax_batch.argtypes
        lib.acoss_swconstrained_batch.restype = None
        lib.acoss_swconstrained_batch.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            i32p, i32p, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, f32p]
        _lib = lib
        return _lib


def _as_u8(S: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(S, dtype=np.uint8)


def qmax_cpu(S: np.ndarray, gap_onset: float = 0.5,
             gap_extension: float = 0.5) -> float:
    """Single-pair qmax on the CPU (golden oracle)."""
    S = _as_u8(S)
    M, N = S.shape
    lib = get_lib()
    return float(lib.acoss_qmax(
        S.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), M, N,
        gap_onset, gap_extension))


def dmax_cpu(S: np.ndarray, gap_onset: float = 0.5,
             gap_extension: float = 0.5) -> float:
    S = _as_u8(S)
    M, N = S.shape
    lib = get_lib()
    return float(lib.acoss_dmax(
        S.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), M, N,
        gap_onset, gap_extension))


def swconstrained_cpu(S: np.ndarray, gap_opening: float = -0.5,
                      gap_extension: float = -0.7,
                      match_score: float = 1.0,
                      mismatch_score: float = -1.0) -> float:
    S = _as_u8(S)
    M, N = S.shape
    lib = get_lib()
    return float(lib.acoss_swconstrained(
        S.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), M, N,
        gap_opening, gap_extension, match_score, mismatch_score))


def qmax_batch_cpu(S: np.ndarray, m_len: np.ndarray, n_len: np.ndarray,
                   gap_onset: float = 0.5,
                   gap_extension: float = 0.5) -> np.ndarray:
    """Batched qmax on the CPU; S is (B, M, N) zero-padded."""
    S = _as_u8(S)
    B, M, N = S.shape
    m = np.ascontiguousarray(m_len, dtype=np.int32)
    n = np.ascontiguousarray(n_len, dtype=np.int32)
    out = np.zeros(B, dtype=np.float32)
    lib = get_lib()
    lib.acoss_qmax_batch(
        S.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), B, M, N,
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        gap_onset, gap_extension,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def dmax_batch_cpu(S: np.ndarray, m_len: np.ndarray, n_len: np.ndarray,
                   gap_onset: float = 0.5,
                   gap_extension: float = 0.5) -> np.ndarray:
    S = _as_u8(S)
    B, M, N = S.shape
    m = np.ascontiguousarray(m_len, dtype=np.int32)
    n = np.ascontiguousarray(n_len, dtype=np.int32)
    out = np.zeros(B, dtype=np.float32)
    lib = get_lib()
    lib.acoss_dmax_batch(
        S.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), B, M, N,
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        gap_onset, gap_extension,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def swconstrained_batch_cpu(S: np.ndarray, m_len: np.ndarray,
                            n_len: np.ndarray,
                            gap_opening: float = -0.5,
                            gap_extension: float = -0.7,
                            match_score: float = 1.0,
                            mismatch_score: float = -1.0) -> np.ndarray:
    S = _as_u8(S)
    B, M, N = S.shape
    m = np.ascontiguousarray(m_len, dtype=np.int32)
    n = np.ascontiguousarray(n_len, dtype=np.int32)
    out = np.zeros(B, dtype=np.float32)
    lib = get_lib()
    lib.acoss_swconstrained_batch(
        S.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), B, M, N,
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        gap_opening, gap_extension, match_score, mismatch_score,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
