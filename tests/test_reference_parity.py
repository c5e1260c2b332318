"""Ultimate kernel parity: compare our aligners against the REFERENCE'S OWN
C implementation, compiled from the read-only mount at test time and used
purely as an external oracle (no reference code enters this repo).

Skipped when the reference mount is absent (e.g. external CI).
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest

REF_C = "/root/reference/benchmarking/SequenceAlignment.c"


@pytest.fixture(scope="module")
def ref_lib(tmp_path_factory):
    if not os.path.exists(REF_C):
        pytest.skip("reference mount not available")
    so = str(tmp_path_factory.mktemp("ref") / "libref.so")
    try:
        subprocess.run(["gcc", "-O2", "-shared", "-fPIC", REF_C, "-o", so],
                       check=True, capture_output=True)
    except Exception:
        pytest.skip("cannot compile the reference kernel")
    lib = ctypes.CDLL(so)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    for name in ("qmax_c", "dmax_c", "swalignimpconstrained"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_float
        fn.argtypes = [u8p, f32p, ctypes.c_int, ctypes.c_int]
    return lib


def _ref_call(lib, name, S, extra_dp_row=False):
    M, N = S.shape
    S = np.ascontiguousarray(S, dtype=np.uint8)
    if extra_dp_row:   # swconstrained allocates (M+1)*(N+1)
        D = np.zeros((M + 1) * (N + 1), dtype=np.float32)
    else:
        D = np.zeros(M * N, dtype=np.float32)
    fn = getattr(lib, name)
    return float(fn(S.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    D.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    M, N))


@pytest.mark.parametrize("shape", [(16, 16), (64, 48), (48, 64), (80, 80)])
@pytest.mark.parametrize("density", [0.05, 0.095, 0.4])
def test_qmax_matches_reference_binary(ref_lib, rng, shape, density):
    from acoss_jax.ops import alignment
    S = (rng.random(shape) < density).astype(np.uint8)
    want = _ref_call(ref_lib, "qmax_c", S)
    got = float(alignment.qmax(S))
    assert got == pytest.approx(want, abs=1e-3)


@pytest.mark.parametrize("shape", [(16, 16), (64, 48), (48, 64)])
@pytest.mark.parametrize("density", [0.05, 0.095, 0.4])
def test_dmax_matches_reference_binary(ref_lib, rng, shape, density):
    from acoss_jax.ops import alignment
    S = (rng.random(shape) < density).astype(np.uint8)
    want = _ref_call(ref_lib, "dmax_c", S)
    got = float(alignment.dmax(S))
    assert got == pytest.approx(want, abs=1e-3)


@pytest.mark.parametrize("shape", [(16, 16), (64, 48), (48, 64)])
@pytest.mark.parametrize("density", [0.05, 0.095, 0.4])
def test_sw_matches_reference_binary(ref_lib, rng, shape, density):
    from acoss_jax.ops import alignment
    S = (rng.random(shape) < density).astype(np.uint8)
    want = _ref_call(ref_lib, "swalignimpconstrained", S,
                     extra_dp_row=True)
    got = float(alignment.swconstrained(S))
    assert got == pytest.approx(want, abs=1e-3)


def test_aligner_backend_matches_reference_binary(ref_lib, rng):
    """The dispatched qmax (the XLA scan on the CPU, the CUDA kernel on a
    GPU) against the reference's own C kernel."""
    from acoss_jax.ops import alignment
    S = (rng.random((48, 48)) < 0.15).astype(np.uint8)
    want = _ref_call(ref_lib, "qmax_c", S)
    got = float(alignment.qmax_batch_best(
        S[None], np.array([48]), np.array([48]))[0])
    assert got == pytest.approx(want, abs=1e-3)
