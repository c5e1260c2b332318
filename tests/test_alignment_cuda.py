"""The aligner backends behind `alignment.*_batch_best`: parity with the
numpy DP oracle on each backend (the XLA scan here; the CUDA kernels on a
card, `-m gpu`), the dispatch rules, and the CUDA wrapper's input
contract (`alignment_cuda.prepare`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from acoss_jax import native
from acoss_jax.data.synthetic import make_random_crps
from acoss_jax.ops import alignment, alignment_cuda
from tests import oracles


def random_crp(rng, m, n, density=0.15):
    return (rng.random((m, n)) < density).astype(np.uint8)


def ragged(rng, sizes, M=40, N=40):
    S = np.zeros((len(sizes), M, N), dtype=np.uint8)
    for b, (m, n) in enumerate(sizes):
        S[b, :m, :n] = random_crp(rng, m, n)
    return S, np.array([s[0] for s in sizes]), np.array([s[1] for s in sizes])


@pytest.fixture(params=["xla", pytest.param("cuda", marks=pytest.mark.gpu)])
def backend(request):
    """Run the test on one aligner backend; the CUDA one needs a card."""
    if request.param == "cuda":
        request.getfixturevalue("gpu")
    return request.param


def one(fn, S, **kw):
    m, n = S.shape
    return float(fn(S[None], np.array([m]), np.array([n]), **kw)[0])


@pytest.mark.parametrize("shape", [(32, 32), (48, 40), (40, 48)])
def test_qmax_vs_oracle(rng, backend, shape):
    S = random_crp(rng, *shape)
    got = one(alignment.qmax_batch_best, S, backend=backend)
    assert got == pytest.approx(oracles.qmax_np(S), abs=1e-4)


@pytest.mark.parametrize("shape", [(32, 32), (48, 40), (40, 48)])
def test_dmax_vs_oracle(rng, backend, shape):
    S = random_crp(rng, *shape)
    got = one(alignment.dmax_batch_best, S, backend=backend)
    assert got == pytest.approx(oracles.dmax_np(S), abs=1e-4)


def test_ragged_batch(rng, backend):
    """Ragged lengths, including pairs below the DP's minimum size."""
    sizes = [(40, 40), (31, 36), (17, 23), (2, 10), (40, 33),
             (36, 40), (25, 25), (40, 40), (9, 40), (40, 9)]
    S, ml, nl = ragged(rng, sizes)
    got_q = np.asarray(alignment.qmax_batch_best(S, ml, nl, backend=backend))
    got_d = np.asarray(alignment.dmax_batch_best(S, ml, nl, backend=backend))
    want_q = [oracles.qmax_np(S[b, :m, :n]) for b, (m, n) in enumerate(sizes)]
    want_d = [oracles.dmax_np(S[b, :m, :n]) for b, (m, n) in enumerate(sizes)]
    np.testing.assert_allclose(got_q, want_q, atol=1e-4)
    np.testing.assert_allclose(got_d, want_d, atol=1e-4)


@pytest.mark.parametrize("shape", [(32, 32), (48, 40), (40, 48)])
def test_sw_vs_oracle(rng, backend, shape):
    S = random_crp(rng, *shape)
    got = one(alignment.swconstrained_batch_best, S, backend=backend)
    assert got == pytest.approx(oracles.swconstrained_np(S), abs=1e-4)


def test_sw_ragged(rng, backend):
    sizes = [(40, 40), (31, 36), (17, 23), (2, 10), (40, 9)]
    S, ml, nl = ragged(rng, sizes)
    got = np.asarray(alignment.swconstrained_batch_best(S, ml, nl,
                                                        backend=backend))
    want = [oracles.swconstrained_np(S[b, :m, :n])
            for b, (m, n) in enumerate(sizes)]
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_small_sizes_score_zero(rng, backend):
    """The early-outs: qmax / SW need m, n >= 3, dmax m, n >= 4."""
    sizes = [(2, 40), (40, 2), (3, 3), (3, 40), (40, 3), (0, 0)]
    S = np.ones((len(sizes), 40, 40), np.uint8)
    ml = np.array([s[0] for s in sizes])
    nl = np.array([s[1] for s in sizes])
    q = np.asarray(alignment.qmax_batch_best(S, ml, nl, backend=backend))
    d = np.asarray(alignment.dmax_batch_best(S, ml, nl, backend=backend))
    sw = np.asarray(alignment.swconstrained_batch_best(S, ml, nl,
                                                       backend=backend))
    np.testing.assert_array_equal(q[[0, 1, 5]], 0.0)
    np.testing.assert_array_equal(sw[[0, 1, 5]], 0.0)
    assert q[2] == 1.0 and sw[2] == 1.0      # the single cell (2, 2)
    np.testing.assert_array_equal(d, 0.0)


@pytest.mark.parametrize("go,ge", [(0.4, 0.8), (0.8, 0.4), (0.0, 0.7)])
def test_qmax_uneq_vs_oracle(rng, go, ge):
    """Unequal-gap qmax (the XLA scan) vs the numpy oracle, ragged."""
    sizes = [(40, 40), (31, 36), (17, 23), (2, 10), (40, 33), (25, 25)]
    S, ml, nl = ragged(rng, sizes)
    got = np.asarray(alignment.qmax_batch(S, ml, nl, gap_onset=go,
                                          gap_extension=ge))
    want = [oracles.qmax_np(S[b, :m, :n], go=go, ge=ge)
            for b, (m, n) in enumerate(sizes)]
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_qmax_uneq_dispatch(rng, backend):
    """qmax_batch_best serves unequal gaps with the XLA scan on every
    backend."""
    S = np.zeros((2, 32, 32), np.uint8)
    S[0, :30, :28] = random_crp(rng, 30, 28)
    S[1, :32, :32] = random_crp(rng, 32, 32)
    ml, nl = np.array([30, 32]), np.array([28, 32])
    got = np.asarray(alignment.qmax_batch_best(
        S, ml, nl, gap_onset=0.3, gap_extension=0.9, backend=backend))
    want = [oracles.qmax_np(S[0, :30, :28], go=0.3, ge=0.9),
            oracles.qmax_np(S[1], go=0.3, ge=0.9)]
    np.testing.assert_allclose(got, want, atol=1e-4)


# ------------------------------------------------------ backend choice

def _primitives(closed):
    """Names of every primitive in a jaxpr, sub-jaxprs included."""
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            out.append(eqn.primitive.name)
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else [v]):
                    if hasattr(sub, "jaxpr"):
                        walk(sub.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)
    walk(closed.jaxpr)
    return out


@pytest.fixture
def fake_gpu(monkeypatch):
    """A process that reports a GPU, with the FFI targets never built: the
    CUDA branch is traced, and lowering for the CPU drops it."""
    monkeypatch.setattr(alignment, "gpu_present", lambda: True)
    monkeypatch.setattr(alignment_cuda, "register", lambda: None)


@pytest.mark.parametrize("name", ["qmax", "dmax", "sw"])
def test_auto_traces_only_the_scan_without_a_gpu(name):
    assert not alignment.gpu_present()
    fn = {"qmax": alignment.qmax_batch_best, "dmax": alignment.dmax_batch_best,
          "sw": alignment.swconstrained_batch_best}[name]
    S = jnp.zeros((2, 8, 8), jnp.uint8)
    prims = _primitives(jax.make_jaxpr(fn)(S, 8, 8))
    assert "scan" in prims
    assert "ffi_call" not in prims and "platform_index" not in prims


@pytest.mark.parametrize("name", ["qmax", "dmax", "sw"])
def test_auto_picks_the_kernel_by_lowering_platform(fake_gpu, rng, name):
    """With a GPU in the process, "auto" stages both the kernel and the
    scan and lets lowering choose: a program run on the CPU gets the
    scan's values."""
    fn, scan = {
        "qmax": (alignment.qmax_batch_best, alignment.qmax_batch),
        "dmax": (alignment.dmax_batch_best, alignment.dmax_batch),
        "sw": (alignment.swconstrained_batch_best,
               alignment.swconstrained_batch)}[name]
    S, ml, nl = ragged(rng, [(40, 40), (31, 36), (17, 23)])
    prims = _primitives(jax.make_jaxpr(fn)(S, ml, nl))
    assert {"platform_index", "cond", "ffi_call", "scan"} <= set(prims)
    np.testing.assert_array_equal(np.asarray(jax.jit(fn)(S, ml, nl)),
                                  np.asarray(scan(S, ml, nl)))


def test_auto_inside_shard_map(fake_gpu, rng):
    """Both branches of "auto" have the same type inside shard_map: the
    kernel's result varies over the mesh axis like the scan's."""
    from jax.sharding import PartitionSpec as P

    n = len(jax.devices())
    S, ml, nl = ragged(rng, [(40, 40), (31, 36), (17, 23), (25, 25)] * n)
    mesh = jax.make_mesh((n,), ("x",))
    fn = jax.shard_map(alignment.dmax_batch_best, mesh=mesh,
                       in_specs=(P("x"),) * 3, out_specs=P("x"))
    np.testing.assert_array_equal(np.asarray(jax.jit(fn)(S, ml, nl)),
                                  np.asarray(alignment.dmax_batch(S, ml, nl)))


def test_cuda_backend_raises_off_gpu(rng):
    S = random_crp(rng, 8, 8)
    for fn in (alignment.qmax_batch_best, alignment.dmax_batch_best,
               alignment.swconstrained_batch_best):
        with pytest.raises(RuntimeError, match="needs a GPU"):
            fn(S[None], 8, 8, backend="cuda")


def test_unknown_backend_rejected():
    with pytest.raises(ValueError, match="unknown aligner backend"):
        alignment.qmax_batch_best(jnp.zeros((1, 8, 8)), 8, 8,
                                  backend="pallas")
    assert alignment.ALIGNER_BACKENDS == ("auto", "xla", "cuda")


@pytest.mark.parametrize("call,width,want", [
    ("qmax", 64, "cuda"),
    ("qmax_uneq", 64, "xla"),
    ("dmax", 64, "cuda"),
    ("dmax_uneq", 64, "xla"),
    ("sw", 64, "cuda"),
    ("qmax", alignment_cuda.MAX_N + 4, "xla"),
])
def test_dispatch_rules(fake_gpu, monkeypatch, call, width, want):
    """With the CUDA backend selected, equal-gap qmax/dmax and SW go to
    the kernels; unequal gaps and CRPs wider than a block take the scan."""
    used = []

    def fake(name):
        def f(S, m_len, n_len, **kw):
            used.append(("cuda", name))
            return jnp.zeros(S.shape[:-2], jnp.float32)
        return f

    for name in ("qmax", "dmax", "swconstrained"):
        monkeypatch.setattr(alignment_cuda, f"{name}_batch_cuda", fake(name))
    S = jnp.zeros((1, 8, width), jnp.uint8)
    fn = {"qmax": alignment.qmax_batch_best,
          "dmax": alignment.dmax_batch_best,
          "sw": alignment.swconstrained_batch_best}[call.split("_")[0]]
    kw = {"gap_onset": 0.3, "gap_extension": 0.9} if "uneq" in call else {}
    fn(S, 8, width, backend="cuda", **kw)
    assert (len(used) == 1) == (want == "cuda")


def test_algorithm_aligner_keys_the_sweep_programs():
    """An algorithm's `aligner` is part of the key of its cached sweep
    programs, so changing it never reuses a program traced for another
    backend."""
    from acoss_jax.benchmarking.algorithms import Serra09
    from acoss_jax.benchmarking.harness import _instance_jit

    algo = Serra09()
    assert algo.aligner == "auto"
    a = _instance_jit(algo, "tile_fn", object)
    assert _instance_jit(algo, "tile_fn", object) is a
    algo.aligner = "xla"
    assert _instance_jit(algo, "tile_fn", object) is not a


# ------------------------------------------- the CUDA wrapper's contract

@pytest.mark.parametrize("N", [4, 5, 7, 10])
def test_prepare_pads_columns(rng, N):
    S = random_crp(rng, 6, N)[None]
    Sp, m, n = alignment_cuda.prepare(S, 6, N + 3)
    assert Sp.dtype == jnp.uint8
    assert Sp.shape == (1, 6, -(-N // 4) * 4)
    np.testing.assert_array_equal(np.asarray(Sp)[..., :N], S)
    assert not np.asarray(Sp)[..., N:].any()
    # lengths clip to the UNPADDED width: padding columns are never valid
    assert int(n[0]) == N and int(m[0]) == 6


@pytest.mark.parametrize("dtype", [np.bool_, np.float32, np.int32])
def test_prepare_casts_binary_exactly(rng, dtype):
    S = random_crp(rng, 5, 8)
    Sp, _, _ = alignment_cuda.prepare(S.astype(dtype)[None], 5, 8)
    assert Sp.dtype == jnp.uint8
    np.testing.assert_array_equal(np.asarray(Sp)[0], S)


def test_prepare_broadcasts_lengths(rng):
    S = np.zeros((2, 3, 7, 8), np.uint8)
    Sp, m, n = alignment_cuda.prepare(S, 9, np.array([5, 6, 7]))
    assert Sp.shape == (2, 3, 7, 8)
    assert m.shape == n.shape == (2, 3) and m.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(m), 7)    # clipped to M
    np.testing.assert_array_equal(np.asarray(n), [[5, 6, 7]] * 2)


def test_prepare_rejects_wide_and_flat():
    with pytest.raises(ValueError, match="N <= 4096"):
        alignment_cuda.prepare(jnp.zeros((1, 2, 4100), jnp.uint8), 2, 2)
    with pytest.raises(ValueError, match=r"\(\.\.\., M, N\)"):
        alignment_cuda.prepare(jnp.zeros((8,), jnp.uint8), 2, 2)


def test_library_path_tracks_the_source():
    path = alignment_cuda.library_path()
    assert path.startswith(alignment_cuda._BUILD_DIR)
    assert path.endswith(".so") and "libacoss_aligners_" in path


# ------------------------------------------------------------- on a card

@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qmax", "dmax", "sw"])
def test_cuda_kernels_exact_at_bench_shape(gpu, name):
    """The kernels equal the XLA scan and the C++ oracle exactly."""
    S, ml, nl = make_random_crps(np.random.default_rng(1), 64, 512)
    kernel, scan, oracle = {
        "qmax": (alignment_cuda.qmax_batch_cuda, alignment.qmax_batch,
                 native.qmax_batch_cpu),
        "dmax": (alignment_cuda.dmax_batch_cuda, alignment.dmax_batch,
                 native.dmax_batch_cpu),
        "sw": (alignment_cuda.swconstrained_batch_cuda,
               alignment.swconstrained_batch,
               native.swconstrained_batch_cpu)}[name]
    got = np.asarray(jax.jit(kernel)(S, ml, nl))
    np.testing.assert_array_equal(got, np.asarray(jax.jit(scan)(S, ml, nl)))
    np.testing.assert_array_equal(got[:16], oracle(S[:16], ml[:16], nl[:16]))


@pytest.mark.gpu
def test_cuda_kernel_under_vmap_and_odd_width(gpu, rng):
    S = (rng.random((3, 2, 37, 45)) < 0.2).astype(np.uint8)
    got = jax.vmap(lambda s: alignment_cuda.dmax_batch_cuda(s, 37, 45))(S)
    want = alignment.dmax_batch(S.reshape(6, 37, 45), 37, 45).reshape(3, 2)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
