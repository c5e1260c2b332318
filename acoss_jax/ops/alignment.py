"""Batched row-streaming alignment kernels (qmax / dmax / constrained SW).

JAX re-design of the reference's C aligners
(`/root/reference/benchmarking/SequenceAlignment.c:73-180`, exposed via the
Cython module `pySeqAlign`, `pySeqAlign.pyx:7-23`). The C code fills an
M x N dynamic-programming table cell-by-cell.

Key structural observation: these recurrences have NO intra-row dependency —
every predecessor of cell (i, j) lives in rows i-1, i-2 (and i-3 for dmax):
    qmax:  (i-1,j-1), (i-2,j-1), (i-1,j-2)        (`:124-135`)
    dmax:  + (i-3,j-1), (i-1,j-3)                  (`:158-172`)
    sw:    (i-1,j-1), (i-2,j-1), (i-1,j-2)         (`:85-92`)
so a whole row is ONE vector op over shifted previous rows, and a batch of
pairs vectorizes on the (batch, column) axes. `lax.scan` runs over the M
rows; an anti-diagonal wavefront (the classic Smith-Waterman GPU trick) is
unnecessary here and would double the step count.

Inputs are padded to static (M, N); per-pair true lengths are passed
separately, and every DP cell outside (m_len, n_len) is masked to 0, so
the padding's content never reaches a score. The `*_batch_best`
dispatchers run the same recurrences as CUDA kernels on a GPU
(`alignment_cuda`), in the same fp32 operation order.

Semantics parity (vs `SequenceAlignment.c`):
- qmax (`:113-143`): match +1 else state-dependent gap penalty clamped at
  0; loops start at i,j >= 2; returns 0 when M < 3 or N < 3 (`:117`).
- dmax (`:147-180`): the long paths accumulate the intermediate S values
  they skip; loops start at i,j >= 3; returns 0 when M < 4 or N < 4.
- swconstrained (`:73-99`): +-1 match with affine Delta gaps (opening -0.5,
  extension -0.7); the C code's offset (N+1)x(M+1) table is equivalent to
  the 0-based recurrence here; returns 0 when M < 3 or N < 3.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from acoss_jax.ops import alignment_cuda


def _shift(x: jax.Array, k: int) -> jax.Array:
    """shift(x, k)[..., j] = x[..., j - k], zeros shifted in at the front."""
    if k == 0:
        return x
    pad = [(0, 0)] * (x.ndim - 1) + [(k, 0)]
    return jnp.pad(x, pad)[..., : x.shape[-1]]


def _prep(S, m_len, n_len):
    S = jnp.asarray(S)
    if S.ndim == 2:
        S = S[None]
    B, M, N = S.shape
    m_len = jnp.broadcast_to(jnp.asarray(m_len, jnp.int32), (B,))
    n_len = jnp.broadcast_to(jnp.asarray(n_len, jnp.int32), (B,))
    rows = jnp.moveaxis(S, 1, 0)  # (M, B, N) — scan consumes rows
    xs = (rows, jnp.arange(M, dtype=jnp.int32))
    # Derive the zero carries from the inputs so they inherit any shard_map
    # varying-manual-axes provenance (scan carry types must match).
    z = (S[:, 0, :] * 0).astype(jnp.float32)        # (B, N) zeros
    return xs, B, M, N, m_len, n_len, z


@functools.partial(jax.jit, static_argnames=("gap_onset", "gap_extension"))
def qmax_batch(
    S: jax.Array,
    m_len: jax.Array,
    n_len: jax.Array,
    gap_onset: float = 0.5,
    gap_extension: float = 0.5,
) -> jax.Array:
    """Batched Serra 2009 Qmax scores.

    Args:
      S: (B, M, N) binary CRP (uint8/float), zero outside (m_len, n_len).
      m_len, n_len: (B,) true row/col counts.
      gap_onset / gap_extension: penalty after a match / after a gap
        (both 0.5 in the reference, `SequenceAlignment.c:104-111`).

    Returns: (B,) float32 max-cell scores (unnormalized, like the C kernel;
    callers divide by m_len + n_len as in `Serra09.py:174`).
    """
    xs, B, M, N, m_len, n_len, z = _prep(S, m_len, n_len)
    const_gap = gap_onset == gap_extension
    colmask = (jnp.arange(N) >= 2)[None, :] & (
        jnp.arange(N)[None, :] < n_len[:, None])

    def step(carry, x):
        # A = D row i-1, B2 = D row i-2; GA/GB = gamma(S) of those rows.
        A, B2, GA, GB, best = carry
        srow, i = x
        sd = srow.astype(jnp.float32)
        p1 = _shift(A, 1)    # (i-1, j-1)
        p2 = _shift(B2, 1)   # (i-2, j-1)
        p3 = _shift(A, 2)    # (i-1, j-2)
        if const_gap:
            pre = jnp.maximum(jnp.maximum(p1, p2), p3)
            match = pre + 1.0
            gap = jnp.maximum(pre - gap_extension, 0.0)
            Gd = z
        else:
            match = jnp.maximum(jnp.maximum(p1, p2), p3) + 1.0
            gap = jnp.maximum(
                jnp.maximum(
                    jnp.maximum(p1 - _shift(GA, 1), p2 - _shift(GB, 1)),
                    p3 - _shift(GA, 2)),
                0.0)
            Gd = jnp.where(sd > 0, gap_onset, gap_extension)
        Dd = jnp.where(sd > 0, match, gap)
        valid = colmask & ((i >= 2) & (i < m_len))[:, None]
        Dd = jnp.where(valid, Dd, 0.0)
        best = jnp.maximum(best, jnp.max(Dd, axis=-1))
        return (Dd, A, Gd, GA, best), None

    init = (z, z, z, z, z[:, 0])
    (*_, best), _ = jax.lax.scan(step, init, xs)
    ok = (m_len >= 3) & (n_len >= 3)
    return jnp.where(ok, best, 0.0)


@functools.partial(jax.jit, static_argnames=("gap_onset", "gap_extension"))
def dmax_batch(
    S: jax.Array,
    m_len: jax.Array,
    n_len: jax.Array,
    gap_onset: float = 0.5,
    gap_extension: float = 0.5,
) -> jax.Array:
    """Batched Chen 2017 Dmax scores (`SequenceAlignment.c:147-180`).

    Five predecessors; the (i-2,j-1)/(i-1,j-2)/(i-3,j-1)/(i-1,j-3) paths
    accumulate the intermediate S values they skip over.
    """
    xs, B, M, N, m_len, n_len, z = _prep(S, m_len, n_len)

    colmask = (jnp.arange(N) >= 3)[None, :] & (
        jnp.arange(N)[None, :] < n_len[:, None])

    def gamma(s):
        return jnp.where(s > 0, gap_onset, gap_extension)

    def step(carry, x):
        # A/B2/B3 = D rows i-1, i-2, i-3; SA/SB/SC = S rows i-1, i-2, i-3.
        A, B2, B3, SA, SB, SC, best = carry
        srow, i = x
        sd = srow.astype(jnp.float32)
        p1 = _shift(A, 1)                      # D[i-1, j-1]
        p2 = _shift(B2, 1) + SA                # D[i-2, j-1] + S[i-1, j]
        p3 = _shift(A, 2) + _shift(sd, 1)      # D[i-1, j-2] + S[i, j-1]
        p4 = _shift(B3, 1) + SB + SA           # D[i-3,j-1]+S[i-2,j]+S[i-1,j]
        p5 = _shift(A, 3) + _shift(sd, 2) + _shift(sd, 1)
        m5 = jnp.maximum(jnp.maximum(jnp.maximum(p1, p2), p3),
                         jnp.maximum(p4, p5))
        match = m5 + 1.0
        gap = jnp.maximum(
            jnp.maximum(
                jnp.maximum(p1 - gamma(_shift(SA, 1)),
                            p2 - gamma(_shift(SB, 1))),
                jnp.maximum(p3 - gamma(_shift(SA, 2)),
                            p4 - gamma(_shift(SC, 1)))),
            jnp.maximum(p5 - gamma(_shift(SA, 3)), 0.0))
        Dd = jnp.where(sd > 0, match, gap)
        valid = colmask & ((i >= 3) & (i < m_len))[:, None]
        Dd = jnp.where(valid, Dd, 0.0)
        best = jnp.maximum(best, jnp.max(Dd, axis=-1))
        return (Dd, A, B2, sd, SA, SB, best), None

    init = (z, z, z, z, z, z, z[:, 0])
    (*_, best), _ = jax.lax.scan(step, init, xs)
    ok = (m_len >= 4) & (n_len >= 4)
    return jnp.where(ok, best, 0.0)


@functools.partial(jax.jit, static_argnames=(
    "gap_opening", "gap_extension", "match_score", "mismatch_score"))
def swconstrained_batch(
    S: jax.Array,
    m_len: jax.Array,
    n_len: jax.Array,
    gap_opening: float = -0.5,
    gap_extension: float = -0.7,
    match_score: float = 1.0,
    mismatch_score: float = -1.0,
) -> jax.Array:
    """Batched constrained Smith-Waterman (`SequenceAlignment.c:73-99`).

    0-based recurrence equivalent to the C code's offset (N+1)x(M+1) table:
    for a, b >= 2:
      MS = S[a,b] ? match : mismatch
      D[a,b] = max(0, max over preds p in {(a-1,b-1),(a-2,b-1),(a-1,b-2)} of
                   D[p] + MS + Delta(S[p], S[a,b]))
    Delta(prev, cur) = 0 if cur > 0 else (gap_opening if prev > 0
                                          else gap_extension)   (`:43-54`).
    """
    xs, B, M, N, m_len, n_len, z = _prep(S, m_len, n_len)
    colmask = (jnp.arange(N) >= 2)[None, :] & (
        jnp.arange(N)[None, :] < n_len[:, None])

    def step(carry, x):
        A, B2, SA, SB, best = carry
        srow, i = x
        sd = srow.astype(jnp.float32)
        cur_match = sd > 0
        ms = jnp.where(cur_match, match_score, mismatch_score)

        def delta(sprev):
            return jnp.where(
                cur_match, 0.0,
                jnp.where(sprev > 0, gap_opening, gap_extension))

        d1 = _shift(A, 1) + ms + delta(_shift(SA, 1))
        d2 = _shift(B2, 1) + ms + delta(_shift(SB, 1))
        d3 = _shift(A, 2) + ms + delta(_shift(SA, 2))
        Dd = jnp.maximum(jnp.maximum(jnp.maximum(d1, d2), d3), 0.0)
        valid = colmask & ((i >= 2) & (i < m_len))[:, None]
        Dd = jnp.where(valid, Dd, 0.0)
        best = jnp.maximum(best, jnp.max(Dd, axis=-1))
        return (Dd, A, sd, SA, best), None

    init = (z, z, z, z, z[:, 0])
    (*_, best), _ = jax.lax.scan(step, init, xs)
    ok = (m_len >= 3) & (n_len >= 3)
    return jnp.where(ok, best, 0.0)


def _single(batch_fn):
    def fn(S, m_len=None, n_len=None, **kw):
        S = jnp.asarray(S)
        M, N = S.shape
        m = M if m_len is None else m_len
        n = N if n_len is None else n_len
        return batch_fn(S[None], jnp.array([m]), jnp.array([n]), **kw)[0]

    return fn


qmax = _single(qmax_batch)
qmax.__doc__ = "Single-pair qmax; see `qmax_batch`."
dmax = _single(dmax_batch)
dmax.__doc__ = "Single-pair dmax; see `dmax_batch`."
swconstrained = _single(swconstrained_batch)
swconstrained.__doc__ = "Single-pair constrained SW; see `swconstrained_batch`."


# Aligner backends of the *_best dispatchers, chosen per call with the
# `backend` argument (a Python value, so it is part of what jit traces;
# the algorithms pass their `aligner` attribute):
#   "auto" — the CUDA kernels (`alignment_cuda`) where the computation is
#            lowered for a CUDA device, the XLA scan on any other platform
#            (`lax.platform_dependent`, resolved at lowering);
#   "xla"  — always the XLA scan;
#   "cuda" — always the CUDA kernels; an error off a GPU.
ALIGNER_BACKENDS = ("auto", "xla", "cuda")


@functools.cache
def gpu_present() -> bool:
    """Whether this process has a CUDA backend. Without one, "auto" traces
    the scan alone, so the kernels are never built."""
    try:
        return bool(jax.devices("gpu"))
    except RuntimeError:
        return False


def _dispatch(backend: str, kernel, scan, S, m_len, n_len):
    """`kernel` or `scan` of (S, m_len, n_len) as `backend` says; `kernel`
    None means the case has no kernel."""
    if backend not in ALIGNER_BACKENDS:
        raise ValueError(f"unknown aligner backend {backend!r}; expected "
                         f"one of {ALIGNER_BACKENDS}")
    S = jnp.asarray(S)
    if S.ndim == 2:
        S = S[None]
    # The kernel's block holds at most MAX_N columns; wider CRPs take the
    # scan (no aligner caller pads that wide).
    if (backend == "xla" or kernel is None
            or S.shape[-1] > alignment_cuda.MAX_N):
        return scan(S, m_len, n_len)
    if not gpu_present():
        if backend == "cuda":
            raise RuntimeError("aligner backend 'cuda' needs a GPU; JAX "
                               "found none in this process")
        return scan(S, m_len, n_len)
    if backend == "cuda":
        return kernel(S, m_len, n_len)
    return jax.lax.platform_dependent(S, m_len, n_len, cuda=kernel,
                                      default=scan)


def qmax_batch_best(S, m_len, n_len, gap_onset: float = 0.5,
                    gap_extension: float = 0.5, backend: str = "auto"):
    """qmax on the aligner `backend` (see `ALIGNER_BACKENDS`). The CUDA
    kernel takes the equal-gap case (the reference's values); unequal gaps
    run the XLA scan on every backend."""
    kernel = (functools.partial(alignment_cuda.qmax_batch_cuda,
                                gap=gap_onset)
              if gap_onset == gap_extension else None)
    scan = functools.partial(qmax_batch, gap_onset=gap_onset,
                             gap_extension=gap_extension)
    return _dispatch(backend, kernel, scan, S, m_len, n_len)


def dmax_batch_best(S, m_len, n_len, gap_onset: float = 0.5,
                    gap_extension: float = 0.5, backend: str = "auto"):
    """dmax on the aligner `backend` (see `qmax_batch_best`)."""
    kernel = (functools.partial(alignment_cuda.dmax_batch_cuda,
                                gap=gap_onset)
              if gap_onset == gap_extension else None)
    scan = functools.partial(dmax_batch, gap_onset=gap_onset,
                             gap_extension=gap_extension)
    return _dispatch(backend, kernel, scan, S, m_len, n_len)


def swconstrained_batch_best(S, m_len, n_len, gap_opening: float = -0.5,
                             gap_extension: float = -0.7,
                             match_score: float = 1.0,
                             mismatch_score: float = -1.0,
                             backend: str = "auto"):
    """Constrained SW on the aligner `backend` (see `ALIGNER_BACKENDS`)."""
    kw = dict(gap_opening=gap_opening, gap_extension=gap_extension,
              match_score=match_score, mismatch_score=mismatch_score)
    return _dispatch(
        backend, functools.partial(alignment_cuda.swconstrained_batch_cuda,
                                   **kw),
        functools.partial(swconstrained_batch, **kw), S, m_len, n_len)
