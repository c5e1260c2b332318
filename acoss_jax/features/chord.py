"""Chord-template HMM chroma — the `crema` slot's chord-aware substitute.

The reference fills the `crema` feature with the CREMA chord model's
chord-pitch posteriors (`/root/reference/preprocess/features.py:277-296`):
a 12-dim per-frame output whose energy concentrates on the pitch classes
of the active CHORD, i.e. a temporally-smoothed, harmony-quantized
chroma. No pretrained chord model ships in this image, so we build the
classical template equivalent: major/minor triad templates + a no-chord
state, cosine emission scores over CQT chroma, and forward-backward
posterior smoothing under a sticky transition prior. The output is the
posterior-weighted mixture of chord templates — like CREMA's output, it
snaps noisy chroma onto chord pitch classes and is transposition-covariant
(rolling the input chroma rolls the output).

Design: the emission scores are one matmul; the forward-backward
recursions are `lax.scan`s in log space over bucket-padded frames (padding
is EXACT: pad frames carry uniform emissions and the transition matrix is
symmetric, so padded-region messages stay uniform and do not perturb valid
posteriors). One compile per frame bucket.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

FRAME_BUCKET = 2048


def chord_templates(harmonic_bleed: float = 0.0) -> np.ndarray:
    """(25, 12) templates: 12 major + 12 minor triads (root, third,
    fifth) + a uniform no-chord state; rows unit-normalized."""
    T = np.zeros((25, 12), np.float32)
    for root in range(12):
        for q, third in enumerate((4, 3)):
            row = np.zeros(12, np.float32)
            row[root] = 1.0
            row[(root + third) % 12] = 1.0
            row[(root + 7) % 12] = 1.0
            if harmonic_bleed:
                row[(root + 7) % 12] += harmonic_bleed      # 3rd harmonic
                row[(root + 4) % 12] += harmonic_bleed / 2  # 5th harmonic
            T[2 * root + q] = row
    T[24] = 1.0
    return T / np.linalg.norm(T, axis=1, keepdims=True)


@functools.partial(jax.jit, static_argnames=())
def _chord_posteriors_padded(chroma: jax.Array, templates: jax.Array,
                             log_trans: jax.Array,
                             temperature: jax.Array,
                             valid: jax.Array) -> jax.Array:
    """Forward-backward chord posteriors. chroma (T, 12) bucket-padded,
    valid (T,) mask; returns gamma (T, C)."""
    # Pearson correlation emissions (Krumhansl-style): centering kills the
    # flat no-chord template's unfair advantage on noisy frames — it
    # scores exactly 0 and wins only when no chord correlates.
    cc = chroma - jnp.mean(chroma, axis=1, keepdims=True)
    nrm = jnp.sqrt(jnp.sum(cc * cc, axis=1, keepdims=True))
    unit = cc / jnp.where(nrm > 0, nrm, 1.0)
    tc = templates - jnp.mean(templates, axis=1, keepdims=True)
    tn = jnp.sqrt(jnp.sum(tc * tc, axis=1, keepdims=True))
    tu = tc / jnp.where(tn > 0, tn, 1.0)
    # fp32 on the GPU (no TF32): the /temperature amplifies input rounding
    logits = jnp.matmul(unit, tu.T, precision="highest") / temperature
    C = templates.shape[0]
    # padded frames -> uniform emissions (exactness: see module docstring)
    logits = jnp.where(valid[:, None], logits, 0.0)
    log_emis = jax.nn.log_softmax(logits, axis=1)

    def fwd(alpha, le):
        a = jax.nn.logsumexp(alpha[:, None] + log_trans, axis=0) + le
        return a, a

    a0 = -jnp.log(float(C)) + log_emis[0]
    _, alphas = jax.lax.scan(fwd, a0, log_emis[1:])
    alphas = jnp.concatenate([a0[None], alphas], axis=0)

    def bwd(beta, le):
        b = jax.nn.logsumexp(log_trans + (le + beta)[None, :], axis=1)
        return b, b

    bT = jnp.zeros(C)
    _, betas = jax.lax.scan(bwd, bT, log_emis[1:][::-1])
    betas = jnp.concatenate([betas[::-1], bT[None]], axis=0)

    lg = alphas + betas
    return jax.nn.softmax(lg, axis=1)                       # (T, C)


def chord_posteriors(chroma: np.ndarray, self_prob: float = 0.97,
                     temperature: float = 0.08,
                     templates: np.ndarray | None = None) -> np.ndarray:
    """Posterior chord probabilities (T, 25) for a chroma sequence."""
    chroma = np.asarray(chroma, np.float32)
    T = chroma.shape[0]
    Tp = max(-(-T // FRAME_BUCKET) * FRAME_BUCKET, FRAME_BUCKET)
    padded = np.zeros((Tp, chroma.shape[1]), np.float32)
    padded[:T] = chroma
    valid = np.zeros(Tp, bool)
    valid[:T] = True
    tmpl = templates if templates is not None else chord_templates()
    C = tmpl.shape[0]
    trans = np.full((C, C), (1.0 - self_prob) / (C - 1), np.float32)
    np.fill_diagonal(trans, self_prob)
    gamma = _chord_posteriors_padded(
        jnp.asarray(padded), jnp.asarray(tmpl),
        jnp.asarray(np.log(trans)), jnp.float32(temperature),
        jnp.asarray(valid))
    return np.asarray(gamma, np.float32)[:T]


def chord_chroma(chroma: np.ndarray, self_prob: float = 0.97,
                 temperature: float = 0.08) -> np.ndarray:
    """Chord-pitch chroma (T, 12): posterior-weighted chord templates
    (the CREMA chord_pitch analog, `features.py:277-296`). The no-chord
    posterior spreads uniformly, which its (uniform) template already
    encodes."""
    tmpl = chord_templates()
    gamma = chord_posteriors(chroma, self_prob, temperature, tmpl)
    out = gamma @ tmpl
    mx = out.max(axis=1, keepdims=True)
    return (out / np.where(mx > 0, mx, 1.0)).astype(np.float32)


def crema_substitute(y: np.ndarray, sr: int = 44100,
                     hop_length: int = 512) -> np.ndarray:
    """The pipeline's `crema` feature: CQT chroma -> chord-template HMM
    posterior smoothing -> chord-pitch chroma (T, 12)."""
    from acoss_jax.features.chroma import chroma_cqt
    return chord_chroma(chroma_cqt(y, sr, hop_length))
