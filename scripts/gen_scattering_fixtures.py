"""Generate the committed golden fixtures for the scattering transforms
(tests/fixtures/scattering*.npz).

The oracle is an INDEPENDENT direct-space float64 implementation of the
same published Morlet scattering construction (Bruna & Mallat 2013 /
Anden & Mallat 2014, the construction kymatio implements —
`Serra09.py:16-22`): filters built from the closed-form Gabor/Morlet
formulas, convolution done by EXPLICIT periodic spatial convolution (no
FFT), modulus, Gaussian low-pass, subsampling. It shares no code with
`acoss_jax.ops.scattering` beyond the published formulas, so it catches
Fourier-domain indexing, pooling and channel-ordering bugs in the fast
jax path. Outputs are stored float64; the test compares the jax fp32
path against them at 1e-4.

Run: python scripts/gen_scattering_fixtures.py   (CPU, deterministic)
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "tests",
                       "fixtures")


# ---------------------------------------------------------------- 2D ----

def _gabor_2d(M, N, sigma, theta, xi, slant=0.5):
    R = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])
    D = np.array([[1.0, 0.0], [0.0, slant ** 2]])
    curv = R @ D @ R.T / (2 * sigma ** 2)
    gab = np.zeros((M, N), dtype=np.complex128)
    for ex in (-2, -1, 0, 1):
        for ey in (-2, -1, 0, 1):
            xx, yy = np.mgrid[ex * M:M + ex * M, ey * N:N + ey * N]
            arg = -(curv[0, 0] * xx ** 2
                    + (curv[0, 1] + curv[1, 0]) * xx * yy
                    + curv[1, 1] * yy ** 2) \
                + 1j * (xx * xi * np.cos(theta)
                        + yy * xi * np.sin(theta))
            gab += np.exp(arg)
    return gab / (2 * np.pi * sigma ** 2 / slant)


def _morlet_2d(M, N, sigma, theta, xi, slant=0.5):
    wv = _gabor_2d(M, N, sigma, theta, xi, slant)
    g = _gabor_2d(M, N, sigma, theta, 0.0, slant)
    return wv - (np.sum(wv) / np.sum(g)) * g


def _circ_conv2(x, h):
    """Explicit periodic 2D convolution (no FFT): out[u] =
    sum_v x[v] h[u - v mod]."""
    M, N = x.shape
    out = np.zeros((M, N), dtype=np.complex128)
    for du in range(M):
        for dv in range(N):
            out += x[du, dv] * np.roll(np.roll(h, du, 0), dv, 1)
    return out


def direct_scatter_2d(x, J, L):
    """Direct-space scattering with the published parametrization
    (sigma_j = 0.8 * 2^j, xi_j = 3pi/4 / 2^j, theta_l = (l+0.5)pi/L,
    phi = Gaussian at sigma 0.8 * 2^J); channel order: S0, S1 (j-major,
    l-minor), S2 for j1 ascending then j2 > j1 (l1-major, l2-minor)."""
    M, N = x.shape
    psis = {(j, l): _morlet_2d(M, N, 0.8 * 2 ** j, (l + 0.5) * np.pi / L,
                               0.75 * np.pi / 2 ** j)
            for j in range(J) for l in range(L)}
    phi = _gabor_2d(M, N, 0.8 * 2 ** J, 0.0, 0.0)

    def pool(u):
        return np.real(_circ_conv2(u, phi))[::2 ** J, ::2 ** J]

    outs = [pool(x)[None]]
    U1 = {}
    S1 = []
    for j in range(J):
        for l in range(L):
            U1[(j, l)] = np.abs(_circ_conv2(x, psis[(j, l)]))
            S1.append(pool(U1[(j, l)]))
    outs.append(np.stack(S1))
    S2 = []
    for j1 in range(J):
        for j2 in range(j1 + 1, J):
            for l1 in range(L):
                for l2 in range(L):
                    U2 = np.abs(_circ_conv2(U1[(j1, l1)],
                                            psis[(j2, l2)]))
                    S2.append(pool(U2))
    if S2:
        outs.append(np.stack(S2))
    return np.concatenate(outs, axis=0)


# ---------------------------------------------------------------- 1D ----

def _morlet_1d_f(T, xi, sigma):
    om = np.fft.fftfreq(T) * 2 * np.pi
    g = np.exp(-(om - xi) ** 2 / (2 * sigma ** 2))
    g0 = np.exp(-(om ** 2) / (2 * sigma ** 2))
    return g - np.exp(-(xi ** 2) / (2 * sigma ** 2)) * g0


def _circ_conv1(x, h_f):
    """Periodic 1D convolution with a FOURIER-domain filter, evaluated in
    direct space: h[n] = (1/T) sum_k h_f[k] e^{2 pi i k n / T}."""
    T = len(x)
    n = np.arange(T)
    h = (h_f[None, :] * np.exp(2j * np.pi * np.outer(n, np.arange(T))
                               / T)).sum(1) / T
    out = np.zeros(T, dtype=np.complex128)
    for d in range(T):
        out += x[d] * np.roll(h, d)
    return out


def direct_scatter_1d(x, J, Q):
    """Direct-space 1D scattering matching the documented bank:
    first order log-spaced (J*Q filters from xi_max = 0.35*2pi), second
    order octave-spaced, pairs xi2 < xi1/2, Gaussian phi at 2^-J."""
    T = len(x)
    xi_max = 0.35 * 2 * np.pi
    xis1 = xi_max * 2 ** (-np.arange(J * Q) / Q)
    r = 2 ** (1.0 / Q)
    sig1 = xis1 * (r - 1) / (r + 1) * 2
    xis2 = xi_max * 2.0 ** (-np.arange(J))
    sig2 = xis2 * (2 - 1) / (2 + 1) * 2
    om = np.fft.fftfreq(T) * 2 * np.pi
    phi_f = np.exp(-(om ** 2) / (2 * (xi_max * 2.0 ** (-J)) ** 2))

    def pool(u):
        return np.real(_circ_conv1(u, phi_f))[::2 ** J]

    U1 = [np.abs(_circ_conv1(x, _morlet_1d_f(T, xi, s)))
          for xi, s in zip(xis1, sig1)]
    outs = [pool(x)[None], np.stack([pool(u) for u in U1])]
    S2 = []
    for k1, u in enumerate(U1):
        for k2 in range(J):
            if xis2[k2] < xis1[k1] / 2:
                S2.append(pool(np.abs(_circ_conv1(
                    u, _morlet_1d_f(T, xis2[k2], sig2[k2])))))
    if S2:
        outs.append(np.stack(S2))
    return np.concatenate(outs, axis=0)


def main() -> int:
    os.makedirs(OUT_DIR, exist_ok=True)
    rng = np.random.default_rng(42)

    x2 = rng.random((16, 16))
    out2 = direct_scatter_2d(x2, J=2, L=4)
    np.savez(os.path.join(OUT_DIR, "scattering2d_16x16_J2_L4.npz"),
             x=x2, expected=out2, J=2, L=4)
    print("2D fixture:", out2.shape)

    x1 = rng.random(128)
    out1 = direct_scatter_1d(x1, J=3, Q=2)
    np.savez(os.path.join(OUT_DIR, "scattering1d_128_J3_Q2.npz"),
             x=x1, expected=out1, J=3, Q=2)
    print("1D fixture:", out1.shape)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
