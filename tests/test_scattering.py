"""Scattering transform properties: kymatio-compatible output geometry,
approximate translation invariance, and texture discriminability."""

import numpy as np
import pytest

from acoss_jax.ops.resize import resize
from acoss_jax.ops.scattering import Scattering1D, Scattering2D


@pytest.fixture(scope="module")
def sc2d():
    return Scattering2D(shape=(64, 64), J=2, L=8)


def test_scattering2d_shape(sc2d, rng):
    x = rng.random((64, 64)).astype(np.float32)
    out = np.asarray(sc2d(x))
    assert out.shape == (81, 16, 16)   # 1 + 2*8 + 64, 64/2^2
    b = rng.random((3, 64, 64)).astype(np.float32)
    assert np.asarray(sc2d(b)).shape == (3, 81, 16, 16)


def test_scattering2d_translation_stability(sc2d, rng):
    x = np.zeros((64, 64), dtype=np.float32)
    x[20:30, 20:30] = 1.0
    y = np.roll(x, (2, 2), axis=(0, 1))
    sx = np.asarray(sc2d(x)).ravel()
    sy = np.asarray(sc2d(y)).ravel()
    base = np.linalg.norm(sx)
    # scattering stability bound: ||S(x) - S(T_c x)|| <~ (c / 2^J) ||x||;
    # c=2, J=2 -> 0.5
    assert np.linalg.norm(sx - sy) < 0.5 * base
    # but a structurally different image is far
    z = rng.random((64, 64)).astype(np.float32)
    sz = np.asarray(sc2d(z)).ravel()
    assert np.linalg.norm(sx - sz) > np.linalg.norm(sx - sy) * 1.5


def test_scattering1d_shape(rng):
    T = 2 ** 10
    sc = Scattering1D(4, T, 4)
    x = rng.random(T).astype(np.float32)
    out = np.asarray(sc.scattering(x))
    assert out.shape[-1] == T // 2 ** 4
    assert out.shape[-2] > 1 + 4 * 4   # order 0 + order 1 + some order 2
    b = rng.random((5, T)).astype(np.float32)
    assert np.asarray(sc(b)).shape == (5,) + out.shape


def test_scattering1d_shift_stability(rng):
    T = 2 ** 10
    sc = Scattering1D(5, T, 4)
    x = np.zeros(T, dtype=np.float32)
    x[100:200] = np.sin(np.arange(100) * 0.3)
    y = np.roll(x, 8)
    sx = np.asarray(sc(x)).ravel()
    sy = np.asarray(sc(y)).ravel()
    # c=8, J=5 -> bound 0.25
    assert np.linalg.norm(sx - sy) < 0.3 * np.linalg.norm(sx)


def test_resize_matches_mean_on_constant(rng):
    img = np.full((100, 80), 3.5, dtype=np.float32)
    out = np.asarray(resize(img, (64, 64)))
    np.testing.assert_allclose(out, 3.5, rtol=1e-5)


def test_resize_downscale_antialias(rng):
    # high-frequency checkerboard must not alias to a constant-free image
    img = (np.indices((128, 128)).sum(0) % 2).astype(np.float32)
    out = np.asarray(resize(img, (16, 16)))
    assert abs(out.mean() - 0.5) < 0.05
    assert out.std() < 0.2   # smoothed, not aliased stripes
    up = np.asarray(resize(np.eye(8, dtype=np.float32), (32, 32),
                           anti_aliasing=False))
    assert up.shape == (32, 32)
    assert up.max() <= 1.0 + 1e-5


def test_scattering2d_subsampled_matches_full_res(rng):
    """The reduced-resolution pipeline (kymatio-style U1 decimation +
    sum-periodized filters) matches the full-resolution path: S0 is an
    EXACT fold-decimation identity, band-pass paths differ only by the
    periodized filter tail (<~2% per path)."""
    from acoss_jax.ops.scattering import Scattering2D

    x = rng.random((2, 128, 128)).astype(np.float32)
    full = np.asarray(Scattering2D((128, 128), J=3, L=4,
                                   subsample=False)(x))
    sub = np.asarray(Scattering2D((128, 128), J=3, L=4,
                                  subsample=True)(x))
    assert full.shape == sub.shape
    np.testing.assert_allclose(sub[:, 0], full[:, 0], rtol=1e-4,
                               atol=1e-6)
    num = np.linalg.norm((full - sub).reshape(-1, full.shape[1],
                                              16 * 16), axis=-1)
    den = np.linalg.norm(full.reshape(-1, full.shape[1], 16 * 16),
                         axis=-1) + 1e-12
    assert (num / den).max() < 0.05


def test_scattering2d_subsample_auto_threshold():
    from acoss_jax.ops.scattering import Scattering2D

    assert not Scattering2D((64, 64), J=2, L=4).subsample
    assert Scattering2D((256, 256), J=2, L=4).subsample


def test_scattering2d_arbitrary_shape(rng):
    """Shapes NOT divisible by 2^J (public kymatio-style contract) run on
    the full-resolution path: phi smoothing at full size, subsample by
    slicing (exactly the fold-decimation identity where both exist)."""
    from acoss_jax.ops.scattering import Scattering2D
    x = rng.random((2, 100, 100)).astype(np.float32)
    sc = Scattering2D((100, 100), J=3, L=4)
    assert not sc.subsample
    out = np.asarray(sc(x))
    J, L = 3, 4
    n_ch = 1 + J * L + L * L * J * (J - 1) // 2
    assert out.shape == (2, n_ch, 13, 13)   # ceil(100 / 8) = 13
    assert np.all(np.isfinite(out))
