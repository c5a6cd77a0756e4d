"""The diagonal step of the engines (kernels_jax.getrf_with_inverses):
LU of one tile plus both triangle inverses, at every tile width the
bench and smoke configurations use, batched, with the tiny-pivot path,
and one check that runs only on a GPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pangulu_jax.ops import interface, kernels_jax

F32_TOL = float(np.float32(kernels_jax.DEFAULT_TOL[jnp.dtype(jnp.float32)]))


def _tiles(nb, batch=None, seed=0, dtype=np.float32):
    """Well-conditioned tiles; row and column 3 of the first tile are
    zero, so its pivot 3 is exactly zero and takes the tiny-pivot
    substitution without coupling to the rest of the tile."""
    rng = np.random.default_rng(seed)
    shape = (batch or 1, nb, nb)
    a = rng.standard_normal(shape) + nb * np.eye(nb)
    a[0, 3, :] = 0.0
    a[0, :, 3] = 0.0
    a = a.astype(dtype)
    return jnp.asarray(a if batch else a[0])


def _unpivoted_lu(a):
    """Plain f64 Doolittle LU with the same tiny-pivot rule."""
    f = np.array(a, dtype=np.float64)
    for k in range(f.shape[0]):
        if abs(f[k, k]) < F32_TOL:
            f[k, k] = F32_TOL
        f[k + 1:, k] /= f[k, k]
        f[k + 1:, k + 1:] -= np.outer(f[k + 1:, k], f[k, k + 1:])
    return f


@pytest.mark.parametrize("nb", [16, 32, 64, 128])
def test_matches_plain_lu_with_tiny_pivot(nb):
    a = _tiles(nb)
    with jax.default_matmul_precision("highest"):
        f, linv, uinv = kernels_jax.getrf_with_inverses(a)
    assert float(f[3, 3]) == F32_TOL          # tiny pivot substituted
    ref = _unpivoted_lu(np.asarray(a))
    err = np.abs(np.asarray(f, np.float64) - ref).max() / np.abs(ref).max()
    assert err <= 1e-5, err


@pytest.mark.parametrize("nb", [16, 64])
def test_inverses_invert_the_triangles(nb):
    with jax.default_matmul_precision("highest"):
        f, linv, uinv = (np.asarray(x, np.float64) for x in
                         kernels_jax.getrf_with_inverses(_tiles(nb, seed=5)))
    lmat = np.tril(f, -1) + np.eye(nb)
    umat = np.triu(f)
    assert np.abs(linv @ lmat - np.eye(nb)).max() < 1e-5
    assert np.abs(uinv @ umat - np.eye(nb)).max() < 1e-5


def test_batched_matches_per_tile():
    a = _tiles(32, batch=5, seed=3)
    got = jax.vmap(kernels_jax.getrf_with_inverses)(a)
    assert [g.shape for g in got] == [(5, 32, 32)] * 3
    for i in range(5):
        one = kernels_jax.getrf_with_inverses(a[i])
        for g, r in zip(got, one):
            np.testing.assert_allclose(np.asarray(g[i]), np.asarray(r),
                                       rtol=1e-6, atol=1e-6)


def test_f64_tiles_keep_f64():
    f, linv, uinv = kernels_jax.getrf_with_inverses(
        _tiles(32, seed=2, dtype=np.float64))
    assert f.dtype == linv.dtype == uinv.dtype == jnp.float64
    lmat = np.tril(np.asarray(f), -1) + np.eye(32)
    assert np.abs(np.asarray(linv) @ lmat - np.eye(32)).max() < 1e-12


@pytest.mark.parametrize("name", ["auto", "jax"])
def test_engines_take_the_xla_diagonal_step(name):
    """Every backend name resolves to the XLA diagonal step, on every
    platform and for every dtype."""
    assert (interface.get_backend(name).diag_factor_invert
            is kernels_jax.getrf_with_inverses)


@pytest.mark.gpu
def test_compiled_diagonal_step_is_true_fp32_on_gpu(gpu):
    """On the card the diagonal step's products run in IEEE f32 (not
    TF32): its factor agrees with a plain f64 LU to f32 rounding."""
    a = jax.device_put(_tiles(128, batch=16), gpu)
    with jax.default_matmul_precision("highest"):
        f, _, _ = jax.vmap(kernels_jax.getrf_with_inverses)(a)
    assert float(f[0, 3, 3]) == F32_TOL
    for i in (0, 15):
        ref = _unpivoted_lu(np.asarray(a[i]))
        err = np.abs(np.asarray(f[i], np.float64) - ref).max() \
            / np.abs(ref).max()
        assert err <= 1e-5, err
