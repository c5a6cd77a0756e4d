"""Per-kernel unit tests vs numpy/scipy oracles (SURVEY §4: the test
pyramid the reference lacks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

from pangulu_jax.ops import kernels_jax as _K

NB = 32


class K:
    """Jitted wrappers — eager per-op compiles are prohibitively slow on
    this 1-core host; jit gives one (persistently cached) compile per
    kernel/shape."""

    getrf = staticmethod(jax.jit(_K.getrf, static_argnames=("tol",)))
    tstrf = staticmethod(jax.jit(_K.tstrf))
    gessm = staticmethod(jax.jit(_K.gessm))
    ssssm = staticmethod(jax.jit(_K.ssssm))
    diag_inverses = staticmethod(jax.jit(_K.diag_inverses))
    trsv_lower_unit = staticmethod(jax.jit(_K.trsv_lower_unit))
    trsv_upper = staticmethod(jax.jit(_K.trsv_upper))


def _rand(nb=NB, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((nb, nb))
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        a = a + 1j * rng.standard_normal((nb, nb))
    return (a + nb * np.eye(nb)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128])
def test_getrf_reconstructs(dtype):
    a = _rand(dtype=dtype)
    f = np.asarray(K.getrf(jnp.asarray(a)))
    l = np.tril(f, -1) + np.eye(NB)
    u = np.triu(f)
    tol = 1e-4 if dtype == np.float32 else 1e-10
    np.testing.assert_allclose(l @ u, a, rtol=tol, atol=tol)


def test_getrf_matches_scipy_unpivoted():
    a = _rand()
    f = np.asarray(K.getrf(jnp.asarray(a)))
    # scipy lu with permute_l=False gives P L U; diagonally-dominant a
    # needs no pivoting so P should be I
    p, l, u = scipy.linalg.lu(a)
    assert np.allclose(p, np.eye(NB))
    np.testing.assert_allclose(np.tril(f, -1), np.tril(l, -1),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.triu(f), u, rtol=1e-9, atol=1e-9)


def test_getrf_tiny_pivot_substitution():
    a = np.eye(4)
    a[2, 2] = 0.0  # exactly singular pivot
    f = np.asarray(K.getrf(jnp.asarray(a), tol=1e-16))
    assert f[2, 2] == 1e-16  # reference PANGULU_TOL semantics


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_tstrf_gessm(dtype):
    diag = np.asarray(K.getrf(jnp.asarray(_rand(dtype=dtype))))
    b = _rand(dtype=dtype, seed=1)
    u = np.triu(diag)
    l = np.tril(diag, -1) + np.eye(NB)
    x_t = np.asarray(K.tstrf(jnp.asarray(diag), jnp.asarray(b)))
    np.testing.assert_allclose(x_t @ u, b, rtol=1e-9, atol=1e-9)
    x_g = np.asarray(K.gessm(jnp.asarray(diag), jnp.asarray(b)))
    np.testing.assert_allclose(l @ x_g, b, rtol=1e-9, atol=1e-9)


def test_diag_inverses():
    diag = np.asarray(K.getrf(jnp.asarray(_rand())))
    linv, uinv = K.diag_inverses(jnp.asarray(diag))
    l = np.tril(diag, -1) + np.eye(NB)
    u = np.triu(diag)
    np.testing.assert_allclose(np.asarray(linv) @ l, np.eye(NB),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.asarray(uinv) @ u, np.eye(NB),
                               rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("nb", [16, 32, 96])
def test_getrf_with_inverses(nb):
    a = _rand(nb=nb)
    f, linv, uinv = jax.jit(_K.getrf_with_inverses)(jnp.asarray(a))
    f, linv, uinv = map(np.asarray, (f, linv, uinv))
    l = np.tril(f, -1) + np.eye(nb)
    u = np.triu(f)
    np.testing.assert_allclose(l @ u, a, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(linv @ l, np.eye(nb), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(uinv @ u, np.eye(nb), rtol=1e-8, atol=1e-8)
    # must agree with the plain getrf kernel
    f2 = np.asarray(K.getrf(jnp.asarray(a)))
    np.testing.assert_allclose(f, f2, rtol=1e-9, atol=1e-9)


def test_ssssm():
    a, b, c = _rand(seed=1), _rand(seed=2), _rand(seed=3)
    out = np.asarray(K.ssssm(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(out, c - a @ b, rtol=1e-12, atol=1e-12)


def test_trsv():
    diag = np.asarray(K.getrf(jnp.asarray(_rand())))
    x = np.random.default_rng(4).standard_normal(NB)
    l = np.tril(diag, -1) + np.eye(NB)
    u = np.triu(diag)
    y = np.asarray(K.trsv_lower_unit(jnp.asarray(diag), jnp.asarray(x)))
    np.testing.assert_allclose(l @ y, x, rtol=1e-9, atol=1e-9)
    z = np.asarray(K.trsv_upper(jnp.asarray(diag), jnp.asarray(x)))
    np.testing.assert_allclose(u @ z, x, rtol=1e-9, atol=1e-9)


def test_structural_zeros_preserved():
    """Dense-tile correctness hinges on exact-zero preservation."""
    a = _rand()
    a[:, 5] = 0.0
    a[5, :] = 0.0
    a[5, 5] = 2.0
    f = np.asarray(K.getrf(jnp.asarray(a)))
    # column 5 of L below diag and row 5 of U right of diag stay zero
    assert (f[6:, 5] == 0).all()
    assert (f[5, 6:] == 0).all()
