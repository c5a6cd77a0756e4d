"""Transpose solve A^T x = b from the same factors (sptrsv
_fused_solve_trans + gstrs(trans=True)) — beyond the reference's API
(SuperLU-style trans surface)."""

import numpy as np
import pytest

from pangulu_jax.api import InitOptions, finalize, gstrf, gstrs, init
from pangulu_jax.models import circuit, poisson2d, random_unsymmetric
from pangulu_jax.utils.perf import residual_norm


@pytest.mark.parametrize("gen,kw,dtype", [
    (poisson2d, dict(nx=9), "r64"),
    (random_unsymmetric, dict(n=150, density=0.05, seed=3), "r64"),
    (circuit, dict(n=400, seed=6), "r64"),
    (random_unsymmetric, dict(n=120, density=0.05, seed=4), "r32"),
])
def test_transpose_solve(gen, kw, dtype):
    a = gen(**kw)
    s = a.to_scipy()
    rng = np.random.default_rng(0)
    xt = rng.standard_normal(a.n)
    bt = np.asarray(s.T @ xt)
    h = init(a, InitOptions(nb=16, dtype=dtype))
    gstrf(h)
    x = gstrs(h, bt, trans=True)
    res = residual_norm(s.T.tocsc(), x, bt)
    tol = 1e-10 if dtype == "r64" else 1e-5
    assert res < tol, res
    # normal solve still works on the same handle
    b = np.asarray(s @ xt)
    x2 = gstrs(h, b)
    assert residual_norm(s, x2, b) < tol
    finalize(h)


@pytest.mark.parametrize("poison", [np.inf, np.nan])
def test_transpose_solve_ignores_scratch_tile(poison):
    """The engines leave padded-lane garbage in the scratch tile (inf on
    some platforms); the transpose solve must never multiply it in."""
    import jax.numpy as jnp

    a = poisson2d(9)
    s = a.to_scipy()
    h = init(a, InitOptions(nb=16, dtype="r32", ordering="rcm", refine=0))
    gstrf(h)
    h.factor_tiles = jnp.asarray(h.factor_tiles).at[-1].set(poison)
    b = np.asarray(s.T @ np.ones(a.n))
    x = gstrs(h, b, trans=True)
    assert residual_norm(s.T.tocsc(), x, b) < 1e-5


def test_transpose_solve_multi_rhs():
    a = random_unsymmetric(120, 0.06, seed=9)
    s = a.to_scipy()
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((a.n, 3))
    bs = np.asarray(s.T @ xs)
    h = init(a, InitOptions(nb=16, dtype="r64"))
    gstrf(h)
    xg = gstrs(h, bs, trans=True)
    np.testing.assert_allclose(xg, xs, rtol=1e-8, atol=1e-8)
    finalize(h)


def test_transpose_solve_complex_embed():
    """trans=True means plain transpose for complex too: the real
    embedding's transpose is emb(A^H), handled via conjugation."""
    a = random_unsymmetric(90, 0.06, seed=12, dtype=np.complex128)
    s = a.to_scipy()
    rng = np.random.default_rng(2)
    xt = rng.standard_normal(a.n) + 1j * rng.standard_normal(a.n)
    bt = np.asarray(s.T @ xt)
    h = init(a, InitOptions(nb=16, dtype="cr64", complex_mode="embed"))
    gstrf(h)
    x = gstrs(h, bt, trans=True)
    assert residual_norm(s.T.tocsc(), x, bt) < 1e-10
    finalize(h)


def test_transpose_solve_unsupported_paths_raise():
    a = poisson2d(8)
    h = init(a, InitOptions(nb=8, dtype="r64",
                            tile_storage="compressed"))
    gstrf(h)
    with pytest.raises(NotImplementedError):
        gstrs(h, np.ones(a.n), trans=True)
    finalize(h)


def test_factor_diagnostics():
    """logdet/sign vs numpy slogdet; cond estimate within the usual
    Hager-estimator band of the true 1-norm condition number."""
    from pangulu_jax.api import factor_diagnostics

    a = random_unsymmetric(120, 0.08, seed=5)
    h = init(a, InitOptions(nb=16, dtype="r64"))
    gstrf(h)
    d = factor_diagnostics(h)
    dense = a.to_scipy().toarray()
    sign, logdet = np.linalg.slogdet(dense)
    assert abs(d["logabsdet"] - logdet) < 1e-6 * max(abs(logdet), 1.0)
    assert d["sign"] == pytest.approx(sign)
    true_cond = (np.linalg.norm(dense, 1)
                 * np.linalg.norm(np.linalg.inv(dense), 1))
    assert 0.1 * true_cond <= d["cond1_est"] <= 3.0 * true_cond
    finalize(h)


@pytest.mark.parametrize(
    "seed", [s if s < 3 else pytest.param(s, marks=pytest.mark.slow)
             for s in range(8)])
@pytest.mark.parametrize("ordering", ["rcm", "mindeg"])
def test_factor_diagnostics_sign_many_seeds(seed, ordering):
    """Determinant SIGN across many random matrices/orderings: the
    fill-reducing permutation is symmetric (det contribution +1), so
    seeds whose perm is odd must not flip the sign (regression: the
    sign disagreed with slogdet on every odd-parity perm)."""
    from pangulu_jax.api import factor_diagnostics

    a = random_unsymmetric(60, 0.12, seed=100 + seed)
    h = init(a, InitOptions(nb=8, dtype="r64", ordering=ordering))
    gstrf(h)
    d = factor_diagnostics(h)
    sign, logdet = np.linalg.slogdet(a.to_scipy().toarray())
    assert d["sign"] == pytest.approx(sign), (seed, ordering)
    assert abs(d["logabsdet"] - logdet) < 1e-6 * max(abs(logdet), 1.0)
    finalize(h)
