"""Mixed-precision iterative refinement: f32 factorization + f64
residual correction should reach ~f64 solve accuracy."""

import numpy as np

from pangulu_jax.api import InitOptions, gstrf, gstrs, init
from pangulu_jax.io.mmio import generated_rhs
from pangulu_jax.models import poisson2d
from pangulu_jax.utils.perf import residual_norm


def test_refinement_improves_r32():
    a = poisson2d(10)
    b = generated_rhs(a)
    h = init(a, InitOptions(nb=16, dtype="r32"))
    gstrf(h)
    x0 = gstrs(h, b, refine=0)
    x2 = gstrs(h, b, refine=3)
    r0 = residual_norm(a.to_scipy(), x0, b)
    r2 = residual_norm(a.to_scipy(), x2, b)
    assert r2 < r0 / 10
    assert r2 < 1e-6


def test_refinement_auto_default_for_r32():
    a = poisson2d(8)
    b = generated_rhs(a)
    h = init(a, InitOptions(nb=16, dtype="r32"))
    gstrf(h)
    x = gstrs(h, b)  # auto => 2 rounds for r32
    assert residual_norm(a.to_scipy(), x, b) < 1e-6


def test_refinement_complex():
    from pangulu_jax.models import random_unsymmetric

    a = random_unsymmetric(60, 0.06, dtype=np.complex128).astype(np.complex64)
    from pangulu_jax.sparse import CscMatrix

    a = CscMatrix(a.n, a.colptr, a.rowidx, a.values.astype(np.complex64))
    rng = np.random.default_rng(5)
    xt = (rng.standard_normal(a.n) + 1j * rng.standard_normal(a.n)).astype(
        np.complex64)
    b = a.to_scipy() @ xt
    h = init(a, InitOptions(nb=16, dtype="cr32"))
    gstrf(h)
    x = gstrs(h, b, refine=3)
    assert residual_norm(a.to_scipy(), x, b) < 1e-5


def test_refinement_goes_on_while_the_correction_shrinks():
    """A refactorized circuit matrix (cond ~1e16) whose residual barely
    moves in the first round (2.0e-10 -> 1.9e-10) while the error
    shrinks; the next rounds converge.  A stop rule on the residual
    ended refinement there; the rule on the correction goes on."""
    from pangulu_jax.api import update_values
    from pangulu_jax.models import circuit

    a = circuit(2000, seed=1)
    s2 = a.to_scipy().tocsc().copy()
    s2.data = s2.data * (1.0 + 0.01 * np.cos(np.arange(s2.nnz)))
    b = np.asarray(s2 @ np.ones(a.n))
    h = init(a, InitOptions(nb=16, dtype="r64", mc64=True))
    gstrf(h)
    update_values(h, s2)
    gstrf(h)
    assert residual_norm(s2, gstrs(h, b, refine=1), b) > 1e-10
    assert residual_norm(s2, gstrs(h, b, refine=4), b) < 1e-12


def test_refinement_stops_when_the_correction_stalls(monkeypatch):
    """Refinement against a wrong matrix cannot converge: the loop ends
    at the first correction that does not halve, and that correction is
    not applied."""
    from pangulu_jax import api

    a = poisson2d(8)
    b = generated_rhs(a)
    h = init(a, InitOptions(nb=16, dtype="r64"))
    gstrf(h)
    x0 = gstrs(h, b, refine=0)
    h.a_origin = h.a_origin * 3.0     # residuals against 3 A
    solves = []
    real = api._solve_once
    monkeypatch.setattr(api, "_solve_once",
                        lambda *a, **k: solves.append(1) or real(*a, **k))
    x = gstrs(h, b, refine=8)
    assert len(solves) == 3           # x0, one applied and one stalled
    # A x0 = b, so x1 = x0 + A^-1 (b - 3 A x0) = x0 - 2 x0 = -x0
    np.testing.assert_allclose(x, -x0, rtol=1e-9)
