"""Every dense single-card engine on every matrix generator, checked
against a plain dense unpivoted f64 LU (numpy) of the same reordered
matrix: the factors and the solve."""

import numpy as np
import pytest

from pangulu_jax.blocks import gather_factor, tile_matrix
from pangulu_jax.models import (arrowhead, circuit, poisson2d,
                                random_unsymmetric, smallworld, trefethen)
from pangulu_jax.numeric import LUFactorizer
from pangulu_jax.ops.kernels_jax import DEFAULT_TOL
from pangulu_jax.reorder import reorder
from pangulu_jax.schedule import build_schedule
from pangulu_jax.sptrsv import TriangularSolver
from pangulu_jax.symbolic import symbolic
from pangulu_jax.utils.perf import residual_norm

GENERATORS = {
    "poisson2d": lambda: poisson2d(9),
    "circuit": lambda: circuit(120, seed=2),
    "arrowhead": lambda: arrowhead(70),
    "smallworld": lambda: smallworld(9, seed=1),
    "random_unsymmetric": lambda: random_unsymmetric(90, 0.05, seed=4),
    "trefethen": lambda: trefethen(80),
}
ENGINES = ("fused", "segmented", "superfused", "levels")


def dense_unpivoted_lu(a, tol):
    """Doolittle LU without pivoting, with the solver's tiny-pivot
    substitution: returns (unit-lower L, U)."""
    f = np.array(a, dtype=np.float64)
    n = f.shape[0]
    for k in range(n):
        if abs(f[k, k]) < tol:
            f[k, k] = tol
        f[k + 1:, k] /= f[k, k]
        f[k + 1:, k + 1:] -= np.outer(f[k + 1:, k], f[k, k + 1:])
    return np.tril(f, -1) + np.eye(n), np.triu(f)


@pytest.mark.parametrize("gen", sorted(GENERATORS))
@pytest.mark.parametrize("engine", ENGINES)
def test_engine_matches_dense_lu(engine, gen):
    a = GENERATORS[gen]()
    ro = reorder(a, ordering="mindeg", nb=16)
    symb = symbolic(ro.reordered, 16)
    blocked = tile_matrix(ro.reordered, symb)
    schedule = build_schedule(blocked)
    fac = LUFactorizer(blocked, schedule, dispatch=engine)
    tiles = fac.factorize()
    lmat, umat = gather_factor(blocked, np.asarray(tiles))
    a3 = ro.reordered.to_scipy().toarray()
    lref, uref = dense_unpivoted_lu(a3, DEFAULT_TOL[np.dtype(np.float64)])
    scale = np.abs(uref).max()
    np.testing.assert_allclose(lmat.toarray(), lref, rtol=0,
                               atol=1e-8 * np.abs(lref).max())
    np.testing.assert_allclose(umat.toarray(), uref, rtol=0,
                               atol=1e-8 * scale)
    # and the solve on those factors
    b = np.asarray(a.to_scipy() @ np.linspace(1.0, 2.0, a.n))
    ts = TriangularSolver(blocked, schedule)
    x = ro.transform_x(ts.solve(tiles, ro.transform_b(b)))
    assert residual_norm(a.to_scipy(), x, b) < 1e-8
