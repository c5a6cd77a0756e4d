"""Device-resident solve surface: gstrs_device (on-device permutation
+ scale + solve + back-permutation, no host sync inside) and
TriangularSolver.solve_blocked (blocked-layout serving chain).

Reference counterpart: repeated host-resident pangulu_gstrs calls
(pangulu.c:271); the device-resident chain serves back-to-back solves
with no host round trip between them."""

import jax.numpy as jnp
import numpy as np
import pytest

from pangulu_jax.api import (InitOptions, gstrf, gstrs, gstrs_device,
                             init, update_values)
from pangulu_jax.models import poisson2d, trefethen
from pangulu_jax.utils.perf import residual_norm


def _setup(dtype="r32", nb=16, gen=poisson2d, **kw):
    a = gen(**(kw or dict(nx=12)))
    h = init(a, InitOptions(nb=nb, dtype=dtype))
    gstrf(h)
    return a, h


def test_gstrs_device_matches_host_path():
    a, h = _setup()
    b = (a.to_scipy() @ np.arange(1.0, a.n + 1)).astype(np.float32)
    x_host = gstrs(h, b, refine=0)
    x_dev = np.asarray(gstrs_device(h, jnp.asarray(b)))
    np.testing.assert_allclose(x_dev, x_host, rtol=1e-5, atol=1e-5)


def test_gstrs_device_multi_rhs_and_chain():
    a, h = _setup()
    rng = np.random.default_rng(3)
    b = rng.standard_normal((a.n, 3)).astype(np.float32)
    x = gstrs_device(h, jnp.asarray(b))
    assert x.shape == (a.n, 3)
    # chain: feed the result back in with NO host transfer in between
    y = gstrs_device(h, x)
    xs, ys = np.asarray(x), np.asarray(y)
    for c in range(3):
        r = residual_norm(a.to_scipy(), xs[:, c], b[:, c])
        assert r < 5e-5, r
        r2 = residual_norm(a.to_scipy(), ys[:, c], xs[:, c])
        assert r2 < 5e-5, r2


def test_gstrs_device_refine_tightens():
    a, h = _setup(gen=trefethen, n=60, nb=16)
    b = (a.to_scipy() @ np.ones(a.n)).astype(np.float32)
    x0 = np.asarray(gstrs_device(h, jnp.asarray(b), refine=0))
    x2 = np.asarray(gstrs_device(h, jnp.asarray(b), refine=2))
    r0 = residual_norm(a.to_scipy(), x0, b)
    r2 = residual_norm(a.to_scipy(), x2, b)
    assert r2 <= r0 * 2  # refinement never blows up...
    assert r2 < 5e-6     # ...and lands at working-precision quality


def test_gstrs_device_after_update_values():
    a, h = _setup()
    s2 = a.to_scipy().copy()
    s2.data = s2.data * 1.5
    update_values(h, s2)
    gstrf(h)
    b = (s2 @ np.ones(a.n)).astype(np.float32)
    x = np.asarray(gstrs_device(h, jnp.asarray(b), refine=1))
    assert residual_norm(s2, x, b) < 5e-5


def test_gstrs_device_r64_cpu_path():
    """On CPU the r64 factors are plain f64 tiles — gstrs_device runs
    the fused engine at full precision."""
    a, h = _setup(dtype="r64")
    b = a.to_scipy() @ np.arange(1.0, a.n + 1)
    x = np.asarray(gstrs_device(h, jnp.asarray(b)))
    assert residual_norm(a.to_scipy(), x, b) < 1e-12


def test_gstrs_device_dd_factors():
    """dd-pair (double-float r64) factors: gstrs_device runs the whole
    permute/scale/dd-IR-solve chain device-side as dd-pair ops."""
    from pangulu_jax.numeric import DdTiles, LUFactorizer

    a, h = _setup(dtype="r64")
    # re-factor with the dd engine on the same handle (dd runs only on
    # explicit request)
    fac = LUFactorizer(h.blocked, h.schedule, dispatch="dd")
    h.factor_tiles = fac.factorize()
    assert isinstance(h.factor_tiles, DdTiles)
    h._factorizer = fac
    h._trisolver = None
    b = a.to_scipy() @ np.arange(1.0, a.n + 1)
    x = np.asarray(gstrs_device(h, jnp.asarray(b)))
    assert x.dtype == np.float64
    assert residual_norm(a.to_scipy(), x, b) < 1e-12
    # multi-rhs + chain without host transfers
    rng = np.random.default_rng(5)
    b2 = rng.standard_normal((a.n, 2))
    x2 = gstrs_device(h, jnp.asarray(b2))
    y2 = gstrs_device(h, x2)
    for c in range(2):
        assert residual_norm(a.to_scipy(), np.asarray(x2)[:, c],
                             b2[:, c]) < 1e-12
        assert residual_norm(a.to_scipy(), np.asarray(y2)[:, c],
                             np.asarray(x2)[:, c]) < 1e-12


def test_solve_blocked_roundtrip():
    a, h = _setup()
    b = (a.to_scipy() @ np.ones(a.n)).astype(np.float32)
    gstrs(h, b)  # builds the solver
    solver = h._trisolver
    assert solver is not None
    # blocked in, blocked out, chained twice on device
    bt = h.reordering.transform_b(b)
    xb = solver.blockify_rhs(bt)
    w = solver.solve_blocked(h.factor_tiles, xb)
    x = h.reordering.transform_x(solver.unblockify(w)[:, 0])
    assert residual_norm(a.to_scipy(), x, b) < 5e-5

