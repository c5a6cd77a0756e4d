"""End-to-end acceptance tests — the reference's own verification story
(examples/example.c:304-364): factor + solve, check ||Ax-b||/||b||."""

import numpy as np
import pytest

from pangulu_jax.api import InitOptions, Solver, finalize, gssv, gstrf, gstrs, init
from pangulu_jax.io.mmio import generated_rhs
from pangulu_jax.models import arrowhead, poisson2d, random_unsymmetric, trefethen
from pangulu_jax.utils.perf import residual_norm

TOL = {"r32": 2e-4, "r64": 1e-10, "cr32": 5e-4, "cr64": 1e-10}


def _solve_and_check(a, opts, rhs=None, tol=None):
    b = rhs if rhs is not None else generated_rhs(a)
    s = Solver(a, opts)
    x = s.solve(b)
    r = residual_norm(a.to_scipy(), x, b)
    assert r < (tol or TOL[opts.dtype]), f"residual {r}"
    s.close()
    return x


def test_trefethen_smoke():
    """The reference smoke config: Trefethen_20b, nb=10
    (README.md:145-153)."""
    a = trefethen(20)
    x = _solve_and_check(a, InitOptions(nb=10, dtype="r64"))
    np.testing.assert_allclose(x, np.ones(a.n), rtol=1e-8)


def test_five_api_entry_points():
    a = trefethen(20)
    b = generated_rhs(a)
    h = init(a, InitOptions(nb=8, dtype="r64", check=True))
    gstrf(h)
    assert h.perf.kernels["gstrf_residual"] < 1e-12
    x = gstrs(h, b)
    assert residual_norm(a.to_scipy(), x, b) < 1e-10
    finalize(h)
    assert h.factor_tiles is None
    # gssv = gstrf; gstrs on a fresh handle
    h2 = init(a, InitOptions(nb=8, dtype="r64"))
    x2 = gssv(h2, b)
    np.testing.assert_allclose(x2, x, rtol=1e-10)
    finalize(h2)


def test_poisson_spd():
    _solve_and_check(poisson2d(12), InitOptions(nb=16, dtype="r64"))


def test_unsymmetric():
    _solve_and_check(random_unsymmetric(150, 0.03),
                     InitOptions(nb=32, dtype="r64"))


def test_arrowhead_needs_reordering():
    _solve_and_check(arrowhead(100), InitOptions(nb=16, dtype="r64",
                                                 ordering="mindeg"))


def test_r32():
    _solve_and_check(poisson2d(8), InitOptions(nb=16, dtype="r32"))


def test_cr64_complex():
    a = random_unsymmetric(80, 0.05, dtype=np.complex128)
    rng = np.random.default_rng(7)
    xtrue = rng.standard_normal(a.n) + 1j * rng.standard_normal(a.n)
    b = a.to_scipy() @ xtrue
    x = _solve_and_check(a, InitOptions(nb=16, dtype="cr64"), rhs=b)
    np.testing.assert_allclose(x, xtrue, rtol=1e-7, atol=1e-8)


def test_multi_rhs():
    a = trefethen(20)
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((a.n, 3))
    bs = a.to_scipy() @ xs
    h = init(a, InitOptions(nb=8, dtype="r64"))
    gstrf(h)
    out = gstrs(h, bs)
    np.testing.assert_allclose(out, xs, rtol=1e-8, atol=1e-9)
    finalize(h)


def test_factor_once_solve_many():
    a = poisson2d(8)
    h = init(a, InitOptions(nb=16, dtype="r64"))
    gstrf(h)
    for seed in range(3):
        rng = np.random.default_rng(seed)
        xt = rng.standard_normal(a.n)
        b = a.to_scipy() @ xt
        np.testing.assert_allclose(gstrs(h, b), xt, rtol=1e-8, atol=1e-8)
    finalize(h)


def test_block_symbolic_mode():
    _solve_and_check(poisson2d(10),
                     InitOptions(nb=16, dtype="r64", symbolic_mode="block"))


def test_nb_not_dividing_n():
    # n=19 with nb=8 exercises the padded last block
    _solve_and_check(trefethen(20), InitOptions(nb=8, dtype="r64"))


def test_trsm_panel_solve_variant():
    from pangulu_jax.blocks import tile_matrix
    from pangulu_jax.numeric import LUFactorizer
    from pangulu_jax.reorder import reorder
    from pangulu_jax.schedule import build_schedule
    from pangulu_jax.sptrsv import TriangularSolver
    from pangulu_jax.symbolic import symbolic

    a = trefethen(20)
    ro = reorder(a)
    symb = symbolic(ro.reordered, 8)
    bm = tile_matrix(ro.reordered, symb)
    sc = build_schedule(bm)
    f = LUFactorizer(bm, sc, panel_solve="trsm")
    tiles = f.factorize()
    ts = TriangularSolver(bm, sc)
    b = generated_rhs(a)
    w = ts.solve(tiles, ro.transform_b(b))
    x = ro.transform_x(w)
    assert residual_norm(a.to_scipy(), x, b) < 1e-10


def test_smallworld_irregular():
    """Irregular structure (grid + scattered long-range couplings) —
    the SuiteSparse-circuit-class stand-in; exercises auto ordering and
    wider, raggeder elimination levels."""
    from pangulu_jax.models import smallworld

    a = smallworld(16, long_range=0.08, seed=3)
    b = np.asarray(a.to_scipy() @ np.ones(a.n))
    x = _solve_and_check(a, InitOptions(nb=32, dtype="r64"), rhs=b)
    assert np.allclose(x, 1.0, atol=1e-8)


def test_complex_embedding_matches_native():
    """cr64 via the real 2x2 embedding (complex_mode="embed")
    must match the native complex solve."""
    a = random_unsymmetric(60, 0.07, dtype=np.complex128, seed=9)
    b = np.asarray(a.to_scipy() @ (np.ones(a.n) + 0.5j))
    x_native = _solve_and_check(
        a, InitOptions(nb=16, dtype="cr64", complex_mode="native"), rhs=b)
    from pangulu_jax.api import finalize, gstrf, gstrs, init

    h = init(a, InitOptions(nb=16, dtype="cr64", complex_mode="embed"))
    assert h.complex_embed is not None
    assert h.blocked.dtype == np.float64  # real embedded system
    gstrf(h)
    x_emb = gstrs(h, b)
    assert np.iscomplexobj(x_emb)
    np.testing.assert_allclose(x_emb, x_native, rtol=1e-9, atol=1e-9)
    from pangulu_jax.utils.perf import residual_norm

    assert residual_norm(a.to_scipy(), x_emb, b) < 1e-10
    finalize(h)


def test_spsolve_oneliner():
    import pangulu_jax

    a = random_unsymmetric(70, 0.08, seed=2)
    b = np.asarray(a.to_scipy() @ np.ones(a.n))
    x = pangulu_jax.spsolve(a, b, nb=16, dtype="r64")
    from pangulu_jax.utils.perf import residual_norm

    assert residual_norm(a.to_scipy(), x, b) < 1e-10


def test_analyze():
    import pangulu_jax

    a = poisson2d(12)
    info = pangulu_jax.analyze(a, InitOptions(nb=16, dtype="r32"))
    assert info["n"] == a.n
    assert info["tiles"] > 0 and info["flops"] > 0
    assert info["factor_hbm_bytes"] == (info["tiles"] + 1) * 16 * 16 * 4
    assert "reorder" in info["phase_time_s"]
