"""Double-float (dd) arithmetic and the dd engines (ops/dd.py, numeric
dispatch="dd"/"dd_group", explicit request only): f64-class results
from f32 device math.  The engine structure (slicing, dd matmuls, dd
LU, dd solve) is the same on every platform."""

import functools

import numpy as np
import pytest

import jax

from pangulu_jax.blocks import gather_factor, tile_matrix
from pangulu_jax.io.mmio import generated_rhs
from pangulu_jax.models import poisson2d, smallworld
from pangulu_jax.numeric import DdTiles, LUFactorizer
from pangulu_jax.ops import dd as D
from pangulu_jax.reorder import reorder
from pangulu_jax.schedule import build_schedule
from pangulu_jax.sptrsv import TriangularSolver
from pangulu_jax.symbolic import symbolic
from pangulu_jax.utils.perf import factorization_residual, residual_norm


def test_dd_roundtrip_and_add_mul():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(512) * np.exp(rng.standard_normal(512) * 3)
    y = rng.standard_normal(512)
    xh, xl = D.dd(x)
    yh, yl = D.dd(y)
    assert np.max(np.abs(D.dd_to_f64(xh, xl) - x)) < 1e-13 * np.max(
        np.abs(x))
    sh, sl = jax.jit(D.dd_add)(xh, xl, yh, yl)
    rel = np.max(np.abs(D.dd_to_f64(sh, sl) - (x + y))
                 / (np.abs(x) + np.abs(y) + 1e-30))
    assert rel < 1e-13
    ph, pl = jax.jit(D.dd_mul)(xh, xl, yh, yl)
    rel = np.max(np.abs(D.dd_to_f64(ph, pl) - x * y)
                 / (np.abs(x * y) + 1e-30))
    assert rel < 1e-13
    qh, ql = jax.jit(D.dd_div)(xh, xl, yh, yl)
    rel = np.max(np.abs(D.dd_to_f64(qh, ql) - x / y)
                 / (np.abs(x / y) + 1e-30))
    assert rel < 1e-12


def test_dd_matmul_accuracy():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((96, 128)) * np.exp(
        rng.standard_normal((96, 128)))
    b = rng.standard_normal((128, 64))
    ch, cl = jax.jit(D.dd_matmul)(*D.dd(a), *D.dd(b))
    rel = np.max(np.abs(D.dd_to_f64(ch, cl) - a @ b)
                 / (np.abs(a) @ np.abs(b) + 1e-30))
    assert rel < 1e-11


@pytest.mark.slow
def test_dd_lu_inverses_vs_f64():
    rng = np.random.default_rng(2)
    for nb in (32, 48, 64):
        a = rng.standard_normal((nb, nb)) + np.eye(nb) * 6
        (fh, fl), li, ui = jax.jit(functools.partial(
            D.dd_lu_inverses, nb=nb, tol=1e-30))(*D.dd(a))
        fv = D.dd_to_f64(fh, fl)
        L = np.tril(fv, -1) + np.eye(nb)
        U = np.triu(fv)
        assert np.max(np.abs(L @ U - a)) / np.max(np.abs(a)) < 1e-12
        assert np.max(np.abs(D.dd_to_f64(*li) @ L - np.eye(nb))) < 1e-10
        assert np.max(np.abs(D.dd_to_f64(*ui) @ U - np.eye(nb))) < 1e-10


def _problem(a, nb):
    ro = reorder(a, ordering="rcm")
    symb = symbolic(ro.reordered, nb)
    blocked = tile_matrix(ro.reordered, symb)
    return ro, blocked, build_schedule(blocked)


def test_dd_engine_factorization_residual():
    """The VERDICT r1 done-criterion shape: r64 factors via the dd
    engine with residual <= 1e-12 (here on CPU; the identical code
    path runs on the chip)."""
    a = poisson2d(12)
    ro, blocked, schedule = _problem(a, 16)
    fac = LUFactorizer(blocked, schedule, dispatch="dd")
    tiles = fac.factorize()
    assert isinstance(tiles, DdTiles)
    lmat, umat = gather_factor(blocked, np.asarray(tiles))
    res = factorization_residual(ro.reordered.to_scipy(), lmat, umat)
    assert res < 1e-12, res


def test_dd_end_to_end_solve():
    a = smallworld(12)
    ro, blocked, schedule = _problem(a, 16)
    fac = LUFactorizer(blocked, schedule, dispatch="dd")
    tiles = fac.factorize()
    ts = TriangularSolver(blocked, schedule, inv_tiles=fac.inv_tiles)
    b = generated_rhs(a)
    w = ts.solve(tiles, ro.transform_b(b))
    x = ro.transform_x(w)
    assert residual_norm(a.to_scipy(), x, b) < 1e-12


def test_dd_multi_rhs():
    a = poisson2d(10)
    ro, blocked, schedule = _problem(a, 16)
    fac = LUFactorizer(blocked, schedule, dispatch="dd")
    tiles = fac.factorize()
    ts = TriangularSolver(blocked, schedule, inv_tiles=fac.inv_tiles)
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((a.n, 3))
    bs = np.asarray(ro.reordered.to_scipy() @ xs)
    w = ts.solve(tiles, bs)
    np.testing.assert_allclose(w, xs, rtol=1e-10, atol=1e-10)


def test_dd_matches_f64_engine():
    """dd factors must agree with the native-f64 fused engine to
    ~dd precision."""
    a = poisson2d(8)
    ro, blocked, schedule = _problem(a, 8)
    t64 = np.asarray(LUFactorizer(blocked, schedule,
                                  dispatch="fused").factorize())
    tdd = np.asarray(LUFactorizer(blocked, schedule,
                                  dispatch="dd").factorize())
    nt = blocked.num_tiles
    np.testing.assert_allclose(tdd[:nt], t64[:nt], rtol=1e-11,
                               atol=1e-11)


@pytest.mark.slow
def test_dd_ir_solve_matches_pure_dd():
    """The device-fused IR solve (default) and the all-dd fused solve
    must both reach f64-class residuals; IR is the fast path (one f32
    inverse solve + dd residual per round, no level-latency chain)."""
    a = smallworld(12, seed=5)
    ro, blocked, schedule = _problem(a, 16)
    fac = LUFactorizer(blocked, schedule, dispatch="dd")
    tiles = fac.factorize()
    b = generated_rhs(a)
    bt = ro.transform_b(b)
    outs = {}
    for method in ("ir", "dd"):
        ts = TriangularSolver(blocked, schedule, inv_tiles=fac.inv_tiles)
        ts.dd_solve_method = method
        w = ts.solve(tiles, bt)
        x = ro.transform_x(w)
        res = residual_norm(a.to_scipy(), x, b)
        assert res < 1e-12, (method, res)
        outs[method] = x
    np.testing.assert_allclose(outs["ir"], outs["dd"],
                               rtol=1e-10, atol=1e-12)


def test_dd_blocked_residual_exact():
    """dd_blocked_residual vs an f64 reference residual."""
    import jax.numpy as jnp

    a = poisson2d(9)
    ro, blocked, schedule = _problem(a, 8)
    bl, nb = schedule.block_length, blocked.nb
    rng = np.random.default_rng(11)
    nrhs = 2
    x = rng.standard_normal((a.n, nrhs))
    b = rng.standard_normal((a.n, nrhs))
    ref = b - ro.reordered.to_scipy() @ x

    def blockify(v):
        out = np.zeros((bl + 1, nb, nrhs))
        out[:bl].reshape(bl * nb, nrhs)[: a.n] = v
        return out

    host = blocked.tiles
    hi = host.astype(np.float32)
    lo = (host - hi.astype(np.float64)).astype(np.float32)
    w = int(np.diff(blocked.brownnzptr).max())
    row_ids = np.full((bl, w), blocked.num_tiles, np.int32)
    row_cols = np.full((bl, w), bl, np.int32)
    for k in range(bl):
        s, e = blocked.brownnzptr[k], blocked.brownnzptr[k + 1]
        row_ids[k, : e - s] = blocked.tile_of_csr[s:e]
        row_cols[k, : e - s] = blocked.bcolidx[s:e]
    xb, bb = blockify(x), blockify(b)
    xh, xl = D.dd(xb)
    bh, bl_ = D.dd(bb)
    rh, rl = jax.jit(D.dd_blocked_residual)(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(row_ids),
        jnp.asarray(row_cols), xh, xl, bh, bl_)
    got = D.dd_to_f64(rh, rl)[:bl].reshape(bl * nb, nrhs)[: a.n]
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def _nd_problem(nb=8, nx=12):
    """ND-ordered fixture with real super-level compression (multiple
    same-depth columns per group)."""
    from pangulu_jax.models import poisson2d as _p2d

    a = _p2d(nx)
    ro = reorder(a, ordering="nd", nb=nb)
    symb = symbolic(ro.reordered, nb)
    blocked = tile_matrix(ro.reordered, symb)
    return a, ro, blocked, build_schedule(blocked)


def test_superfused_wave_tables_cover_all_updates():
    """Union of waves == every update exactly once; destinations are
    unique within each (group, wave); panel concat offsets match the
    superfused layout."""
    a, ro, blocked, schedule = _nd_problem()
    assert max(len(m) for m in schedule.superlevels()) > 1
    gmax = 4
    segs = schedule.superfused_wave_tables(blocked.num_tiles, gmax=gmax)
    groups = [mem[s:s + gmax] for mem in schedule.superlevels()
              for s in range(0, len(mem), gmax)]
    gi = 0
    multi_wave = False
    for seg in segs:
        (lev_ids, diag_idx, l_ids, l_dsel, u_ids, u_dsel,
         upd_dst, upd_l, upd_u) = seg
        for t in range(lev_ids.shape[0]):
            mem = groups[gi]
            assert [k for k in lev_ids[t]
                    if k < schedule.block_length] == list(mem)
            # reconstruct (dst, l, u) triples from the wave tables
            got = []
            for w in range(upd_dst.shape[1]):
                real = upd_dst[t, w] != blocked.num_tiles
                wd = upd_dst[t, w][real]
                assert len(np.unique(wd)) == len(wd), "dup dst in wave"
                got += list(zip(wd, upd_l[t, w][real],
                                upd_u[t, w][real]))
                if w > 0 and real.any():
                    multi_wave = True
            want = []
            ol = ou = 0
            for k in mem:
                lev = schedule.levels[k]
                want += [(d, li + ol, ui + ou) for d, li, ui in
                         zip(lev.upd_dst, lev.upd_l, lev.upd_u)]
                ol += len(lev.lpanel)
                ou += len(lev.upanel)
            assert sorted(got) == sorted(want), f"group {gi}"
            gi += 1
    assert gi == len(groups)
    assert multi_wave, "fixture never exercises a second wave"


@pytest.mark.slow
def test_dd_group_engine_matches_dd():
    """The batched super-level group dd engine must agree with the
    per-level dd engine to ~dd precision and keep residual + solve
    quality (inverse store contract included)."""
    a, ro, blocked, schedule = _nd_problem()
    fac1 = LUFactorizer(blocked, schedule, dispatch="dd")
    t1 = np.asarray(fac1.factorize())
    fac2 = LUFactorizer(blocked, schedule, dispatch="dd_group")
    tiles2 = fac2.factorize()
    assert isinstance(tiles2, DdTiles)
    t2 = np.asarray(tiles2)
    nt = blocked.num_tiles
    np.testing.assert_allclose(t2[:nt], t1[:nt], rtol=1e-11, atol=1e-11)
    lmat, umat = gather_factor(blocked, t2)
    res = factorization_residual(ro.reordered.to_scipy(), lmat, umat)
    assert res < 1e-12, res
    ts = TriangularSolver(blocked, schedule, inv_tiles=fac2.inv_tiles)
    b = generated_rhs(a)
    w = ts.solve(tiles2, ro.transform_b(b))
    x = ro.transform_x(w)
    assert residual_norm(a.to_scipy(), x, b) < 1e-12
