"""Etree super-level batching: independent block columns factor in one
batched step (Schedule.superlevels / the superfused engine) — the
static-schedule analogue of the reference's concurrent ready-GETRF
seeding (pangulu_numeric.c:1054-1068)."""

import numpy as np
import pytest

from pangulu_jax.blocks import gather_factor, tile_matrix
from pangulu_jax.io.mmio import generated_rhs
from pangulu_jax.models import poisson2d, smallworld
from pangulu_jax.numeric import LUFactorizer
from pangulu_jax.reorder import reorder
from pangulu_jax.schedule import build_schedule
from pangulu_jax.symbolic import symbolic
from pangulu_jax.utils.perf import factorization_residual


def _problem(a, nb, ordering):
    ro = reorder(a, ordering=ordering, nb=nb)
    symb = symbolic(ro.reordered, nb)
    blocked = tile_matrix(ro.reordered, symb)
    return ro, blocked, build_schedule(blocked)


def test_superlevel_depths_respect_dependencies():
    """depth[k] must exceed depth[j] for every present tile (j,k)/(k,j)
    with j < k (the exact write-read dependency)."""
    a = smallworld(20)
    ro, blocked, schedule = _problem(a, 16, "nd")
    depth = schedule.block_depths()
    for lev in schedule.levels:
        for j in lev.ucolrows:       # (j, k), j < k
            assert depth[j] < depth[lev.k]
        for i in lev.lrows:          # (i, k), i > k
            assert depth[lev.k] < depth[i]


def test_superlevel_members_touch_disjoint_diag_panel_tiles():
    a = smallworld(20)
    ro, blocked, schedule = _problem(a, 16, "nd")
    for group in schedule.superlevels():
        touched = set()
        for k in group:
            lev = schedule.levels[k]
            mine = {lev.diag} | set(lev.lpanel) | set(lev.upanel)
            assert not (mine & touched)
            touched |= mine
        # no member's update destination is another member's
        # diag/panel tile (destinations may collide with each other)
        for k in group:
            lev = schedule.levels[k]
            assert not (set(lev.upd_dst) & touched)


def test_superlevel_compresses_nd_schedule():
    a = smallworld(24)
    _, _, s_nd = _problem(a, 16, "nd")
    assert len(s_nd.superlevels()) < 0.7 * s_nd.block_length


@pytest.mark.parametrize("ordering", ["nd", "rcm"])
def test_superfused_matches_fused(ordering):
    a = smallworld(20)
    ro, blocked, schedule = _problem(a, 16, ordering)
    t_fused = np.asarray(LUFactorizer(
        blocked, schedule, dispatch="fused").factorize())
    t_super = np.asarray(LUFactorizer(
        blocked, schedule, dispatch="superfused").factorize())
    nt = blocked.num_tiles
    np.testing.assert_allclose(t_super[:nt], t_fused[:nt],
                               rtol=1e-9, atol=1e-9)


def test_superfused_end_to_end_residual():
    a = smallworld(22)
    ro, blocked, schedule = _problem(a, 16, "nd")
    fac = LUFactorizer(blocked, schedule, dispatch="superfused")
    tiles = fac.factorize()
    lmat, umat = gather_factor(blocked, np.asarray(tiles))
    res = factorization_residual(ro.reordered.to_scipy(), lmat, umat)
    assert res < 1e-12


def test_auto_never_picks_superfused():
    """superfused is explicitly-requested only: measured slower than
    fused on the CPU backend (padding outweighs the amortized fixed
    costs at XLA level)."""
    a = smallworld(24)
    ro, blocked, schedule = _problem(a, 16, "nd")
    fac = LUFactorizer(blocked, schedule)
    assert fac.dispatch != "superfused"
