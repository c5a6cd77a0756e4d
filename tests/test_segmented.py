"""Segmented-fused engine: must match the fused engine exactly on
skewed (mindeg-ordered) schedules."""

import numpy as np

from pangulu_jax.blocks import tile_matrix
from pangulu_jax.models import poisson2d, random_unsymmetric
from pangulu_jax.numeric import LUFactorizer
from pangulu_jax.reorder import reorder
from pangulu_jax.schedule import build_schedule
from pangulu_jax.symbolic import symbolic


def _blocked(a, nb, ordering):
    ro = reorder(a, ordering=ordering)
    symb = symbolic(ro.reordered, nb)
    blocked = tile_matrix(ro.reordered, symb)
    return blocked, build_schedule(blocked)


def test_segmented_matches_fused_mindeg():
    a = poisson2d(12)
    blocked, schedule = _blocked(a, 16, "mindeg")
    t_fused = np.asarray(LUFactorizer(blocked, schedule,
                                      dispatch="fused").factorize())
    t_seg = np.asarray(LUFactorizer(blocked, schedule,
                                    dispatch="segmented").factorize())
    nt = blocked.num_tiles
    np.testing.assert_allclose(t_seg[:nt], t_fused[:nt],
                               rtol=1e-13, atol=1e-13)


def test_segmented_matches_levels_unsymmetric():
    a = random_unsymmetric(200, 0.03, seed=5)
    blocked, schedule = _blocked(a, 32, "mindeg")
    t_lvl = np.asarray(LUFactorizer(blocked, schedule, panel_solve="inv",
                                    dispatch="levels").factorize())
    t_seg = np.asarray(LUFactorizer(blocked, schedule,
                                    dispatch="segmented").factorize())
    nt = blocked.num_tiles
    np.testing.assert_allclose(t_seg[:nt], t_lvl[:nt],
                               rtol=1e-12, atol=1e-12)


def test_segment_tables_cover_all_levels():
    a = poisson2d(10)
    blocked, schedule = _blocked(a, 8, "mindeg")
    segs = schedule.segmented_tables(blocked.num_tiles)
    diag_seen = np.concatenate([np.asarray(s[0]) for s in segs])
    real = diag_seen[diag_seen != blocked.num_tiles]
    expect = np.array([lev.diag for lev in schedule.levels])
    np.testing.assert_array_equal(real, expect)