"""Property sweep: randomized matrices x dtypes x block sizes x
orderings solve to dtype-appropriate residuals (refinement included).
Bounded sizes keep the sweep fast on the CPU backend."""

import numpy as np
import pytest

from pangulu_jax.api import InitOptions, finalize, gssv, init
from pangulu_jax.models import random_unsymmetric, smallworld
from pangulu_jax.utils.perf import residual_norm

TOL = {"r32": 1e-6, "r64": 1e-10, "cr32": 1e-6, "cr64": 1e-10}
# r32/cr32 approach f64 accuracy through iterative refinement (observed
# ~1e-8; refinement stops when limited by the f32 factor quality)

CASES = [
    # (dtype, nb, ordering, generator)
    ("r64", 8, "natural", lambda: random_unsymmetric(40, 0.15, seed=1)),
    ("r64", 24, "mindeg", lambda: random_unsymmetric(150, 0.04, seed=2)),
    ("r32", 16, "rcm", lambda: smallworld(10, 0.1, seed=3)),
    ("r32", 32, "auto", lambda: random_unsymmetric(120, 0.05, seed=4)),
    ("cr32", 16, "auto",
     lambda: random_unsymmetric(80, 0.06, seed=5, dtype=np.complex128)),
    ("cr64", 24, "mindeg",
     lambda: random_unsymmetric(100, 0.05, seed=6, dtype=np.complex128)),
    ("r64", 16, "auto", lambda: random_unsymmetric(90, 0.07, seed=7)),
    ("r32", 16, "natural", lambda: random_unsymmetric(64, 0.1, seed=8)),
]


@pytest.mark.parametrize("dtype,nb,ordering,gen", CASES)
def test_random_solve(dtype, nb, ordering, gen):
    a = gen()
    s = a.to_scipy()
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(a.n)
    if dtype.startswith("cr"):
        x_true = x_true + 1j * rng.standard_normal(a.n)
    b = np.asarray(s @ x_true)
    h = init(a, InitOptions(nb=nb, dtype=dtype, ordering=ordering))
    x = gssv(h, b)
    res = residual_norm(s, x, b)
    assert res < TOL[dtype], f"residual {res:.3e} for {dtype}/{ordering}"
    finalize(h)


def _campaign_config(seed: int):
    """Deterministic pseudo-random config — the in-suite version of the
    24-config on-chip campaign (BASELINE.md round-1): random family,
    size, density, dtype, nb and ordering, everything else on auto so
    the auto-dispatch/ordering interplay is what gets exercised."""
    from pangulu_jax.models import (arrowhead, circuit, poisson2d,
                                    random_unsymmetric, smallworld)

    rng = np.random.default_rng(1000 + seed)
    family = rng.choice(["poisson2d", "smallworld", "random",
                         "arrowhead", "circuit"])
    dtype = str(rng.choice(["r32", "r64", "cr32", "cr64"]))
    nb = int(rng.choice([8, 16, 24, 32]))
    ordering = str(rng.choice(["auto", "rcm", "mindeg", "nd"]))
    vdt = np.complex128 if dtype.startswith("cr") else np.float64
    if family == "poisson2d":
        a = poisson2d(int(rng.integers(8, 15)))
        if dtype.startswith("cr"):  # complexify the values
            a = a.astype(np.complex128)
            a.values = a.values * (1 + 0.1j)
    elif family == "smallworld":
        a = smallworld(int(rng.integers(8, 13)),
                       float(rng.uniform(0.05, 0.15)), seed=seed)
        if dtype.startswith("cr"):
            a = a.astype(np.complex128)
            a.values = a.values * (1 + 0.1j)
    elif family == "random":
        a = random_unsymmetric(int(rng.integers(60, 180)),
                               float(rng.uniform(0.03, 0.1)),
                               seed=seed, dtype=vdt)
    elif family == "arrowhead":
        a = arrowhead(int(rng.integers(60, 160)))
        if dtype.startswith("cr"):
            a = a.astype(np.complex128)
            a.values = a.values * (1 + 0.1j)
    else:
        a = circuit(int(rng.integers(150, 400)), seed=seed)
        if dtype.startswith("cr"):
            a = a.astype(np.complex128)
            a.values = a.values * (1 + 0.1j)
    return a, dtype, nb, ordering, family


@pytest.mark.parametrize(
    "seed", [s if s < 10 else pytest.param(s, marks=pytest.mark.slow)
             for s in range(20)])
def test_seeded_campaign(seed):
    """Seeded randomized campaign (>=20 configs): regressions in the
    auto-dispatch / ordering / dtype interplay fail HERE in CI, not
    only in the on-chip sweep."""
    a, dtype, nb, ordering, family = _campaign_config(seed)
    s = a.to_scipy()
    rng = np.random.default_rng(seed)
    x_true = rng.standard_normal(a.n)
    if dtype.startswith("cr"):
        x_true = x_true + 1j * rng.standard_normal(a.n)
    b = np.asarray(s @ x_true)
    h = init(a, InitOptions(nb=nb, dtype=dtype, ordering=ordering))
    x = gssv(h, b)
    res = residual_norm(s, x, b)
    assert res < TOL[dtype], (
        f"residual {res:.3e} for seed={seed} "
        f"({family}/{dtype}/nb={nb}/{ordering})")
    finalize(h)
