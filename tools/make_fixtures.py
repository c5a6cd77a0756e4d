"""Generate the bundled irregular test fixtures (tests/fixtures/*.npz).

Run once (`python tools/make_fixtures.py`); the outputs are committed.
Each is a SuiteSparse-CLASS stand-in — genuinely irregular pattern +
bad scaling — for end-to-end acceptance (the reference validates on
SuiteSparse downloads, README.md:145-153; this environment has no
network, so the fixtures are deterministic generator outputs).
"""

import os

import numpy as np
import scipy.sparse as sp

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, os.pardir, "tests", "fixtures")


def _save(name, a):
    from pangulu_jax.io.mmio import write_matrix
    from pangulu_jax.sparse import CscMatrix

    path = os.path.join(OUT, name + ".npz")
    write_matrix(path, CscMatrix.from_scipy(sp.csc_matrix(a)))
    print(f"{name}: n={a.shape[0]} nnz={a.nnz} -> {path}")


def circuit_like():
    """Modified-nodal-analysis-class: pattern unsymmetric, structurally
    zero diagonals, ~8-decade value spread (memplus/rajat class)."""
    from pangulu_jax.models import circuit

    return circuit(2000, seed=11).to_scipy()


def stiff_transport():
    """Convection-dominated transport with per-row stiffness scaling
    over 12 decades (west/lns chemical-engineering class): symmetric
    diffusion pattern + one-sided convection couplings, then rows
    scaled wildly."""
    rng = np.random.default_rng(42)
    nx = 38
    n = nx * nx
    from pangulu_jax.models import poisson2d

    a = poisson2d(nx).to_scipy().tolil()
    # one-sided convection: couple each node to a node 2..5 ahead
    rows = np.arange(n - 6)
    ahead = rows + rng.integers(2, 6, size=rows.size)
    for i, j in zip(rows[::3], ahead[::3]):
        a[i, j] += rng.standard_normal() * 10.0
    a = sp.csc_matrix(a)
    rscale = 10.0 ** rng.uniform(-6, 6, size=n)
    return sp.diags(rscale) @ a


def powergrid_like():
    """Small-world grid + long-range ties with admittances spanning
    6 decades (power-network class, pattern unsymmetric via directed
    controller rows)."""
    rng = np.random.default_rng(7)
    from pangulu_jax.models import smallworld

    a = smallworld(45, long_range=0.08, seed=7).to_scipy().tolil()
    n = a.shape[0]
    # directed "controller" rows: row i reads remote bus j, not vice versa
    for _ in range(n // 20):
        i, j = rng.integers(0, n, size=2)
        if i != j:
            a[i, j] += 10.0 ** rng.uniform(-3, 3)
    a = sp.csc_matrix(a)
    scale = 10.0 ** rng.uniform(-3, 3, size=n)
    return sp.diags(scale) @ a @ sp.diags(scale)


if __name__ == "__main__":
    os.makedirs(OUT, exist_ok=True)
    _save("circuit_mna_2000", circuit_like())
    _save("stiff_transport_1444", stiff_transport())
    _save("powergrid_2025", powergrid_like())
