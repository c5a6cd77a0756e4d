#!/usr/bin/env python
"""Factor-many workflow: one symbolic analysis, many numeric
factorizations (time-stepping / Newton-type outer loops).

    python examples/run_refactorize.py

``update_values`` swaps in a same-pattern matrix in O(nnz) and reuses
the reordering, symbolic pattern, tiling and schedule; ``gstrf``
refactors on warm jit caches.  The reference requires finalize+init for
every new matrix (README.md:125) — this is the fast path it lacks.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax

# r64 needs 64-bit JAX arrays
jax.config.update("jax_enable_x64", True)

import numpy as np

from pangulu_jax import InitOptions, gstrf, gstrs, init, update_values
from pangulu_jax.models import poisson2d
from pangulu_jax.utils import enable_compilation_cache
from pangulu_jax.utils.perf import residual_norm


def main():
    enable_compilation_cache()
    a = poisson2d(40)
    s = a.to_scipy()
    h = init(a, InitOptions(nb=32, dtype="r64"))
    rng = np.random.default_rng(0)

    for step in range(4):
        b = np.asarray(s @ np.ones(a.n))
        gstrf(h)
        x = gstrs(h, b)
        res = residual_norm(s, x, b)
        print(f"step {step}: residual {res:.3e}")
        assert res < 1e-10
        # perturb values (same pattern) like a time step would
        s = s.copy()
        s.data = s.data * (1.0 + 0.05 * rng.standard_normal(s.nnz))
        update_values(h, s)


if __name__ == "__main__":
    main()
