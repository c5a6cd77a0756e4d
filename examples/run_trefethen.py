#!/usr/bin/env python
"""Smoke example — the reference's documented smoke test
(README.md:145-153: Trefethen_20b.mtx, nb=10) without needing the .mtx
file: the fixture is generated programmatically.

    python examples/run_trefethen.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax

# r64 needs 64-bit JAX arrays
jax.config.update("jax_enable_x64", True)

import numpy as np

from pangulu_jax import InitOptions, Solver
from pangulu_jax.io.mmio import generated_rhs
from pangulu_jax.models import trefethen
from pangulu_jax.utils import enable_compilation_cache
from pangulu_jax.utils.perf import residual_norm


def main():
    enable_compilation_cache()
    a = trefethen(20)           # 19x19, 147 nnz == Trefethen_20b
    b = generated_rhs(a)        # b = A @ 1
    solver = Solver(a, InitOptions(nb=10, dtype="r64", check=True))
    x = solver.solve(b)
    res = residual_norm(a.to_scipy(), x, b)
    print(solver.perf.summary())
    print(f"||Ax-b||/||b|| = {res:.3e}  (exact solution is ones; "
          f"max |x-1| = {np.abs(x - 1).max():.3e})")
    assert res < 1e-12


if __name__ == "__main__":
    main()
