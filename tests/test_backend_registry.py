"""Kernel-backend registry pluggability — the counterpart of the
reference's platform registry (build_list.csv + generated dispatch,
build_helper.py): third-party backends register and dispatch without
touching the engines."""

import dataclasses

import numpy as np

from pangulu_jax.api import InitOptions, init
from pangulu_jax.blocks import gather_factor
from pangulu_jax.models import poisson2d
from pangulu_jax.numeric import LUFactorizer
from pangulu_jax.ops.interface import get_backend, register_backend
from pangulu_jax.utils.perf import factorization_residual


def test_custom_backend_registers_and_runs():
    base = get_backend("jax")
    calls = {"diag": 0}

    def counting_diag(a, tol=None):
        calls["diag"] += 1
        return base.diag_factor_invert(a, tol)

    custom = dataclasses.replace(base, name="custom-test",
                                 diag_factor_invert=counting_diag)
    register_backend(custom)
    assert get_backend("custom-test") is custom

    a = poisson2d(8)
    h = init(a, InitOptions(nb=16, dtype="r64"))
    fac = LUFactorizer(h.blocked, h.schedule,
                       backend=get_backend("custom-test"),
                       dispatch="fused")
    tiles = np.asarray(fac.factorize())
    assert calls["diag"] > 0  # engine dispatched through the custom hook
    lm, um = gather_factor(h.blocked, tiles)
    res = factorization_residual(h.reordering.reordered.to_scipy(), lm, um)
    assert res < 1e-12
