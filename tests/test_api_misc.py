"""API misc: error paths, finalize idempotency, banner, analyze."""

import numpy as np
import pytest

from pangulu_jax.api import InitOptions, finalize, gstrf, gstrs, init
from pangulu_jax.models import poisson2d
from pangulu_jax.utils.log import config_banner


def test_gstrs_before_gstrf_raises():
    h = init(poisson2d(6), InitOptions(nb=8, dtype="r64"))
    with pytest.raises(RuntimeError, match="gstrf"):
        gstrs(h, np.ones(h.blocked.n))


def test_finalize_idempotent():
    h = init(poisson2d(6), InitOptions(nb=8, dtype="r64"))
    gstrf(h)
    finalize(h)
    finalize(h)  # second call is a no-op
    assert h.factor_tiles is None
    with pytest.raises(RuntimeError):
        gstrs(h, np.ones(h.blocked.n))


def test_config_banner_contents():
    opts = InitOptions(nb=32, dtype="r32", ordering="rcm")
    s = config_banner(opts, 100, 500, (2, 2))
    for needle in ("n", "nnz", "r32", "rcm", "(2, 2)"):
        assert str(needle) in s


def test_invalid_dtype_rejected():
    with pytest.raises(ValueError, match="dtype"):
        init(poisson2d(4), InitOptions(nb=8, dtype="q128"))


def test_invalid_complex_mode_rejected():
    a = poisson2d(4).to_scipy().astype(np.complex128)
    with pytest.raises(ValueError, match="complex_mode"):
        init(a, InitOptions(nb=8, dtype="cr64", complex_mode="bogus"))


def test_init_options_tol_is_honored():
    """InitOptions.tol must reach the diagonal kernels: with an absurdly
    large tiny-pivot threshold every pivot is replaced by tol, so the
    factorization visibly changes."""
    import numpy as np

    from pangulu_jax.api import InitOptions, finalize, gstrf, init
    from pangulu_jax.models import poisson2d

    a = poisson2d(6)
    h1 = init(a, InitOptions(nb=8, dtype="r64"))
    gstrf(h1)
    t1 = np.asarray(h1.factor_tiles)
    h2 = init(a, InitOptions(nb=8, dtype="r64", tol=1e6))
    gstrf(h2)
    t2 = np.asarray(h2.factor_tiles)
    assert not np.allclose(t1, t2)
    finalize(h1)
    finalize(h2)


def test_r64_init_enables_x64_outside_tests():
    """Library surface: requesting r64 in a process where x64 is OFF
    must not silently compute in f32 (init enables jax_enable_x64, as
    the CLI does).  Run in a subprocess because the suite itself forces
    x64 on."""
    import subprocess
    import sys

    code = (
        "import jax; jax.config.update('jax_platforms','cpu')\n"
        "assert not jax.config.jax_enable_x64\n"
        "from pangulu_jax import Solver, InitOptions\n"
        "from pangulu_jax.models import trefethen\n"
        "from pangulu_jax.io.mmio import generated_rhs\n"
        "import numpy as np\n"
        "a = trefethen(16)\n"
        "x = Solver(a, InitOptions(nb=8, dtype='r64'))"
        ".solve(generated_rhs(a))\n"
        "b = np.asarray(generated_rhs(a), np.float64)\n"
        "r = a.to_scipy() @ np.asarray(x, np.float64) - b\n"
        "res = np.linalg.norm(r) / np.linalg.norm(b)\n"
        "assert res < 1e-12, f'silent f32 downcast: residual {res:.2e}'\n"
    )
    env = dict(__import__("os").environ)
    env.pop("JAX_ENABLE_X64", None)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
