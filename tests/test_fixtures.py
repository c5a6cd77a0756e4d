"""On-disk fixture acceptance: the reference's ACTUAL bundled matrix
(/root/reference/examples/Trefethen_20b.mtx — integer symmetric
MatrixMarket, exercising the native mmio path) plus bundled irregular
SuiteSparse-class fixtures (tests/fixtures/*.npz, generated once by
tools/make_fixtures.py).

Acceptance formulas are the reference's own: the gstrf check
``||L(U*1)-A*1||/||A*1||`` (pangulu_numeric.c:1082-1341) and the
driver's solve residual ``||Ax-b||/||b||`` (examples/example.c:252-266).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from pangulu_jax.api import InitOptions, finalize, gstrf, gstrs, init
from pangulu_jax.io.mmio import generated_rhs, read_matrix
from pangulu_jax.utils.perf import residual_norm

REF_MTX = "/root/reference/examples/Trefethen_20b.mtx"
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")

needs_ref = pytest.mark.skipif(not os.path.exists(REF_MTX),
                               reason="reference fixture not present")


@needs_ref
def test_reference_fixture_from_disk():
    """Full init/gstrf/gstrs on the reference's own smoke-test matrix,
    read from DISK (integer symmetric mtx -> native reader path), at
    the reference's smoke nb=10 (README.md:145-153)."""
    a = read_matrix(REF_MTX, dtype=np.float64)
    assert a.n == 19 and a.nnz == 147, (a.n, a.nnz)  # 19x19 expanded
    b = generated_rhs(a)
    h = init(a, InitOptions(nb=10, dtype="r64", check=True))
    gstrf(h)
    assert h.perf.kernels["gstrf_residual"] < 1e-14
    x = gstrs(h, b)
    assert residual_norm(a.to_scipy(), x, b) < 1e-14
    np.testing.assert_allclose(x, np.ones(a.n), rtol=1e-10)
    finalize(h)


@needs_ref
def test_reference_fixture_matches_generator():
    """The generated trefethen(20) twin must equal the on-disk fixture
    exactly (values are small integers/primes)."""
    from pangulu_jax.models import trefethen

    disk = read_matrix(REF_MTX, dtype=np.float64).to_scipy()
    gen = trefethen(20).to_scipy()
    assert (disk != gen).nnz == 0


@needs_ref
@pytest.mark.slow
def test_reference_fixture_through_cli(tmp_path):
    """The reference's smoke test through our CLI driver: mtx from
    disk, nb=10, --check — the two acceptance residuals printed and
    exit 0."""
    out = subprocess.run(
        [sys.executable, "-m", "pangulu_jax.cli", "-f", REF_MTX,
         "-nb", "10", "--dtype", "r64", "--check", "--platform", "cpu"],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "solve residual" in out.stdout
    res = float(out.stdout.split("solve residual")[1].split("=")[1].split()[0])
    assert res < 1e-12, out.stdout


@pytest.mark.parametrize("name,tol", [
    ("circuit_mna_2000", 1e-9),
    ("stiff_transport_1444", 1e-10),
    ("powergrid_2025", 1e-10),
])
def test_bundled_irregular_fixtures(name, tol):
    """End-to-end on genuinely irregular, badly-scaled matrices from
    disk: auto ordering + MC64 + refinement must reach the acceptance
    residual."""
    a = read_matrix(os.path.join(FIXDIR, name + ".npz"))
    s = a.to_scipy()
    rng = np.random.default_rng(3)
    x_true = rng.standard_normal(a.n)
    b = np.asarray(s @ x_true)
    h = init(a, InitOptions(nb=32, dtype="r64", check=True))
    gstrf(h)
    x = gstrs(h, b)
    res = residual_norm(s, x, b)
    assert res < tol, f"{name}: residual {res:.3e}"
    finalize(h)


@pytest.mark.slow
def test_bundled_fixture_requires_mc64():
    """The circuit fixture must actually NEED the MC64 path (otherwise
    it is not testing what it claims): without matching/scaling the
    factorization blows up."""
    a = read_matrix(os.path.join(FIXDIR, "circuit_mna_2000.npz"))
    s = a.to_scipy()
    b = np.asarray(s @ np.ones(a.n))
    h = init(a, InitOptions(nb=32, dtype="r64", mc64=False, refine=0))
    gstrf(h)
    x = gstrs(h, b)
    res_off = residual_norm(s, x, b)
    finalize(h)
    assert not np.isfinite(res_off) or res_off > 1e3, res_off
