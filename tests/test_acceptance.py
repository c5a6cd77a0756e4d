"""Real-matrix acceptance (VERDICT r1, missing #8 / next #9): a
genuinely irregular, pattern-unsymmetric, MC64-REQUIRING circuit-class
matrix through the full CLI path, plus the pathological error paths
the reference aborts on (null columns, pangulu_reordering.c:181-186;
singular pivots)."""

import numpy as np
import pytest
import scipy.sparse as sp

from pangulu_jax import cli
from pangulu_jax.api import InitOptions, finalize, gssv, gstrf, init
from pangulu_jax.io.mmio import write_matrix
from pangulu_jax.models import circuit
from pangulu_jax.utils.perf import residual_norm


def test_circuit_matrix_requires_mc64():
    """Without MC64 the unpivoted factorization must blow up on the
    circuit-class matrix; with MC64 it must solve well."""
    a = circuit(1200, seed=3)
    d = a.to_scipy().diagonal()
    assert (d == 0).sum() > 50          # structurally zero diagonals
    b = np.asarray(a.to_scipy() @ np.ones(a.n))
    h = init(a, InitOptions(nb=32, dtype="r64", mc64=True))
    x = gssv(h, b)
    finalize(h)
    good = residual_norm(a.to_scipy(), x, b)
    assert good < 1e-6, good
    h = init(a, InitOptions(nb=32, dtype="r64", mc64=False, refine=0))
    x = gssv(h, b)
    finalize(h)
    bad = residual_norm(a.to_scipy(), x, b)
    assert not np.isfinite(bad) or bad > 1e3  # catastrophic without MC64


def test_circuit_matrix_cli_end_to_end(tmp_path, capsys):
    a = circuit(800, seed=5)
    mtx = str(tmp_path / "circuit.mtx")
    write_matrix(mtx, a)
    rc = cli.main(["-f", mtx, "-nb", "32", "--dtype", "r64", "--check",
                   "--platform", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "solve residual" in out


def test_structurally_singular_identity_fallback(caplog):
    """Empty column: MC64 has no perfect matching — match the
    reference's graceful path (identity perm + warning + tiny-pivot
    substitution, pangulu_reordering.c:1152-1171) rather than its
    example-level abort."""
    n = 30
    s = sp.lil_matrix((n, n))
    for i in range(n - 1):
        s[i, i] = 2.0
        s[i, i + 1] = -1.0
    # column n-1 and row n-1 entirely empty -> structurally singular
    a = sp.csc_matrix(s)
    h = init(a, InitOptions(nb=8, dtype="r64"))
    gstrf(h)  # must not raise: placeholder diagonal gives a pivot slot
    finalize(h)


def test_numerically_singular_finite_behavior():
    """Exactly singular values (duplicate rows): tiny-pivot
    substitution keeps the factorization finite (the reference
    substitutes 1e-16, pangulu_platform_0100000.c:80-84)."""
    n = 24
    rng = np.random.default_rng(0)
    m = rng.standard_normal((n, n))
    m[n - 1] = m[n - 2]                  # rank-deficient
    a = sp.csc_matrix(m)
    h = init(a, InitOptions(nb=8, dtype="r64"))
    gstrf(h)
    tiles = np.asarray(h.factor_tiles)
    assert np.all(np.isfinite(tiles))
    finalize(h)


def test_cli_missing_file_clean_error(capsys):
    rc = cli.main(["-f", "/nonexistent/x.mtx", "-nb", "16",
                   "--platform", "cpu"])
    assert rc == 2
    assert "error reading matrix" in capsys.readouterr().err


def test_rhs_wrong_length_raises(tmp_path):
    from pangulu_jax.api import gstrs

    a = circuit(100, seed=7)
    h = init(a, InitOptions(nb=16, dtype="r64"))
    gstrf(h)
    with pytest.raises(ValueError):
        gstrs(h, np.ones(a.n + 5))
    finalize(h)
