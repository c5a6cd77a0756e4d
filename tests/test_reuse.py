"""Refactorization (update_values) and factor checkpoint/resume."""

import numpy as np
import pytest
import scipy.sparse as sp

from pangulu_jax.api import InitOptions, gstrf, gstrs, init, update_values
from pangulu_jax.io.checkpoint import load_factor, save_factor
from pangulu_jax.models import poisson2d, random_unsymmetric
from pangulu_jax.utils.perf import residual_norm


def test_update_values_same_pattern():
    a = random_unsymmetric(90, 0.06, seed=3)
    h = init(a, InitOptions(nb=16, dtype="r64"))
    b = a.to_scipy() @ np.ones(a.n)
    gstrf(h)
    x = gstrs(h, b)
    assert residual_norm(a.to_scipy(), x, b) < 1e-10

    # same pattern, new values
    s2 = a.to_scipy().copy()
    rng = np.random.default_rng(7)
    s2.data = s2.data + 0.3 * rng.standard_normal(s2.nnz)
    s2 = s2 + sp.identity(a.n, format="csc") * 3.0  # keep well-conditioned
    # identity may add pattern entries -> rebuild with original pattern
    mask = sp.csc_matrix(
        (np.ones(a.nnz), a.rowidx, a.colptr), shape=(a.n, a.n))
    s2 = s2.multiply(mask).tocsc()
    update_values(h, s2)
    gstrf(h)
    b2 = s2 @ np.ones(a.n)
    x2 = gstrs(h, b2)
    assert residual_norm(s2, x2, b2) < 1e-10


def test_update_values_rejects_new_pattern():
    a = poisson2d(8)
    h = init(a, InitOptions(nb=8, dtype="r64"))
    gstrf(h)
    s2 = a.to_scipy().copy().tolil()
    s2[0, a.n - 1] = 5.0  # structural change
    with pytest.raises(ValueError, match="same sparsity pattern"):
        update_values(h, s2.tocsc())


def test_checkpoint_roundtrip(tmp_path):
    a = random_unsymmetric(70, 0.08, seed=11)
    h = init(a, InitOptions(nb=16, dtype="r64"))
    gstrf(h)
    b = a.to_scipy() @ np.arange(1.0, a.n + 1)
    x_ref = gstrs(h, b)

    path = tmp_path / "factor.npz"
    save_factor(h, path)
    h2 = load_factor(path)
    x = gstrs(h2, b)
    np.testing.assert_allclose(x, x_ref, rtol=1e-12, atol=1e-12)
    assert residual_norm(a.to_scipy(), x, b) < 1e-10

    # the loaded handle supports refactorization too
    update_values(h2, a.to_scipy() * 2.0)
    gstrf(h2)
    x3 = gstrs(h2, b)
    assert residual_norm(a.to_scipy() * 2.0, x3, b) < 1e-10


def test_checkpoint_requires_factor(tmp_path):
    a = poisson2d(6)
    h = init(a, InitOptions(nb=8, dtype="r64"))
    with pytest.raises(RuntimeError, match="gstrf"):
        save_factor(h, tmp_path / "x.npz")


def test_refactorize_drops_stale_solver_state():
    """gstrf must invalidate the cached triangular solver: the solver
    caches triangle inverses of the factorization it first saw,
    and reusing the previous factorization's inverses would corrupt
    solves after update_values + gstrf."""
    a = random_unsymmetric(60, 0.08, seed=21)
    h = init(a, InitOptions(nb=16, dtype="r64"))
    gstrf(h)
    b = a.to_scipy() @ np.ones(a.n)
    _ = gstrs(h, b)           # caches a trisolver
    solver_before = h._trisolver
    s2 = a.to_scipy().copy()
    s2.data = s2.data * 1.7
    update_values(h, s2)
    gstrf(h)
    assert h._trisolver is not solver_before or h._trisolver is None
    b2 = s2 @ np.ones(a.n)
    x2 = gstrs(h, b2)
    assert residual_norm(s2, x2, b2) < 1e-10


def test_update_values_complex_embed_missing_diagonal():
    """Same invariant when the input is structurally MISSING diagonal
    entries: add_diagonal_elements must insert them pattern-
    preservingly (scipy 's + d' addition pruned the embed's explicit
    zeros again — advisor r4)."""
    a = random_unsymmetric(100, 0.05, seed=9, dtype=np.complex128)
    s = a.to_scipy().tolil()
    for i in (3, 41, 77):
        s[i, i] = 0.0  # lil drops explicit zeros -> structurally absent
    s = s.tocsc()
    s.eliminate_zeros()
    s.data = s.data.real.astype(np.complex128)  # imag exactly zero
    from pangulu_jax.sparse import CscMatrix

    diag = s.diagonal()
    assert np.any(diag[np.array([3, 41, 77])] == 0)
    ac = CscMatrix.from_scipy(s)
    h = init(ac, InitOptions(nb=16, dtype="cr64", complex_mode="embed"))
    gstrf(h)
    rng = np.random.default_rng(13)
    s2 = s.copy()
    s2.data = s2.data * (1.0 + 0.01 * rng.standard_normal(s.nnz)
                         + 0.01j * rng.standard_normal(s.nnz))
    update_values(h, s2)  # must NOT raise despite new imag structure
    gstrf(h)
    xref = rng.standard_normal(ac.n) + 1j * rng.standard_normal(ac.n)
    b2 = s2 @ xref
    x2 = gstrs(h, b2)
    # zeroed diagonals worsen conditioning; 1e-8 still proves the solve
    assert residual_norm(s2, x2, b2) < 1e-8


def test_update_values_complex_embed_zero_structure():
    """A pure-real complex matrix whose update gains imaginary parts:
    the embedded pattern must be value-INDEPENDENT (4 stored real
    components per complex entry, explicit zeros kept through the
    scaling/permutation chain), so update_values accepts it.
    Regression: kron-based embedding + sp.diags matmul both pruned
    stored zeros, raising a spurious pattern mismatch (found by the
    r4 cr64 soak)."""
    a = random_unsymmetric(120, 0.05, seed=5, dtype=np.complex128)
    s = a.to_scipy().tocsc()
    s.data = s.data.real.astype(np.complex128)  # imag exactly zero
    from pangulu_jax.sparse import CscMatrix, complex_embed_matrix

    ac = CscMatrix.from_scipy(s)
    assert complex_embed_matrix(ac).nnz == 4 * s.nnz
    h = init(ac, InitOptions(nb=16, dtype="cr64", complex_mode="embed"))
    gstrf(h)
    rng = np.random.default_rng(11)
    s2 = s.copy()
    s2.data = s2.data * (1.0 + 0.01 * rng.standard_normal(s.nnz)
                         + 0.01j * rng.standard_normal(s.nnz))
    update_values(h, s2)  # must NOT raise despite new imag structure
    gstrf(h)
    xref = rng.standard_normal(ac.n) + 1j * rng.standard_normal(ac.n)
    b2 = s2 @ xref
    x2 = gstrs(h, b2)
    assert residual_norm(s2, x2, b2) < 1e-10
