"""Native C++ runtime parity tests: every native function must agree
with its pure-Python reference implementation."""

import numpy as np
import pytest
import scipy.sparse as sp

from pangulu_jax import native
from pangulu_jax.models import poisson2d, random_unsymmetric, trefethen
from pangulu_jax.sparse import CscMatrix, symmetrize_pattern

pytestmark = pytest.mark.skipif(native.get_lib() is None,
                                reason="native lib unavailable")


def _py_etree(sym):
    n = sym.shape[0]
    csr = sym.tocsr()
    indptr, indices = csr.indptr, csr.indices
    parent = np.full(n, -1, dtype=np.int64)
    ancestor = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        for k in indices[indptr[i]:indptr[i + 1]]:
            if k >= i:
                continue
            j = k
            while ancestor[j] != -1 and ancestor[j] != i:
                t = ancestor[j]
                ancestor[j] = i
                j = t
            if ancestor[j] == -1:
                ancestor[j] = i
                parent[j] = i
    return parent


def test_etree_parity():
    for a in [trefethen(20), poisson2d(10)]:
        sym = symmetrize_pattern(a)
        csr = sym.tocsr()
        got = native.etree(a.n, csr.indptr, csr.indices)
        np.testing.assert_array_equal(got, _py_etree(sym))


def test_fill_walk_parity():
    a = poisson2d(10)
    nb = 8
    bl = -(-a.n // nb)
    sym = symmetrize_pattern(a)
    csr = sym.tocsr()
    parent = native.etree(a.n, csr.indptr, csr.indices)
    count, mark = native.fill_walk(a.n, csr.indptr, csr.indices, parent,
                                   nb, bl)
    # python reference
    from pangulu_jax.symbolic import _fill_walk

    pmark = np.zeros((bl, bl), dtype=bool)
    visited = np.full(a.n, -1, dtype=np.int64)
    pcount = 0
    indptr, indices = csr.indptr, csr.indices
    for i in range(a.n):
        visited[i] = i
        bi = i // nb
        for k in indices[indptr[i]:indptr[i + 1]]:
            if k >= i:
                continue
            j = k
            while visited[j] != i:
                visited[j] = i
                pcount += 1
                pmark[bi, j // nb] = True
                j = parent[j]
                if j == -1 or j >= i:
                    break
    assert count == pcount
    np.testing.assert_array_equal(mark, pmark)


def test_mindeg_is_valid_permutation_and_reduces_fill():
    from pangulu_jax.models import arrowhead
    import scipy.sparse.linalg as spla

    a = arrowhead(80)
    sym = symmetrize_pattern(a).tocsr()
    order = native.mindeg(a.n, sym.indptr, sym.indices)
    assert sorted(order) == list(range(a.n))
    s = sp.csc_matrix(a.to_scipy())[order][:, order]
    lu = spla.splu(s, permc_spec="NATURAL", options=dict(SymmetricMode=False))
    lu0 = spla.splu(a.to_scipy().tocsc(), permc_spec="NATURAL",
                    options=dict(SymmetricMode=False))
    assert lu.L.nnz + lu.U.nnz < (lu0.L.nnz + lu0.U.nnz) / 2


def test_mc64_unit_diagonal_and_feasible():
    rng = np.random.default_rng(2)
    a = random_unsymmetric(120, 0.04, seed=3)
    s = a.to_scipy().copy()
    s.data = np.abs(s.data)
    res = native.mc64(a.n, s.indptr, s.indices, s.data)
    assert res is not None
    colperm, dr, dc = res
    assert sorted(colperm) == list(range(a.n))
    scaled = sp.diags(dr) @ s @ sp.diags(dc)
    perm = sp.csc_matrix(scaled)[:, colperm]
    d = np.abs(perm.diagonal())
    np.testing.assert_allclose(d, 1.0, rtol=1e-10)
    assert np.abs(perm.todense()).max() <= 1.0 + 1e-10


def test_mc64_matches_scipy_optimum():
    """Total log-product of the matched diagonal must equal scipy's
    optimal assignment value."""
    from scipy.sparse.csgraph import min_weight_full_bipartite_matching

    a = random_unsymmetric(60, 0.08, seed=4)
    s = a.to_scipy().copy()
    s.data = np.abs(s.data)
    res = native.mc64(a.n, s.indptr, s.indices, s.data)
    colperm, _, _ = res
    dense = np.asarray(np.abs(s.todense()))
    ours = np.sum([np.log(dense[i, colperm[i]]) for i in range(a.n)])
    # scipy on the -log cost (maximize product)
    cost = s.copy()
    cost.data = -np.log(cost.data)
    # shift to positive as scipy treats explicit zeros as absent edges
    cost.data = cost.data + 100.0
    rows, cols = min_weight_full_bipartite_matching(cost.tocsr())
    best = np.sum([np.log(dense[i, j]) for i, j in zip(rows, cols)])
    np.testing.assert_allclose(ours, best, rtol=1e-9)


def test_mc64_singular_returns_none():
    s = sp.csc_matrix((5, 5))
    s[0, 0] = s[1, 1] = s[2, 2] = s[3, 3] = 1.0
    s[4, 0] = 1.0
    s = sp.csc_matrix(s)
    assert native.mc64(5, s.indptr, s.indices, np.abs(s.data)) is None


def test_native_mmio_reader(tmp_path):
    """Native C++ MatrixMarket reader matches scipy across storage
    variants (general / symmetric / hermitian / pattern)."""
    import scipy.io
    import scipy.sparse as sp

    from pangulu_jax.io.mmio import _read_mtx_native, read_matrix, \
        write_matrix
    from pangulu_jax.models import random_unsymmetric

    a = random_unsymmetric(120, 0.05, seed=4)
    p = tmp_path / "g.mtx"
    write_matrix(p, a)
    if _read_mtx_native(p) is None:
        import pytest

        pytest.skip("native lib unavailable")
    assert (read_matrix(p).to_scipy() != a.to_scipy()).nnz == 0

    s = a.to_scipy()
    s = (s + s.T) / 2
    ps = tmp_path / "s.mtx"
    scipy.io.mmwrite(ps, sp.csc_matrix(s), symmetry="symmetric")
    assert abs(read_matrix(ps).to_scipy() - s).max() < 1e-12

    c = s.astype(np.complex128) + 1j * sp.triu(s, 1) - 1j * sp.tril(s, -1)
    c = sp.csc_matrix((c + c.getH()) / 2)
    ph = tmp_path / "h.mtx"
    scipy.io.mmwrite(ph, c)
    assert abs(read_matrix(ph).to_scipy() - c).max() < 1e-12
