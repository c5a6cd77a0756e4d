"""Symbolic factorization tests: fill pattern must cover the true LU
fill (oracle: scipy splu with natural ordering)."""

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from pangulu_jax.models import poisson2d, trefethen
from pangulu_jax.sparse import CscMatrix
from pangulu_jax.symbolic import elimination_tree, symbolic


def _true_fill_blocks(a, nb):
    """Block pattern of the exact LU factors (natural order, no pivot)."""
    lu = spla.splu(a.to_scipy().tocsc(), permc_spec="NATURAL",
                   diag_pivot_thresh=0.0,
                   options=dict(SymmetricMode=True))
    pat = (abs(lu.L) + abs(lu.U)).tocoo()
    bl = -(-a.n // nb)
    mark = np.zeros((bl, bl), dtype=bool)
    mark[pat.row // nb, pat.col // nb] = True
    return mark


def test_scalar_symbolic_covers_true_fill():
    for a, nb in [(trefethen(20), 4), (poisson2d(8), 8)]:
        symb = symbolic(a, nb, mode="scalar")
        ours = np.asarray(symb.block_full.todense()) > 0
        true = _true_fill_blocks(a, nb)
        assert (ours | ~true).all(), "symbolic pattern misses true fill"


def test_block_symbolic_superset_of_scalar():
    a = poisson2d(8)
    s_scalar = symbolic(a, 8, mode="scalar")
    s_block = symbolic(a, 8, mode="block")
    sc = np.asarray(s_scalar.block_full.todense()) > 0
    bk = np.asarray(s_block.block_full.todense()) > 0
    assert (bk | ~sc).all()


def test_etree_parent_ordering():
    a = poisson2d(6)
    from pangulu_jax.sparse import symmetrize_pattern

    parent = elimination_tree(symmetrize_pattern(a))
    n = a.n
    for j in range(n):
        assert parent[j] == -1 or parent[j] > j


def test_symbolic_nnz_matches_dense_bound():
    a = trefethen(20)
    symb = symbolic(a, 4, mode="scalar")
    # |L|+|U| of symmetric symbolic is between nnz(A) and n^2
    assert a.nnz <= symb.symbolic_nnz <= a.n * a.n


def _dense_fill_flops_and_nnz(a):
    """Oracle: dense simulation of symbolic elimination on the
    symmetrized pattern; returns (exact LU flops, |L|+|U| nnz)."""
    from pangulu_jax.sparse import symmetrize_pattern

    p = symmetrize_pattern(a).toarray() != 0
    n = p.shape[0]
    np.fill_diagonal(p, True)
    flops = 0
    for k in range(n):
        rows = np.flatnonzero(p[k + 1:, k]) + k + 1
        cols = np.flatnonzero(p[k, k + 1:]) + k + 1
        flops += len(rows) + 2 * len(rows) * len(cols)
        p[np.ix_(rows, cols)] = True
    return flops, int(np.count_nonzero(p))


def test_sparse_flops_exact():
    """sparse_flops() must equal the dense elimination oracle."""
    for a in (trefethen(18), poisson2d(7)):
        symb = symbolic(a, 4, mode="scalar")
        want_flops, want_nnz = _dense_fill_flops_and_nnz(a)
        assert symb.sparse_flops() == want_flops
        assert symb.symbolic_nnz == want_nnz


def test_sparse_flops_python_native_agree():
    """Native fill_walk_counts and the pure-Python walk must agree."""
    from pangulu_jax import native
    from pangulu_jax.sparse import symmetrize_pattern
    from pangulu_jax.symbolic import _fill_walk, elimination_tree

    if native.get_lib() is None:
        import pytest

        pytest.skip("native lib unavailable")
    a = poisson2d(9)
    sym = symmetrize_pattern(a)
    parent = elimination_tree(sym)
    n = a.n
    nb = 8
    bl = -(-n // nb)
    # python path (block_mark=None disables the native shortcut)
    cc_py = np.zeros(n, dtype=np.int64)
    cnt_py = _fill_walk(sym, parent, nb, None, cc_py)
    csr = sym.tocsr()
    cnt_nat, _, cc_nat = native.fill_walk_counts(
        n, csr.indptr, csr.indices, parent, nb, bl)
    assert cnt_py == cnt_nat
    assert np.array_equal(cc_py, cc_nat)


def test_sparse_flops_none_in_block_mode():
    symb = symbolic(poisson2d(6), 8, mode="block")
    assert symb.sparse_flops() is None
