"""Reordering tests: MC64-equivalent matching/scaling + fill-reducing
orderings (reference has no tests; oracle = mathematical invariants)."""

import numpy as np
import scipy.sparse as sp

from pangulu_jax.models import arrowhead, poisson2d, trefethen
from pangulu_jax.reorder import fill_reducing_order, mc64_scale_and_match, reorder
from pangulu_jax.sparse import CscMatrix


def test_matching_puts_large_entries_on_diagonal():
    rng = np.random.default_rng(0)
    n = 40
    # random permutation with huge entries off-diagonal
    perm = rng.permutation(n)
    a = sp.lil_matrix((n, n))
    for i in range(n):
        a[i, perm[i]] = 10.0 + rng.random()
    a = a + sp.random(n, n, density=0.1, random_state=rng) * 0.01
    a = CscMatrix.from_scipy(sp.csc_matrix(a))
    dr, dc, colperm = mc64_scale_and_match(a)
    s = sp.diags(dr) @ a.to_scipy() @ sp.diags(dc)
    s = sp.csc_matrix(s)[:, colperm]
    d = np.abs(s.diagonal())
    assert (d > 0).all()
    # every diagonal entry should be ~the max of its column
    dense = np.abs(s.todense())
    colmax = np.asarray(dense.max(axis=0)).ravel()
    assert np.all(d >= 0.5 * colmax)


def test_matching_identity_fallback_on_singular():
    # structurally singular: an empty column
    a = sp.lil_matrix((5, 5))
    a[0, 0] = a[1, 1] = a[2, 2] = a[3, 3] = 1.0
    a[4, 0] = 1.0  # column 4 empty
    a = CscMatrix.from_scipy(sp.csc_matrix(a))
    _, _, colperm = mc64_scale_and_match(a)
    assert (colperm == np.arange(5)).all()


def test_fill_reducing_is_permutation():
    a = poisson2d(8)
    for method in ("rcm", "mindeg", "natural"):
        p = fill_reducing_order(a, method)
        assert sorted(p) == list(range(a.n))


def test_mindeg_beats_natural_on_arrowhead():
    a = arrowhead(60)
    import scipy.sparse.linalg as spla

    def fill(perm):
        s = sp.csc_matrix(a.to_scipy())[perm][:, perm]
        lu = spla.splu(s.tocsc(), permc_spec="NATURAL",
                       options=dict(SymmetricMode=False))
        return lu.L.nnz + lu.U.nnz

    p = fill_reducing_order(a, "mindeg")
    assert fill(p) < fill(np.arange(a.n)) / 2


def test_reorder_roundtrip_transforms():
    a = trefethen(20)
    ro = reorder(a)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(a.n)
    b = a.to_scipy() @ x
    # A3 w = transform_b(b) should have solution w with transform_x(w) = x
    bt = ro.transform_b(b)
    w = np.linalg.solve(ro.reordered.to_scipy().todense(), bt)
    x_rec = ro.transform_x(np.asarray(w).ravel())
    np.testing.assert_allclose(x_rec, x, rtol=1e-9, atol=1e-9)


def test_nested_dissection_ordering():
    from pangulu_jax.reorder.fill_reducing import fill_reducing_order

    for a in (poisson2d(20), arrowhead(150)):
        p = fill_reducing_order(a, method="nd")
        assert sorted(p) == list(range(a.n))  # a permutation

    # end-to-end correctness under nd
    from pangulu_jax.api import InitOptions, gssv, init
    from pangulu_jax.utils.perf import residual_norm

    a = poisson2d(15)
    b = np.asarray(a.to_scipy() @ np.ones(a.n))
    h = init(a, InitOptions(nb=16, dtype="r64", ordering="nd"))
    x = gssv(h, b)
    assert residual_norm(a.to_scipy(), x, b) < 1e-10


def test_native_ndorder_valid_and_quality():
    """Native multilevel ND: valid permutation; on an irregular
    small-world graph it must clearly beat RCM's fill (the reference's
    METIS_NodeND role for its target matrix class)."""
    from pangulu_jax import native
    from pangulu_jax.models import smallworld
    from pangulu_jax.sparse import CscMatrix, symmetrize_pattern
    from pangulu_jax.symbolic import symbolic
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    if native.get_lib() is None:
        import pytest

        pytest.skip("native lib unavailable")
    a = smallworld(40)  # n=1600
    sym = symmetrize_pattern(a)
    csr = sym.tocsr()
    p = np.asarray(native.ndorder(a.n, csr.indptr, csr.indices, 128))
    assert sorted(p) == list(range(a.n))
    s = a.to_scipy()

    def fill_of(perm):
        s3 = sp.csc_matrix(s[perm][:, perm])
        s3.sort_indices()
        return symbolic(CscMatrix.from_scipy(s3), 32,
                        mode="scalar").symbolic_nnz

    rcm = np.asarray(reverse_cuthill_mckee(sym, symmetric_mode=True),
                     dtype=np.int64)
    assert fill_of(p) < 0.7 * fill_of(rcm)


def test_ndorder_solves_end_to_end():
    from pangulu_jax.api import InitOptions, gssv, finalize, init
    from pangulu_jax.io.mmio import generated_rhs
    from pangulu_jax.models import smallworld
    from pangulu_jax.utils.perf import residual_norm

    a = smallworld(20)
    b = generated_rhs(a)
    h = init(a, InitOptions(nb=16, dtype="r64", ordering="nd"))
    x = gssv(h, b)
    assert residual_norm(a.to_scipy(), x, b) < 1e-10
    finalize(h)


def test_mindeg_dense_phase_terminates():
    """Expander-class graphs densify the quotient graph; the dense-
    phase shortcut must keep mindeg near-linear (this case hung before
    round 2)."""
    import time

    from pangulu_jax import native
    from pangulu_jax.models import smallworld
    from pangulu_jax.sparse import symmetrize_pattern

    if native.get_lib() is None:
        import pytest

        pytest.skip("native lib unavailable")
    a = smallworld(50, long_range=0.2, seed=2)  # n=2500, very irregular
    csr = symmetrize_pattern(a).tocsr()
    t0 = time.perf_counter()
    p = native.mindeg(a.n, csr.indptr, csr.indices)
    assert time.perf_counter() - t0 < 30.0
    assert sorted(p) == list(range(a.n))
