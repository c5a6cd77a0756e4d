"""IO, model generators, tiling and schedule invariants."""

import numpy as np
import scipy.sparse as sp

from pangulu_jax.blocks import gather_factor, tile_matrix
from pangulu_jax.io.mmio import generated_rhs, read_matrix, write_matrix
from pangulu_jax.models import poisson2d, trefethen
from pangulu_jax.reorder import reorder
from pangulu_jax.schedule import bucket, build_schedule
from pangulu_jax.sparse import CscMatrix, add_diagonal_elements
from pangulu_jax.symbolic import symbolic


def test_trefethen_matches_reference_fixture():
    """The reference fixture is 19x19 with 147 nnz (Trefethen_20b)."""
    a = trefethen(20)
    assert a.n == 19
    assert a.nnz == 147
    s = a.to_scipy()
    assert (abs(s - s.T) > 0).nnz == 0  # symmetric
    assert s.diagonal()[0] == 3.0       # primes 3,5,7,... after drop


def test_mmio_roundtrip(tmp_path):
    a = trefethen(20)
    path = tmp_path / "t.mtx"
    write_matrix(path, a)
    b = read_matrix(path)
    assert (a.to_scipy() != b.to_scipy()).nnz == 0


def test_add_diagonal_elements():
    a = sp.csc_matrix(np.array([[1.0, 2.0], [3.0, 0.0]]))
    out = add_diagonal_elements(CscMatrix.from_scipy(a))
    assert out.to_scipy()[1, 1] == 1e-8
    # explicit stored zero is kept (only structural gaps are filled)
    a2 = sp.csc_matrix(np.array([[1.0, 2.0], [3.0, 4.0]]))
    out2 = add_diagonal_elements(CscMatrix.from_scipy(a2))
    assert out2.nnz == 4


def test_add_diagonal_keeps_explicit_zeros():
    """Inserting missing diagonals must NOT prune explicit stored
    zeros elsewhere (advisor r4: scipy 's + d' pruned the complex
    embed's exact-zero components whenever the need-branch ran)."""
    rows = np.array([0, 1, 2, 0])
    cols = np.array([0, 0, 1, 2])
    vals = np.array([1.0, 0.0, 3.0, 0.0])  # two explicit zeros
    a = CscMatrix.from_scipy(
        sp.csc_matrix((vals, (rows, cols)), shape=(3, 3)))
    assert a.nnz == 4
    out = add_diagonal_elements(a)  # cols 1 and 2 lack diagonals
    assert out.nnz == 6
    s = out.to_scipy()
    assert s[1, 1] == 1e-8 and s[2, 2] == 1e-8
    assert s[1, 0] == 0.0 and (s.indptr[1] - s.indptr[0]) == 2


def test_tile_matrix_fallback_above_dense_lookup():
    """tile_matrix at bl > _DENSE_LOOKUP_MAX_BL must use the batched
    searchsorted path and still scatter correctly (the old per-element
    Python loop was O(nnz) interpreter work and never yielded -1)."""
    import pangulu_jax.blocks as blocks_mod

    a = poisson2d(12)
    ro = reorder(a, ordering="natural", mc64=False)
    symb = symbolic(ro.reordered, 8)
    ref = tile_matrix(ro.reordered, symb)
    old = blocks_mod._DENSE_LOOKUP_MAX_BL
    blocks_mod._DENSE_LOOKUP_MAX_BL = 0  # force the fallback
    try:
        blocked = tile_matrix(ro.reordered, symb)
    finally:
        blocks_mod._DENSE_LOOKUP_MAX_BL = old
    assert blocked._lookup is None
    np.testing.assert_array_equal(blocked.scatter_plan[0],
                                  ref.scatter_plan[0])
    # vectorized tile_ids agrees too, including out-of-pattern -> -1
    bi = np.array([0, blocked.block_length - 1, 0])
    bj = np.array([0, 0, blocked.block_length - 1])
    got = blocked.tile_ids(bi, bj)
    want = np.array([blocked.tile_id(int(i), int(j))
                     for i, j in zip(bi, bj)])
    np.testing.assert_array_equal(got, want)


def test_tile_roundtrip():
    a = poisson2d(6)
    ro = reorder(a, ordering="natural", mc64=False)
    symb = symbolic(ro.reordered, 8)
    blocked = tile_matrix(ro.reordered, symb)
    # Reassembling the unfactored tiles must reproduce A (L strict
    # lower + U upper incl diag = A when tiles hold raw values).
    lmat, umat = gather_factor(blocked, blocked.tiles)
    recon = (lmat - sp.identity(a.n)) + umat
    diff = abs(recon - ro.reordered.to_scipy())
    assert diff.max() < 1e-14


def test_schedule_invariants():
    a = poisson2d(6)
    ro = reorder(a)
    symb = symbolic(ro.reordered, 8)
    blocked = tile_matrix(ro.reordered, symb)
    sched = build_schedule(blocked)
    assert len(sched.levels) == blocked.block_length
    for lev in sched.levels:
        # L-panel rows strictly below, U-panel cols strictly right
        assert (lev.lrows > lev.k).all()
        assert (lev.ucols > lev.k).all()
        # update destinations unique within a level (scatter-add safety)
        assert len(np.unique(lev.upd_dst)) == len(lev.upd_dst)
        # every update references a valid panel position
        if len(lev.upd_dst):
            assert lev.upd_l.max() < len(lev.lpanel)
            assert lev.upd_u.max() < len(lev.upanel)
    assert sched.flop_estimate() > 0


def test_bucket_padding():
    assert bucket(0) == 0
    assert bucket(1) == 1
    assert bucket(5) == 8
    assert bucket(8) == 8


def test_generated_rhs_is_row_sums():
    a = trefethen(20)
    b = generated_rhs(a)
    np.testing.assert_allclose(b, np.asarray(a.to_scipy().sum(axis=1)).ravel())


def test_npz_matrix_roundtrip(tmp_path):
    from pangulu_jax.io.mmio import read_matrix, write_matrix
    from pangulu_jax.models import poisson2d

    a = poisson2d(9)
    p = tmp_path / "m.npz"
    write_matrix(p, a)
    b = read_matrix(p, dtype=a.values.dtype)
    assert (a.to_scipy() != b.to_scipy()).nnz == 0


def test_rejects_non_square():
    import pytest
    import scipy.sparse as sp

    from pangulu_jax.api import InitOptions, init

    with pytest.raises(ValueError, match="square"):
        init(sp.random(5, 7, density=0.5, format="csc"),
             InitOptions(nb=4))


def test_rhs_length_mismatch(tmp_path):
    import pytest

    from pangulu_jax.io.mmio import read_rhs

    p = tmp_path / "b.txt"
    np.savetxt(p, np.ones(5))
    with pytest.raises(ValueError, match="rhs length"):
        read_rhs(p, 7, np.float64)


def test_lid_roundtrip(tmp_path):
    """Binary .lid CSR format (reference: examples/example.c:100-164):
    u32 m,n + u64 nnz header, u64 rowptr, u32 colidx (0-based), raw
    values."""
    from pangulu_jax.io.mmio import read_matrix, write_matrix

    a = poisson2d(9)
    p = tmp_path / "m.lid"
    write_matrix(p, a)
    b = read_matrix(p)
    assert (a.to_scipy() != b.to_scipy()).nnz == 0
    assert b.values.dtype == np.float64

    # f32 values round-trip via the inferred 4-byte width
    a32 = CscMatrix.from_scipy(a.to_scipy().astype(np.float32))
    p32 = tmp_path / "m32.lid"
    write_matrix(p32, a32)
    b32 = read_matrix(p32)
    assert b32.values.dtype == np.float32
    assert (a32.to_scipy() != b32.to_scipy()).nnz == 0

    # header/layout is byte-exact vs a hand-built file
    s = a.to_scipy().tocsr()
    raw = (np.asarray(s.shape, np.uint32).tobytes()
           + np.asarray([s.nnz], np.uint64).tobytes()
           + s.indptr.astype(np.uint64).tobytes()
           + s.indices.astype(np.uint32).tobytes()
           + s.data.tobytes())
    assert raw == p.read_bytes()

    # truncated file -> clean error
    (tmp_path / "bad.lid").write_bytes(raw[:10])
    import pytest

    with pytest.raises(ValueError, match="truncated"):
        read_matrix(tmp_path / "bad.lid")


def test_cli_solves_lid_same_as_mtx(tmp_path, capsys):
    """The CLI must solve a .lid matrix with the same residual as its
    .mtx twin (reference example ingests both, example.c:100-164)."""
    from pangulu_jax.cli import main

    a = poisson2d(8)
    write_matrix(tmp_path / "m.mtx", a)
    write_matrix(tmp_path / "m.lid", a)
    res = {}
    for ext in ("mtx", "lid"):
        rc = main(["-f", str(tmp_path / f"m.{ext}"), "-nb", "16",
                   "--dtype", "r64", "--platform", "cpu"])
        assert rc == 0
        out = capsys.readouterr().out
        line = [l for l in out.splitlines() if "solve residual" in l][0]
        res[ext] = float(line.split("=")[1])
    assert res["lid"] < 1e-12 and res["mtx"] < 1e-12


def test_read_mtx_gz(tmp_path):
    import gzip
    import shutil

    from pangulu_jax.io.mmio import read_matrix, write_matrix
    from pangulu_jax.models import poisson2d

    a = poisson2d(7)
    p = tmp_path / "m.mtx"
    write_matrix(p, a)
    pgz = tmp_path / "m.mtx.gz"
    with open(p, "rb") as fin, gzip.open(pgz, "wb") as fout:
        shutil.copyfileobj(fin, fout)
    b = read_matrix(pgz)
    assert (a.to_scipy() != b.to_scipy()).nnz == 0


def test_read_rhs_binary(tmp_path):
    from pangulu_jax.io.mmio import read_rhs

    b = np.arange(9.0)
    np.save(tmp_path / "b.npy", b)
    np.savez(tmp_path / "b.npz", b=b)
    np.testing.assert_array_equal(
        read_rhs(tmp_path / "b.npy", 9, np.float64), b)
    np.testing.assert_array_equal(
        read_rhs(tmp_path / "b.npz", 9, np.float64), b)


def test_perf_to_dict():
    import json

    from pangulu_jax.utils.perf import PerfCounters

    p = PerfCounters()
    with p.phase("numeric"):
        pass
    p.add_flops(10.0)
    p.kernel_counts(getrf=2)
    d = p.to_dict()
    json.dumps(d)  # serializable
    assert d["kernels"]["getrf"] == 2 and "numeric" in d["phase_time_s"]
