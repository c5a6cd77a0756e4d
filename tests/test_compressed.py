"""Compressed (sparse-in-tile) factor storage — the reference's
nnz-capacity-class block storage (pangulu_storage.c:83-293) re-expressed
for XLA: O(fill) HBM, identical numerics."""

import numpy as np
import pytest

from pangulu_jax.api import InitOptions, finalize, gssv, gstrf, gstrs, init
from pangulu_jax.blocks import tile_matrix
from pangulu_jax.compressed import CompressedLU, CompressedTiles
from pangulu_jax.io.mmio import generated_rhs
from pangulu_jax.models import circuit, poisson2d, smallworld
from pangulu_jax.numeric import LUFactorizer
from pangulu_jax.reorder import reorder
from pangulu_jax.schedule import build_schedule
from pangulu_jax.symbolic import symbolic
from pangulu_jax.utils.perf import residual_norm


def _problem(a, nb, ordering="rcm"):
    ro = reorder(a, ordering=ordering, nb=nb)
    symb = symbolic(ro.reordered, nb)
    blocked = tile_matrix(ro.reordered, symb)
    return ro, blocked, build_schedule(blocked)


def test_compressed_store_roundtrip():
    """Densified compressed store must equal the dense tile store."""
    a = poisson2d(9)
    ro, blocked, schedule = _problem(a, 8)
    st = CompressedTiles(blocked, ro.reordered)
    dense = np.asarray(st)
    np.testing.assert_array_equal(dense[: blocked.num_tiles],
                                  blocked.tiles[: blocked.num_tiles])


def test_compressed_factorize_bitexact_vs_dense():
    a = smallworld(14)
    ro, blocked, schedule = _problem(a, 16)
    dense_tiles = np.asarray(LUFactorizer(
        blocked, schedule, dispatch="fused").factorize())
    clu = CompressedLU(blocked, schedule, ro.reordered)
    st = clu.factorize()
    nt = blocked.num_tiles
    np.testing.assert_allclose(np.asarray(st)[:nt], dense_tiles[:nt],
                               rtol=1e-12, atol=1e-14)


def test_compressed_end_to_end_api():
    a = circuit(600, seed=2)
    b = generated_rhs(a)
    h = init(a, InitOptions(nb=32, dtype="r64",
                            tile_storage="compressed"))
    x = gssv(h, b)
    res = residual_norm(a.to_scipy(), x, b)
    assert res < 1e-6, res
    # factor-once / solve-many on the same compressed handle
    b2 = np.asarray(a.to_scipy() @ np.arange(1.0, a.n + 1))
    x2 = gstrs(h, b2)
    assert residual_norm(a.to_scipy(), x2, b2) < 1e-6
    finalize(h)


@pytest.mark.slow
def test_compressed_memory_savings_circuit():
    """VERDICT r1 done-criterion: >= 3x HBM reduction on a
    circuit-class matrix with residual parity."""
    a = circuit(3000, seed=4)
    ro, blocked, schedule = _problem(a, 32, ordering="mindeg")
    st = CompressedTiles(blocked, ro.reordered)
    ratio = st.dense_bytes / st.compressed_bytes
    assert ratio >= 3.0, ratio
    clu = CompressedLU(blocked, schedule, ro.reordered)
    clu.factorize()
    b = generated_rhs(a)
    w = clu.solve(ro.transform_b(b))
    x = ro.transform_x(w)
    assert residual_norm(a.to_scipy(), x, b) < 1e-6


def test_compressed_refactorize_fast_path():
    """update_values + gstrf on compressed storage reuses the store
    STRUCTURE (O(nnz) refill, no second fill walk) and stays correct."""
    a = circuit(500, seed=4)
    s = a.to_scipy()
    h = init(a, InitOptions(nb=16, dtype="r64",
                            tile_storage="compressed"))
    b = generated_rhs(a)
    x1 = gssv(h, b)
    from pangulu_jax.utils.perf import residual_norm as rn

    assert rn(s, x1, b) < 1e-9
    store1 = h._comp_store
    assert store1 is not None
    s2 = s.copy()
    s2.data = s2.data * (1.0 + 0.05 * np.sin(np.arange(s2.nnz)))
    from pangulu_jax.api import update_values

    update_values(h, s2)
    gstrf(h)
    assert h._comp_store is store1  # structure reused, not rebuilt
    b2 = np.asarray(s2 @ np.ones(a.n))
    x2 = gstrs(h, b2)
    assert rn(s2.tocsc(), x2, b2) < 1e-9
    finalize(h)


def test_compressed_nb256_uses_u32_slots():
    """nb=256 (the reference DEFAULT block size, pangulu.c:52-56)
    promotes in-tile positions to u32 (sentinel 256*256 exceeds u16)
    and stays numerically correct end to end."""
    a = poisson2d(20)          # n=400 -> bl=2 at nb=256
    ro, blocked, schedule = _problem(a, 256)
    st = CompressedTiles(blocked, ro.reordered)
    assert st.idx.dtype == np.uint32
    dense = np.asarray(st)
    np.testing.assert_array_equal(dense[: blocked.num_tiles],
                                  blocked.tiles[: blocked.num_tiles])
    h = init(a, InitOptions(nb=256, dtype="r64",
                            tile_storage="compressed"))
    b = generated_rhs(a)
    x = gssv(h, b)
    assert residual_norm(a.to_scipy(), x, b) < 1e-9
    finalize(h)


def test_compressed_rejects_nb_over_65535():
    """u32 slots bound nb at 65535 — same bound as the reference's u16
    in-block row/col indices (pangulu_common.h:54-65)."""
    a = poisson2d(8)
    with pytest.raises(ValueError, match="65535"):
        init(a, InitOptions(nb=65536, dtype="r64",
                            tile_storage="compressed"))


def test_compressed_rejects_mesh():
    a = poisson2d(8)
    h_opts = InitOptions(nb=8, dtype="r64", tile_storage="compressed",
                         mesh_shape=(2, 2))
    h = init(a, h_opts)
    with pytest.raises(ValueError):
        gstrf(h)


def test_compressed_checkpoint_roundtrip(tmp_path):
    """Compressed factors checkpoint as values+u16 slots (O(fill), not
    dense) and reload solve-ready."""
    from pangulu_jax.io.checkpoint import load_factor, save_factor

    a = circuit(700, seed=8)
    b = generated_rhs(a)
    h = init(a, InitOptions(nb=32, dtype="r64",
                            tile_storage="compressed"))
    x_ref = gssv(h, b)
    p_comp = str(tmp_path / "comp.npz")
    save_factor(h, p_comp)
    finalize(h)
    h3 = load_factor(p_comp)
    # the loaded factor is the O(fill) store, NOT densified tiles
    from pangulu_jax.compressed import CompressedTiles

    assert isinstance(h3.factor_tiles, CompressedTiles)
    assert (h3.factor_tiles.compressed_bytes
            < h3.factor_tiles.dense_bytes)
    x = gstrs(h3, b)
    from pangulu_jax.utils.perf import residual_norm as _rn

    assert _rn(a.to_scipy(), x, b) < 1e-6
    np.testing.assert_allclose(x, x_ref, rtol=1e-8, atol=1e-8)
