"""Factor checkpoint / resume: save a factorized handle to disk and
reload it later for solve-only workloads (factor once on a big slice,
serve ``gstrs`` from anywhere).

The reference has no checkpointing (SURVEY.md §5) — its closest feature
is keeping the handle alive for repeated ``pangulu_gstrs`` calls within
one process (README.md:125).  This module extends that across
processes: everything ``gstrs`` needs — factored tiles, block pattern,
reordering (permutations + scalings) and the original matrix (for
iterative refinement / residuals) — is stored in ONE ``.npz``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

_FORMAT_VERSION = 2


def save_factor(handle, path) -> None:
    """Serialize a factorized handle (after :func:`~pangulu_jax.api.gstrf`)
    to ``path`` (.npz)."""
    if handle.factor_tiles is None:
        raise RuntimeError("save_factor requires a factorized handle "
                           "(call gstrf first)")
    b = handle.blocked
    ro = handle.reordering
    rr = ro.reordered
    ao = sp.csc_matrix(handle.a_origin)
    tid, ri, cj, vals = b.scatter_plan
    from pangulu_jax.compressed import CompressedTiles

    ft = handle.factor_tiles
    if isinstance(ft, CompressedTiles):
        # O(fill) checkpoint: values + u16 slot indices, not dense tiles
        factor_fields = dict(
            factor_storage="compressed",
            comp_values=np.asarray(ft.values),
            comp_idx=np.asarray(ft.idx),
            comp_off=ft.host_off, comp_cap=ft.host_cap,
            comp_capmax=ft.capmax, comp_nnz=ft.nnz_pattern,
        )
    else:
        factor_fields = dict(factor_storage="dense",
                             factor_tiles=np.asarray(ft))
    np.savez_compressed(
        path,
        format_version=_FORMAT_VERSION,
        **factor_fields,
        nb=b.nb, n=b.n, block_length=b.block_length, num_tiles=b.num_tiles,
        dtype=str(np.dtype(b.dtype)),
        opts_dtype=handle.opts.dtype,
        opts_backend=handle.opts.backend,
        opts_refine=handle.opts.refine,
        complex_embed=(str(np.dtype(handle.complex_embed))
                       if handle.complex_embed is not None else ""),
        bcolptr=b.bcolptr, browidx=b.browidx,
        brownnzptr=b.brownnzptr, bcolidx=b.bcolidx,
        tile_of_csr=b.tile_of_csr,
        plan_tid=tid, plan_ri=ri, plan_cj=cj, plan_vals=vals,
        row_scale=ro.row_scale, col_scale=ro.col_scale,
        colperm=ro.colperm, perm=ro.perm,
        reordered_colptr=rr.colptr, reordered_rowidx=rr.rowidx,
        reordered_values=rr.values,
        origin_indptr=ao.indptr, origin_indices=ao.indices,
        origin_data=ao.data,
    )


def load_factor(path):
    """Reload a saved factor into a solve-ready
    :class:`~pangulu_jax.api.Handle` (``gstrs`` works immediately;
    ``update_values`` + ``gstrf`` refactorize with the saved analysis)."""
    from pangulu_jax.api import Handle, InitOptions
    from pangulu_jax.blocks import BlockedMatrix, _DENSE_LOOKUP_MAX_BL
    from pangulu_jax.reorder import Reordering
    from pangulu_jax.schedule import build_schedule
    from pangulu_jax.sparse import CscMatrix
    from pangulu_jax.utils.perf import PerfCounters

    z = np.load(path, allow_pickle=False)
    ver = int(z["format_version"])
    if ver > _FORMAT_VERSION:
        raise ValueError(f"checkpoint format {ver} is newer than this "
                         f"library supports ({_FORMAT_VERSION})")
    n = int(z["n"])
    nb = int(z["nb"])
    bl = int(z["block_length"])
    num_tiles = int(z["num_tiles"])
    bcolptr, browidx = z["bcolptr"], z["browidx"]
    lookup = None
    if bl <= _DENSE_LOOKUP_MAX_BL:
        lookup = np.full((bl, bl), -1, dtype=np.int64)
        cols = np.repeat(np.arange(bl), np.diff(bcolptr))
        lookup[browidx, cols] = np.arange(num_tiles)
    blocked = BlockedMatrix(
        n=n, nb=nb, block_length=bl, num_tiles=num_tiles,
        bcolptr=bcolptr, browidx=browidx,
        brownnzptr=z["brownnzptr"], bcolidx=z["bcolidx"],
        tile_of_csr=z["tile_of_csr"],
        scatter_plan=(z["plan_tid"], z["plan_ri"], z["plan_cj"],
                      z["plan_vals"]),
        dtype=np.dtype(str(z["dtype"])),
        _lookup=lookup,
    )
    reordering = Reordering(
        row_scale=z["row_scale"], col_scale=z["col_scale"],
        colperm=z["colperm"], perm=z["perm"],
        reordered=CscMatrix(n, z["reordered_colptr"],
                            z["reordered_rowidx"], z["reordered_values"]),
    )
    a_origin = sp.csc_matrix(
        (z["origin_data"], z["origin_indices"], z["origin_indptr"]),
        shape=(n, n))
    opts = InitOptions(nb=nb, dtype=str(z["opts_dtype"]),
                       backend=str(z["opts_backend"]),
                       refine=int(z["opts_refine"]))
    emb = str(z["complex_embed"]) if "complex_embed" in z else ""
    schedule = build_schedule(blocked)
    storage = (str(z["factor_storage"]) if "factor_storage" in z
               else "dense")
    if storage == "compressed":
        import jax.numpy as jnp

        from pangulu_jax.compressed import CompressedLU, CompressedTiles

        st = CompressedTiles.__new__(CompressedTiles)
        st.blocked = blocked
        st.nb, st.num_tiles = nb, num_tiles
        st.nnz_pattern = int(z["comp_nnz"])
        st.capmax = int(z["comp_capmax"])
        st.host_off = z["comp_off"]
        st.host_cap = z["comp_cap"]
        st.scratch_slot = int(st.host_off[-1])
        st.off = jnp.asarray(np.append(
            st.host_off[:-1], st.scratch_slot).astype(np.int32))
        st.cap = jnp.asarray(np.append(st.host_cap, 0).astype(np.int32))
        st.idx = jnp.asarray(z["comp_idx"])
        st.values = jnp.asarray(z["comp_values"])
        factor_tiles = st
    else:
        factor_tiles = z["factor_tiles"]
    handle = Handle(
        opts=opts, a_origin=a_origin, reordering=reordering,
        symbolic_result=None, blocked=blocked,
        schedule=schedule, perf=PerfCounters(),
        factor_tiles=factor_tiles,
        complex_embed=np.dtype(emb) if emb else None,
    )
    if storage == "compressed":
        handle._factorizer = CompressedLU.from_store(
            blocked, schedule, factor_tiles, perf=handle.perf)
    return handle
