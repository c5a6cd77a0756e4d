"""Compressed (sparse-in-tile) factor storage.

Counterpart of the reference's nnz-capacity-class block storage
(pangulu_storage.c:83-293, u16 in-block indices pangulu_common.h:54-65,
bin capacities pangulu_preprocessing.c:325-332): device memory is
O(fill-nnz),
not O(tiles * nb^2).  Each present tile stores only its EXACT scalar
fill pattern (from the scalar symbolic analysis) as a u16
position list + value slots.  6 bytes/slot vs 4*nb^2 bytes/tile dense — a circuit-class matrix at
~15% per-tile fill compresses >4x.

Matmuls still want dense operands, so the compressed ENGINE stages
each elimination level's working set (diag + panels + update
destinations) dense via batched scatter, runs the identical level
math, and re-compresses via batched gather.  Dropping positions
outside the symbolic pattern loses NOTHING: any such position has a
structurally-zero factor in every product that could touch it, so its
value is exactly 0.0 through IEEE arithmetic (the superset-pattern
invariant, symbolic.py docstring).

Speed/memory tradeoff is explicit: the dense engines (numeric.py) are
the fast path; this engine trades gather/scatter bandwidth for an
O(fill) footprint (InitOptions.tile_storage = "compressed").
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from pangulu_jax.blocks import BlockedMatrix
from pangulu_jax.ops.interface import KernelBackend, get_backend
from pangulu_jax.schedule import Schedule, bucket, build_schedule
from pangulu_jax.sparse import CscMatrix, symmetrize_pattern
from pangulu_jax.symbolic import elimination_tree
from pangulu_jax.utils.perf import PerfCounters


def _scalar_fill_entries(a3: CscMatrix):
    """All strictly-lower scalar fill entries (i, j) of L for the
    symmetrized pattern of ``a3`` (native fast path; Python fallback)."""
    sym = symmetrize_pattern(a3)
    parent = elimination_tree(sym)
    csr = sym.tocsr()
    from pangulu_jax import native

    # count pass: one n-sized block so the 1x1 block_mark is in range
    count = native.fill_walk(a3.n, csr.indptr, csr.indices, parent,
                             a3.n, 1)
    if count is not None:
        got = native.fill_entries(a3.n, csr.indptr, csr.indices, parent,
                                  count[0])
        if got is not None:
            return got
    # Python fallback (row-subtree walk)
    n = a3.n
    indptr, indices = csr.indptr, csr.indices
    visited = np.full(n, -1, dtype=np.int64)
    oi, oj = [], []
    for i in range(n):
        visited[i] = i
        for k in indices[indptr[i]:indptr[i + 1]]:
            if k >= i:
                continue
            j = k
            while visited[j] != i:
                visited[j] = i
                oi.append(i)
                oj.append(j)
                j = parent[j]
                if j == -1 or j >= i:
                    break
    return (np.asarray(oi, dtype=np.int32),
            np.asarray(oj, dtype=np.int32))


class CompressedTiles:
    """Device-side compressed tile store: ``values[s]`` holds the value
    of in-tile position ``idx[s]`` (row-major r*nb+c) of the tile
    owning slot range [off[t], off[t]+cap[t])."""

    def __init__(self, blocked: BlockedMatrix, a3: CscMatrix):
        nb, nt = blocked.nb, blocked.num_tiles
        bl = blocked.block_length
        nn = nb * nb
        # in-tile positions (row-major r*nb+c, sentinel nb*nb): u16
        # covers nb <= 255; wider tiles (the reference DEFAULT nb=256,
        # pangulu.c:52-56) promote to u32 — still O(fill) at rest, 2
        # extra bytes/slot.  The reference's u16 in-block indices bound
        # nb <= 65535 (pangulu_common.h:54-65); u32 matches that range.
        idx_dtype = np.uint16 if nn <= np.iinfo(np.uint16).max \
            else np.uint32
        if nn > np.iinfo(np.uint32).max:
            raise ValueError(
                f"tile_storage='compressed' stores in-tile positions as "
                f"uint32 at most (sentinel nb*nb={nn}); nb must be <= "
                f"65535 (got nb={nb})")
        li, lj = _scalar_fill_entries(a3)
        n = a3.n
        nf = len(li)
        total = 2 * nf + bl * nb
        # Build every entry's sort key tid*nn + pos in three segments
        # WITHOUT materializing the concatenated (gi, gj) int64 pairs,
        # then sort IN PLACE.  After the sort, slot space is dense in
        # sorted order (off = exact cumsum of per-tile counts, keys
        # sorted by (tid, pos)), so slot-of-sorted-position-p is p —
        # the previous ranks/first/slots gathers (several full passes
        # over hundreds of millions of int64 on a 1-core host — the
        # dominant cost of the >16 GB out-of-core demo's preprocess)
        # all collapse away.
        key = np.empty(total, dtype=np.int64)
        count = np.zeros(nt, dtype=np.int64)

        def seg_key(out, i, j):
            tid = blocked.tile_ids(i // nb, j // nb)
            assert len(tid) == 0 or tid.min() >= 0, \
                "scalar fill outside the block pattern"
            # counts are order-invariant: bincount before sorting
            count[:] += np.bincount(tid, minlength=nt)
            np.multiply(tid, nn, out=out, casting="unsafe")
            out += (i % nb).astype(np.int64) * nb
            out += j % nb

        seg_key(key[:nf], li, lj)
        seg_key(key[nf:2 * nf], lj, li)
        diag = np.arange(bl * nb, dtype=np.int64)  # incl padded tail
        seg_key(key[2 * nf:], diag, diag)
        key.sort()
        # capacities are EXACT counts: only the gather width (capmax)
        # must be static, so per-tile padding would be pure waste (the
        # reference pads to 7 bin classes because its slots are
        # recycled MPI buffers; ours are never recycled)
        cap = count.copy()
        off = np.zeros(nt + 1, dtype=np.int64)
        off[1:] = np.cumsum(cap)
        s_total = int(off[-1])
        assert s_total == total
        self.capmax = int(max(bucket(int(count.max(initial=1))), 1))
        idx = np.full(s_total + self.capmax, nn, dtype=idx_dtype)
        np.mod(key, nn, out=idx[:s_total], casting="unsafe")
        values = np.zeros(s_total + self.capmax, dtype=blocked.dtype)
        # initial values: scatter A3's entries into their slots (the
        # slot of a key is its sorted position)
        acols = np.repeat(np.arange(n), np.diff(a3.colptr))
        arows = a3.rowidx
        akey = (blocked.tile_ids(arows // nb, acols // nb) * nn
                + (arows % nb) * nb + (acols % nb))
        r = np.searchsorted(key, akey)
        assert (key[r] == akey).all(), "A entry outside fill pattern"
        np.add.at(values, r, a3.values)
        # padded diagonal tail = 1.0 (identity; matches blocks.py)
        tail = np.arange(n, bl * nb, dtype=np.int64)
        tail_slots = np.empty(0, dtype=np.int64)
        if len(tail):
            tkey = (blocked.tile_ids(tail // nb, tail // nb) * nn
                    + (tail % nb) * nb + (tail % nb))
            tail_slots = np.searchsorted(key, tkey)
            values[tail_slots] = 1.0
        # retained for the O(nnz) refactorization fast path (refill)
        self._a_slots = r
        self._tail_slots = tail_slots

        self.blocked = blocked
        self.nb, self.num_tiles = nb, nt
        self.nnz_pattern = len(key)
        self.scratch_slot = s_total
        # scratch tile id nt: zero capacity
        self.off = jnp.asarray(np.append(off[:-1], s_total).astype(
            np.int32))                        # [nt+1]: off[nt]=scratch
        self.cap = jnp.asarray(np.append(cap, 0).astype(np.int32))
        self.idx = jnp.asarray(idx)
        self.values = jnp.asarray(values)
        if self.values.dtype != values.dtype:
            raise ValueError(
                f"device would silently downcast the {values.dtype} "
                f"compressed store to {self.values.dtype} — enable "
                f"jax_enable_x64 for r64/cr64 compressed storage, or "
                f"use dense tile storage")
        self.host_off, self.host_cap = off, cap

    def refill(self, a3: CscMatrix) -> None:
        """Refactorization fast path: replace the store's VALUES from a
        same-pattern matrix — O(nnz), no fill walk (the reference
        requires a full finalize+init here, README.md:125)."""
        values = np.zeros(self.scratch_slot + self.capmax,
                          dtype=self.blocked.dtype)
        np.add.at(values, self._a_slots, a3.values)
        values[self._tail_slots] = 1.0
        self.values = jnp.asarray(values)

    # -- memory accounting -------------------------------------------------
    @property
    def compressed_bytes(self) -> int:
        return int(self.values.size
                   * (np.dtype(self.blocked.dtype).itemsize
                      + self.idx.dtype.itemsize))

    @property
    def dense_bytes(self) -> int:
        return int((self.num_tiles + 1) * self.nb * self.nb
                   * np.dtype(self.blocked.dtype).itemsize)

    def __array__(self, dtype=None, copy=None):
        """Densify (residual checks / checkpoints) — one vectorized
        scatter over all slots (a per-tile Python loop is minutes at
        10^5 tiles, exactly the problem class compressed storage
        targets)."""
        nb, nn = self.nb, self.nb * self.nb
        vals = np.asarray(self.values)
        idx = np.asarray(self.idx)
        out = np.zeros((self.num_tiles + 1, nn),
                       dtype=dtype or self.blocked.dtype)
        # tile id owning each real (non-scratch-pad) slot
        tid = np.repeat(np.arange(self.num_tiles, dtype=np.int64),
                        self.host_cap)
        s = np.arange(tid.size)
        keep = idx[s] < nn
        out[tid[keep], idx[s[keep]].astype(np.int64)] = vals[s[keep]]
        return out.reshape(self.num_tiles + 1, nb, nb)


@functools.partial(jax.jit, static_argnums=(0, 1, 2), donate_argnums=(3,))
def _compressed_factorize(backend: KernelBackend, nb: int, capmax: int,
                          values, idx, off, cap,
                          diag_idx, l_ids, u_ids, upd_dst, upd_l, upd_u):
    """Fused level loop over the compressed store: per level, stage the
    working set dense (batched scatter), run the identical dense level
    math, re-compress (batched gather).  Also persists the per-level
    triangle inverses for the matmul-only compressed solve."""
    bl = diag_idx.shape[0]
    nn = nb * nb
    dt = values.dtype
    scratch = values.shape[0] - capmax
    ar = jnp.arange(capmax)

    def gather(vals, ids):
        pos = off[ids][:, None] + ar[None, :]
        mask = ar[None, :] < cap[ids][:, None]
        v = jnp.where(mask, vals[pos], 0)
        ix = jnp.where(mask, idx[pos].astype(jnp.int32), nn)
        b = ids.shape[0]
        dense = jnp.zeros((b, nn + 1), dt)
        dense = dense.at[jnp.arange(b)[:, None], ix].set(v)
        return dense[:, :nn].reshape(b, nb, nb)

    def scatter(vals, ids, dense):
        b = ids.shape[0]
        pos = off[ids][:, None] + ar[None, :]
        mask = ar[None, :] < cap[ids][:, None]
        ix = idx[pos].astype(jnp.int32)
        v = dense.reshape(b, nn)[jnp.arange(b)[:, None],
                                 jnp.minimum(ix, nn - 1)]
        tgt = jnp.where(mask, pos, scratch)
        return vals.at[tgt].set(jnp.where(mask, v, 0))

    invs0 = jnp.zeros((bl, 2, nb, nb), dt)

    def body(k, c):
        vals, invs = c
        dg = gather(vals, diag_idx[k][None])[0]
        diag_f, linv, uinv = backend.diag_factor_invert(dg, backend.tol)
        vals = scatter(vals, diag_idx[k][None], diag_f[None])
        invs = invs.at[k, 0].set(linv)
        invs = invs.at[k, 1].set(uinv)
        lblk = jnp.matmul(gather(vals, l_ids[k]), uinv,
                          preferred_element_type=dt)
        vals = scatter(vals, l_ids[k], lblk)
        ublk = jnp.matmul(linv, gather(vals, u_ids[k]),
                          preferred_element_type=dt)
        vals = scatter(vals, u_ids[k], ublk)
        prod = jnp.matmul(lblk[upd_l[k]], ublk[upd_u[k]],
                          preferred_element_type=dt)
        dst = gather(vals, upd_dst[k]) - prod
        vals = scatter(vals, upd_dst[k], dst)
        return vals, invs

    return jax.lax.fori_loop(0, bl, body, (values, invs0))


@functools.partial(jax.jit, static_argnums=(0, 1), donate_argnums=(6,))
def _compressed_solve(nb: int, capmax: int, values, idx, off, cap, x,
                      invs, l_ids, l_rows, uc_ids, uc_rows):
    """Fused forward+backward solve over the compressed factor: diag
    steps are matmuls against the persisted inverses; panel updates
    stage their tiles dense per level."""
    bl = l_ids.shape[0]
    nn = nb * nb
    dt = x.dtype
    ar = jnp.arange(capmax)

    def gather(ids):
        pos = off[ids][:, None] + ar[None, :]
        mask = ar[None, :] < cap[ids][:, None]
        v = jnp.where(mask, values[pos], 0)
        ix = jnp.where(mask, idx[pos].astype(jnp.int32), nn)
        b = ids.shape[0]
        dense = jnp.zeros((b, nn + 1), dt)
        dense = dense.at[jnp.arange(b)[:, None], ix].set(v)
        return dense[:, :nn].reshape(b, nb, nb)

    def level(k, x, inv_slot, ids, rows):
        xk = jnp.matmul(invs[k, inv_slot], x[k],
                        preferred_element_type=dt)
        x = x.at[k].set(xk)
        upd = jnp.matmul(gather(ids[k]), xk, preferred_element_type=dt)
        return x.at[rows[k]].add(-upd)

    def fwd(k, x):
        return level(k, x, 0, l_ids, l_rows)

    def bwd(i, x):
        return level(bl - 1 - i, x, 1, uc_ids, uc_rows)

    x = jax.lax.fori_loop(0, bl, fwd, x)
    x = jax.lax.fori_loop(0, bl, bwd, x)
    return x


class CompressedLU:
    """gstrf/gstrs executor over a :class:`CompressedTiles` store."""

    def __init__(self, blocked: BlockedMatrix, schedule: Schedule | None,
                 a3: CscMatrix, backend: KernelBackend | None = None,
                 perf: PerfCounters | None = None,
                 precision: str = "highest", store=None):
        self.blocked = blocked
        self.schedule = schedule or build_schedule(blocked)
        self.backend = backend or get_backend("auto")
        self.perf = perf or PerfCounters()
        self.precision = precision
        with self.perf.phase("preprocess"):
            if store is not None:      # refactorize: same pattern,
                store.refill(a3)       # new values — O(nnz)
                self.store = store
            else:
                self.store = CompressedTiles(blocked, a3)
        self._fused_args = tuple(
            jnp.asarray(t) for t in
            self.schedule.fused_tables(self.blocked.num_tiles))
        self._solve_args = None
        self.inv_tiles = None

    @classmethod
    def from_store(cls, blocked, schedule, store,
                   backend=None, perf=None, precision="highest"):
        """Rehydrate a solve-ready executor from a saved compressed
        store (checkpoint load): inverses are recomputed from the
        FACTORED diagonal tiles on first solve."""
        self = cls.__new__(cls)
        self.blocked = blocked
        self.schedule = schedule or build_schedule(blocked)
        self.backend = backend or get_backend("auto")
        self.perf = perf or PerfCounters()
        self.precision = precision
        self.store = store
        self._fused_args = None
        self._solve_args = None
        self.inv_tiles = None
        return self

    def _ensure_inverses(self):
        """Triangle inverses of every factored diagonal, recomputed
        from the compressed store (checkpoint-loaded executors; the
        factorization itself persists them)."""
        if self.inv_tiles is not None:
            return self.inv_tiles
        from pangulu_jax.ops.kernels_jax import (DEFAULT_TOL,
                                                 unit_lower_inv_newton,
                                                 upper_inv_newton)

        st = self.store
        bl, nb = self.schedule.block_length, self.store.nb
        nn = nb * nb
        vals = np.asarray(st.values)
        idx = np.asarray(st.idx)
        diags = np.zeros((bl, nn), dtype=self.blocked.dtype)
        for lev in self.schedule.levels:
            o = int(st.host_off[lev.diag])
            c = int(st.host_cap[lev.diag])
            sl = idx[o:o + c]
            keep = sl < nn
            diags[lev.k, sl[keep].astype(np.int64)] = vals[o:o + c][keep]
        diags = jnp.asarray(diags.reshape(bl, nb, nb))
        tol = (self.backend.tol if self.backend.tol is not None
               else float(DEFAULT_TOL[jnp.dtype(self.blocked.dtype)]))

        @jax.jit
        def _compute(d):
            linv = jax.vmap(unit_lower_inv_newton)(d)
            uinv = jax.vmap(lambda f: upper_inv_newton(f, tol))(d)
            return jnp.stack([linv, uinv], axis=1)

        with jax.default_matmul_precision(self.precision):
            self.inv_tiles = _compute(diags)
        return self.inv_tiles

    def factorize(self):
        st = self.store
        ctx = jax.default_matmul_precision(self.precision)
        with self.perf.phase("numeric"), ctx:
            vals, invs = _compressed_factorize(
                self.backend, st.nb, st.capmax, st.values, st.idx,
                st.off, st.cap, *self._fused_args)
            vals = jax.block_until_ready(vals)
        st.values = vals
        self.inv_tiles = invs
        self.perf.add_flops(self.schedule.flop_estimate())
        self.perf.kernel_counts(
            getrf=self.schedule.block_length,
            tstrf=self.schedule.n_tstrf,
            gessm=self.schedule.n_gessm,
            ssssm=self.schedule.n_ssssm,
        )
        return st

    def solve(self, b: np.ndarray) -> np.ndarray:
        st = self.store
        bl, nb = self.schedule.block_length, self.schedule.nb
        if self._solve_args is None:
            _, l_ids, l_rows, uc_ids, uc_rows = (
                jnp.asarray(t) for t in self.schedule.fused_solve_tables(
                    self.blocked.num_tiles, bl))
            self._solve_args = (l_ids, l_rows, uc_ids, uc_rows)
        b2 = np.asarray(b)
        squeeze = b2.ndim == 1
        if squeeze:
            b2 = b2[:, None]
        nrhs = b2.shape[1]
        xb = np.zeros((bl + 1, nb, nrhs), dtype=self.blocked.dtype)
        xb[:bl].reshape(bl * nb, nrhs)[: b2.shape[0]] = b2
        ctx = jax.default_matmul_precision(self.precision)
        with self.perf.phase("sptrsv"), ctx:
            x = _compressed_solve(nb, st.capmax, st.values, st.idx,
                                  st.off, st.cap, jnp.asarray(xb),
                                  self._ensure_inverses(),
                                  *self._solve_args)
            x = jax.block_until_ready(x)
        out = np.asarray(x)[:bl].reshape(bl * nb, nrhs)[: self.blocked.n]
        return out[:, 0] if squeeze else out
