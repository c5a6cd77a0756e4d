"""Distributed blocked triangular solves (multi-chip gstrs).

Re-expression of the reference's SpTRSV
(pangulu_sptrsv.c:24-174): the reference computes per-rank partial
spmv accumulations, point-to-point reduces them onto the diagonal
owner, solves the nb triangle there and MPI_Bcasts the solved segment.

Here the solution vector is **additively sharded**: every device holds
a partial x whose mesh-sum is the true x (the collective analogue of
the reference's spmv_acc buffers).  Per level, inside one fused
shard_map fori_loop:

  1. ``psum`` the k-th segment (the reduce-to-owner),
  2. the diag owner solves the nb triangle, a second masked ``psum``
     broadcasts the solved segment (the reference's MPI_Bcast),
  3. owners of column-k panel blocks subtract ``T(i,k) @ x_k`` from
     their partial segments locally (the reference's per-rank spmv).

Levels are batched into super-level GROUPS (independent same-depth
columns, Schedule.superlevels — the same block adjacency governs the
solve's dependencies): one iteration settles a whole group with TWO
[G, nb, nrhs] psums instead of 2 psums per level (collective-latency
amortization; chain schedules degenerate to G=1 and behave exactly as
per-level stepping).  The backward sweep walks the groups in reverse.
Traffic equals the per-level scheme — strictly less than the
reference's panel-sized exchanges.  The whole lower+upper sweep is ONE
device dispatch.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pangulu_jax.blocks import BlockedMatrix
from pangulu_jax.ops.interface import KernelBackend, get_backend
from pangulu_jax.schedule import Schedule
from pangulu_jax.utils.perf import PerfCounters


class DistributedTriangularSolver:
    """Multi-chip gstrs executor over block-cyclic factored tiles."""

    def __init__(self, blocked: BlockedMatrix, schedule: Schedule,
                 layout, mesh: Mesh,
                 backend: KernelBackend | None = None,
                 perf: PerfCounters | None = None,
                 inv_dd=None):
        self.blocked = blocked
        self.schedule = schedule
        self.layout = layout
        self.mesh = mesh
        self.p, self.q = mesh.devices.shape
        self.backend = backend or get_backend("auto")
        self.perf = perf or PerfCounters()
        # replicated [p,q,bl+1,2,nb,nb] hi/lo triangle inverses
        # persisted by the dd distributed factorization — the dd solve
        # applies them as dd matmuls (no triangular substitution)
        self.inv_dd = inv_dd
        self._tables = self._prepare()
        self._run = None
        self._nrhs = None
        self._sum = None
        self._run_dd = None
        self._nrhs_dd = None

    # Group width cap, matching the distributed factorization engine.
    GMAX = 16

    def _prepare(self):
        lay, p, q = self.layout, self.p, self.q
        bl = self.schedule.block_length
        scratch_tile = lay.lmax - 1
        scratch_seg = bl  # x carries bl+1 segments
        groups = [mem[s:s + self.GMAX]
                  for mem in self.schedule.superlevels()
                  for s in range(0, len(mem), self.GMAX)]
        ngr = len(groups)
        G = max((len(g) for g in groups), default=1)
        NL = max((sum(len(self.schedule.levels[k].lpanel) for k in g)
                  for g in groups), default=0)
        NL = max(NL, 1)
        NUC = max((sum(len(self.schedule.levels[k].ucolpanel)
                       for k in g) for g in groups), default=0)
        NUC = max(NUC, 1)
        kmat = np.full((ngr, G), -1, dtype=np.int32)
        kseg = np.full((ngr, G), scratch_seg, dtype=np.int32)
        l_msel = np.zeros((ngr, NL), dtype=np.int32)
        uc_msel = np.zeros((ngr, NUC), dtype=np.int32)
        diag_slot = np.full((p, q, ngr, G), scratch_tile, dtype=np.int32)
        l_slot = np.full((p, q, ngr, NL), scratch_tile, dtype=np.int32)
        l_rows = np.full((p, q, ngr, NL), scratch_seg, dtype=np.int32)
        uc_slot = np.full((p, q, ngr, NUC), scratch_tile, dtype=np.int32)
        uc_rows = np.full((p, q, ngr, NUC), scratch_seg, dtype=np.int32)
        for gi, g in enumerate(groups):
            ol = ou = 0
            for mi, k in enumerate(g):
                lev = self.schedule.levels[k]
                kmat[gi, mi] = k
                kseg[gi, mi] = k
                diag_slot[k % p, k % q, gi, mi] = lay.tile_slot[lev.diag]
                for t, (tid, bi) in enumerate(zip(lev.lpanel, lev.lrows)):
                    r, c = lay.tile_owner_r[tid], lay.tile_owner_c[tid]
                    l_slot[r, c, gi, ol + t] = lay.tile_slot[tid]
                    l_rows[r, c, gi, ol + t] = bi
                    l_msel[gi, ol + t] = mi
                for t, (tid, bi) in enumerate(zip(lev.ucolpanel,
                                                  lev.ucolrows)):
                    r, c = lay.tile_owner_r[tid], lay.tile_owner_c[tid]
                    uc_slot[r, c, gi, ou + t] = lay.tile_slot[tid]
                    uc_rows[r, c, gi, ou + t] = bi
                    uc_msel[gi, ou + t] = mi
                ol += len(lev.lpanel)
                ou += len(lev.ucolpanel)
        from pangulu_jax.parallel.multihost import (
            put_grid_sharded, put_replicated,
        )

        tables = dict(diag_slot=diag_slot, l_slot=l_slot, l_rows=l_rows,
                      uc_slot=uc_slot, uc_rows=uc_rows)
        out = {k: put_grid_sharded(self.mesh, v.shape,
                                   lambda r, c, v=v: v[r:r + 1, c:c + 1])
               for k, v in tables.items()}
        for k, v in dict(kmat=kmat, kseg=kseg, l_msel=l_msel,
                         uc_msel=uc_msel).items():
            out[k] = put_replicated(self.mesh, v)
        self._ngroups = ngr
        self._G = G
        return out

    def _build(self, nrhs: int):
        backend = self.backend
        p, q = self.p, self.q
        ngr = self._ngroups
        nb = self.schedule.nb

        def run(tiles, x, diag_slot, l_slot, l_rows, uc_slot, uc_rows,
                kmat, kseg, l_msel, uc_msel):
            tiles = tiles[0, 0]
            x = x[0, 0]
            diag_slot = diag_slot[0, 0]
            l_slot, l_rows = l_slot[0, 0], l_rows[0, 0]
            uc_slot, uc_rows = uc_slot[0, 0], uc_rows[0, 0]
            dt = x.dtype
            my_r = jax.lax.axis_index("gp")
            my_c = jax.lax.axis_index("gq")

            def group(g, x, slot_tab, rows_tab, msel_tab, lower):
                kg = kmat[g]                               # [G]
                ks = kseg[g]                               # [G], pad=bl
                is_owner = ((my_r == kg % p) & (my_c == kg % q)
                            & (kg >= 0))[:, None, None]
                xk = jax.lax.psum(x[ks], ("gp", "gq"))     # [G,nb,nrhs]
                d = tiles[diag_slot[g]]                    # [G,nb,nb]
                solved = jax.vmap(backend.trsv_lower_unit if lower
                                  else backend.trsv_upper)(d, xk)
                solved = jax.lax.psum(
                    jnp.where(is_owner, solved, jnp.zeros_like(solved)),
                    ("gp", "gq"))
                x = x.at[ks].set(jnp.where(is_owner, solved,
                                           jnp.zeros_like(solved)))
                upd = jnp.matmul(tiles[slot_tab[g]],
                                 solved[msel_tab[g]],
                                 preferred_element_type=dt)
                return x.at[rows_tab[g]].add(-upd)

            def fwd(g, x):
                return group(g, x, l_slot, l_rows, l_msel, True)

            def bwd(i, x):
                return group(ngr - 1 - i, x, uc_slot, uc_rows,
                             uc_msel, False)

            x = jax.lax.fori_loop(0, ngr, fwd, x)
            x = jax.lax.fori_loop(0, ngr, bwd, x)
            return x[None, None]

        specs = P("gp", "gq")
        shard = jax.shard_map(run, mesh=self.mesh,
                              in_specs=(specs,) * 7 + (P(),) * 4,
                              out_specs=specs,
                              check_vma=False)
        return jax.jit(shard, donate_argnums=(1,))

    def _build_dd(self, nrhs: int):
        """Double-float solve step (r64/cr64-embed meshes; the dd
        counterpart of :meth:`_build`).  Three dd-specific changes:

        * the reduce-to-owner of the additively-sharded partials is an
          ``all_gather`` + SEQUENTIAL dd summation — a plain f32 psum
          of multi-contributor partials would round at f32 eps and
          destroy the dd low word (the factorization's psums are
          single-contributor broadcasts, so they stay psums there);
        * the diag step applies the factorization's REPLICATED dd
          triangle inverses as a dd matmul on every device (no second
          broadcast collective needed);
        * panel updates apply per MEMBER WAVE (collision-free
          gather -> dd_sub -> set), like the dd factorization step.
        """
        from pangulu_jax.ops import dd as D

        p, q = self.p, self.q
        ngr, G = self._ngroups, self._G
        bl = self.schedule.block_length
        scratch_seg = bl

        def run(th, tl, invh, invl, xh, xl, l_slot, l_rows,
                uc_slot, uc_rows, kmat, kseg, l_msel, uc_msel):
            th, tl = th[0, 0], tl[0, 0]
            invh, invl = invh[0, 0], invl[0, 0]
            xh, xl = xh[0, 0], xl[0, 0]
            l_slot, l_rows = l_slot[0, 0], l_rows[0, 0]
            uc_slot, uc_rows = uc_slot[0, 0], uc_rows[0, 0]
            my_r = jax.lax.axis_index("gp")
            my_c = jax.lax.axis_index("gq")
            z = jnp.zeros((), jnp.float32)

            def group(g, x, slot_tab, rows_tab, msel_tab, inv_slot):
                xh, xl = x
                kg = kmat[g]
                ks = kseg[g]
                is_owner = ((my_r == kg % p) & (my_c == kg % q)
                            & (kg >= 0))[:, None, None]
                # exact dd reduce of the partial segments
                parts = jax.lax.all_gather(
                    jnp.stack([xh[ks], xl[ks]]), "gq")
                parts = jax.lax.all_gather(parts, "gp")
                parts = parts.reshape((p * q, 2) + parts.shape[3:])

                def red(j, acc):
                    return D.dd_add(acc[0], acc[1],
                                    parts[j, 0], parts[j, 1])

                bh_, bl_ = jax.lax.fori_loop(
                    1, p * q, red, (parts[0, 0], parts[0, 1]))
                kcl = jnp.where(kg >= 0, kg, bl)
                sh, sl = D.dd_matmul(invh[kcl, inv_slot],
                                     invl[kcl, inv_slot], bh_, bl_)
                xh = xh.at[ks].set(jnp.where(is_owner, sh, z))
                xl = xl.at[ks].set(jnp.where(is_owner, sl, z))
                uph, upl = D.dd_matmul(th[slot_tab[g]], tl[slot_tab[g]],
                                       sh[msel_tab[g]],
                                       sl[msel_tab[g]])
                rows = rows_tab[g]

                def w_body(w, xx):
                    xh, xl = xx
                    sel = msel_tab[g] == w
                    d = jnp.where(sel, rows, scratch_seg)
                    s3 = sel[:, None, None]
                    nh, nl = D.dd_sub(xh[d], xl[d],
                                      jnp.where(s3, uph, z),
                                      jnp.where(s3, upl, z))
                    return xh.at[d].set(nh), xl.at[d].set(nl)

                return jax.lax.fori_loop(0, G, w_body, (xh, xl))

            def fwd(g, x):
                return group(g, x, l_slot, l_rows, l_msel, 0)

            def bwd(i, x):
                return group(ngr - 1 - i, x, uc_slot, uc_rows,
                             uc_msel, 1)

            xh, xl = jax.lax.fori_loop(0, ngr, fwd, (xh, xl))
            xh, xl = jax.lax.fori_loop(0, ngr, bwd, (xh, xl))
            return xh[None, None], xl[None, None]

        specs = P("gp", "gq")
        shard = jax.shard_map(run, mesh=self.mesh,
                              in_specs=(specs,) * 10 + (P(),) * 4,
                              out_specs=(specs, specs),
                              check_vma=False)
        return jax.jit(shard, donate_argnums=(4, 5))

    def _solve_dd(self, dist_tiles, b: np.ndarray) -> np.ndarray:
        th, tl = dist_tiles
        if self.inv_dd is None:
            raise RuntimeError(
                "dd distributed solve requires the factorization's "
                "persisted inverse stores (run the dd distributed "
                "gstrf first)")
        invh, invl = self.inv_dd
        bl, nb = self.schedule.block_length, self.schedule.nb
        n = self.blocked.n
        b = np.asarray(b, dtype=np.float64)
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        nrhs = b.shape[1]
        if self._run_dd is None or self._nrhs_dd != nrhs:
            self._run_dd = self._build_dd(nrhs)
            self._nrhs_dd = nrhs
        from pangulu_jax.parallel.multihost import put_grid_sharded

        def x_shard(which):
            def build(r, c):
                sh = np.zeros((1, 1, bl + 1, nb, nrhs), np.float32)
                if r == 0 and c == 0:
                    hi = b.astype(np.float32)
                    val = (hi if which == 0
                           else (b - hi.astype(np.float64)
                                 ).astype(np.float32))
                    sh[0, 0, :bl].reshape(bl * nb, nrhs)[:n] = val
                return sh
            return build

        shape = (self.p, self.q, bl + 1, nb, nrhs)
        xh = put_grid_sharded(self.mesh, shape, x_shard(0))
        xl = put_grid_sharded(self.mesh, shape, x_shard(1))
        t = self._tables
        with self.perf.phase("sptrsv"):
            xh, xl = self._run_dd(th, tl, invh, invl, xh, xl,
                                  t["l_slot"], t["l_rows"],
                                  t["uc_slot"], t["uc_rows"],
                                  t["kmat"], t["kseg"], t["l_msel"],
                                  t["uc_msel"])
            # each segment is nonzero on exactly ONE device, so the
            # per-plane shard sums are exact; combine in f64 on host
            if self._sum is None:
                self._sum = jax.jit(
                    lambda v: v.sum(axis=(0, 1)),
                    out_shardings=NamedSharding(self.mesh, P()))
            gh = self._sum(xh)
            gl = self._sum(xl)
            gh_host, gl_host = jax.device_get((gh, gl))
        out = gh_host.astype(np.float64) + gl_host.astype(np.float64)
        out = out[:bl].reshape(bl * nb, nrhs)[:n]
        return out[:, 0] if squeeze else out

    def solve(self, dist_tiles, b: np.ndarray) -> np.ndarray:
        """b: [n] or [n, nrhs] on host -> x on host."""
        if isinstance(dist_tiles, tuple):
            return self._solve_dd(dist_tiles, b)
        bl, nb = self.schedule.block_length, self.schedule.nb
        n = self.blocked.n
        b = np.asarray(b)
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        nrhs = b.shape[1]
        if self._run is None or self._nrhs != nrhs:
            self._run = self._build(nrhs)
            self._nrhs = nrhs
        # additively sharded x: device (0,0) holds b, others zero.
        from pangulu_jax.parallel.multihost import put_grid_sharded

        def x_shard(r, c):
            sh = np.zeros((1, 1, bl + 1, nb, nrhs), dtype=self.blocked.dtype)
            if r == 0 and c == 0:
                sh[0, 0, :bl].reshape(bl * nb, nrhs)[:n] = b
            return sh

        x = put_grid_sharded(self.mesh,
                             (self.p, self.q, bl + 1, nb, nrhs), x_shard)
        t = self._tables
        ctx = jax.default_matmul_precision("highest")
        with self.perf.phase("sptrsv"), ctx:
            x = self._run(dist_tiles, x, t["diag_slot"], t["l_slot"],
                          t["l_rows"], t["uc_slot"], t["uc_rows"],
                          t["kmat"], t["kseg"], t["l_msel"],
                          t["uc_msel"])
            # reduce the additive shards ON DEVICE to a replicated x
            # (multi-host safe: every process can read a replicated
            # array; summing on host would need all shards local).
            if self._sum is None:
                self._sum = jax.jit(
                    lambda v: v.sum(axis=(0, 1)),
                    out_shardings=NamedSharding(self.mesh, P()))
            xg = jax.block_until_ready(self._sum(x))
        out = np.asarray(xg)[:bl].reshape(bl * nb, nrhs)[:n]
        return out[:, 0] if squeeze else out
