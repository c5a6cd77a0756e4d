"""Numeric LU factorization engine (single-chip path).

Counterpart of the reference's DAG scheduler + compute/comm threads
(``pangulu_numeric.c:256-1080``), re-expressed as XLA programs.  The
default engine (``fused``) runs the whole elimination loop as one
``lax.fori_loop`` dispatch; the per-level engine (``levels``) walks the
precomputed level schedule from the host; each level runs

  1. a fixed-shape jitted *diag step* — GETRF of the diagonal tile plus
     inversion of its two triangles (compiled once per dtype/nb), and
  2. a variable-shape jitted *panel+Schur step* — pure gathers, batched
     matmuls and scatter-adds (cheap to compile; bucket-padded so
     the jit cache stays O(log max_batch)).

Panel solves are matmuls against the precomputed triangular inverses —
the replacement for the reference's per-block sparse substitutions
(TSTRF/GESSM, pangulu_platform_0100000.c:137-209): one nb^3/3
inversion per level turns every panel solve into a batched matmul.
Substitution-based solves remain available on the backend
(``tstrf``/``gessm``) with ``panel_solve="trsm"``.

Device buffers are donated so tiles update in place in device memory; XLA's async
dispatch pipelines level k+1's host work under level k's device work
(the role of the reference's separate comm thread).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from pangulu_jax.blocks import BlockedMatrix
from pangulu_jax.ops.interface import KernelBackend, get_backend
from pangulu_jax.schedule import Schedule, bucket, build_schedule, pad_ids
from pangulu_jax.utils.log import get_logger
from pangulu_jax.utils.perf import PerfCounters

log = get_logger()


@functools.partial(jax.jit, static_argnums=(0,), donate_argnums=(1,))
def _diag_step(backend: KernelBackend, tiles, diag_idx):
    """GETRF the diagonal tile; return triangle inverses."""
    diag, linv, uinv = backend.diag_factor_invert(tiles[diag_idx[0]], backend.tol)
    tiles = tiles.at[diag_idx[0]].set(diag)
    return tiles, linv, uinv


@functools.partial(jax.jit, static_argnums=(0,), donate_argnums=(1,))
def _panel_schur_step(backend: KernelBackend, tiles, linv, uinv,
                      l_ids, u_ids, upd_dst, upd_lsel, upd_usel):
    """Batched panel solves (as matmuls) + batched Schur update."""
    dt = tiles.dtype
    nl, nu = l_ids.shape[0], u_ids.shape[0]
    nb = tiles.shape[-1]
    lblk = (jnp.matmul(tiles[l_ids], uinv, preferred_element_type=dt)
            if nl else jnp.zeros((0, nb, nb), dt))
    ublk = (jnp.matmul(linv, tiles[u_ids], preferred_element_type=dt)
            if nu else jnp.zeros((0, nb, nb), dt))
    if nl:
        tiles = tiles.at[l_ids].set(lblk)
    if nu:
        tiles = tiles.at[u_ids].set(ublk)
    if upd_dst.shape[0]:
        prod = jnp.matmul(lblk[upd_lsel], ublk[upd_usel],
                          preferred_element_type=dt)
        tiles = tiles.at[upd_dst].add(-prod)
    return tiles


@functools.partial(jax.jit, static_argnums=(0,), donate_argnums=(1,))
def _panel_schur_step_trsm(backend: KernelBackend, tiles, diag,
                           l_ids, u_ids, upd_dst, upd_lsel, upd_usel):
    """Substitution-based variant (triangular solves, no inverses)."""
    dt = tiles.dtype
    nl, nu = l_ids.shape[0], u_ids.shape[0]
    nb = tiles.shape[-1]
    lblk = (backend.tstrf(jnp.broadcast_to(diag, (nl, nb, nb)), tiles[l_ids])
            if nl else jnp.zeros((0, nb, nb), dt))
    ublk = (backend.gessm(jnp.broadcast_to(diag, (nu, nb, nb)), tiles[u_ids])
            if nu else jnp.zeros((0, nb, nb), dt))
    if nl:
        tiles = tiles.at[l_ids].set(lblk)
    if nu:
        tiles = tiles.at[u_ids].set(ublk)
    if upd_dst.shape[0]:
        prod = jnp.matmul(lblk[upd_lsel], ublk[upd_usel],
                          preferred_element_type=dt)
        tiles = tiles.at[upd_dst].add(-prod)
    return tiles


class DdTiles:
    """Factored tiles in double-float representation (hi/lo f32 pairs)
    — the double-float storage (ops.dd).  ``np.asarray`` yields the f64
    combination, so checkpointing/gather_factor work unchanged."""

    def __init__(self, hi, lo):
        self.hi = hi
        self.lo = lo

    def __array__(self, dtype=None, copy=None):
        out = (np.asarray(self.hi).astype(np.float64)
               + np.asarray(self.lo).astype(np.float64))
        return out.astype(dtype) if dtype is not None else out


@functools.partial(jax.jit, static_argnums=(0, 1), donate_argnums=(2, 3))
def _fused_factorize_dd(nb: int, tol: float, th, tl, diag_idx, l_ids,
                        u_ids, upd_dst, upd_l, upd_u):
    """r64 factorization in double-float arithmetic (ops.dd): the
    fused level engine with every matmul an exact-sliced f32 product
    and every elementwise op an error-free-transform pair (~48-bit
    results from f32 hardware).  Also persists the per-level dd
    triangle inverses for the matmul-only dd solve.  Chosen only on
    explicit request (``dispatch="dd"``)."""
    from pangulu_jax.ops import dd as D

    bl = diag_idx.shape[0]
    invh = jnp.zeros((bl, 2, nb, nb), jnp.float32)
    invl = jnp.zeros_like(invh)

    def body(k, c):
        th, tl, invh, invl = c
        d = diag_idx[k]
        (dh, dl), (lih, lil), (uih, uil) = D.dd_lu_inverses(
            th[d], tl[d], nb=nb, tol=tol)
        th = th.at[d].set(dh)
        tl = tl.at[d].set(dl)
        invh = invh.at[k, 0].set(lih)
        invl = invl.at[k, 0].set(lil)
        invh = invh.at[k, 1].set(uih)
        invl = invl.at[k, 1].set(uil)
        lbh, lbl = D.dd_matmul(th[l_ids[k]], tl[l_ids[k]], uih, uil)
        th = th.at[l_ids[k]].set(lbh)
        tl = tl.at[l_ids[k]].set(lbl)
        ubh, ubl = D.dd_matmul(lih, lil, th[u_ids[k]], tl[u_ids[k]])
        th = th.at[u_ids[k]].set(ubh)
        tl = tl.at[u_ids[k]].set(ubl)
        ph, pl = D.dd_matmul(lbh[upd_l[k]], lbl[upd_l[k]],
                             ubh[upd_u[k]], ubl[upd_u[k]])
        # dd scatter-subtract = gather, renormalizing dd_sub, set
        # (destinations are unique within a level)
        nh, nl2 = D.dd_sub(th[upd_dst[k]], tl[upd_dst[k]], ph, pl)
        th = th.at[upd_dst[k]].set(nh)
        tl = tl.at[upd_dst[k]].set(nl2)
        return th, tl, invh, invl

    return jax.lax.fori_loop(0, bl, body, (th, tl, invh, invl))


@functools.partial(jax.jit, static_argnums=(0, 1),
                   donate_argnums=(2, 3, 4, 5))
def _group_factorize_dd(nb: int, tol: float, th, tl, invh, invl,
                        lev_ids, diag_idx, l_ids, l_dsel, u_ids,
                        u_dsel, upd_dst, upd_l, upd_u):
    """Super-level GROUP dd engine: one fori iteration factors a whole
    group of independent same-depth columns — G batched dd LU scans
    (vmapped ``dd_lu_inverses``), union panels against per-member inverses, and
    WAVE-SPLIT updates (dd's gather / renormalizing ``dd_sub`` / set
    needs unique destinations per application; wave w carries every
    destination's w-th occurrence — see
    ``Schedule.superfused_wave_tables``).  Amortizes the per-level
    sequential scan latency that dominates the dd engine under
    nested-dissection schedules (depth << bl); the dd analogue of the
    super-level fused engine and of the reference's concurrent
    ready-GETRF seeding (pangulu_numeric.c:1054-1068)."""
    from pangulu_jax.ops import dd as D

    ns, W = diag_idx.shape[0], upd_dst.shape[1]

    def body(s, c):
        th, tl, invh, invl = c
        d_idx = diag_idx[s]
        (dh, dl), (lih, lil), (uih, uil) = jax.vmap(
            lambda h, l: D.dd_lu_inverses(h, l, nb=nb, tol=tol))(
                th[d_idx], tl[d_idx])
        th = th.at[d_idx].set(dh)
        tl = tl.at[d_idx].set(dl)
        ks = lev_ids[s]
        invh = invh.at[ks, 0].set(lih)
        invl = invl.at[ks, 0].set(lil)
        invh = invh.at[ks, 1].set(uih)
        invl = invl.at[ks, 1].set(uil)
        lbh, lbl = D.dd_matmul(th[l_ids[s]], tl[l_ids[s]],
                               uih[l_dsel[s]], uil[l_dsel[s]])
        th = th.at[l_ids[s]].set(lbh)
        tl = tl.at[l_ids[s]].set(lbl)
        ubh, ubl = D.dd_matmul(lih[u_dsel[s]], lil[u_dsel[s]],
                               th[u_ids[s]], tl[u_ids[s]])
        th = th.at[u_ids[s]].set(ubh)
        tl = tl.at[u_ids[s]].set(ubl)

        def wave(w, c2):
            th, tl = c2
            dst = upd_dst[s, w]
            ph, pl = D.dd_matmul(lbh[upd_l[s, w]], lbl[upd_l[s, w]],
                                 ubh[upd_u[s, w]], ubl[upd_u[s, w]])
            nh, nl2 = D.dd_sub(th[dst], tl[dst], ph, pl)
            return th.at[dst].set(nh), tl.at[dst].set(nl2)

        th, tl = jax.lax.fori_loop(0, W, wave, (th, tl))
        return th, tl, invh, invl

    return jax.lax.fori_loop(0, ns, body, (th, tl, invh, invl))


@functools.partial(jax.jit, static_argnums=(0,), donate_argnums=(1,))
def _superfused_factorize(backend: KernelBackend, tiles, diag_idx,
                          l_ids, l_dsel, u_ids, u_dsel,
                          upd_dst, upd_l, upd_u):
    """Super-level fused engine: one fori iteration factors a whole
    GROUP of independent block columns (equal block-etree depth,
    Schedule.superlevels) — G diagonals in one batched GETRF+invert,
    the union of their panels in one batched matmul against the
    per-member inverses, and all Schur updates in one scatter-add
    (duplicate destinations accumulate; addition commutes).  The
    static-schedule counterpart of the reference's concurrent
    ready-GETRF seeding (pangulu_numeric.c:1054-1068); transformative
    under nested-dissection orderings (depth << bl)."""
    ns = diag_idx.shape[0]
    dt = tiles.dtype

    def body(s, tiles):
        d_idx = diag_idx[s]
        diag, linv, uinv = jax.vmap(
            lambda t: backend.diag_factor_invert(t, backend.tol))(tiles[d_idx])
        tiles = tiles.at[d_idx].set(diag)
        lblk = jnp.matmul(tiles[l_ids[s]], uinv[l_dsel[s]],
                          preferred_element_type=dt)
        tiles = tiles.at[l_ids[s]].set(lblk)
        ublk = jnp.matmul(linv[u_dsel[s]], tiles[u_ids[s]],
                          preferred_element_type=dt)
        tiles = tiles.at[u_ids[s]].set(ublk)
        prod = jnp.matmul(lblk[upd_l[s]], ublk[upd_u[s]],
                          preferred_element_type=dt)
        tiles = tiles.at[upd_dst[s]].add(-prod)
        return tiles

    return jax.lax.fori_loop(0, ns, body, tiles)


@functools.partial(jax.jit, static_argnums=(0,), donate_argnums=(1,))
def _fused_factorize(backend: KernelBackend, tiles, diag_idx, l_ids, u_ids,
                     upd_dst, upd_l, upd_u):
    """Whole factorization in ONE dispatch: lax.fori_loop over levels
    with fully padded index tables — no host round-trip between levels,
    one compile for the whole factorization."""
    bl = diag_idx.shape[0]
    dt = tiles.dtype
    has_l = l_ids.shape[1] > 0
    has_u = u_ids.shape[1] > 0
    has_upd = upd_dst.shape[1] > 0

    def body(k, tiles):
        d_idx = diag_idx[k]
        diag, linv, uinv = backend.diag_factor_invert(tiles[d_idx], backend.tol)
        tiles = tiles.at[d_idx].set(diag)
        if has_l:
            lids = l_ids[k]
            lblk = jnp.matmul(tiles[lids], uinv, preferred_element_type=dt)
            tiles = tiles.at[lids].set(lblk)
        if has_u:
            uids = u_ids[k]
            ublk = jnp.matmul(linv, tiles[uids], preferred_element_type=dt)
            tiles = tiles.at[uids].set(ublk)
        if has_upd and has_l and has_u:
            prod = jnp.matmul(lblk[upd_l[k]], ublk[upd_u[k]],
                              preferred_element_type=dt)
            tiles = tiles.at[upd_dst[k]].add(-prod)
        return tiles

    return jax.lax.fori_loop(0, bl, body, tiles)


class LUFactorizer:
    """Runs gstrf on a blocked matrix.  Mirrors the reference handle's
    numeric phase (pangulu_gstrf, pangulu.c:211).

    ``dispatch``: "fused" = single-dispatch XLA fori_loop engine;
    "segmented" = fused in signature-homogeneous runs (bounds padding
    on skewed schedules); "superfused" = one iteration per super-level
    group of independent columns; "levels" = per-level bucketed
    dispatch; "dd"/"dd_group" = double-float r64 engines (explicit
    request only); "auto" = fused or segmented by padding overhead
    (levels for trsm panel solves).
    """

    # Above this padded/real work ratio the per-level engine wins.
    FUSED_OVERHEAD_LIMIT = 6.0

    def __init__(self, blocked: BlockedMatrix, schedule: Schedule | None = None,
                 backend: KernelBackend | None = None,
                 perf: PerfCounters | None = None,
                 panel_solve: str = "inv",
                 dispatch: str = "auto",
                 precision: str = "highest"):
        # 'highest' forces true-f32 matmuls.  JAX's DEFAULT may run f32
        # matmul inputs at reduced precision (TF32 on the GPU), which
        # wrecks the LU backward error.  Part of the jit trace context,
        # so engines stay cached per precision.
        self.precision = precision
        self.blocked = blocked
        self.schedule = schedule or build_schedule(blocked)
        self.backend = backend or get_backend("auto")
        self.perf = perf or PerfCounters()
        if panel_solve not in ("inv", "trsm"):
            raise ValueError("panel_solve must be 'inv' or 'trsm'")
        self.panel_solve = panel_solve
        if dispatch == "auto":
            if panel_solve != "inv":
                dispatch = "levels"
                reason = "trsm panel solves need per-level dispatch"
            elif (self.schedule.fused_overhead()
                  <= self.FUSED_OVERHEAD_LIMIT):
                dispatch = "fused"
                reason = "one fori_loop dispatch over all levels"
            else:
                dispatch = "segmented"
                reason = "skewed level widths: per-run padding"
            log.info("engine: %s (%s)", dispatch, reason)
            # NOTE: dispatch="superfused" (etree super-level batching)
            # exists but is never auto-selected: on the CPU backend it
            # padded more work than the per-step fixed costs it saves.
            # Its launch economics on the GPU are not measured yet.
        self.dispatch = dispatch
        self._prepared = None
        self._fused_args = None
        self._segments = None
        self._super_segments = None
        self.inv_tiles = None  # dd engines: per-level hi/lo inverses
        if dispatch == "dd":
            self._fused_args = tuple(
                jnp.asarray(t) for t in
                self.schedule.fused_tables(self.blocked.num_tiles))
        elif dispatch == "dd_group":
            self._super_segments = [
                tuple(jnp.asarray(t) for t in seg)
                for seg in self.schedule.superfused_wave_tables(
                    self.blocked.num_tiles, gmax=self.GROUP_GMAX)]
        elif dispatch == "superfused":
            self._super_segments = [
                tuple(jnp.asarray(t) for t in seg)
                for seg in self.schedule.superfused_tables(
                    self.blocked.num_tiles)]
        elif dispatch == "fused":
            self._fused_args = tuple(
                jnp.asarray(t) for t in
                self.schedule.fused_tables(self.blocked.num_tiles))
        elif dispatch == "segmented":
            self._segments = [
                tuple(jnp.asarray(t) for t in seg)
                for seg in self.schedule.segmented_tables(
                    self.blocked.num_tiles)]
        else:
            self._prepared = self._prepare_levels()

    # Batched dd-group width cap: groups wider than this split
    # (members stay independent).
    GROUP_GMAX = 16

    def _prepare_levels(self):
        """Host-side: bucket-pad every level's index arrays once."""
        scratch = self.blocked.num_tiles  # the scratch tile id
        prepared = []
        for lev in self.schedule.levels:
            nl = bucket(len(lev.lpanel))
            nu = bucket(len(lev.upanel))
            nup = bucket(len(lev.upd_dst))
            prepared.append((
                np.array([lev.diag], dtype=np.int32),
                pad_ids(lev.lpanel, nl, scratch),
                pad_ids(lev.upanel, nu, scratch),
                pad_ids(lev.upd_dst, nup, scratch),
                pad_ids(lev.upd_l, nup, 0),
                pad_ids(lev.upd_u, nup, 0),
            ))
        return prepared

    def factorize(self, tiles=None):
        """Run the factorization; returns factored tiles (device array,
        L\\U packed per tile), complete on the device.  ``tiles``, when
        given, is a device tile store to factor in place (donated)."""
        if self.dispatch in ("dd", "dd_group"):
            from pangulu_jax.ops.kernels_jax import DEFAULT_TOL

            if isinstance(tiles, DdTiles):
                th, tl = tiles.hi, tiles.lo
            else:
                # split f64 host tiles into hi/lo f32 pairs; only f32
                # ever reaches the device
                with self.perf.phase("preprocess"):
                    host = self.blocked.tiles
                    hi = host.astype(np.float32)
                    lo = (host - hi.astype(np.float64)).astype(np.float32)
                    th, tl = jax.block_until_ready(
                        (jnp.asarray(hi), jnp.asarray(lo)))
            tol = (self.backend.tol if self.backend.tol is not None
                   else float(DEFAULT_TOL[jnp.dtype(np.float64)]))
            with self.perf.phase("numeric"):
                if self.dispatch == "dd_group":
                    # +1 scratch inverse row for padding group members
                    nb = self.blocked.nb
                    invh = jnp.zeros(
                        (self.schedule.block_length + 1, 2, nb, nb),
                        jnp.float32)
                    invl = jnp.zeros_like(invh)
                    for seg in self._super_segments:
                        th, tl, invh, invl = _group_factorize_dd(
                            nb, tol, th, tl, invh, invl, *seg)
                    invh, invl = invh[:-1], invl[:-1]
                else:
                    th, tl, invh, invl = _fused_factorize_dd(
                        self.blocked.nb, tol, th, tl, *self._fused_args)
                th, tl = jax.block_until_ready((th, tl))
            self.inv_tiles = (invh, invl)
            self._count()
            return DdTiles(th, tl)
        if tiles is None:
            # H2D of the tile store counts as preprocessing (the
            # reference scatters blocks in pangulu_preprocessing, not
            # in the numeric phase) — and the transfer is async, so it
            # must complete before the numeric timer starts.
            with self.perf.phase("preprocess"):
                tiles = jax.block_until_ready(self.blocked.device_tiles())
        ctx = jax.default_matmul_precision(self.precision)
        with self.perf.phase("numeric"), ctx:
            if self.dispatch == "fused":
                tiles = _fused_factorize(self.backend, tiles,
                                         *self._fused_args)
            elif self.dispatch == "superfused":
                for seg in self._super_segments:
                    tiles = _superfused_factorize(self.backend, tiles,
                                                  *seg)
            elif self.dispatch == "segmented":
                for seg in self._segments:
                    tiles = _fused_factorize(self.backend, tiles, *seg)
            else:
                tiles = self._factorize_levels(tiles)
            tiles = jax.block_until_ready(tiles)
        self._count()
        return tiles

    def _factorize_levels(self, tiles):
        """Host loop over levels: one diag dispatch + one panel/Schur
        dispatch per level."""
        for (diag_idx, l_ids, u_ids, dst, lsel, usel) in self._prepared:
            tiles, linv, uinv = _diag_step(self.backend, tiles, diag_idx)
            if self.panel_solve == "inv":
                tiles = _panel_schur_step(
                    self.backend, tiles, linv, uinv,
                    l_ids, u_ids, dst, lsel, usel)
            else:
                tiles = _panel_schur_step_trsm(
                    self.backend, tiles, tiles[diag_idx[0]],
                    l_ids, u_ids, dst, lsel, usel)
        return tiles

    def _count(self):
        self.perf.add_flops(self.schedule.flop_estimate())
        self.perf.kernel_counts(
            getrf=self.schedule.block_length,
            tstrf=self.schedule.n_tstrf,
            gessm=self.schedule.n_gessm,
            ssssm=self.schedule.n_ssssm,
        )
