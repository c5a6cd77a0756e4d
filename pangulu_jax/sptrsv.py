"""Blocked sparse triangular solves (SpTRSV) — the gstrs path.

Counterpart of ``pangulu_sptrsv.c``: level-by-level blocked forward
substitution on L (unit diagonal) then backward substitution on U, both
reading the factored tiles in place.  The reference's per-level
spmv-partial + MPI reduce + bcast (pangulu_sptrsv.c:24-174) becomes, on
a single chip, a batched tile x segment matmul with scatter-add — the
right-looking formulation: once segment k is solved, all dependent
segments are updated in one batched launch.

Multi-RHS is first-class: x is carried as ``[bl+1, nb, nrhs]`` (the +1
row is the scratch segment absorbing padded lanes), so factor-once /
solve-many amortizes like the reference's repeated gstrs calls
(README.md:125).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from pangulu_jax.blocks import BlockedMatrix
from pangulu_jax.ops.interface import KernelBackend, get_backend
from pangulu_jax.schedule import Schedule, bucket, pad_ids
from pangulu_jax.utils.log import get_logger
from pangulu_jax.utils.perf import PerfCounters

log = get_logger()


@functools.partial(jax.jit, static_argnums=(0, 4), donate_argnums=(2,))
def _seg_solve(backend: KernelBackend, tiles, x, args, lower: bool):
    """Fixed-shape per-level triangular solve of one x-segment
    (compiles once per direction/dtype/nrhs)."""
    diag_idx, k = args
    d = tiles[diag_idx[0]]
    xk = (backend.trsv_lower_unit(d, x[k[0]]) if lower
          else backend.trsv_upper(d, x[k[0]]))
    return x.at[k[0]].set(xk)


@functools.partial(jax.jit, static_argnums=(0,), donate_argnums=(2,))
def _seg_update(backend: KernelBackend, tiles, x, k, panel_ids, panel_rows):
    """x[rows] -= T(i,k) @ x[k] for the level's panel blocks (batched
    matmul, bucket-padded — cheap to compile)."""
    xk = x[k[0]]
    upd = jnp.matmul(tiles[panel_ids], xk, preferred_element_type=x.dtype)
    return x.at[panel_rows].add(-upd)


@functools.partial(jax.jit, static_argnums=(0,), donate_argnums=(2,))
def _fused_solve(backend: KernelBackend, tiles, x, diag_idx,
                 l_ids, l_rows, uc_ids, uc_rows):
    """Whole forward+backward solve in ONE dispatch (lax.fori_loop over
    levels), matching the fused factorize engine."""
    bl = diag_idx.shape[0]
    dt = x.dtype

    def fwd(k, x):
        xk = backend.trsv_lower_unit(tiles[diag_idx[k]], x[k])
        x = x.at[k].set(xk)
        upd = jnp.matmul(tiles[l_ids[k]], xk, preferred_element_type=dt)
        return x.at[l_rows[k]].add(-upd)

    def bwd(i, x):
        k = bl - 1 - i
        xk = backend.trsv_upper(tiles[diag_idx[k]], x[k])
        x = x.at[k].set(xk)
        upd = jnp.matmul(tiles[uc_ids[k]], xk, preferred_element_type=dt)
        return x.at[uc_rows[k]].add(-upd)

    x = jax.lax.fori_loop(0, bl, fwd, x)
    x = jax.lax.fori_loop(0, bl, bwd, x)
    return x


@functools.partial(jax.jit, donate_argnums=(2,))
def _fused_solve_trans(tiles, invs, x, l_ids, l_rows, uc_ids, uc_rows):
    """Whole TRANSPOSE solve (A^T x = b from the same factors,
    A^T = U^T L^T) in one dispatch.  LEFT-looking so the existing
    column-panel tables serve both sweeps: forward on U^T gathers
    column k's above-diagonal tiles transposed; backward on L^T its
    below-diagonal tiles.  Padded entries contribute exactly zero: their
    tiles are masked (the scratch tile holds the engines' padded-lane
    garbage, possibly inf, and inf * 0 is NaN) and the scratch x-segment
    is never written.  Diag steps are matmuls against the transposed
    persisted inverses ((U^-1)^T = (U^T)^-1)."""
    bl = l_ids.shape[0]
    dt = x.dtype
    scratch = tiles.shape[0] - 1

    def level(k, x, inv_slot, ids, rows):
        panel = jnp.where((ids[k] == scratch)[:, None, None],
                          jnp.zeros((), tiles.dtype), tiles[ids[k]])
        upd = jnp.einsum("bji,bjr->ir", panel, x[rows[k]],
                         preferred_element_type=dt)
        acc = x[k] - upd
        xk = jnp.matmul(invs[k, inv_slot].T, acc,
                        preferred_element_type=dt)
        return x.at[k].set(xk)

    def fwd(k, x):                      # U^T y = b
        return level(k, x, 1, uc_ids, uc_rows)

    def bwd(i, x):                      # L^T x = y
        return level(bl - 1 - i, x, 0, l_ids, l_rows)

    x = jax.lax.fori_loop(0, bl, fwd, x)
    x = jax.lax.fori_loop(0, bl, bwd, x)
    return x


@functools.partial(jax.jit, donate_argnums=(2,))
def _solve_inv_xla(tiles, invs, x, l_ids, l_rows, uc_ids, uc_rows):
    """Matmul-only fused f32 solve against persisted triangle inverses
    (the correction engine of the dd IR solve)."""
    bl = l_ids.shape[0]
    dt = x.dtype

    def level(k, x, inv_slot, ids, rows):
        xk = jnp.matmul(invs[k, inv_slot], x[k], preferred_element_type=dt)
        x = x.at[k].set(xk)
        upd = jnp.matmul(tiles[ids[k]], xk, preferred_element_type=dt)
        return x.at[rows[k]].add(-upd)

    def fwd(k, x):
        return level(k, x, 0, l_ids, l_rows)

    def bwd(i, x):
        return level(bl - 1 - i, x, 1, uc_ids, uc_rows)

    x = jax.lax.fori_loop(0, bl, fwd, x)
    x = jax.lax.fori_loop(0, bl, bwd, x)
    return x


@functools.partial(jax.jit, static_argnames=("iters",))
def _dd_ir_solve(xbh, xbl, a_th, a_tl, th, invh,
                 row_ids, row_cols,
                 l_ids, l_rows, uc_ids, uc_rows, *, iters):
    """r64 solve at f32-solve speed: device-fused mixed-precision
    iterative refinement.  One dispatch runs (1) an f32 triangular
    solve against the dd factors' HI parts (the matmul-only inverse
    solve), then ``iters`` rounds of (2) EXACT dd blocked residual
    ``r = b - A x`` (ops.dd.dd_blocked_residual) and (3) an f32
    correction solve, accumulating x in dd.  No host round trips.

    Converges to ~f64-class residuals in 2-3 rounds while
    cond(A) << 1/eps_f32 (~1e7); beyond that the all-dd fused solve
    (``_fused_solve_dd``) remains the robust fallback."""
    from pangulu_jax.ops import dd as D

    def corr(r):
        # f32 solve LU dx = r on the hi factors
        return _solve_inv_xla(th, invh, r, l_ids, l_rows,
                              uc_ids, uc_rows)

    xh = corr(xbh)
    xl = jnp.zeros_like(xh)
    for _ in range(iters):
        rh, rl = D.dd_blocked_residual(a_th, a_tl, row_ids, row_cols,
                                       xh, xl, xbh, xbl)
        dx = corr(rh)
        xh, xl = D.dd_add(xh, xl, dx, jnp.zeros_like(dx))
    return xh, xl


@functools.partial(jax.jit, donate_argnums=(4, 5))
def _fused_solve_dd(th, tl, invh, invl, xh, xl, l_ids, l_rows,
                    uc_ids, uc_rows):
    """Whole forward+backward solve in dd arithmetic — matmul-only
    against the per-level dd triangle inverses persisted by the dd
    factorization (numeric._fused_factorize_dd)."""
    from pangulu_jax.ops import dd as D

    bl = l_ids.shape[0]

    def level(k, x, inv_slot, ids, rows):
        xh, xl = x
        kh, kl = D.dd_matmul(invh[k, inv_slot], invl[k, inv_slot],
                             xh[k], xl[k])
        xh = xh.at[k].set(kh)
        xl = xl.at[k].set(kl)
        ph, pl = D.dd_matmul(th[ids[k]], tl[ids[k]], kh, kl)
        rws = rows[k]
        nh, nl = D.dd_sub(xh[rws], xl[rws], ph, pl)
        return xh.at[rws].set(nh), xl.at[rws].set(nl)

    def fwd(k, x):
        return level(k, x, 0, l_ids, l_rows)

    def bwd(i, x):
        return level(bl - 1 - i, x, 1, uc_ids, uc_rows)

    x = jax.lax.fori_loop(0, bl, fwd, (xh, xl))
    x = jax.lax.fori_loop(0, bl, bwd, x)
    return x


class TriangularSolver:
    """gstrs executor over factored tiles."""

    def __init__(self, blocked: BlockedMatrix, schedule: Schedule,
                 backend: KernelBackend | None = None,
                 perf: PerfCounters | None = None,
                 dispatch: str = "fused",
                 precision: str = "highest",
                 inv_tiles=None):
        self.precision = precision
        self.blocked = blocked
        self.schedule = schedule
        self.backend = backend or get_backend("auto")
        self.perf = perf or PerfCounters()
        self.dispatch = dispatch
        # triangle inverses persisted by the factorization (dd engines)
        # or computed on first use by _ensure_inverses
        self.inv_tiles = inv_tiles
        if dispatch == "fused":
            self._fused_args = tuple(
                jnp.asarray(t) for t in self.schedule.fused_solve_tables(
                    self.blocked.num_tiles, self.schedule.block_length))
            self._lower_args = self._upper_args = None
        else:
            self._lower_args, self._upper_args = self._prepare()

    def _prepare(self):
        scratch_seg = self.schedule.block_length  # scratch x-segment
        lower, upper = [], []
        for lev in self.schedule.levels:
            nl = bucket(len(lev.lpanel))
            lower.append((
                np.array([lev.diag], dtype=np.int32),
                np.array([lev.k], dtype=np.int32),
                pad_ids(lev.lpanel, nl, self.blocked.num_tiles),
                pad_ids(lev.lrows, nl, scratch_seg),
            ))
            nu = bucket(len(lev.ucolpanel))
            upper.append((
                np.array([lev.diag], dtype=np.int32),
                np.array([lev.k], dtype=np.int32),
                pad_ids(lev.ucolpanel, nu, self.blocked.num_tiles),
                pad_ids(lev.ucolrows, nu, scratch_seg),
            ))
        return lower, upper

    def blockify_rhs(self, b: np.ndarray) -> jnp.ndarray:
        """[n] or [n, nrhs] -> [bl+1, nb, nrhs] padded segments."""
        bl, nb = self.schedule.block_length, self.schedule.nb
        b = np.asarray(b)
        if b.ndim == 1:
            b = b[:, None]
        nrhs = b.shape[1]
        xb = np.zeros((bl + 1, nb, nrhs), dtype=self.blocked.dtype)
        flat = xb[:bl].reshape(bl * nb, nrhs)
        flat[: b.shape[0]] = b
        return jnp.asarray(xb)

    def unblockify(self, xb) -> np.ndarray:
        bl, nb = self.schedule.block_length, self.schedule.nb
        n = self.blocked.n
        out = np.asarray(xb)[:bl].reshape(bl * nb, -1)[:n]
        return out

    def _ensure_inverses(self, tiles):
        """Triangle inverses for every level, recomputed from the packed
        factors when the factorization didn't persist them (e.g. a
        checkpoint-loaded handle).  Unlike the factorization itself the
        inverses have NO cross-level dependency, so this is one batched
        Newton pass over all diagonal tiles."""
        if self.inv_tiles is not None:
            return self.inv_tiles
        from pangulu_jax.ops.kernels_jax import (DEFAULT_TOL,
                                                 unit_lower_inv_newton,
                                                 upper_inv_newton)

        diag_ids = jnp.asarray(
            np.array([lev.diag for lev in self.schedule.levels],
                     dtype=np.int32))
        tol = float(DEFAULT_TOL[jnp.dtype(self.blocked.dtype)])

        @jax.jit
        def _compute(tiles):
            diags = tiles[diag_ids]
            linv = jax.vmap(unit_lower_inv_newton)(diags)
            uinv = jax.vmap(lambda f: upper_inv_newton(f, tol))(diags)
            return jnp.stack([linv, uinv], axis=1)

        with jax.default_matmul_precision(self.precision):
            self.inv_tiles = _compute(jnp.asarray(tiles))
        return self.inv_tiles

    def _log_engine(self, engine: str, why: str = "") -> None:
        """One log line per distinct solve-engine choice — the solve
        analogue of the factorizer's dispatch log."""
        msg = f"{engine} ({why})" if why else engine
        seen = getattr(self, "_logged_engines", None)
        if seen is None:
            seen = self._logged_engines = set()
        if msg not in seen:
            seen.add(msg)
            log.info("solve engine: %s", msg)

    # dd solve method: "ir" = device-fused mixed-precision iterative
    # refinement (f32 inverse-solve corrections + exact dd residuals;
    # ~the f32 solve speed), "dd" = all-dd fused solve (level-latency-
    # bound but robust for cond(A) near/beyond 1/eps_f32).
    dd_solve_method = "ir"
    dd_ir_iters = 3

    def _ensure_dd_ir_state(self):
        """Lazy device state for the dd IR solve: the ORIGINAL A3 tiles
        as a dd pair (the host tile store still holds A3 — the
        factorization ran on device copies), the block-row gather
        tables for the residual and the fused solve tables."""
        if getattr(self, "_dd_ir_state", None) is not None:
            return self._dd_ir_state
        blocked, bl = self.blocked, self.schedule.block_length
        host = blocked.tiles
        hi = host.astype(np.float32)
        lo = (host - hi.astype(np.float64)).astype(np.float32)
        a_th, a_tl = jnp.asarray(hi), jnp.asarray(lo)
        w = max(int(np.diff(blocked.brownnzptr).max()), 1)
        row_ids = np.full((bl, w), blocked.num_tiles, np.int32)
        row_cols = np.full((bl, w), bl, np.int32)  # pad: scratch seg
        for k in range(bl):
            s, e = blocked.brownnzptr[k], blocked.brownnzptr[k + 1]
            row_ids[k, : e - s] = blocked.tile_of_csr[s:e]
            row_cols[k, : e - s] = blocked.bcolidx[s:e]
        fused = tuple(jnp.asarray(t) for t in
                      self.schedule.fused_solve_tables(
                          blocked.num_tiles, bl))[1:]
        self._dd_ir_state = (a_th, a_tl, jnp.asarray(row_ids),
                             jnp.asarray(row_cols)) + fused
        return self._dd_ir_state

    def _dd_ir(self, tiles, xh, xl):
        invh, _ = self.inv_tiles
        a_th, a_tl, row_ids, row_cols, *fused = self._ensure_dd_ir_state()
        with jax.default_matmul_precision(self.precision):
            return _dd_ir_solve(xh, xl, a_th, a_tl, tiles.hi, invh,
                                row_ids, row_cols, *fused,
                                iters=self.dd_ir_iters)

    def _solve_dd(self, tiles, b: np.ndarray) -> np.ndarray:
        """r64 solve from dd factors (see dd_solve_method)."""
        if self.inv_tiles is None or not isinstance(self.inv_tiles,
                                                    tuple):
            raise RuntimeError(
                "dd solve requires the dd factorization's persisted "
                "inverses (factor with the dd engine first)")
        invh, invl = self.inv_tiles
        bl, nb = self.schedule.block_length, self.schedule.nb
        b2 = np.asarray(b, dtype=np.float64)
        squeeze = b2.ndim == 1
        if squeeze:
            b2 = b2[:, None]
        nrhs = b2.shape[1]
        xb = np.zeros((bl + 1, nb, nrhs), dtype=np.float64)
        xb[:bl].reshape(bl * nb, nrhs)[: b2.shape[0]] = b2
        xh = xb.astype(np.float32)
        xl = (xb - xh.astype(np.float64)).astype(np.float32)
        with self.perf.phase("sptrsv"):
            if self.dd_solve_method == "ir":
                self._log_engine("dd_ir", "mixed-precision refinement, "
                                 "corrections via XLA inverse solve")
                oh, ol = self._dd_ir(tiles, jnp.asarray(xh),
                                     jnp.asarray(xl))
            else:
                self._log_engine("dd_fused", "all-dd matmul-only solve")
                _, l_ids, l_rows, uc_ids, uc_rows = (
                    jnp.asarray(t)
                    for t in self.schedule.fused_solve_tables(
                        self.blocked.num_tiles, bl))
                oh, ol = _fused_solve_dd(
                    tiles.hi, tiles.lo, invh, invl, jnp.asarray(xh),
                    jnp.asarray(xl), l_ids, l_rows, uc_ids, uc_rows)
            # one device_get moves both planes and waits for them
            oh_host, ol_host = jax.device_get((oh, ol))
        out = (oh_host.astype(np.float64) + ol_host.astype(np.float64))
        out = out[:bl].reshape(bl * nb, nrhs)[: self.blocked.n]
        return out[:, 0] if squeeze else out

    def solve_trans(self, tiles, b: np.ndarray) -> np.ndarray:
        """Solve (LU)^T x = b on the same factors (transpose solve —
        no reference equivalent; SuperLU-style trans surface)."""
        squeeze = np.asarray(b).ndim == 1
        x = self.blockify_rhs(b)
        tiles = jax.block_until_ready(jnp.asarray(tiles))
        invs = self._ensure_inverses(tiles)
        _, l_ids, l_rows, uc_ids, uc_rows = (
            jnp.asarray(t) for t in self.schedule.fused_solve_tables(
                self.blocked.num_tiles, self.schedule.block_length))
        ctx = jax.default_matmul_precision(self.precision)
        with self.perf.phase("sptrsv"), ctx:
            x = _fused_solve_trans(tiles, invs, x, l_ids, l_rows,
                                   uc_ids, uc_rows)
            x = jax.block_until_ready(x)
        out = self.unblockify(x)
        return out[:, 0] if squeeze else out

    def solve_blocked(self, tiles, xb):
        """Device-resident solve: ``xb`` is an ALREADY-BLOCKED rhs on
        device (``[bl+1, nb, nrhs]``, see :meth:`blockify_rhs`; for dd
        factors a ``(hi, lo)`` pair of such arrays) and the result
        comes back in the same blocked layout WITHOUT a host sync.
        The input buffer may be DONATED (consumed) by the underlying
        engine — do not reuse it after the call.

        This is the serving path: back-to-back solves chain entirely
        on-device with no host round trip between them.  The
        reference's pangulu_gstrs always runs host-resident vectors
        (pangulu_sptrsv.c).
        """
        from pangulu_jax.numeric import DdTiles

        if isinstance(tiles, DdTiles):
            xh, xl = (xb if isinstance(xb, tuple)
                      else (xb, jnp.zeros_like(xb)))
            return self._dd_ir(tiles, xh, xl)
        self._log_engine("fused")
        tiles = jnp.asarray(tiles)
        with jax.default_matmul_precision(self.precision):
            return _fused_solve(self.backend, tiles, xb,
                                *self._fused_args)

    def solve(self, tiles, b: np.ndarray) -> np.ndarray:
        """Solve LU x = b on the factored tiles.  Returns x with the
        same leading shape as b (pangulu_solve, pangulu_sptrsv.c:176)."""
        from pangulu_jax.numeric import DdTiles

        if isinstance(tiles, DdTiles):
            return self._solve_dd(tiles, b)
        squeeze = np.asarray(b).ndim == 1
        self._log_engine(self.dispatch)
        x = self.blockify_rhs(b)
        ctx = jax.default_matmul_precision(self.precision)
        if self.dispatch == "fused":
            tiles = jax.block_until_ready(jnp.asarray(tiles))
            with self.perf.phase("sptrsv"), ctx:
                x = _fused_solve(self.backend, tiles, x, *self._fused_args)
                x = jax.block_until_ready(x)
            out = self.unblockify(x)
            return out[:, 0] if squeeze else out
        with self.perf.phase("sptrsv"), ctx:
            for (diag_idx, k, ids, rows) in self._lower_args:
                x = _seg_solve(self.backend, tiles, x, (diag_idx, k), True)
                if len(ids):
                    x = _seg_update(self.backend, tiles, x, k, ids, rows)
            for (diag_idx, k, ids, rows) in reversed(self._upper_args):
                x = _seg_solve(self.backend, tiles, x, (diag_idx, k), False)
                if len(ids):
                    x = _seg_update(self.backend, tiles, x, k, ids, rows)
            x = jax.block_until_ready(x)
        out = self.unblockify(x)
        return out[:, 0] if squeeze else out
