"""Elimination-level schedule: the static task DAG.

The reference executes the factorization as a synchronisation-free task
DAG driven by precomputed dependency counters, a mutex-protected binary
heap and per-tile SSSSM aggregation (pangulu_preprocessing.c:132-207,
pangulu_task.c, pangulu_numeric.c:655-930).  XLA's static-shape world
wants none of that machinery: the heap's level-first priority (compare
strategy 0, pangulu_task.c:268-281) already makes execution
approximately level-ordered, so we *precompute the level schedule
outright* on the host:

  level k:  GETRF(k,k)
            TSTRF batch  { (i,k) : i>k in pattern }   (L-panel)
            GESSM batch  { (k,j) : j>k in pattern }   (U-panel)
            SSSSM batch  { (i,j) <- (i,k)x(k,j) : (i,j) in pattern }

Dependency counters become implicit: everything level k reads was
produced by levels < k, and within a level each SSSSM destination is
unique, so the whole level lowers to three batched kernels with no
synchronization beyond data flow.  The reference's task *aggregator*
(pangulu_task.c:13-177) maps to exactly this batching.

Index arrays are bucket-padded at dispatch time (pad slot = the scratch
tile) so the jit cache stays O(log max_batch) — the static-shape
replacement for the reference's dynamic task_storage pool.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pangulu_jax.blocks import BlockedMatrix


@dataclasses.dataclass
class Level:
    k: int
    diag: int                 # tile id of (k,k)
    lpanel: np.ndarray        # tile ids of (i,k), i>k  (col-k lower panel)
    lrows: np.ndarray         # their block rows i
    upanel: np.ndarray        # tile ids of (k,j), j>k  (row-k upper panel)
    ucols: np.ndarray         # their block cols j
    upd_dst: np.ndarray       # SSSSM destinations (tile ids)
    upd_l: np.ndarray         # index into lpanel for each update
    upd_u: np.ndarray         # index into upanel for each update
    # SpTRSV (backward pass) needs column-k blocks ABOVE the diagonal:
    ucolpanel: np.ndarray     # tile ids of (i,k), i<k
    ucolrows: np.ndarray      # their block rows i


@dataclasses.dataclass
class Schedule:
    block_length: int
    nb: int
    levels: list
    n_tstrf: int
    n_gessm: int
    n_ssssm: int

    @property
    def max_lpanel(self):
        return max((len(l.lpanel) for l in self.levels), default=0)

    @property
    def max_upanel(self):
        return max((len(l.upanel) for l in self.levels), default=0)

    @property
    def max_updates(self):
        return max((len(l.upd_dst) for l in self.levels), default=0)

    def fused_tables(self, scratch_tile: int):
        """Fully padded [bl, N] index tables for the single-dispatch
        fused engine: every level padded to the schedule-wide maxima.
        Returns (diag_idx, l_ids, u_ids, upd_dst, upd_l, upd_u)."""
        bl = self.block_length
        nl = max(self.max_lpanel, 1)
        nu = max(self.max_upanel, 1)
        np_ = max(self.max_updates, 1)
        diag_idx = np.zeros(bl, dtype=np.int32)
        l_ids = np.full((bl, nl), scratch_tile, dtype=np.int32)
        u_ids = np.full((bl, nu), scratch_tile, dtype=np.int32)
        upd_dst = np.full((bl, np_), scratch_tile, dtype=np.int32)
        upd_l = np.zeros((bl, np_), dtype=np.int32)
        upd_u = np.zeros((bl, np_), dtype=np.int32)
        for i, lev in enumerate(self.levels):
            diag_idx[i] = lev.diag
            l_ids[i, : len(lev.lpanel)] = lev.lpanel
            u_ids[i, : len(lev.upanel)] = lev.upanel
            upd_dst[i, : len(lev.upd_dst)] = lev.upd_dst
            upd_l[i, : len(lev.upd_l)] = lev.upd_l
            upd_u[i, : len(lev.upd_u)] = lev.upd_u
        return diag_idx, l_ids, u_ids, upd_dst, upd_l, upd_u

    def fused_solve_tables(self, scratch_tile: int, scratch_seg: int):
        """Padded tables for the single-dispatch SpTRSV: per level the
        forward pass needs the L-panel (column k below diag) and the
        backward pass the U-column panel (column k above diag)."""
        bl = self.block_length
        nl = max(self.max_lpanel, 1)
        nuc = max((len(l.ucolpanel) for l in self.levels), default=0)
        nuc = max(nuc, 1)
        diag_idx = np.zeros(bl, dtype=np.int32)
        l_ids = np.full((bl, nl), scratch_tile, dtype=np.int32)
        l_rows = np.full((bl, nl), scratch_seg, dtype=np.int32)
        uc_ids = np.full((bl, nuc), scratch_tile, dtype=np.int32)
        uc_rows = np.full((bl, nuc), scratch_seg, dtype=np.int32)
        for i, lev in enumerate(self.levels):
            diag_idx[i] = lev.diag
            l_ids[i, : len(lev.lpanel)] = lev.lpanel
            l_rows[i, : len(lev.lrows)] = lev.lrows
            uc_ids[i, : len(lev.ucolpanel)] = lev.ucolpanel
            uc_rows[i, : len(lev.ucolrows)] = lev.ucolrows
        return diag_idx, l_ids, l_rows, uc_ids, uc_rows

    def segmented_tables(self, scratch_tile: int, min_run: int = 4):
        """Segment the level sequence into runs sharing one bucketed
        (nl, nu, nup) signature and build per-segment padded tables.

        The fused engine pads every level to the schedule-wide maxima —
        wasteful for skewed schedules (minimum-degree orderings grow
        denser toward the end).  Segmenting bounds padding to <=2x per
        dimension within each run while keeping the dispatch count at
        O(#signature changes); runs shorter than ``min_run`` merge into
        their neighbour (elementwise-max signature) to bound the jit
        cache.  Returns a list of fused-table tuples, each shaped
        [seg_len, ...] and consumable by the same fused engine.
        """
        sig = [(bucket(max(len(l.lpanel), 1)),
                bucket(max(len(l.upanel), 1)),
                bucket(max(len(l.upd_dst), 1))) for l in self.levels]
        merged = group_runs(sig, min_run)
        out = []
        for start, end, (nl, nu, np_) in merged:
            seg = end - start
            seg_p = bucket(seg)  # pad run length too: dummy trailing
            # levels factor the scratch tile (harmless), keeping the
            # jit cache keyed on power-of-two shapes only.
            diag_idx = np.full(seg_p, scratch_tile, dtype=np.int32)
            l_ids = np.full((seg_p, nl), scratch_tile, dtype=np.int32)
            u_ids = np.full((seg_p, nu), scratch_tile, dtype=np.int32)
            upd_dst = np.full((seg_p, np_), scratch_tile, dtype=np.int32)
            upd_l = np.zeros((seg_p, np_), dtype=np.int32)
            upd_u = np.zeros((seg_p, np_), dtype=np.int32)
            for t, lev in enumerate(self.levels[start:end]):
                diag_idx[t] = lev.diag
                l_ids[t, : len(lev.lpanel)] = lev.lpanel
                u_ids[t, : len(lev.upanel)] = lev.upanel
                upd_dst[t, : len(lev.upd_dst)] = lev.upd_dst
                upd_l[t, : len(lev.upd_l)] = lev.upd_l
                upd_u[t, : len(lev.upd_u)] = lev.upd_u
            out.append((diag_idx, l_ids, u_ids, upd_dst, upd_l, upd_u))
        return out

    def block_depths(self) -> np.ndarray:
        """Exact block-column dependency depths.  Level j must precede
        level k (j < k) iff tile (j,k) or (k,j) is present: only then
        does level j write anything level k reads (its diag via a Schur
        update needs (k,j) AND (j,k); its panels need (j,k) or (k,j) —
        the union is exactly pattern adjacency).  Distinct columns at
        equal depth touch disjoint diag/panel tiles; their Schur
        updates may share destinations, which commute (addition).
        This is the reference's concurrent ready-GETRF seeding
        (pangulu_numeric.c:1054-1068) made static."""
        if getattr(self, "_depths", None) is not None:
            return self._depths
        bl = self.block_length
        depth = np.zeros(bl, dtype=np.int64)
        for lev in self.levels:
            k = lev.k
            d = 0
            if len(lev.ucolrows):       # (j,k), j<k — column above diag
                d = int(depth[lev.ucolrows].max()) + 1
            # (k,j), j<k — handled via the transpose view: lrows of
            # earlier columns; equivalently row k's left entries.  The
            # pattern is structurally symmetric at block level
            # (block_full), so ucolrows covers both.
            depth[k] = d
        self._depths = depth
        return depth

    def superlevels(self) -> list:
        """Groups of level indices at equal dependency depth — each
        group's diagonals/panels can factor concurrently (etree-level
        batching; pairs with nested-dissection orderings whose
        disjoint subtrees are abundant)."""
        depth = self.block_depths()
        groups: dict[int, list] = {}
        for k, d in enumerate(depth):
            groups.setdefault(int(d), []).append(k)
        return [groups[d] for d in sorted(groups)]

    def superfused_tables(self, scratch_tile: int, min_run: int = 1):
        """Per-SEGMENT padded tables for the super-level fused engine.
        Each super-level batches G diagonals (one batched GETRF+invert)
        plus the union of members' panels and Schur updates; upd_l /
        upd_u index the CONCATENATED panel batches.  Segments group
        consecutive super-levels of one bucketed signature (leaf depths
        have hundreds of members, the root has one — global padding
        would erase the win).

        ``min_run=1`` (default) disables run-merging: super-level
        sequences are heterogeneous (leaf groups are huge, the root is
        one column), and merging to the elementwise-max signature was
        measured to pad 3-5x more work than it saves in dispatches.

        Returns a list of
        (diag_idx[S,G], l_ids[S,NL], l_dsel[S,NL], u_ids[S,NU],
         u_dsel[S,NU], upd_dst[S,NUP], upd_l[S,NUP], upd_u[S,NUP])."""
        supers = self.superlevels()
        sig = []
        stats = []
        for mem in supers:
            g = len(mem)
            nl = sum(len(self.levels[k].lpanel) for k in mem)
            nu = sum(len(self.levels[k].upanel) for k in mem)
            nup = sum(len(self.levels[k].upd_dst) for k in mem)
            stats.append((g, nl, nu, nup))
            sig.append((bucket(max(g, 1)), bucket(max(nl, 1)),
                        bucket(max(nu, 1)), bucket(max(nup, 1))))
        out = []
        for s0, s1, (G, NL, NU, NUP) in group_runs(sig, min_run):
            seg = s1 - s0
            diag_idx = np.full((seg, G), scratch_tile, dtype=np.int32)
            l_ids = np.full((seg, NL), scratch_tile, dtype=np.int32)
            l_dsel = np.zeros((seg, NL), dtype=np.int32)
            u_ids = np.full((seg, NU), scratch_tile, dtype=np.int32)
            u_dsel = np.zeros((seg, NU), dtype=np.int32)
            upd_dst = np.full((seg, NUP), scratch_tile, dtype=np.int32)
            upd_l = np.zeros((seg, NUP), dtype=np.int32)
            upd_u = np.zeros((seg, NUP), dtype=np.int32)
            for t, mem in enumerate(supers[s0:s1]):
                ol = ou = op = 0
                for g, k in enumerate(mem):
                    lev = self.levels[k]
                    diag_idx[t, g] = lev.diag
                    nlk = len(lev.lpanel)
                    nuk = len(lev.upanel)
                    nupk = len(lev.upd_dst)
                    l_ids[t, ol:ol + nlk] = lev.lpanel
                    l_dsel[t, ol:ol + nlk] = g
                    u_ids[t, ou:ou + nuk] = lev.upanel
                    u_dsel[t, ou:ou + nuk] = g
                    upd_dst[t, op:op + nupk] = lev.upd_dst
                    upd_l[t, op:op + nupk] = lev.upd_l + ol
                    upd_u[t, op:op + nupk] = lev.upd_u + ou
                    ol += nlk
                    ou += nuk
                    op += nupk
            out.append((diag_idx, l_ids, l_dsel, u_ids, u_dsel,
                        upd_dst, upd_l, upd_u))
        return out

    def superfused_wave_tables(self, scratch_tile: int, gmax: int = 16,
                               min_run: int = 1):
        """Per-SEGMENT padded tables for SET-semantics super-level
        engines (the dd engine's update is gather / renormalizing
        dd_sub / SET, which — unlike a commutative scatter-ADD —
        cannot tolerate duplicate destinations in one application).

        Groups = superlevels split at ``gmax`` (bounds the batched
        dd-scan width).  Each group's updates are WAVE-SPLIT: wave w
        holds every destination's w-th occurrence, so destinations are
        unique within a wave; waves apply sequentially (W = max
        destination multiplicity across the group — small in
        practice, 1 for chain schedules).

        Returns a list of
        (lev_ids[S,G], diag_idx[S,G], l_ids[S,NL], l_dsel[S,NL],
         u_ids[S,NU], u_dsel[S,NU], upd_dst[S,W,NW], upd_l[S,W,NW],
         upd_u[S,W,NW]); ``lev_ids`` pad = ``block_length`` (the
        scratch inverse-store row), tile pads = ``scratch_tile``,
        ``upd_l``/``upd_u`` index the group-CONCATENATED panel lists.
        """
        supers = [mem[s:s + gmax] for mem in self.superlevels()
                  for s in range(0, len(mem), gmax)]
        gdata = []
        sig = []
        for mem in supers:
            nl = nu = 0
            dsts, uls, uus = [], [], []
            for k in mem:
                lev = self.levels[k]
                dsts.append(np.asarray(lev.upd_dst, dtype=np.int64))
                uls.append(np.asarray(lev.upd_l, dtype=np.int64) + nl)
                uus.append(np.asarray(lev.upd_u, dtype=np.int64) + nu)
                nl += len(lev.lpanel)
                nu += len(lev.upanel)
            dst = (np.concatenate(dsts) if dsts
                   else np.empty(0, np.int64))
            if len(dst):
                ul = np.concatenate(uls)
                uu = np.concatenate(uus)
                # occurrence index of each destination = its wave
                order = np.argsort(dst, kind="stable")
                ds = dst[order]
                idx = np.arange(len(ds))
                start = np.maximum.accumulate(
                    np.where(np.r_[True, ds[1:] != ds[:-1]], idx, 0))
                occ = np.empty_like(idx)
                occ[order] = idx - start
                # position within the wave = appearance order
                worder = np.argsort(occ, kind="stable")
                ws = occ[worder]
                widx = np.arange(len(ws))
                wstart = np.maximum.accumulate(
                    np.where(np.r_[True, ws[1:] != ws[:-1]], widx, 0))
                wpos = np.empty_like(widx)
                wpos[worder] = widx - wstart
                wcnt = np.bincount(occ)
                W, NW = len(wcnt), int(wcnt.max())
            else:
                ul = uu = dst
                occ = wpos = np.zeros(0, dtype=np.int64)
                W = NW = 1
            gdata.append((mem, nl, nu, dst, ul, uu, occ, wpos))
            sig.append((bucket(max(len(mem), 1)), bucket(max(nl, 1)),
                        bucket(max(nu, 1)), W, bucket(max(NW, 1))))
        out = []
        for s0, s1, (G, NL, NU, W, NW) in group_runs(sig, min_run):
            seg = s1 - s0
            lev_ids = np.full((seg, G), self.block_length,
                              dtype=np.int32)
            diag_idx = np.full((seg, G), scratch_tile, dtype=np.int32)
            l_ids = np.full((seg, NL), scratch_tile, dtype=np.int32)
            l_dsel = np.zeros((seg, NL), dtype=np.int32)
            u_ids = np.full((seg, NU), scratch_tile, dtype=np.int32)
            u_dsel = np.zeros((seg, NU), dtype=np.int32)
            upd_dst = np.full((seg, W, NW), scratch_tile, dtype=np.int32)
            upd_l = np.zeros((seg, W, NW), dtype=np.int32)
            upd_u = np.zeros((seg, W, NW), dtype=np.int32)
            for t in range(seg):
                mem, nl, nu, dst, ul, uu, occ, wpos = gdata[s0 + t]
                ol = ou = 0
                for g, k in enumerate(mem):
                    lev = self.levels[k]
                    lev_ids[t, g] = k
                    diag_idx[t, g] = lev.diag
                    nlk = len(lev.lpanel)
                    nuk = len(lev.upanel)
                    l_ids[t, ol:ol + nlk] = lev.lpanel
                    l_dsel[t, ol:ol + nlk] = g
                    u_ids[t, ou:ou + nuk] = lev.upanel
                    u_dsel[t, ou:ou + nuk] = g
                    ol += nlk
                    ou += nuk
                upd_dst[t, occ, wpos] = dst
                upd_l[t, occ, wpos] = ul
                upd_u[t, occ, wpos] = uu
            out.append((lev_ids, diag_idx, l_ids, l_dsel, u_ids,
                        u_dsel, upd_dst, upd_l, upd_u))
        return out

    def fused_overhead(self) -> float:
        """Padded-work / real-work ratio of the fused engine's Schur
        stage (the dominant cost); used to pick fused vs per-level
        dispatch."""
        real = max(self.n_ssssm, 1)
        padded = self.block_length * max(self.max_updates, 1)
        return padded / real

    def flop_estimate(self) -> float:
        """Dense-tile flop model (counterpart of the reference's exact
        sparse flop counters, pangulu_kernel_interface.c:4-178 — ours
        counts the dense-tile flops actually executed)."""
        nb = float(self.nb)
        getrf = 2.0 / 3.0 * nb ** 3 * self.block_length
        trsm = nb ** 3 * (self.n_tstrf + self.n_gessm)
        gemm = 2.0 * nb ** 3 * self.n_ssssm
        return getrf + trsm + gemm


def build_schedule(blocked: BlockedMatrix) -> Schedule:
    bl = blocked.block_length
    bcolptr, browidx = blocked.bcolptr, blocked.browidx
    brptr, bcolidx = blocked.brownnzptr, blocked.bcolidx
    tile_of_csr = blocked.tile_of_csr

    levels = []
    n_tstrf = n_gessm = n_ssssm = 0
    for k in range(bl):
        lo, hi = bcolptr[k], bcolptr[k + 1]
        col_rows = browidx[lo:hi]
        col_ids = np.arange(lo, hi)
        below = col_rows > k
        above = col_rows < k
        at = col_rows == k
        if not at.any():
            raise AssertionError(f"missing diagonal block at level {k}")
        diag = int(col_ids[at][0])
        lpanel = col_ids[below].astype(np.int64)
        lrows = col_rows[below].astype(np.int64)
        ucolpanel = col_ids[above].astype(np.int64)
        ucolrows = col_rows[above].astype(np.int64)

        rlo, rhi = brptr[k], brptr[k + 1]
        row_cols = bcolidx[rlo:rhi]
        right = row_cols > k
        upanel = tile_of_csr[rlo:rhi][right].astype(np.int64)
        ucols = row_cols[right].astype(np.int64)

        # Updates: (i,j) for i in lrows x j in ucols present in pattern.
        if len(lrows) and len(ucols):
            ii = np.repeat(np.arange(len(lrows)), len(ucols))
            jj = np.tile(np.arange(len(ucols)), len(lrows))
            dst = blocked.tile_ids(lrows[ii], ucols[jj])
            present = dst >= 0
            upd_dst = dst[present].astype(np.int64)
            upd_l = ii[present].astype(np.int64)
            upd_u = jj[present].astype(np.int64)
        else:
            upd_dst = np.empty(0, dtype=np.int64)
            upd_l = np.empty(0, dtype=np.int64)
            upd_u = np.empty(0, dtype=np.int64)

        n_tstrf += len(lpanel)
        n_gessm += len(upanel)
        n_ssssm += len(upd_dst)
        levels.append(Level(
            k=k, diag=diag, lpanel=lpanel, lrows=lrows,
            upanel=upanel, ucols=ucols,
            upd_dst=upd_dst, upd_l=upd_l, upd_u=upd_u,
            ucolpanel=ucolpanel, ucolrows=ucolrows,
        ))

    return Schedule(
        block_length=bl, nb=blocked.nb, levels=levels,
        n_tstrf=n_tstrf, n_gessm=n_gessm, n_ssssm=n_ssssm,
    )


def waste_aware_runs(sig: list, weights: tuple, lam: float) -> list:
    """Split a per-group signature sequence into contiguous runs
    minimizing TOTAL PADDED COST: each run is padded to its
    elementwise-max signature, costing ``len(run) * dot(weights,
    max_sig)``, plus ``lam`` per run (the per-compiled-step overhead —
    one jitted executable per run).

    ``group_runs(min_run=16)`` merges by POSITION, which on grouped
    (nd) schedules welds wide early groups to narrow late ones and
    pads everything to global maxima — measured 58.8 ms vs rcm's
    21.5 ms on the bench matrix at (1,1) even though nd has 7x fewer
    sequential steps (BASELINE r5).  This O(n^2) DP pads each run to
    its OWN maxima; ``lam`` bounds the run count economically instead
    of positionally.

    Returns [[start, end_exclusive, max_sig], ...] like group_runs.
    """
    n = len(sig)
    if n == 0:
        return []
    INF = float("inf")
    best = [INF] * (n + 1)
    best[0] = 0.0
    cut = [0] * (n + 1)
    for i in range(1, n + 1):
        mx = list(sig[i - 1])
        j = i - 1
        while j >= 0:
            vol = sum(w * m for w, m in zip(weights, mx))
            c = best[j] + (i - j) * vol + lam
            if c < best[i]:
                best[i] = c
                cut[i] = j
            j -= 1
            if j >= 0:
                s = sig[j]
                for d in range(len(mx)):
                    if s[d] > mx[d]:
                        mx[d] = s[d]
    runs = []
    i = n
    while i > 0:
        j = cut[i]
        mx = tuple(max(vals) for vals in zip(*sig[j:i]))
        runs.append([j, i, mx])
        i = j
    runs.reverse()
    return runs


def group_runs(sig: list, min_run: int) -> list:
    """Group consecutive equal per-level signatures into runs and merge
    runs shorter than ``min_run`` into their predecessor (elementwise-
    max signature) — bounds the number of distinct compiled segments.
    Returns [[start, end_exclusive, sig], ...]."""
    runs = []
    s = 0
    for i in range(1, len(sig) + 1):
        if i == len(sig) or sig[i] != sig[s]:
            runs.append([s, i, sig[s]])
            s = i
    merged = []
    for run in runs:
        if merged and (run[1] - run[0] < min_run
                       or merged[-1][1] - merged[-1][0] < min_run):
            prev = merged[-1]
            prev[1] = run[1]
            prev[2] = tuple(max(a, b) for a, b in zip(prev[2], run[2]))
        else:
            merged.append(run)
    return merged


def bucket(n: int) -> int:
    """Pad a batch size to the next power of two (keeps the jit cache
    small — the static-shape analogue of the reference's 7 geometric
    storage-bin capacity classes, pangulu_preprocessing.c:325-332)."""
    if n <= 0:
        return 0
    return 1 << (n - 1).bit_length()


def pad_ids(ids: np.ndarray, size: int, pad_value: int) -> np.ndarray:
    out = np.full(size, pad_value, dtype=np.int32)
    out[: len(ids)] = ids
    return out
