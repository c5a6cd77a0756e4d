#!/usr/bin/env python
"""Smoke test of the solver on one NVIDIA GPU, through init/gstrf/gstrs.

    python chip_smoke.py           # one card: phases 1-4 below
    python chip_smoke.py --four    # four cards: the (2,2)-mesh engine only

Phases (one card), each checked against a plain reference — an f64
residual ||Ax-b||/||b|| computed on the host with scipy, and scipy's
``splu`` where it solves the same system in seconds:

1. poisson3d(64) nd and poisson3d(32) rcm/nd, nb=128, in r64 (residual
   <= 1e-10) and r32 with refine=0 (residual <= 1e-4; a residual near
   1e-3 means TF32 crept into a product); poisson3d(16) r64 against
   splu (relative difference of x <= 1e-9).
2. Reuse of the poisson3d(32) handle: update_values + gstrf + gstrs,
   16 right-hand sides, chained gstrs_device solves, transpose solve.
3. A circuit matrix in r64 with MC64 (4 refinement rounds) plus one
   update_values cycle, and a complex matrix in cr64 and cr32 (native
   complex), each against splu.  The circuit generator's matrices have
   cond ~1e16, so there both solvers are held to the residual and the
   difference of their x is only reported.
4. Compressed tile storage on poisson3d(32) r32.

``--four`` runs the 2D block-cyclic engine on a (2,2) mesh — poisson3d(48)
nd r64 and a circuit matrix with MC64 plus one update_values cycle — and
compares each with the same matrix factored on one card in this process,
by residual (every solve, mesh and one card, <= 1e-10) and by
||x4 - x1|| / ||x1|| (checked for the Poisson matrix, reported for the
ill-conditioned circuit matrix).

Every phase prints its engine, times, residual and peak device memory.
A failed phase is reported and the script exits 1 after the others; the
last line is the JSON ok record only when every phase passed.  Without a
GPU it exits 1 before any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

SIZES = {
    "poisson_big": 64,       # n = 262,144
    "poisson_mid": 32,       # n = 32,768 (the bench matrix)
    "poisson_splu": 16,      # n = 4,096
    "circuit_n": 5000,
    "complex_n": 2000,
    "four_poisson": 48,      # n = 110,592
    "four_circuit_n": 5000,
}
NB = 128
# the circuit matrices are solved with iterative refinement (gstrs
# refine=): static pivoting leaves ~1e-7 residuals at n=5,000 before it
CIRCUIT_REFINE = 4
TOL_R64 = 1e-10
TOL_R32 = 1e-4      # refine=0; TF32 products give ~1e-3
TOL_SPLU = 1e-9     # relative difference of x, r64


def log(msg: str) -> None:
    print(msg, flush=True)


def peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def rel_diff(x, ref) -> float:
    x, ref = np.asarray(x), np.asarray(ref)
    return float(np.linalg.norm(x - ref) / (np.linalg.norm(ref) or 1.0))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def engine_of(h) -> str:
    fac = h._factorizer
    if h._dist is not None and h._dist.single is None:
        return "distributed-2d"
    return getattr(fac, "dispatch", type(fac).__name__)


def rhs_for(a, seed: int = 0):
    """b = A x_true with a seeded random x_true (in a's value type)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(a.n)
    if np.iscomplexobj(a.values):
        x = x + 1j * rng.standard_normal(a.n)
    return np.asarray(a.to_scipy() @ x)


def solve_timed(a, opts, b, refine=0, record=None):
    """init -> gstrf (twice: cold, then warm) -> gstrs (twice).  Returns
    (handle, x, record) with the wall times in seconds."""
    from pangulu_jax.api import gstrf, gstrs, init

    rec = {} if record is None else record
    t0 = time.perf_counter()
    h = init(a, opts)
    rec["analysis_s"] = time.perf_counter() - t0
    for key in ("gstrf_cold_s", "gstrf_s"):
        t0 = time.perf_counter()
        gstrf(h)
        rec[key] = time.perf_counter() - t0
    for key in ("gstrs_cold_s", "gstrs_s"):
        t0 = time.perf_counter()
        x = gstrs(h, b, refine=refine)
        rec[key] = time.perf_counter() - t0
    rec["engine"] = engine_of(h)
    rec["tiles"] = h.blocked.num_tiles
    rec["levels"] = h.schedule.block_length
    rec["peak_bytes"] = peak_bytes()
    return h, x, rec


def report(name: str, rec: dict) -> None:
    """One line per record; nested records print as their own lines."""
    flat = []
    for k, v in rec.items():
        if isinstance(v, dict):
            report(f"{name}: {k}", v)
        elif isinstance(v, float):
            flat.append(f"{k}={v:.6g}")
        else:
            flat.append(f"{k}={v}")
    if flat:
        log(f"[{name}] " + " ".join(flat))


def print_memory_analysis(h) -> None:
    """compiled.memory_analysis() of the first numeric step of a dense
    single-card handle."""
    import jax

    from pangulu_jax import numeric

    fac = h._factorizer
    tiles = jax.ShapeDtypeStruct(
        (h.blocked.num_tiles + 1, h.blocked.nb, h.blocked.nb),
        h.blocked.dtype)
    args = (fac._fused_args if fac.dispatch == "fused"
            else fac._segments[0] if fac.dispatch == "segmented" else None)
    if args is None:
        return
    with jax.default_matmul_precision(fac.precision):
        ma = numeric._fused_factorize.lower(
            fac.backend, tiles, *args).compile().memory_analysis()
    log(f"memory_analysis({fac.dispatch}, first step): {ma}")


# ---------------------------------------------------------------- phases


def phase_poisson(nx, ordering, dtype, nb=NB, memory_analysis=False):
    from pangulu_jax.api import InitOptions, finalize
    from pangulu_jax.models import poisson3d
    from pangulu_jax.utils.perf import residual_norm

    a = poisson3d(nx)
    b = rhs_for(a)
    rec = {"n": a.n}
    h, x, rec = solve_timed(
        a, InitOptions(nb=nb, dtype=dtype, ordering=ordering, refine=0),
        b, record=rec)
    rec["flops"] = h.schedule.flop_estimate()
    rec["residual"] = residual_norm(a.to_scipy(), x, b)
    if memory_analysis:
        print_memory_analysis(h)
    finalize(h)
    tol = TOL_R64 if dtype == "r64" else TOL_R32
    check(rec["residual"] <= tol,
          f"poisson3d({nx}) {ordering} {dtype} residual "
          f"{rec['residual']:.3e} > {tol:g}")
    return rec


def phase_vs_splu(nx, nb=NB):
    import scipy.sparse.linalg as spla

    from pangulu_jax.api import InitOptions, finalize
    from pangulu_jax.models import poisson3d
    from pangulu_jax.utils.perf import residual_norm

    a = poisson3d(nx)
    b = rhs_for(a, seed=1)
    h, x, rec = solve_timed(a, InitOptions(nb=nb, dtype="r64"), b)
    finalize(h)
    ref = spla.splu(a.to_scipy().tocsc()).solve(b)
    rec["residual"] = residual_norm(a.to_scipy(), x, b)
    rec["vs_splu"] = rel_diff(x, ref)
    check(rec["residual"] <= TOL_R64, f"residual {rec['residual']:.3e}")
    check(rec["vs_splu"] <= TOL_SPLU, f"x vs splu {rec['vs_splu']:.3e}")
    return rec


def phase_reuse(nx, nb=NB, nrhs=16):
    """Refactorization, multi-RHS, chained device solves and the
    transpose solve on one r32 handle (refine=0 throughout)."""
    import jax.numpy as jnp

    from pangulu_jax.api import (InitOptions, finalize, gstrf, gstrs,
                                 gstrs_device, init, update_values)
    from pangulu_jax.models import poisson3d
    from pangulu_jax.utils.perf import residual_norm

    a = poisson3d(nx)
    s = a.to_scipy().tocsc()
    h = init(a, InitOptions(nb=nb, dtype="r32", ordering="rcm", refine=0))
    gstrf(h)
    rec = {"engine": engine_of(h)}
    # refactorization: same pattern, new values
    s2 = s.copy()
    s2.data = s2.data * (1.0 + 0.05 * np.cos(np.arange(s2.nnz)))
    t0 = time.perf_counter()
    update_values(h, s2)
    gstrf(h)
    b = rhs_for(a, seed=2)
    x = gstrs(h, b)
    rec["refactor_solve_s"] = time.perf_counter() - t0
    rec["refactor_residual"] = residual_norm(s2, x, b)
    # many right-hand sides
    rng = np.random.default_rng(3)
    bm = np.asarray(s2 @ rng.standard_normal((a.n, nrhs)))
    t0 = time.perf_counter()
    xm = gstrs(h, bm)
    rec[f"gstrs_nrhs{nrhs}_s"] = time.perf_counter() - t0
    rec["multi_rhs_residual"] = max(
        residual_norm(s2, xm[:, j], bm[:, j]) for j in range(nrhs))
    # chained device solves: x1 = A^-1 b, x2 = A^-1 x1
    bd = jnp.asarray(b.astype(np.float32))
    x1 = gstrs_device(h, bd)
    x2 = gstrs_device(h, x1)
    x1h, x2h = np.asarray(x1), np.asarray(x2)
    rec["device_chain_residual"] = max(residual_norm(s2, x1h, b),
                                       residual_norm(s2, x2h, x1h))
    # transpose solve
    bt = rhs_for(a, seed=4)
    xt = gstrs(h, bt, trans=True)
    rec["trans_residual"] = residual_norm(s2.T.tocsc(), xt, bt)
    rec["peak_bytes"] = peak_bytes()
    finalize(h)
    for k in ("refactor_residual", "multi_rhs_residual",
              "device_chain_residual", "trans_residual"):
        check(rec[k] <= TOL_R32, f"{k} {rec[k]:.3e} > {TOL_R32:g}")
    return rec


def perturbed(a, scale=0.01):
    """Same pattern as ``a``, values perturbed by up to ``scale``, and
    the right-hand side A2 @ ones: one refactorization cycle's input."""
    s2 = a.to_scipy().tocsc().copy()
    s2.data = s2.data * (1.0 + scale * np.cos(np.arange(s2.nnz)))
    return s2, np.asarray(s2 @ np.ones(a.n))


def refactor_timed(h, s2, b2, refine, rec):
    """update_values + gstrf + gstrs on ``h``; the time and the f64
    residual go into ``rec``.  Returns x."""
    from pangulu_jax.api import gstrf, gstrs, update_values
    from pangulu_jax.utils.perf import residual_norm

    t0 = time.perf_counter()
    update_values(h, s2)
    gstrf(h)
    x = gstrs(h, b2, refine=refine)
    rec["refactor_s"] = time.perf_counter() - t0
    rec["refactor_residual"] = residual_norm(s2, x, b2)
    return x


def phase_circuit(n, nb=NB):
    import scipy.sparse.linalg as spla

    from pangulu_jax.api import InitOptions, finalize
    from pangulu_jax.models import circuit
    from pangulu_jax.utils.perf import residual_norm

    a = circuit(n, seed=5)
    b = rhs_for(a, seed=5)
    h, x, rec = solve_timed(a, InitOptions(nb=nb, dtype="r64", mc64=True),
                            b, refine=CIRCUIT_REFINE)
    # one refactorization cycle: the first matrix's MC64 scaling and
    # orderings are reused for new values
    refactor_timed(h, *perturbed(a), CIRCUIT_REFINE, rec)
    finalize(h)
    ref = spla.splu(a.to_scipy().tocsc()).solve(b)
    rec["residual"] = residual_norm(a.to_scipy(), x, b)
    rec["splu_residual"] = residual_norm(a.to_scipy(), ref, b)
    # the generator's matrices have cond ~1e16 (conductances over eight
    # decades): x itself is not determined to f64 accuracy, so the
    # comparison with splu is by residual; the x difference is reported
    rec["vs_splu"] = rel_diff(x, ref)
    for k in ("residual", "splu_residual", "refactor_residual"):
        check(rec[k] <= TOL_R64, f"{k} {rec[k]:.3e} > {TOL_R64:g}")
    return rec


def phase_complex(n, dtype, nb=NB):
    import scipy.sparse.linalg as spla

    from pangulu_jax.api import InitOptions, finalize
    from pangulu_jax.models import random_unsymmetric
    from pangulu_jax.utils.perf import residual_norm

    a = random_unsymmetric(n, 3.0 / n, seed=7, dtype=np.complex128)
    b = rhs_for(a, seed=7)
    h, x, rec = solve_timed(
        a, InitOptions(nb=nb, dtype=dtype, complex_mode="native"), b)
    check(h.complex_embed is None, "complex auto mode did not run native")
    finalize(h)
    rec["residual"] = residual_norm(a.to_scipy(), x, b)
    ref = spla.splu(a.to_scipy().tocsc()).solve(b)
    rec["vs_splu"] = rel_diff(x, ref)
    tol = TOL_R64 if dtype == "cr64" else TOL_R32
    check(rec["residual"] <= tol, f"residual {rec['residual']:.3e}")
    if dtype == "cr64":
        check(rec["vs_splu"] <= TOL_SPLU, f"x vs splu {rec['vs_splu']:.3e}")
    return rec


def phase_compressed(nx, nb=NB):
    from pangulu_jax.api import InitOptions, finalize
    from pangulu_jax.models import poisson3d
    from pangulu_jax.utils.perf import residual_norm

    a = poisson3d(nx)
    b = rhs_for(a, seed=8)
    h, x, rec = solve_timed(
        a, InitOptions(nb=nb, dtype="r32", tile_storage="compressed",
                       refine=0), b)
    rec["store_ratio"] = (h.factor_tiles.dense_bytes
                          / max(h.factor_tiles.compressed_bytes, 1))
    finalize(h)
    rec["residual"] = residual_norm(a.to_scipy(), x, b)
    check(rec["residual"] <= TOL_R32, f"residual {rec['residual']:.3e}")
    return rec


def phase_four(nx, circuit_n, nb=NB):
    """(2,2) mesh vs one card, same matrices, same process.  Each
    matrix's readings are printed before its checks run."""
    import jax

    from pangulu_jax.api import InitOptions, finalize
    from pangulu_jax.models import circuit, poisson3d
    from pangulu_jax.utils.perf import residual_norm

    check(len(jax.devices()) >= 4, f"--four needs 4 devices, have "
          f"{len(jax.devices())}")
    for name, a, kw in (
            (f"poisson3d({nx}) nd r64", poisson3d(nx),
             dict(ordering="nd")),
            (f"circuit({circuit_n}) r64 mc64", circuit(circuit_n, seed=5),
             dict(mc64=True))):
        is_circuit = "mc64" in kw
        refine = CIRCUIT_REFINE if is_circuit else 0
        b = rhs_for(a, seed=9)
        recs, xs, handles = {}, {}, {}
        for mesh in ((2, 2), None):
            opts = InitOptions(nb=nb, dtype="r64", mesh_shape=mesh, **kw)
            h, x, rec = solve_timed(a, opts, b, refine=refine)
            rec["residual"] = residual_norm(a.to_scipy(), x, b)
            key = "mesh2x2" if mesh else "one_card"
            recs[key], xs[key], handles[key] = rec, x, h
        recs["x4_vs_x1"] = rel_diff(xs["mesh2x2"], xs["one_card"])
        residuals = ["residual"]
        if is_circuit:
            # one refactorization cycle on both: same pattern, values
            # perturbed by 1%, the original MC64 scaling reused
            s2, b2 = perturbed(a)
            xr = {key: refactor_timed(h, s2, b2, refine, recs[key])
                  for key, h in handles.items()}
            recs["refactor_x4_vs_x1"] = rel_diff(xr["mesh2x2"],
                                                 xr["one_card"])
            residuals.append("refactor_residual")
        for h in handles.values():
            finalize(h)
        report(f"four: {name}", recs)
        for key in ("mesh2x2", "one_card"):
            for r in residuals:
                check(recs[key][r] <= TOL_R64,
                      f"{name} {key} {r} {recs[key][r]:.3e} > {TOL_R64:g}")
        if not is_circuit:   # x is ill-determined at cond ~1e16
            check(recs["x4_vs_x1"] <= TOL_SPLU,
                  f"{name} mesh vs one card {recs['x4_vs_x1']:.3e}")
    return {}


def one_card_phases(sizes=SIZES, nb=NB):
    """(name, thunk) for every one-card phase, smallest first so the
    running peak-memory reading of each phase stays meaningful."""
    big, mid = sizes["poisson_big"], sizes["poisson_mid"]
    return [
        (f"poisson3d({sizes['poisson_splu']}) r64 vs splu",
         lambda: phase_vs_splu(sizes["poisson_splu"], nb=nb)),
        (f"poisson3d({mid}) rcm r32",
         lambda: phase_poisson(mid, "rcm", "r32", nb=nb)),
        (f"poisson3d({mid}) nd r32",
         lambda: phase_poisson(mid, "nd", "r32", nb=nb)),
        (f"poisson3d({mid}) rcm r64",
         lambda: phase_poisson(mid, "rcm", "r64", nb=nb)),
        (f"poisson3d({mid}) reuse r32",
         lambda: phase_reuse(mid, nb=nb)),
        (f"circuit({sizes['circuit_n']}) r64 mc64",
         lambda: phase_circuit(sizes["circuit_n"], nb=nb)),
        (f"complex({sizes['complex_n']}) cr64",
         lambda: phase_complex(sizes["complex_n"], "cr64", nb=nb)),
        (f"complex({sizes['complex_n']}) cr32",
         lambda: phase_complex(sizes["complex_n"], "cr32", nb=nb)),
        (f"poisson3d({mid}) compressed r32",
         lambda: phase_compressed(mid, nb=nb)),
        (f"poisson3d({big}) nd r32",
         lambda: phase_poisson(big, "nd", "r32", nb=nb,
                               memory_analysis=True)),
        (f"poisson3d({big}) nd r64",
         lambda: phase_poisson(big, "nd", "r64", nb=nb)),
    ]


def run_phases(phases) -> list:
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            rec = fn()
        except Exception:
            traceback.print_exc()
            log(f"[{name}] FAILED after {time.perf_counter() - t0:.1f}s")
            failed.append(name)
            continue
        report(name, rec)
        log(f"[{name}] ok in {time.perf_counter() - t0:.1f}s")
    return failed


def card_name_and_power() -> str:
    """nvidia-smi's name and power limit, read by a child process that
    does not use JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the (2,2)-mesh engine on four cards "
                         "and its one-card comparison")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"no GPU: JAX's first device is {dev.platform}")
        return 1
    log(f"nvidia-smi: {card_name_and_power()}")
    # the package lives beside this script
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pangulu_jax import native
    from pangulu_jax.utils import enable_compilation_cache

    jax.config.update("jax_enable_x64", True)
    cache = enable_compilation_cache()
    log(f"jax {jax.__version__}, device_kind {dev.device_kind}, "
        f"devices {len(jax.devices())}")
    log(f"native host library loaded: {native.get_lib() is not None}")
    log(f"compile cache: {cache}")
    t0 = time.perf_counter()
    if args.four:
        failed = run_phases([("four-card (2,2) mesh vs one card",
                              lambda: phase_four(
                                  SIZES["four_poisson"],
                                  SIZES["four_circuit_n"]))])
    else:
        failed = run_phases(one_card_phases())
    log(f"total {time.perf_counter() - t0:.1f}s")
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
