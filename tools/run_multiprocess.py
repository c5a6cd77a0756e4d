#!/usr/bin/env python
"""Real multi-PROCESS distributed execution smoke (the analogue of the
reference's ``mpirun -np P`` story, README.md:145-153): spawn N python
processes on this host, each owning its own JAX CPU devices, connect
them with ``jax.distributed`` (localhost coordinator), and run the
distributed gstrf + gstrs across the process boundary.

This exercises exactly the code paths a multi-host job uses —
``put_grid_sharded`` building only addressable shards per process,
non-fully-addressable factor arrays, the replicated solve output — with
``jax.process_count() > 1`` actually true, which no single-process test
can check.

    python tools/run_multiprocess.py -np 2 --devices-per-proc 2

Prints ``MULTIPROC OK residual=<r>`` from process 0 and exits 0 on
success.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys


def worker(args) -> int:
    # Every worker is a JAX process on the CPU backend: the workers never
    # open an accelerator (one JAX process per card; see README.md).
    # Backend selection must precede the first jax op.
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from pangulu_jax.parallel import multihost

    multihost.distributed_init(
        coordinator_address=f"localhost:{args.port}",
        num_processes=args.np, process_id=args.worker)
    assert jax.process_count() == args.np, jax.process_count()

    import numpy as np

    from pangulu_jax.blocks import tile_matrix
    from pangulu_jax.io.mmio import generated_rhs
    from pangulu_jax.models import poisson2d
    from pangulu_jax.parallel.dist_numeric import DistributedLU
    from pangulu_jax.parallel.dist_sptrsv import DistributedTriangularSolver
    from pangulu_jax.parallel.mesh import make_mesh
    from pangulu_jax.reorder import reorder
    from pangulu_jax.schedule import build_schedule
    from pangulu_jax.symbolic import symbolic
    from pangulu_jax.utils.perf import residual_norm

    # identical deterministic host pipeline in every process (the
    # reference instead scatters from rank 0; our setup is cheap and
    # pure, so recomputing beats shipping)
    a = poisson2d(args.nx)
    ro = reorder(a, ordering="rcm")
    symb = symbolic(ro.reordered, args.nb)
    blocked = tile_matrix(ro.reordered, symb)
    schedule = build_schedule(blocked)

    ndev = len(jax.devices())
    assert ndev == args.np * args.devices_per_proc, ndev
    mesh = make_mesh(ndev)
    dist = DistributedLU(blocked, schedule, mesh.devices.shape, mesh=mesh)
    gathered = dist.factorize()
    # multi-process arrays span processes: no global gather possible
    assert gathered is None, "expected non-fully-addressable tiles"
    assert not dist.dist_tiles.is_fully_addressable

    b = generated_rhs(a)
    solver = DistributedTriangularSolver(blocked, schedule, dist.layout,
                                         mesh)
    w = solver.solve(dist.dist_tiles, ro.transform_b(b))
    x = ro.transform_x(w)
    res = residual_norm(a.to_scipy(), x, b)
    ok = res < 1e-10
    if multihost.is_primary():
        print(f"MULTIPROC {'OK' if ok else 'FAIL'} residual={res:.3e} "
              f"processes={jax.process_count()} devices={ndev} "
              f"mesh={mesh.devices.shape}", flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-np", type=int, default=2, dest="np")
    ap.add_argument("--devices-per-proc", type=int, default=2)
    ap.add_argument("--nx", type=int, default=6)
    ap.add_argument("--nb", type=int, default=8)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args(argv)

    if args.worker is not None:
        return worker(args)

    # parent: pick a free port, spawn the workers
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " "
                        "--xla_force_host_platform_device_count="
                        f"{args.devices_per_proc}").strip()
    env.setdefault("JAX_PLATFORMS", "cpu")
    # workers start with sys.path[0] = tools/; the repo root must be
    # importable (and any existing PYTHONPATH preserved)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = (repo_root + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else repo_root)
    procs = []
    for i in range(args.np):
        cmd = [sys.executable, os.path.abspath(__file__),
               "-np", str(args.np),
               "--devices-per-proc", str(args.devices_per_proc),
               "--nx", str(args.nx), "--nb", str(args.nb),
               "--worker", str(i), "--port", str(port)]
        procs.append(subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    rc = 0
    outs = []
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=args.timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += "\n<timeout>"
        outs.append(out)
        if p.returncode != 0:
            rc = 1
    ok = any("MULTIPROC OK" in o for o in outs)
    if not ok:
        rc = rc or 1
        for i, o in enumerate(outs):
            sys.stderr.write(f"--- worker {i} ---\n{o}\n")
    else:
        line = next(ln for o in outs for ln in o.splitlines()
                    if "MULTIPROC OK" in ln)
        print(line)
    return rc


if __name__ == "__main__":
    sys.exit(main())
