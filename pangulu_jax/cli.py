"""CLI driver — counterpart of the reference example driver
(examples/example.c): read a .mtx matrix (and optional rhs), run
init/gstrf/gstrs, report residual and perf.

    python -m pangulu_jax.cli -f matrix.mtx -nb 128 [-r rhs.txt]
                              [--dtype r64] [--check]
"""

from __future__ import annotations

import argparse
import sys

def main(argv=None):
    ap = argparse.ArgumentParser(prog="pangulu_jax",
                                 description=__doc__)
    ap.add_argument("-f", "--file", default=None,
                    help=".mtx / .lid (binary CSR) / .npz matrix file "
                         "(required unless --load-factor)")
    ap.add_argument("-nb", type=int, default=128, help="block size")
    ap.add_argument("-r", "--rhs", default=None,
                    help="rhs file (default: b = A @ ones)")
    ap.add_argument("--dtype", default="r64",
                    choices=["r32", "r64", "cr32", "cr64"])
    ap.add_argument("--ordering", default="auto",
                    choices=["auto", "mindeg", "rcm", "nd", "natural"])
    ap.add_argument("--symbolic", default="auto",
                    choices=["auto", "scalar", "block"])
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "jax"])
    ap.add_argument("--no-mc64", action="store_true")
    ap.add_argument("--check", action="store_true",
                    help="run the gstrf residual check (reference "
                         "-DPANGULU_PERF)")
    ap.add_argument("--mesh", default=None,
                    help="p,q mesh shape for multi-chip (e.g. 2,2), or "
                         "'auto' for a grid over all devices")
    ap.add_argument("--refine", type=int, default=-1,
                    help="iterative-refinement rounds in gstrs "
                         "(-1 = auto: 2 for 32-bit types)")
    ap.add_argument("--save-factor", default=None, metavar="PATH",
                    help="write the factorization to PATH (.npz) after "
                         "gstrf for later solve-only reuse")
    ap.add_argument("--load-factor", default=None, metavar="PATH",
                    help="skip init+gstrf; load a factor saved with "
                         "--save-factor and go straight to gstrs")
    ap.add_argument("--profile-dir", default=None,
                    help="write a jax.profiler trace of the numeric "
                         "phase (viewable in XProf/TensorBoard)")
    ap.add_argument("--tile-storage", default="dense",
                    choices=["dense", "compressed"],
                    help="factor storage: dense tiles (fast) or "
                         "O(fill) compressed slots (low memory)")
    ap.add_argument("--platform", default="auto",
                    choices=["auto", "cpu", "gpu"],
                    help="force a JAX platform")
    args = ap.parse_args(argv)
    if not args.file and not args.load_factor:
        ap.error("either -f/--file or --load-factor is required")

    import jax
    import numpy as np

    if args.platform != "auto":
        try:
            jax.config.update("jax_platforms", args.platform)
        except RuntimeError:
            pass
    if args.dtype in ("r64", "cr64"):
        jax.config.update("jax_enable_x64", True)

    from pangulu_jax.api import InitOptions, finalize, gstrf, gstrs, init
    from pangulu_jax.io.checkpoint import load_factor, save_factor
    from pangulu_jax.io.mmio import generated_rhs, read_matrix, read_rhs
    from pangulu_jax.sparse import CscMatrix, VALUE_DTYPES
    from pangulu_jax.utils import enable_compilation_cache
    from pangulu_jax.utils.perf import device_memory_stats, host_rss_bytes, \
        residual_norm

    enable_compilation_cache()
    dtype = VALUE_DTYPES[args.dtype]

    mesh_shape = None
    if args.mesh:
        mesh_shape = ("auto" if args.mesh == "auto"
                      else tuple(int(x) for x in args.mesh.split(",")))

    if args.load_factor:
        handle = load_factor(args.load_factor)
        # The checkpoint records its own value type — the CLI --dtype
        # default must not override it (a saved r32 factor would
        # otherwise read the rhs as r64).
        dtype = VALUE_DTYPES[handle.opts.dtype]
        if np.dtype(dtype).itemsize >= 8:
            jax.config.update("jax_enable_x64", True)
        if handle.complex_embed is not None:
            # a_origin is the 2n x 2n real embedding; the rhs and the
            # residual belong to the ORIGINAL complex system (gstrs
            # embeds/unembeds internally).
            from pangulu_jax.sparse import complex_unembed_matrix

            a = CscMatrix.from_scipy(complex_unembed_matrix(
                handle.a_origin, handle.complex_embed))
        else:
            a = CscMatrix.from_scipy(handle.a_origin)
    else:
        try:
            a = read_matrix(args.file, dtype=dtype)
        except (OSError, ValueError) as e:
            print(f"error reading matrix {args.file!r}: {e}",
                  file=sys.stderr)
            return 2
        opts = InitOptions(nb=args.nb, dtype=args.dtype,
                           mc64=not args.no_mc64,
                           ordering=args.ordering,
                           symbolic_mode=args.symbolic,
                           backend=args.backend, check=args.check,
                           mesh_shape=mesh_shape, refine=args.refine,
                           tile_storage=args.tile_storage,
                           profile_dir=args.profile_dir)
        handle = init(a, opts)
        gstrf(handle)
        if args.save_factor:
            save_factor(handle, args.save_factor)
    b = (read_rhs(args.rhs, a.n, dtype) if args.rhs
         else generated_rhs(a))
    x = gstrs(handle, b)
    res = residual_norm(a.to_scipy(), x, b)
    print(handle.perf.summary())
    print(f"solve residual ||Ax-b||/||b|| = {res:.6e}")
    rss = host_rss_bytes()
    if rss:
        print(f"host RSS: {rss / 2**20:.1f} MiB")
    for dev, st in device_memory_stats().items():
        print(f"{dev}: {st['bytes_in_use'] / 2**20:.1f} MiB in use, "
              f"peak {st['peak_bytes_in_use'] / 2**20:.1f} MiB")
    finalize(handle)
    return 0 if res < 1e-4 else 1


if __name__ == "__main__":
    sys.exit(main())
