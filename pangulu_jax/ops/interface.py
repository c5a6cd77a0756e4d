"""Kernel backend dispatch.

Counterpart of the reference's platform layer
(``pangulu_kernel_interface.c`` + the generated dispatch in
``src/platforms/pangulu_platform_common.h`` / ``build_helper.py``):
kernels are resolved through a small registry so the numeric engine is
backend-agnostic.  Registered backends:

  * ``"jax"``  — JAX/XLA block kernels (run on every platform; the
    analogue of the reference's CPU_NAIVE platform 0x0100000).
  * ``"auto"`` — the same backend; kept as the default spelling.

An unknown backend name is an error.
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class KernelBackend:
    name: str
    getrf: Callable          # (tile, tol) -> tile (L\U packed)
    getrf_batched: Callable  # (tiles, tol) -> tiles
    tstrf: Callable          # (diag, b) -> X @ U = B solve
    gessm: Callable          # (diag, b) -> L @ X = B solve
    ssssm: Callable          # (c, a, b) -> c - a@b
    diag_inverses: Callable  # factored diag -> (L^-1, U^-1)
    diag_factor_invert: Callable  # raw diag -> (f, L^-1, U^-1), matmul-only
    trsv_lower_unit: Callable
    trsv_upper: Callable
    spmv_sub: Callable
    vecadd: Callable
    # tiny-pivot substitution threshold baked into the engines' traces
    # (None = per-dtype DEFAULT_TOL); set via InitOptions.tol
    tol: float | None = None


_REGISTRY: dict[str, KernelBackend] = {}


def register_backend(backend: KernelBackend) -> None:
    _REGISTRY[backend.name] = backend


def _jax_backend() -> KernelBackend:
    import jax

    from pangulu_jax.ops import kernels_jax as k

    return KernelBackend(
        name="jax",
        getrf=k.getrf,
        getrf_batched=lambda tiles, tol=None: jax.vmap(
            lambda t: k.getrf(t, tol))(tiles),
        tstrf=k.tstrf,
        gessm=k.gessm,
        ssssm=k.ssssm,
        diag_inverses=k.diag_inverses,
        diag_factor_invert=k.getrf_with_inverses,
        trsv_lower_unit=k.trsv_lower_unit,
        trsv_upper=k.trsv_upper,
        spmv_sub=k.spmv_sub,
        vecadd=k.vecadd,
    )


def get_backend(name: str = "auto",
                tol: float | None = None) -> KernelBackend:
    """The kernel backend ``name`` ("auto" and "jax" are the same
    backend on every platform), with ``tol`` as its tiny-pivot
    threshold when given."""
    if not _REGISTRY:
        register_backend(_jax_backend())
    key = "jax" if name == "auto" else name
    if key not in _REGISTRY:
        raise ValueError(
            f"unknown kernel backend {name!r}; have "
            f"{sorted(_REGISTRY) + ['auto']}")
    backend = _REGISTRY[key]
    return (dataclasses.replace(backend, tol=tol)
            if tol is not None else backend)
