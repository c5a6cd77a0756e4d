"""pangulu_jax — a distributed sparse direct LU solver in JAX.

A from-scratch JAX/XLA framework with the capabilities of the PanguLU
reference (SC'23 sparse direct solver):

  * ``Ax = b`` for general sparse A via ``A = LU`` factorization
  * MC64-style max-weight matching + equilibration scaling
  * fill-reducing ordering (AMD / RCM / natural)
  * scalar symbolic factorization with elimination-tree pruning
  * 2D block-cyclic numeric factorization over a device mesh
  * blocked sparse triangular solves (SpTRSV)
  * value types R32 / R64 / CR32 / CR64

Public API mirrors the reference's five entry points
(``pangulu.h:11-15``): :func:`init`, :func:`gstrf`, :func:`gstrs`,
:func:`gssv`, :func:`finalize` — plus a Pythonic :class:`Solver` wrapper.

The execution model is not a translation: equally-sized blocks are
stored as dense tiles, the reference's synchronisation-
free task DAG (pangulu_task.c / pangulu_numeric.c) is re-expressed as a
level-scheduled sequence of batched block kernels, and MPI point-to-
point block exchange (pangulu_communication.c) becomes per-level mesh
collectives.
"""

from pangulu_jax.api import (
    InitOptions,
    analyze,
    factor_diagnostics,
    Solver,
    finalize,
    gssv,
    gstrf,
    gstrs,
    gstrs_device,
    init,
    spsolve,
    update_values,
)
from pangulu_jax.version import __version__

__all__ = [
    "InitOptions",
    "analyze",
    "factor_diagnostics",
    "Solver",
    "init",
    "gstrf",
    "gstrs",
    "gstrs_device",
    "gssv",
    "spsolve",
    "update_values",
    "finalize",
    "__version__",
]
