"""Multi-host (pod-slice) execution support.

Counterpart of the reference's MPI bootstrap: the reference relies on
``mpirun -np P`` + ``MPI_COMM_WORLD`` (examples/example.c:82,
pangulu_communication.c) to span hosts; here a pod slice is one
``jax.distributed`` job — each host runs the same program, JAX exposes
every chip in the slice as a global device, and the 2D block-cyclic
mesh simply spans all of them.  Collectives ride ICI within a slice
and DCN across slices; no per-rank message code exists at all
(SURVEY.md §2 "Distributed communication backend").

Usage (same script on every host)::

    from pangulu_jax.parallel import multihost
    multihost.distributed_init()            # no-op single-host
    opts = InitOptions(mesh_shape="auto")   # grid over ALL devices
    ...

On managed clusters the coordinator/process-id arguments may be discovered
automatically; elsewhere pass them explicitly.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def distributed_init(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     strict: bool | None = None) -> None:
    """Initialize the multi-process JAX runtime (idempotent; a no-op
    when the runtime is already initialized or the job is single-host
    with no coordinator configured).

    ``strict``: raise on initialization failure instead of silently
    degrading to N independent single-process runs.  Defaults to True
    whenever coordinator arguments were passed explicitly — a
    misconfigured coordinator must fail loudly, not quietly produce
    wrong-world-size jobs."""
    # Do NOT probe via jax.process_count(): it initializes the XLA
    # backend, after which jax.distributed.initialize refuses to run.
    try:
        already = jax._src.distributed.global_state.client is not None
    except AttributeError:   # private API moved: fall back to trying
        already = False
    if already:
        return
    explicit = (coordinator_address is not None
                or num_processes is not None or process_id is not None)
    if strict is None:
        strict = explicit
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    except RuntimeError as e:
        # If the private global_state probe above broke (API moved),
        # an already-initialized runtime surfaces here — that is a
        # success condition, never a strict-mode failure.
        if "already initialized" in str(e).lower():
            return
        if strict:
            raise
    except ValueError:
        if strict:
            raise
        # auto-discovery found no cluster env: single-process run


def is_primary() -> bool:
    """True on the process that should do host-side work (rank 0 — the
    reference centralizes reorder/symbolic on rank 0 the same way,
    pangulu_reordering.c:1130)."""
    return jax.process_index() == 0


def put_replicated(mesh: Mesh, host_array: np.ndarray):
    """Replicate a host array to every device of the mesh (used for the
    per-level index tables that every device reads)."""
    sharding = NamedSharding(mesh, P())
    return jax.make_array_from_callback(
        host_array.shape, sharding, lambda idx: host_array[idx])


def put_grid_sharded(mesh: Mesh, host_shape, shard_fn):
    """Global array of ``host_shape`` sharded as P('gp','gq') over the
    leading two axes; ``shard_fn(r, c)`` returns the [1, 1, ...] shard
    for mesh coordinate (r, c).  Only addressable shards are built."""
    sharding = NamedSharding(mesh, P("gp", "gq"))
    p, q = mesh.devices.shape

    def cb(index):
        r = index[0].start if index[0].start is not None else 0
        c = index[1].start if index[1].start is not None else 0
        return np.ascontiguousarray(shard_fn(int(r), int(c)))

    return jax.make_array_from_callback(tuple(host_shape), sharding, cb)
