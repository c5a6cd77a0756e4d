"""Device mesh construction + 2D block-cyclic ownership.

Counterpart of the reference's process grid: ``p = largest divisor of
nproc <= sqrt(nproc)``, ``q = nproc/p``, block (i,j) owned by rank
``(i%p)*q + (j%q)`` (pangulu_common.h:135, pangulu.c:83-90).  Here the
"ranks" are mesh coordinates ``('gp','gq')`` and panel exchange rides
device collectives (NCCL on GPUs) instead of MPI point-to-point.  Every
device reaches every other at the same rate, so the mesh follows
`jax.devices()` order.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def grid_shape(n_devices: int) -> tuple[int, int]:
    """Reference grid rule (pangulu.c:83-90)."""
    p = 1
    for d in range(1, int(np.sqrt(n_devices)) + 1):
        if n_devices % d == 0:
            p = d
    return p, n_devices // p


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    p, q = grid_shape(len(devices))
    dev_array = np.array(devices).reshape(p, q)
    return Mesh(dev_array, axis_names=("gp", "gq"))


def owner(bi, bj, p, q):
    """Mesh coordinates owning block (bi, bj)."""
    return bi % p, bj % q
