"""Distributed execution over a device mesh.

Counterpart of the reference's MPI layer (pangulu_communication.c) and
2D block-cyclic distribution (PANGULU_CALC_RANK, pangulu_common.h:135),
re-expressed as ``jax.sharding.Mesh`` + ``shard_map`` with per-level
masked collectives over the ``('gp', 'gq')`` axes.
"""
