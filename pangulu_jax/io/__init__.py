from pangulu_jax.io.checkpoint import load_factor, save_factor
from pangulu_jax.io.mmio import read_matrix, read_rhs, write_matrix

__all__ = ["read_matrix", "read_rhs", "write_matrix",
           "save_factor", "load_factor"]
