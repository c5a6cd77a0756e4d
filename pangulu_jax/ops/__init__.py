from pangulu_jax.ops.interface import get_backend, KernelBackend

__all__ = ["get_backend", "KernelBackend"]
