from pangulu_jax.reorder.driver import Reordering, reorder
from pangulu_jax.reorder.matching import mc64_scale_and_match
from pangulu_jax.reorder.fill_reducing import fill_reducing_order

__all__ = ["reorder", "Reordering", "mc64_scale_and_match",
           "fill_reducing_order"]
