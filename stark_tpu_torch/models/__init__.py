from stark_tpu_torch.models.air import Air, BoundaryConstraint
from stark_tpu_torch.models.fibonacci import FibonacciAir, fibonacci_trace_mod_p

__all__ = [
    "Air",
    "BoundaryConstraint",
    "FibonacciAir",
    "fibonacci_trace_mod_p",
]
