from stark_tpu_torch.models.air import Air, BoundaryConstraint
from stark_tpu_torch.models.fibonacci import (
    FibonacciAir,
    FibonacciSegmentAir,
    fibonacci_trace_mod_p,
)

__all__ = [
    "Air",
    "BoundaryConstraint",
    "FibonacciAir",
    "FibonacciSegmentAir",
    "fibonacci_trace_mod_p",
]


def get_model(name: str):
    """Model registry: name -> (air, trace_fn, min_blowup).  ``trace_fn(T)``
    returns prover-ready trace rows."""
    from stark_tpu_torch.models import examples as ex

    registry = {
        "fib": (FibonacciAir, fibonacci_trace_mod_p, 4),
        "fib2": (ex.TwoRegisterFibonacciAir, ex.two_register_fibonacci_trace, 4),
        "square": (ex.SquareAir, ex.square_trace, 4),
        "cube": (ex.CubeAir, ex.cube_trace, 8),
        "mds": (ex.MdsSquareAir, ex.mds_square_trace, 4),
        "fib_segment": (FibonacciSegmentAir, fibonacci_trace_mod_p, 4),
    }
    air_cls, trace_fn, min_blowup = registry[name]
    return air_cls(), trace_fn, min_blowup


#: The models the JAX package has too (its tests and the CLI's); the registry
#: also holds ``fib_segment``, whose statements take public inputs.
MODEL_NAMES = ("fib", "fib2", "square", "cube", "mds")
