"""Copy of `mastic_tpu/flp/__init__.py`: the scalar FLP and its
circuits."""

from .flp import FlpBBCGGI19, Gadget, Mul, ParallelSum, PolyEval, Valid
from .circuits import Count, Histogram, MultihotCountVec, Sum, SumVec

__all__ = [
    "FlpBBCGGI19", "Gadget", "Mul", "ParallelSum", "PolyEval", "Valid",
    "Count", "Histogram", "MultihotCountVec", "Sum", "SumVec",
]
