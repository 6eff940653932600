"""Numeric primitives of the port: rounding and the miniature floats."""
from repro_torch.numerics.fp import FPFormat, fp_quantize, fp_round
from repro_torch.numerics.rounding import round_nearest, stochastic_round

__all__ = ["FPFormat", "fp_quantize", "fp_round", "round_nearest",
           "stochastic_round"]
