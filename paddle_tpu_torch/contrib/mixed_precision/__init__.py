"""Parity: fluid/contrib/mixed_precision/ (the port's ``amp.py``)."""

from ...amp import (
    decorate,
    AutoMixedPrecisionLists,
    CustomOpLists,
    OptimizerWithMixedPrecision,
)

__all__ = ["decorate", "AutoMixedPrecisionLists", "CustomOpLists",
           "OptimizerWithMixedPrecision"]
