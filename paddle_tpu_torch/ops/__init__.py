"""Op rules on tensors (counterpart of ``paddle_tpu/ops``).

Importing this package registers the rules the port has so far with the
registry: the ops of LeNet, the basic optimizers, the compare, logical and
tensor ops of control-flow programs, the control-flow ops themselves and
the beam-search ops (``tensor_ops``, ``math_ops``, ``nn_ops``,
``optimizer_ops``, ``metric_ops``, ``control_flow_ops``,
``beam_search_ops``).  Each module mirrors a JAX package module and a
reference operators/ sub-directory; the other op types wait and raise the
registry's "no lowering registered" error.  ``beam_search_ops`` also holds
the NMT decoder's beam step and backtrack on tensors.
"""

from . import tensor_ops  # noqa: F401  (ref: operators/fill_constant, *_random)
from . import math_ops  # noqa: F401  (ref: operators/elementwise/, mul, mean, top_k)
from . import nn_ops  # noqa: F401  (ref: operators/ conv/pool/activation/loss)
from . import optimizer_ops  # noqa: F401  (ref: operators/optimizers/)
from . import metric_ops  # noqa: F401  (ref: operators/metrics/)
from . import control_flow_ops  # noqa: F401  (ref: operators/controlflow/)
from .beam_search_ops import beam_backtrack, beam_search_step

from ..registry import registered_ops  # noqa: F401

__all__ = ["beam_search_step", "beam_backtrack"]
