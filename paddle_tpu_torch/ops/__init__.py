"""Op rules on tensors (counterpart of ``paddle_tpu/ops``).

Importing this package registers the rules the port has so far with the
registry: the ops of LeNet and the book suite (``tensor_ops``, ``math_ops``,
``nn_ops``, ``misc_ops3``, ``sequence_ops``, ``crf_ops``,
``sampling_ops``), the ops the port's clip, regularizer, initializer and
weight-norm classes emit (in ``math_ops``, ``tensor_ops`` and
``misc_ops5``), the optimizers with their SelectedRows branches
(``optimizer_ops``), ``metric_ops``, the control-flow ops
(``control_flow_ops``) and the beam-search ops (``beam_search_ops``).  Each
module mirrors a JAX package module and a reference operators/
sub-directory; the other op types wait and raise the registry's "no
lowering registered" error.  ``beam_search_ops`` also holds the NMT
decoder's beam step and backtrack on tensors.
"""

from . import tensor_ops  # noqa: F401  (ref: operators/fill_constant, *_random)
from . import math_ops  # noqa: F401  (ref: operators/elementwise/, reduce_ops/, mul, mean, top_k)
from . import nn_ops  # noqa: F401  (ref: operators/ conv/pool/norm/activation/loss/embedding)
from . import misc_ops3  # noqa: F401  (ref: operators/cos_sim_op)
from . import misc_ops5  # noqa: F401  (ref: param_attr.py WeightNormParamAttr)
from . import sequence_ops  # noqa: F401  (ref: operators/sequence_ops/)
from . import crf_ops  # noqa: F401  (ref: operators/linear_chain_crf_op, crf_decoding_op)
from . import sampling_ops  # noqa: F401  (ref: operators/nce_op, hierarchical_sigmoid_op)
from . import optimizer_ops  # noqa: F401  (ref: operators/optimizers/)
from . import metric_ops  # noqa: F401  (ref: operators/metrics/)
from . import control_flow_ops  # noqa: F401  (ref: operators/controlflow/)
from .beam_search_ops import beam_backtrack, beam_search_step

from ..registry import registered_ops  # noqa: F401

__all__ = ["beam_search_step", "beam_backtrack"]
