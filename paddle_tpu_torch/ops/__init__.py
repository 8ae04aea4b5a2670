"""Op rules on tensors (counterpart of ``paddle_tpu/ops``).

Importing this package registers the rules the port has so far with the
registry: every rule of the JAX package's ``tensor_ops``, ``math_ops``,
``nn_ops``, ``sequence_ops``, ``ctc_ops``, ``rnn_ops``, ``pooling_ops``,
``metric_ops`` and ``sampling_ops``, every rule of ``misc_ops``,
``misc_ops2``, ``misc_ops3`` and ``misc_ops4``, ``crf_ops``, the
weight-norm op (``misc_ops5``), the optimizers with their SelectedRows
branches (``optimizer_ops``), the control-flow ops
(``control_flow_ops``), the collective ops (``collective_ops``) and the
beam-search ops (``beam_search_ops``).  Each
module mirrors a JAX package module and a reference operators/
sub-directory; the other op types wait and raise the registry's "no
lowering registered" error.  ``beam_search_ops`` also holds the NMT
decoder's beam step and backtrack on tensors.
"""

from . import tensor_ops  # noqa: F401  (ref: operators/fill_constant, *_random)
from . import math_ops  # noqa: F401  (ref: operators/elementwise/, reduce_ops/, mul, mean, top_k)
from . import nn_ops  # noqa: F401  (ref: operators/ conv/pool/norm/activation/loss/embedding)
from . import misc_ops  # noqa: F401  (ref: operators/ losses, tensor utils, rearranges, row_conv, cvm)
from . import misc_ops2  # noqa: F401  (ref: operators/scatter_nd_add, data_norm, gru_unit, ...)
from . import misc_ops3  # noqa: F401  (ref: operators/chunk_eval_op, unique_op, deformable_conv_op, ...)
from . import misc_ops4  # noqa: F401  (ref: operators/hash_op, py_func_op, tree_conv_op, ...)
from . import misc_ops5  # noqa: F401  (ref: param_attr.py WeightNormParamAttr)
from . import sequence_ops  # noqa: F401  (ref: operators/sequence_ops/)
from . import crf_ops  # noqa: F401  (ref: operators/linear_chain_crf_op, crf_decoding_op)
from . import ctc_ops  # noqa: F401  (ref: operators/warpctc_op)
from . import rnn_ops  # noqa: F401  (ref: operators/gru_op, lstm_op, lstmp_op)
from . import pooling_ops  # noqa: F401  (ref: operators/pool_op, pool_with_index_op, maxout_op, unpool_op, spp_op)
from . import sampling_ops  # noqa: F401  (ref: operators/nce_op, hierarchical_sigmoid_op, sample_logits_op, sampling_id_op)
from . import optimizer_ops  # noqa: F401  (ref: operators/optimizers/)
from . import metric_ops  # noqa: F401  (ref: operators/metrics/)
from . import control_flow_ops  # noqa: F401  (ref: operators/controlflow/)
from . import collective_ops  # noqa: F401  (ref: operators/collective/)
from .beam_search_ops import beam_backtrack, beam_search_step

from ..registry import registered_ops  # noqa: F401

__all__ = ["beam_search_step", "beam_backtrack"]
