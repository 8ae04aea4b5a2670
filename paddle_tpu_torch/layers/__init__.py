"""Layers API (parity: python/paddle/fluid/layers/): the JAX package's
``nn``, ``tensor``, ``math_ops``, ``control_flow``, ``metric_op`` and
``io`` (``data``) modules, copied.  Its learning_rate_scheduler, sequence,
detection, extras, collective and rnn modules wait (ROADMAP Queue 1
item 3).  A layer builds ops; an op whose rule the port lacks raises when
the executor plans the program."""

from . import math_ops
from .math_ops import *  # noqa: F401,F403
from . import tensor
from .tensor import *  # noqa: F401,F403
from . import nn
from .nn import *  # noqa: F401,F403
from . import io
from .io import *  # noqa: F401,F403
from . import control_flow
from .control_flow import *  # noqa: F401,F403
from . import metric_op
from .metric_op import *  # noqa: F401,F403

# make sure op rules are registered whenever layers are used
from .. import ops as _ops  # noqa: F401
