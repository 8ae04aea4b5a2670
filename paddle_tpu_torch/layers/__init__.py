"""Layers API (parity: python/paddle/fluid/layers/): the JAX package's
``nn``, ``tensor``, ``math_ops``, ``control_flow``, ``metric_op``, ``io``
(``data``), ``learning_rate_scheduler``, ``sequence``, ``extras`` and
``rnn`` modules and ``collective`` (the ``_c_*`` layers), copied.  Its
detection module waits (ROADMAP Queue 1 item 3-B, tranche 6).  A layer builds ops; an op whose rule the port
lacks raises when the executor plans the program."""

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
from . import learning_rate_scheduler
from .learning_rate_scheduler import *  # noqa: F401,F403
from . import sequence
from .sequence import *  # noqa: F401,F403
from . import extras
from .extras import *  # noqa: F401,F403
from . import collective
from . import rnn
from .rnn import *  # noqa: F401,F403

# make sure op rules are registered whenever layers are used
from .. import ops as _ops  # noqa: F401
