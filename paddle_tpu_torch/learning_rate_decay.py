"""fluid.learning_rate_decay namespace (parity: the reference re-exports
layers.learning_rate_scheduler under this name).  A copy of the JAX
package's ``learning_rate_decay.py``."""

from .layers.learning_rate_scheduler import *  # noqa: F401,F403
from .layers.learning_rate_scheduler import __all__  # noqa: F401
