"""Fault-tolerance layer: ``chaos``, the deterministic fault injection the
executor's ``nan_batch`` and ``oom_step`` drills arm, and ``retry``, the
jittered backoff the dataset's file opens go through.  The rest of the JAX
package's ``ft`` (checkpoint policy, TrainGuard, cross-rank agreement)
waits for ROADMAP Queue 1 item 6.
"""

from . import chaos  # noqa: F401
from . import retry  # noqa: F401

__all__ = ["chaos", "retry"]
