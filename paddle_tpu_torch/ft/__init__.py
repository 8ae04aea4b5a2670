"""Fault-tolerance layer: ``chaos``, the deterministic fault injection the
executor's ``nan_batch`` and ``oom_step`` drills arm, and ``retry``, the
jittered backoff the dataset's file opens go through.  The rest of the JAX
package's ``ft`` (checkpoint policy, TrainGuard, cross-rank agreement)
waits for ROADMAP Queue 1 item 6.
"""

from . import chaos  # noqa: F401
from . import retry  # noqa: F401

# the preemption exit code, the reference's (ft/__init__.py): distinct from
# crash rcs so the elastic launcher (distributed/launch.py) restarts a
# preempted worker for free.  128+15 (the shell's SIGTERM rc) would collide
# with an UNHANDLED sigterm; 120 is unclaimed by POSIX and the usual tooling.
PREEMPTED_RC = 120

__all__ = ["chaos", "retry", "PREEMPTED_RC"]
