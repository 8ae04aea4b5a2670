"""Fault-tolerance layer: for now only ``chaos``, the deterministic fault
injection the executor's ``nan_batch`` and ``oom_step`` drills arm.  The
rest of the JAX package's ``ft`` (checkpoint policy, TrainGuard, retry,
cross-rank agreement) waits for ROADMAP Queue 1 item 6.
"""

from . import chaos  # noqa: F401

__all__ = ["chaos"]
