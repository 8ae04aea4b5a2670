"""CheckpointPolicy — when and how train_from_dataset auto-checkpoints.

Parity: the reference exposes checkpoint cadence through the trainer config
(``save_interval_secs`` / per-pass ``checkpoint_notify`` in the Downpour
trainer descs); here the same knobs are one object handed to
``Executor.train_from_dataset(checkpoint=...)`` and interpreted by
ft/guard.py at step boundaries.  A copy of the JAX package's
``ft/policy.py`` (stdlib only).
"""

import os
import time

__all__ = ["CheckpointPolicy"]


class CheckpointPolicy:
    """Auto-checkpoint cadence + resume contract for train_from_dataset.

    dirname        checkpoint directory (the ``ckpt-<step>`` family lives
                   here; shared across elastic restarts).
    every_steps    save after every N trained steps (None = off).
    every_secs     save when T seconds elapsed since the last save (None =
                   off).  Both set: whichever fires first.
    asynchronous   file IO on a background thread (default True); the train
                   thread only pays the device->host snapshot.  The guard
                   drains the executor's in-flight window before every
                   snapshot so no queued update is mid-flight.
    keep           retain only the newest N committed checkpoints
                   (default 3).
    resume         restore the latest committed checkpoint before the first
                   step and fast-forward the dataset to the saved cursor.
                   A resumed run is bit-identical to a never-interrupted one
                   (params, optimizer slots, HostPS rows, RNG streams,
                   batch order).
    hostps         HostPS embeddings/tables to include in the unified
                   TrainState (None = every live HostPSEmbedding,
                   hostps/service.py registry).
    save_on_preempt  SIGTERM triggers a final synchronous checkpoint before
                   the preemption exit (default True).
    """

    def __init__(self, dirname, every_steps=None, every_secs=None,
                 asynchronous=True, keep=3, resume=False, hostps=None,
                 save_on_preempt=True):
        if every_steps is None and every_secs is None:
            every_steps = int(os.environ.get(
                "PADDLE_TPU_CKPT_EVERY_STEPS", "100"))
        self.dirname = str(dirname)
        self.every_steps = int(every_steps) if every_steps else None
        self.every_secs = float(every_secs) if every_secs else None
        self.asynchronous = bool(asynchronous)
        self.keep = keep
        self.resume = bool(resume)
        self.hostps = hostps
        self.save_on_preempt = bool(save_on_preempt)
        self._last_save_t = time.monotonic()
        self._last_save_step = 0

    def note_saved(self, step):
        self._last_save_t = time.monotonic()
        self._last_save_step = int(step)

    def step_due(self, step):
        """The step-count half of the cadence — deterministic across ranks
        (every rank trains the same step sequence), so a multi-rank fleet
        may act on it locally and still stage identical ``ckpt-<step>``s."""
        return bool(self.every_steps and
                    step - self._last_save_step >= self.every_steps)

    def time_due(self):
        """The wall-clock half — NOT deterministic across ranks (clocks
        skew); in a fleet only rank 0 acts on it directly, publishing the
        boundary it picked for everyone (ft/guard.py cadence marker)."""
        return bool(self.every_secs is not None and
                    time.monotonic() - self._last_save_t >= self.every_secs)

    def should_save(self, step):
        """True when the cadence says a boundary save is due at `step`
        (the single-rank combination of both halves)."""
        return self.step_due(step) or self.time_due()
