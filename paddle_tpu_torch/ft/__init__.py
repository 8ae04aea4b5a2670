"""Fault-tolerance layer (FaultGuard), the counterpart of the JAX package's
``ft``:

- ``ft.ckpt``    unified TrainState checkpoint (dense params + optimizer
                 slots + HostPS sparse shards + dataset cursor + RNG
                 streams + step counter), one committed ``ckpt-<step>``
                 directory;
- ``ft.policy``  CheckpointPolicy — the ``train_from_dataset(checkpoint=…)``
                 and ``TrainLoop`` cadence/resume knobs;
- ``ft.guard``   TrainGuard / LoopGuard — boundary saves, exact-batch
                 resume, SIGTERM → checkpoint-and-exit with ``PREEMPTED_RC``
                 (the rc the elastic launcher restarts for free);
- ``ft.retry``   jittered-exponential-backoff IO wrapper
                 (``ft.retry.{attempts,giveups}`` counters);
- ``ft.chaos``   deterministic fault injection for drills
                 (``tools/chaos_drill.py``), rank-targetable;
- ``ft.agree``   cross-rank step agreement for preemption saves (max-step
                 broadcast over the shared filesystem, multiple-of-K
                 fallback) — all ranks stage the SAME ``ckpt-<step>``.

The resume contract: a run killed at step k (SIGTERM or crash) and resumed
from its auto-checkpoint finishes bit-identical to a never-interrupted run —
parameters, optimizer slots, RNG draws and batch order all replay exactly
(tests/test_torch_ft.py and the drill's gate).
"""

from . import agree        # noqa: F401
from . import chaos        # noqa: F401
from . import policy       # noqa: F401
from . import retry        # noqa: F401
from .policy import CheckpointPolicy  # noqa: F401

# guard/ckpt pull in parallel.checkpoint (which itself uses ft.retry/chaos):
# exposed lazily so importing paddle_tpu_torch.ft never recurses mid-init
_LAZY = {"ckpt", "guard", "TrainGuard",
         "save_train_state", "restore_train_state"}

# the preemption exit code, the reference's (ft/__init__.py): distinct from
# crash rcs so the elastic launcher (distributed/launch.py) restarts a
# preempted worker for free.  128+15 (the shell's SIGTERM rc) would collide
# with an UNHANDLED sigterm; 120 is unclaimed by POSIX and the usual tooling.
PREEMPTED_RC = 120

__all__ = ["CheckpointPolicy", "TrainGuard", "PREEMPTED_RC",
           "agree", "chaos", "retry", "policy", "ckpt", "guard",
           "save_train_state", "restore_train_state"]


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(name)
    # importlib, not `from . import`: the from-import form re-enters this
    # __getattr__ while the submodule attribute is still unset → recursion
    import importlib

    _ckpt = importlib.import_module(__name__ + ".ckpt")
    _guard = importlib.import_module(__name__ + ".guard")
    vals = {"ckpt": _ckpt, "guard": _guard, "TrainGuard": _guard.TrainGuard,
            "save_train_state": _ckpt.save_train_state,
            "restore_train_state": _ckpt.restore_train_state}
    val = vals[name]
    globals()[name] = val
    return val
