"""Global runtime flags — the gflags / `core.globals()` tier.

Parity: platform/flags.cc (~40 FLAGS_* gflags seeded from the environment,
readable/writable from Python via core.globals() and fluid.set_flags;
executor.py:397 reads FLAGS_check_nan_inf per run).

Flags whose behavior the XLA runtime owns (allocator strategy, GC
thresholds) are accepted and recorded for API parity — their reference
behavior is subsumed by XLA buffer liveness — and marked 'no-op by design'
below.  FLAGS_check_nan_inf is live: the Executor validates every fetched
value and written state var for NaN/Inf after each run and raises naming the
offending variable (operator.cc CheckNanInf parity at per-run granularity —
per-op granularity would forbid a single fused XLA module).

The port's copy of the JAX package's ``flags.py``: stdlib only, so the copy
needs no change beyond its package.
"""

import os

__all__ = ["set_flags", "get_flags", "globals_"]

# name -> (default, live?)  live=False: recorded only (XLA owns the behavior)
_KNOWN = {
    "FLAGS_check_nan_inf": (False, True),
    "FLAGS_benchmark": (False, False),
    "FLAGS_eager_delete_tensor_gb": (0.0, False),
    "FLAGS_fraction_of_gpu_memory_to_use": (0.92, False),
    "FLAGS_allocator_strategy": ("auto_growth", False),
    "FLAGS_cudnn_deterministic": (False, False),
    "FLAGS_sync_nccl_allreduce": (False, False),
    "FLAGS_paddle_num_threads": (1, False),
    "FLAGS_use_pinned_memory": (True, False),
}


def _coerce(value, default):
    if isinstance(default, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(default, float):
        return float(value)
    if isinstance(default, int):
        return int(value)
    return value


class _Globals(dict):
    """dict-like flag store (core.globals() analogue)."""

    def __setitem__(self, key, value):
        if key not in _KNOWN:
            raise KeyError("unknown flag %r (known: %s)"
                           % (key, ", ".join(sorted(_KNOWN))))
        super().__setitem__(key, _coerce(value, _KNOWN[key][0]))


def _from_env():
    g = _Globals()
    for name, (default, _) in _KNOWN.items():
        dict.__setitem__(g, name, default)
        if name in os.environ:
            g[name] = os.environ[name]
    return g


globals_ = _from_env()


def set_flags(flags):
    """Parity: fluid.set_flags({'FLAGS_check_nan_inf': True})."""
    for k, v in flags.items():
        globals_[k] = v


def get_flags(names):
    if isinstance(names, str):
        names = [names]
    return {n: globals_[n] for n in names}
