"""fluid.transpiler namespace (counterpart of ``paddle_tpu/transpiler.py``;
parity: python/paddle/fluid/transpiler/ — DistributeTranspiler and its
config, the HashName / RoundRobin ps-dispatchers, and the
memory-optimisation entry points, no-ops as the reference deprecated
them)."""

from .distributed.transpiler import (DistributeTranspiler,  # noqa: F401
                                     DistributeTranspilerConfig)

__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig",
           "HashName", "RoundRobin", "memory_optimize", "release_memory"]


class _PSDispatcher:
    def __init__(self, pserver_endpoints):
        self._eps = list(pserver_endpoints)
        self._i = 0

    def reset(self):
        self._i = 0


class HashName(_PSDispatcher):
    """Parity: ps_dispatcher.py HashName — stable hash routing."""

    def dispatch(self, varlist):
        return [self._eps[hash(v.name) % len(self._eps)] for v in varlist]


class RoundRobin(_PSDispatcher):
    """Parity: ps_dispatcher.py RoundRobin."""

    def dispatch(self, varlist):
        out = []
        for _v in varlist:
            out.append(self._eps[self._i % len(self._eps)])
            self._i += 1
        return out


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0, skip_grads=True):
    """Parity: memory_optimization_transpiler.memory_optimize — a no-op
    (the reference deprecated this API; buffer reuse is the allocator's
    work)."""
    return input_program


def release_memory(input_program, skip_opt_set=None):
    return input_program
