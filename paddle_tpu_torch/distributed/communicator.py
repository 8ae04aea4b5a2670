"""Communicator (counterpart of ``paddle_tpu/distributed/communicator.py``;
parity: python/paddle/fluid/communicator.py over
operators/distributed/communicator.h — AsyncCommunicator :285 aggregates and
sends gradients on background threads; GeoSgdCommunicator :332 pushes
parameter deltas every ``geo_sgd_need_push_nums`` local steps).

As in the JAX package there is no parameter server: the GeoSGD dynamics —
K purely local steps, then the replicas reconcile — become periodic
parameter averaging over the ``torch.distributed`` world.  ``mode="GEO"``
runs that for the Program path: the executor ticks the communicator after
every run of a geo-tagged program, and every K ticks each float persistable
of the program is averaged over the world, the reference's
``np.mean(gathered, axis=0).astype(dtype)`` as an all-reduce sum over n.
``stop()`` always reconciles once more.

ASYNC mode's stale-pull semantics have no counterpart here; constructing one
says so and behaves synchronously.
"""

import warnings

import torch
import torch.distributed as dist

__all__ = ["Communicator"]


class Communicator:
    def __init__(self, program, vars_info=None, trainers=None,
                 geo_sgd_need_push_nums=None, mode=None):
        dist_info = getattr(program, "_dist_info", None) or {}
        if geo_sgd_need_push_nums is None:
            # the transpiler records the configured K on the program
            geo_sgd_need_push_nums = dist_info.get("geo_sgd_need_push_nums")
        if mode is None:
            mode = ("GEO" if geo_sgd_need_push_nums
                    or dist_info.get("mode") == "geo" else "ASYNC")
        self.mode = mode.upper()
        self.program = program
        self.push_nums = int(geo_sgd_need_push_nums or 1)
        self.trainers = trainers
        self._running = False
        self._tick = 0
        self.sync_count = 0
        if self.mode == "ASYNC":
            warnings.warn(
                "Communicator(ASYNC): stale-pull async parameter-server "
                "semantics fold to synchronous execution here (use GEO for "
                "periodic local-step semantics)")

    # -- lifecycle (communicator.py start/stop contract) ------------------------
    def start(self):
        self._running = True
        if self.program is not None:
            # the executor ticks us after each geo-tagged run
            self.program._communicator = self

    def stop(self):
        # GeoSgd's final push: every worker always joins one last reconcile
        # here, so a worker whose step count is a multiple of push_nums
        # does not leave the others waiting in the collective
        if self._running and self.mode == "GEO":
            self._average_params()
        self._running = False
        if self.program is not None and \
                getattr(self.program, "_communicator", None) is self:
            self.program._communicator = None

    def is_running(self):
        return self._running

    # -- geo machinery ------------------------------------------------------------
    def tick(self, scope=None):
        """One local step happened; every push_nums-th tick averages the
        program's float persistables over the world.

        Every rank must run the same number of steps between start() and
        stop(): the k-th reconcile of one rank pairs with the k-th of every
        other, and stop() always contributes one last one."""
        if not self._running or self.mode != "GEO":
            return False
        self._tick += 1
        if self._tick % self.push_nums:
            return False
        self._average_params(scope)
        return True

    def _average_params(self, scope=None):
        from ..parallel.collectives import backend_all_reduce
        from ..scope import global_scope

        scope = scope or global_scope()
        self.sync_count += 1
        n = dist.get_world_size() if dist.is_initialized() else 1
        if n == 1:
            return                      # one process: the mean is itself
        for var in self.program.list_vars():
            local = scope.find_var(var.name) if var.persistable else None
            if not isinstance(local, torch.Tensor) or \
                    not local.is_floating_point():
                continue                # step counters etc. stay local
            total = backend_all_reduce(local, dist.group.WORLD)
            scope.set(var.name, (total / n).to(local.dtype))
