"""Dygraph data parallel (parity: dygraph/parallel.py:84 DataParallel —
scale_loss :150 + apply_collective_grads :201 coalesced allreduce over
NCCLParallelContext nccl_context.h:61).

The counterpart of the JAX package's ``dygraph/parallel.py``:
``ParallelEnv`` reads the same environment; with ``PADDLE_TRAINERS_NUM``
above 1, ``prepare_context`` joins the ``torch.distributed`` world (rank 0's
store at the first endpoint; NCCL on a card, gloo on the CPU) where the
reference calls ``jax.distributed.initialize``, and
``DataParallel.apply_collective_grads`` all-gathers every gradient across
the ranks and takes the mean, as the reference's ``process_allgather`` and
``jnp.mean`` do.  After ``scale_loss`` (1/nranks) that mean is
(1/nranks^2) times the sum of the ranks' gradients, the JAX package's
arithmetic (the reference Paddle sums the scaled gradients; ROADMAP Queue
3)."""

import os

import torch
import torch.distributed as dist

from .base import current_device
from .layers import Layer
from ..parallel import collectives as col
from ..parallel.mesh import init_world

__all__ = ["DataParallel", "ParallelEnv", "prepare_context", "Env"]


class ParallelEnv:
    """Parity: dygraph/parallel.py Env — env-var cluster contract
    (PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM / PADDLE_TRAINER_ENDPOINTS)."""

    def __init__(self):
        self._nranks = int(os.getenv("PADDLE_TRAINERS_NUM", "1"))
        self._local_rank = int(os.getenv("PADDLE_TRAINER_ID", "0"))
        self._dev_id = int(os.getenv("FLAGS_selected_tpus",
                                     os.getenv("FLAGS_selected_gpus", "0")))
        self._trainer_endpoints = os.getenv("PADDLE_TRAINER_ENDPOINTS", "").split(",")
        self._current_endpoint = os.getenv("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def nranks(self):
        return self._nranks

    @property
    def local_rank(self):
        return self._local_rank

    @property
    def dev_id(self):
        return self._dev_id

    @property
    def current_endpoint(self):
        return self._current_endpoint

    @property
    def trainer_endpoints(self):
        return self._trainer_endpoints


Env = ParallelEnv


def prepare_context(strategy=None):
    """Parity: dygraph/parallel.py prepare_context — joins the world of
    ``PADDLE_TRAINERS_NUM`` ranks (the NCCLParallelContext ncclUniqueId
    bootstrap) on the tracer's device, unless one is already joined."""
    env = ParallelEnv()
    if env.nranks > 1 and not dist.is_initialized():
        init_world(env.local_rank, env.nranks, env.trainer_endpoints[0],
                   current_device())
    return env


class DataParallel(Layer):
    """Parity: dygraph/parallel.py:84."""

    def __init__(self, layers, strategy=None):
        super().__init__("data_parallel")
        self._layers = layers
        self._strategy = strategy
        self._env = ParallelEnv()

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        """Parity: :150 — 1/nranks loss scaling before backward."""
        n = max(self._env.nranks, 1)
        if n == 1:
            return loss
        return loss * (1.0 / n)

    def apply_collective_grads(self):
        """Parity: :201 — every gradient gathered across the ranks and
        replaced by the mean over them.  One rank: a no-op."""
        if self._env.nranks <= 1:
            return
        group = dist.group.WORLD
        for p in self._layers.parameters():
            if p._grad is not None:
                arr = col.backend_all_gather(p._grad.unsqueeze(0), group)
                p._grad = torch.mean(arr, dim=0)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_dict(self, *args, **kwargs):
        return self._layers.set_dict(*args, **kwargs)

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def clear_gradients(self):
        self._layers.clear_gradients()
