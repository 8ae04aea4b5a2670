"""Dygraph data parallel (parity: dygraph/parallel.py:84 DataParallel —
scale_loss :150 + apply_collective_grads :201 coalesced allreduce over
NCCLParallelContext nccl_context.h:61).

The counterpart of the JAX package's ``dygraph/parallel.py`` at one rank:
``ParallelEnv`` reads the same environment, ``DataParallel`` wraps a layer
and ``prepare_context`` returns the environment.  With
``PADDLE_TRAINERS_NUM`` above 1, ``prepare_context`` and
``apply_collective_grads`` raise until the port's multi-GPU engine (ROADMAP
Queue 1 item 5) brings the NCCL all-reduce."""

import os

from .layers import Layer

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


def _refuse_ranks(env, what):
    raise NotImplementedError(
        "%s: %d trainers (PADDLE_TRAINERS_NUM); the port's dygraph runs one "
        "rank until its multi-GPU engine (ROADMAP Queue 1 item 5)"
        % (what, env.nranks))


def prepare_context(strategy=None):
    """Parity: dygraph/parallel.py prepare_context — at one rank, the
    environment; above one, refused (ROADMAP Queue 1 item 5)."""
    env = ParallelEnv()
    if env.nranks > 1:
        _refuse_ranks(env, "prepare_context")
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
        """Parity: :201 — allreduce gradients across ranks.  One rank: a
        no-op; above one, refused (ROADMAP Queue 1 item 5)."""
        if self._env.nranks <= 1:
            return
        _refuse_ranks(self._env, "DataParallel.apply_collective_grads")

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_dict(self, *args, **kwargs):
        return self._layers.set_dict(*args, **kwargs)

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def clear_gradients(self):
        self._layers.clear_gradients()
