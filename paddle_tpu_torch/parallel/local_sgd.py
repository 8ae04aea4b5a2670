"""Local SGD: local updates on each replica and a periodic average of the
parameters (counterpart of ``paddle_tpu/parallel/local_sgd.py``).

Parity: transpiler/collective.py:269 LocalSGD.  Instead of all-reducing
every gradient every step, each replica updates itself and the replicas'
parameters are averaged every ``local_steps`` steps: one collective per k
steps, the communication/convergence trade of the Local SGD literature.

The JAX package holds the dp replicas as a leading [dp] axis of every
parameter and optimizer leaf, sharded over the dp mesh axis, inside one
``shard_map``.  Here each rank's process holds its own replica (the slice
of that stack at its dp coordinate), so ``stack_local_state`` gives this
rank's replica with ``step = 0`` and the stack is what gathering every
rank's replica gives (``local_sgd_state_specs`` names that layout).  The
step counter is a host integer, the same on every rank.  With plain SGD and
``local_steps = 1`` this is sync data parallelism up to rounding (averaging
after a linear update equals updating with the averaged gradient).
"""

import copy

import torch

from .._tree import tree_map
from . import collectives as col
from .mesh import DP
from .rules import PartitionSpec as P
from .train import _same_structure, grads_of, shard_batch

__all__ = ["make_local_sgd_train_step", "local_sgd_state_specs",
           "stack_local_state"]


def _stacked_specs(param_specs, axis):
    return tree_map(lambda s: P(axis, *tuple(s)), param_specs)


def local_sgd_state_specs(param_specs, state_template, axis=DP):
    """Specs of the stacked-replica state (the ranks' replicas gathered):
    every parameter and parameter-shaped optimizer leaf gains a leading dp
    axis; other optimizer leaves and the step counter are replicated."""
    opt_specs = {}
    for k, v in state_template["opt"].items():
        if _same_structure(state_template["params"], v):
            opt_specs[k] = _stacked_specs(param_specs, axis)
        else:
            opt_specs[k] = tree_map(lambda _: P(), v)
    return {"params": _stacked_specs(param_specs, axis),
            "opt": opt_specs, "step": P()}


def make_local_sgd_train_step(loss_fn, mesh, param_specs, grad_syncs,
                              optimizer, batch_specs, local_steps, axis=DP):
    """Like ``train.make_train_step``, with Local SGD over ``axis``.

    ``loss_fn(params, batch_local)`` computes this replica's LOCAL loss (no
    collective over ``axis``); the gradients are still psum'd over the
    other axes ``grad_syncs`` names.  ``build(state_template)`` gives
    ``(step, state_specs)``: ``step(state, batch, lr) -> (state, loss)``
    over a global batch (this rank's rows per ``batch_specs``), where
    ``state`` is this rank's replica (``stack_local_state``); after the
    update, every ``local_steps``-th step replaces the parameters by their
    mean over ``axis`` (the optimizer state stays local, as in the
    reference), and the loss returned is the mean over the replicas."""
    _, opt_update = optimizer

    def _sync_non_dp(g, axes):
        for a in axes:
            if a != axis:
                g = col.psum(g, a)
        return g

    def build(state_template):
        sspecs = local_sgd_state_specs(param_specs, state_template, axis)

        def step(state, batch, lr):
            batch = shard_batch(mesh, batch_specs, batch)
            with mesh:
                loss, grads = grads_of(loss_fn, state["params"], batch)
                with torch.no_grad():
                    grads = tree_map(_sync_non_dp, grads, grad_syncs)
                new_params, new_opt = opt_update(grads, state["opt"],
                                                 state["params"], lr)
                count = state["step"] + 1
                with torch.no_grad():
                    if count % local_steps == 0:
                        new_params = tree_map(lambda x: col.pmean(x, axis),
                                              new_params)
                    loss = col.pmean(loss.detach(), axis)
            return {"params": new_params, "opt": new_opt,
                    "step": count}, loss

        return step, sspecs

    return build


def stack_local_state(state, dp):
    """This rank's replica of a plain ``{"params", "opt"}`` state (a copy;
    every rank starts from the same state) with a zero step counter: the
    rank's slice of the reference's stacked [dp, ...] layout.  ``dp`` is
    the number of replicas, kept for the reference's signature."""
    if int(dp) < 1:
        raise ValueError("stack_local_state: dp = %r replicas" % (dp,))
    clone = lambda t: tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor)
        else copy.deepcopy(x), t)
    return {"params": clone(state["params"]), "opt": clone(state["opt"]),
            "step": 0}
