"""The training step at one device (counterpart of
``paddle_tpu/parallel/train.py``'s ``make_train_step`` with no gradient
syncs).  Where the JAX step is one jitted function that donates its state,
this one runs the forward, ``torch.autograd.grad`` and an in-place optimizer
update eagerly on the state it is given.
"""

import numpy as np
import torch

from .._tree import tree_leaves, tree_map

__all__ = ["TrainState", "grads_of", "make_train_step", "stack_batches"]


class TrainState(dict):
    """{'params': tree, 'opt': tree}."""

    @staticmethod
    def create(params, optimizer):
        init, _ = optimizer
        return {"params": params, "opt": init(params)}


def grads_of(loss_fn, params, *args):
    """``(out, grads)``: ``out = loss_fn(params, *args)``, the scalar loss or
    a ``(loss, aux)`` pair, and the loss's gradients as a tree shaped like
    ``params`` (``jax.value_and_grad``, with ``has_aux`` read from ``out``)."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        out = loss_fn(params, *args)
        loss = out[0] if isinstance(out, tuple) else out
        flat = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    grads_by_id = {id(p): g for p, g in zip(leaves, flat)}
    return out, tree_map(lambda p: grads_by_id[id(p)], params)


def make_train_step(loss_fn, optimizer):
    """loss_fn(params, batch) -> scalar loss.  Returns ``build``:
    ``build(state)`` gives ``step(state, batch, lr) -> (state, loss)`` and
    ``build.multi(state)`` gives ``multi(state, batches, lr) ->
    (state, losses[N])`` over batches staged with a leading step axis."""
    _, opt_update = optimizer

    def step(state, batch, lr):
        loss, grads = grads_of(loss_fn, state["params"], batch)
        new_params, new_opt = opt_update(grads, state["opt"], state["params"], lr)
        return {"params": new_params, "opt": new_opt}, loss.detach()

    def build(state_template):
        return step

    def build_multi(state_template):
        """N steps over staged batches (leaves [N, ...batch_shape]); the
        MultiTrainer analogue of N iterations per call."""

        def multi(state, batches, lr):
            n = next(iter(batches.values())).shape[0]
            losses = []
            for i in range(n):
                state, loss = step(state, {k: v[i] for k, v in batches.items()}, lr)
                losses.append(loss)
            return state, torch.stack(losses)

        return multi

    build.multi = build_multi
    return build


def stack_batches(batches, device, dtypes=None):
    """Stack host batch dicts along a new leading step axis on ``device``;
    ``dtypes`` maps keys to torch dtypes (default: numpy's)."""
    out = {}
    for k in batches[0]:
        t = torch.from_numpy(np.stack([b[k] for b in batches]))
        if dtypes and k in dtypes:
            t = t.to(dtypes[k])
        out[k] = t.to(device)
    return out
