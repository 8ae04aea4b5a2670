"""The sharded training step (counterpart of ``paddle_tpu/parallel/train.py``).

Where the JAX step is ONE jitted ``shard_map`` over the mesh — local
``jax.value_and_grad``, an explicit psum of each gradient over its sync
axes (the AllReduceOpHandle placement, details/all_reduce_op_handle.cc:48),
then the optimizer update — each rank's process here runs the same three
steps eagerly on its own slice of the batch: the forward and
``torch.autograd.grad``, the psum of each gradient over its ``grad_syncs``
axes through ``collectives.py``, and the optimizer's in-place update.  At
one rank every psum is a no-op and the step is the one-device step.

``shard_pytree`` is BCastParamsToDevices (parallel_executor.cc:630): rank 0's
value of a replicated leaf on every rank, this rank's slice of a leaf split
over tp or pp (or, under ZeRO, a moment split over dp); ``gather_pytree``
is its inverse, the global tree back from the ranks' shards.
"""

import numpy as np
import torch

from .._tree import tree_leaves, tree_map
from . import collectives as col
from .mesh import WORLD
from .rules import PartitionSpec as P

__all__ = ["TrainState", "grads_of", "make_train_step", "state_specs",
           "shard_pytree", "gather_pytree", "shard_batch", "stack_batches",
           "sync_grads"]


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


def _same_structure(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_structure(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(
            _same_structure(x, y) for x, y in zip(a, b))
    return not isinstance(b, (dict, list))


def _opt_state_specs(param_specs, opt_state):
    """Moment-like leaves mirror their param's spec; scalars replicate."""
    return {k: (param_specs if _same_structure(param_specs, v)
                else tree_map(lambda _: P(), v))
            for k, v in opt_state.items()}


def state_specs(param_specs, state):
    return {"params": param_specs,
            "opt": _opt_state_specs(param_specs, state["opt"])}


def _spec_axes(spec):
    """(dim, axis) for every mesh axis a PartitionSpec splits a dim over."""
    out = []
    for d, part in enumerate(tuple(spec)):
        for a in ((part,) if isinstance(part, str) else tuple(part or ())):
            out.append((d, a))
    return out


def _local_slice(x, spec, mesh):
    """This rank's block of ``x`` under ``spec`` (``x`` itself when no
    split axis has size above one)."""
    for d, a in _spec_axes(spec):
        n = mesh.shape[a]
        if n > 1:
            if x.shape[d] % n:
                raise ValueError("dim %d of size %d does not split over %s=%d"
                                 % (d, x.shape[d], a, n))
            k = x.shape[d] // n
            x = x[(slice(None),) * d + (slice(mesh.coords[a] * k,
                                              (mesh.coords[a] + 1) * k),)]
    return x


def shard_pytree(tree, specs, mesh):
    """Place a global tree on this rank per spec: a leaf split over an axis
    keeps this rank's slice (a copy, so the whole leaf can be freed; every
    rank must hold the same global tree); a leaf replicated over a mesh of
    more than one rank takes world rank 0's value (BCastParamsToDevices
    parity, parallel_executor.cc:630).  On a one-rank mesh the tree comes
    back as it is."""
    if mesh.size == 1:
        return tree

    def place(x, spec):
        if any(mesh.shape[a] > 1 for _, a in _spec_axes(spec)):
            return _local_slice(x, spec, mesh).clone()
        return col.backend_broadcast(x, mesh.groups[WORLD], 0)

    return tree_map(place, tree, specs)


def gather_pytree(tree, specs, mesh):
    """The global tree from this rank's shards (the inverse of
    ``shard_pytree``): each split dim all-gathered over its axes, the last
    split first; replicated leaves as they are.  Every rank of each
    gathering axis must call it."""
    def gather(x, spec):
        for d, a in reversed(_spec_axes(spec)):
            group = mesh.groups.get(a)
            if group is not None:
                x = col.backend_all_gather(x.contiguous(), group, d)
        return x

    if mesh.size == 1:
        return tree
    return tree_map(gather, tree, specs)


def shard_batch(mesh, batch_specs, batch):
    """This rank's slice of a global batch dict (tensors or arrays) per
    ``batch_specs``; the batch itself on a one-rank mesh."""
    if mesh.size == 1:
        return batch
    return {k: _local_slice(v, batch_specs[k], mesh) for k, v in batch.items()}


def stack_batches(mesh, batch_specs, batches, dtypes=None):
    """Stack host batch dicts along a new leading step axis, keep this
    rank's slice of each batch dim per ``batch_specs`` (the step axis
    unsplit) and stage it on ``mesh.device``; ``dtypes`` maps keys to torch
    dtypes (default: numpy's)."""
    out = {}
    for k in batches[0]:
        local = [np.asarray(shard_batch(mesh, batch_specs, {k: b[k]})[k])
                 for b in batches]
        t = torch.from_numpy(np.stack(local))
        if dtypes and k in dtypes:
            t = t.to(dtypes[k])
        out[k] = t.to(mesh.device)
    return out


def sync_grads(grads, grad_syncs):
    """psum each gradient over its sync axes (a tuple per leaf)."""

    def sync(g, axes):
        for a in axes:
            g = col.psum(g, a)
        return g

    with torch.no_grad():
        return tree_map(sync, grads, grad_syncs)


def make_train_step(loss_fn, mesh, param_specs, grad_syncs, optimizer,
                    batch_specs):
    """The training step over ``mesh``.

    loss_fn(params, batch_local) -> scalar loss, written as per-rank code
    whose final loss is already globally reduced.  grad_syncs: tree
    (matching params) of tuples of mesh axis names whose partial gradients
    must be psum'd (transformer.grad_sync_axes).  batch_specs: dict of
    PartitionSpec for the batch.  Returns ``build``: ``build(state)`` gives
    ``step(state, batch, lr) -> (state, loss)`` over a global batch (each
    rank takes its slice), and ``build.multi(state)`` gives
    ``multi(state, batches, lr) -> (state, losses[N])`` over batches staged
    by ``stack_batches`` (already this rank's).  Parameters split over tp
    or pp are this rank's shards (``shard_pytree``)."""
    _, opt_update = optimizer

    def local_step(state, batch, lr):
        with mesh:
            loss, grads = grads_of(loss_fn, state["params"], batch)
            grads = sync_grads(grads, grad_syncs)
            new_params, new_opt = opt_update(grads, state["opt"],
                                             state["params"], lr)
        return {"params": new_params, "opt": new_opt}, loss.detach()

    def step(state, batch, lr):
        return local_step(state, shard_batch(mesh, batch_specs, batch), lr)

    def build(state_template):
        return step

    def build_multi(state_template):
        """N steps over staged batches (leaves [N, ...batch_shape]); the
        MultiTrainer analogue of N iterations per call."""

        def multi(state, batches, lr):
            n = next(iter(batches.values())).shape[0]
            losses = []
            for i in range(n):
                state, loss = local_step(
                    state, {k: v[i] for k, v in batches.items()}, lr)
                losses.append(loss)
            return state, torch.stack(losses)

        return multi

    build.multi = build_multi
    return build
