"""ZeRO-style optimizer-state sharding over the data-parallel axis
(counterpart of ``paddle_tpu/parallel/zero.py``; the reference's kReduce,
details/build_strategy.h:58).

Each rank keeps its dp shard of every eligible moment — rows
``[i*n/dp, (i+1)*n/dp)`` of dim 0 — and updates only that shard:

  grads:   reduce_scatter over dp (each rank gets the sum of its rows)
  state:   moment tensors held as this rank's shard (1/dp of the bytes)
  update:  the optimizer on the local rows of the param and its moments
  params:  all_gather of the updated shards rebuilds the replicated param

Eligibility per leaf, as in the reference: dim 0 divisible by dp and at
least dp, not already split over dp by the param's spec, and the leaf's
gradient synced over dp.  Ineligible leaves take the replicated path in
the same step.  LAMB's per-param trust-ratio norms span the whole param
through ``optim.norm_reduction`` (a psum over dp of each shard's sum of
squares).
"""

import torch

from .._tree import tree_leaves, tree_map
from . import collectives as col
from . import optim
from .mesh import DP
from .rules import PartitionSpec as P
from .train import _same_structure, grads_of, shard_batch

__all__ = ["zero_shardable_mask", "zero_state_specs", "make_zero_train_step"]


def _dim0_axes(spec):
    t = tuple(spec) if spec is not None else ()
    e = t[0] if t else None
    if e is None:
        return ()
    return (e,) if isinstance(e, str) else tuple(e)


def _leaf_shardable(template_leaf, spec, sync_axes, mesh, axis):
    """dim 0 of the LOCAL leaf (after any existing dim-0 split) must divide
    evenly by dp, dp must not already split dim 0, and the leaf's grad must
    be dp-synced."""
    dp = mesh.shape.get(axis, 1)
    shape = tuple(getattr(template_leaf, "shape", ()))
    if dp <= 1 or len(shape) < 1 or axis not in tuple(sync_axes):
        return False
    axes0 = _dim0_axes(spec)
    if axis in axes0:
        return False
    denom = 1
    for a in axes0:
        denom *= mesh.shape.get(a, 1)
    if shape[0] % denom:
        return False
    local0 = shape[0] // denom
    return local0 >= dp and local0 % dp == 0


def zero_shardable_mask(params_template, param_specs, grad_syncs, mesh,
                        axis=DP):
    """Tree of bool (matching params): True where the optimizer state for
    this leaf is sharded over the dp axis."""
    return tree_map(lambda x, s, a: _leaf_shardable(x, s, a, mesh, axis),
                    params_template, param_specs, grad_syncs)


def _moment_spec(param_spec, shardable, axis):
    if not shardable:
        return param_spec
    t = tuple(param_spec) if param_spec is not None else ()
    axes0 = _dim0_axes(param_spec)
    entry0 = axes0 + (axis,) if axes0 else axis
    return P(entry0, *t[1:])


def zero_state_specs(param_specs, state_template, mask, axis=DP):
    """Specs of a TrainState under ZeRO: params keep their specs; moment-
    like opt-state subtrees split dim 0 over dp where the mask allows;
    scalars replicate."""
    opt_specs = {}
    for k, v in state_template["opt"].items():
        if _same_structure(param_specs, v):
            opt_specs[k] = tree_map(lambda s, m: _moment_spec(s, m, axis),
                                    param_specs, mask)
        else:
            opt_specs[k] = tree_map(lambda _: P(), v)
    return {"params": param_specs, "opt": opt_specs}


def make_zero_train_step(loss_fn, mesh, param_specs, grad_syncs, optimizer,
                         batch_specs, axis=DP):
    """ZeRO counterpart of ``train.make_train_step``: the same signature
    plus the dp axis to shard optimizer state over.  Returns
    ``build(state_template) -> (step, state_specs)``: place the state with
    exactly those specs (``shard_pytree``), so that the moments each rank
    holds are its shards."""
    _, opt_update = optimizer
    dp = mesh.shape.get(axis, 1)

    def build(state_template):
        mask = zero_shardable_mask(state_template["params"], param_specs,
                                   grad_syncs, mesh, axis)
        sspecs = zero_state_specs(param_specs, state_template, mask, axis)
        flat_mask = tree_leaves(mask)
        flat_axes = tree_leaves(grad_syncs)
        sh_idx = [i for i, m in enumerate(flat_mask) if m]
        rep_idx = [i for i, m in enumerate(flat_mask) if not m]
        mirroring = [k for k, v in state_template["opt"].items()
                     if _same_structure(state_template["params"], v)]

        def split_state(opt):
            sh, rep = {}, {}
            for k, v in opt.items():
                if k in mirroring:
                    fl = tree_leaves(v)
                    sh[k] = [fl[i] for i in sh_idx]
                    rep[k] = [fl[i] for i in rep_idx]
                else:
                    sh[k] = v
                    rep[k] = v
            return sh, rep

        def local_step(state, batch, lr):
            params = state["params"]
            with mesh:
                loss, grads = grads_of(loss_fn, params, batch)
                flat_g = tree_leaves(grads)
                flat_p = tree_leaves(params)
                idx = col.axis_index(axis)
                with torch.no_grad():
                    # sharded leaves reduce_scatter over dp (ZeRO-2's
                    # schedule); the others psum over their sync axes
                    synced = []
                    for i, (g, axes) in enumerate(zip(flat_g, flat_axes)):
                        for a in axes:
                            if not (flat_mask[i] and a == axis):
                                g = col.psum(g, a)
                        if flat_mask[i]:
                            g = col.reduce_scatter(g, axis, dim=0)
                        synced.append(g)
                    sh_state, rep_state = split_state(state["opt"])
                    sh_p = [flat_p[i].narrow(0, idx * (flat_p[i].shape[0] // dp),
                                             flat_p[i].shape[0] // dp)
                            for i in sh_idx]
                    if sh_idx:
                        with optim.norm_reduction(lambda s: col.psum(s, axis)):
                            new_sh_p, sh_state = opt_update(
                                [synced[i] for i in sh_idx], sh_state, sh_p, lr)
                        for j, i in enumerate(sh_idx):
                            flat_p[i].copy_(col.all_gather(new_sh_p[j], axis,
                                                           dim=0))
                    if rep_idx:
                        _, rep_state = opt_update(
                            [synced[i] for i in rep_idx], rep_state,
                            [flat_p[i] for i in rep_idx], lr)
            # the optimizer updated the params and moments in place; scalar
            # state (the step count) advances identically in both calls
            new_opt = {}
            for k, v in state["opt"].items():
                new_opt[k] = v if k in mirroring else \
                    (sh_state if sh_idx else rep_state)[k]
            return {"params": params, "opt": new_opt}, loss.detach()

        def step(state, batch, lr):
            return local_step(state, shard_batch(mesh, batch_specs, batch), lr)

        return step, sspecs

    return build
