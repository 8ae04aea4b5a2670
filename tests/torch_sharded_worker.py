"""One rank of a gloo world for the row-sharded embedding and Local SGD
tests (ROADMAP item 5-C′): ``tests/test_torch_sharded_embedding.py`` and
``tests/test_torch_local_sgd.py``.

``python tests/torch_sharded_worker.py RANK WORLD STORE IN OUT
SCENARIO...``, as ``torch_dp_worker.py`` runs (its ``spawn_world`` and
``join_world`` start this script with ``script=__file__``).  The inputs are
the JAX package's tables, parameters and batches as numpy; each rank keeps
its row block of a table and its rows of a batch, and returns what it
computed (gathered where the test compares whole values).
"""

import os
import sys

import numpy as np
import torch

import torch_dp_worker as base


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def sharded_lookup(inp, world):
    """``test_sharded_embedding_parity``: the row-sharded lookup of
    replicated ids, and the gradient of psum(sum(y * y)) / n into the
    table, gathered."""
    from paddle_tpu_torch.parallel import collectives as col
    from paddle_tpu_torch.parallel import embedding
    from paddle_tpu_torch.parallel.mesh import DP, make_mesh
    from paddle_tpu_torch.parallel.train import _local_slice

    mesh = make_mesh(dp=world, device="cpu")
    case = inp["lookup"]
    shard = _local_slice(_t(case["table"]), embedding.embedding_spec(DP),
                         mesh).clone().requires_grad_(True)
    ids = _t(case["ids"])
    with mesh:
        y = embedding.sharded_embedding_lookup(shard, ids, DP)
        loss = col.psum((y * y).sum(), DP) / world
        # JAX's grad of a shard_map's replicated output gives each device
        # 1/n of the cotangent (the executor seeds a replicated loss so)
        (g,) = torch.autograd.grad(loss, shard,
                                   grad_outputs=torch.tensor(1.0 / world))
        whole = col.backend_all_gather(g, mesh.groups[DP], 0)
    return {"y": y.detach().numpy(), "grad": whole.numpy(),
            "shard_rows": tuple(shard.shape)}


def deepfm_sharded(inp, world):
    """``test_deepfm_sharded_embedding_parity``: the loss and the gradients
    of ``deepfm_loss_sharded`` (the MLP's and bias's psum'd), the table
    gradients gathered from their owner ranks."""
    from paddle_tpu_torch._tree import tree_map
    from paddle_tpu_torch.convert import params_from_numpy
    from paddle_tpu_torch.models import deepfm
    from paddle_tpu_torch.parallel import collectives as col
    from paddle_tpu_torch.parallel.mesh import DP, make_mesh
    from paddle_tpu_torch.parallel.rules import P
    from paddle_tpu_torch.parallel.train import (gather_pytree, grads_of,
                                                 shard_batch, shard_pytree)

    case = inp["deepfm"]
    cfg = deepfm.deepfm_tiny_config(**case["cfg"])
    mesh = make_mesh(dp=world, device="cpu")
    specs = deepfm.deepfm_param_specs(cfg, DP)
    params = shard_pytree(params_from_numpy(case["params"], "cpu"), specs,
                          mesh)
    batch = shard_batch(mesh, {"feat_ids": P(DP), "label": P(DP)},
                        {k: _t(v) for k, v in case["batch"].items()})
    with mesh:
        loss, g = grads_of(
            lambda p: deepfm.deepfm_loss_sharded(p, batch, cfg, DP), params)
        g["mlp"] = tree_map(lambda a: col.psum(a, DP), g["mlp"])
        g["bias"] = col.psum(g["bias"], DP)
    whole = gather_pytree(g, specs, mesh)
    return {"loss": float(loss), "grads": tree_map(lambda t: t.numpy(),
                                                   whole),
            "embed_rows": tuple(params["embed"].shape)}


def deepfm_trainer(inp, world):
    """``build_deepfm_trainer(mesh=...)``: three SGD steps with the tables
    row-sharded, the parameters gathered after them."""
    from paddle_tpu_torch._tree import tree_map
    from paddle_tpu_torch.models import deepfm
    from paddle_tpu_torch.parallel.mesh import DP, make_mesh
    from paddle_tpu_torch.parallel.train import gather_pytree

    case = inp["deepfm"]
    cfg = deepfm.deepfm_tiny_config(**case["cfg"])
    mesh = make_mesh(dp=world, device="cpu")
    tr = deepfm.build_deepfm_trainer(cfg, device="cpu",
                                     params=case["params"], mesh=mesh)
    losses = [float(tr.step({k: _t(v) for k, v in b.items()}, case["lr"]))
              for b in case["batches"]]
    whole = gather_pytree(tr.state["params"], deepfm.deepfm_param_specs(
        cfg, DP), mesh)
    return {"losses": losses,
            "params": tree_map(lambda t: t.numpy(), whole),
            "embed_rows": tuple(tr.state["params"]["embed"].shape)}


# -- Local SGD ---------------------------------------------------------------

def _mlp_loss(params, batch):
    """The reference test's local loss: the mean squared error of a
    two-layer ReLU MLP."""
    h = torch.clamp_min(batch["x"] @ params["w1"] + params["b1"], 0)
    err = h @ params["w2"] + params["b2"] - batch["y"]
    return torch.square(err).float().mean()


def _dp_loss(params, batch):
    """The sync-DP loss: the global mean (the exact-gradient form)."""
    from paddle_tpu_torch.parallel import collectives as col
    from paddle_tpu_torch.parallel.mesh import DP

    h = torch.clamp_min(batch["x"] @ params["w1"] + params["b1"], 0)
    local = torch.square(h @ params["w2"] + params["b2"]
                         - batch["y"]).float().sum()
    cnt = col.psum(torch.tensor(float(batch["x"].shape[0])), DP)
    return col.global_mean_loss(local, cnt, DP)


def _replicas(tree, mesh):
    """Every rank's replica stacked on a leading [dp] axis (the
    reference's stacked layout)."""
    from paddle_tpu_torch._tree import tree_map
    from paddle_tpu_torch.parallel import collectives as col
    from paddle_tpu_torch.parallel.mesh import DP

    return tree_map(lambda t: col.backend_all_gather(
        t.detach().unsqueeze(0), mesh.groups[DP], 0).numpy(), tree)


def _local_sgd(inp, world, k, steps):
    from paddle_tpu_torch._tree import tree_map
    from paddle_tpu_torch.convert import params_from_numpy
    from paddle_tpu_torch.parallel import optim
    from paddle_tpu_torch.parallel.local_sgd import (
        make_local_sgd_train_step, stack_local_state)
    from paddle_tpu_torch.parallel.mesh import DP, MeshSpec
    from paddle_tpu_torch.parallel.rules import P
    from paddle_tpu_torch.parallel.train import TrainState

    case = inp["local_sgd"]
    mesh = MeshSpec(dp=world).build(device="cpu")
    params = params_from_numpy(case["params"], "cpu")
    pspecs = tree_map(lambda _: P(), params)
    syncs = tree_map(lambda _: (DP,), params)
    bspecs = {"x": P(DP), "y": P(DP)}
    batch = {n: _t(v) for n, v in case["batches"][k].items()}
    opt = optim.sgd()
    build = make_local_sgd_train_step(_mlp_loss, mesh, pspecs, syncs, opt,
                                      bspecs, local_steps=k)
    state = stack_local_state(TrainState.create(params, opt), world)
    step_fn, specs = build(state)
    losses, stacks = [], []
    for _ in range(steps):
        state, loss = step_fn(state, batch, 0.1)
        losses.append(float(loss))
        stacks.append(_replicas(state["params"], mesh))
    out = {"losses": losses, "stacks": stacks, "step": state["step"],
           "specs": specs}
    if k == 1:
        # the sync-DP reference of the same batch
        from paddle_tpu_torch.parallel.train import make_train_step

        ref_params = params_from_numpy(case["params"], "cpu")
        step = make_train_step(_dp_loss, mesh, pspecs, syncs, opt,
                               bspecs)(None)
        st = TrainState.create(ref_params, opt)
        ref = []
        for _ in range(steps):
            st, loss = step(st, batch, 0.1)
            ref.append(float(loss))
        out["sync_dp"] = {"losses": ref, "params": tree_map(
            lambda t: t.numpy(), st["params"])}
    return out


def local_sgd_k1(inp, world):
    return _local_sgd(inp, world, 1, 4)


def local_sgd_k3(inp, world):
    return _local_sgd(inp, world, 3, 6)


SCENARIOS = {f.__name__: f for f in (
    sharded_lookup, deepfm_sharded, deepfm_trainer, local_sgd_k1,
    local_sgd_k3)}


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    base.main(sys.argv[1:], SCENARIOS)
