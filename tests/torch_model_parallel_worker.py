"""One rank of a gloo world on the CPU for the model-parallel tests.

``python tests/torch_model_parallel_worker.py RANK WORLD STORE IN OUT
SCENARIO...`` as ``tests/torch_dp_worker.py`` (whose ``main`` it runs): the
port's tensor, sequence, ring and pipeline parallelism and its
expert-parallel MoE, each scenario's results as numpy for the test to hold
to the JAX package in its own process.
"""

import sys

import torch
import torch.distributed as dist

import torch_dp_worker as W
from paddle_tpu_torch._tree import tree_leaves, tree_map
from paddle_tpu_torch.parallel import collectives as col
from paddle_tpu_torch.parallel import optim
from paddle_tpu_torch.parallel.mesh import (DP, PP, TP, WORLD, MeshSpec,
                                            axis_groups, make_mesh)

LR = 1e-3

# key: (dp, pp, tp, attn_mode, microbatches, zero)
MESHES = {
    "tp2_heads": (1, 1, 2, "heads", 1, False),
    "tp2_ring": (1, 1, 2, "ring", 1, False),
    "pp2": (1, 2, 1, "heads", 2, False),
    "tp4_ring": (1, 1, 4, "ring", 1, False),
    "pp2_tp2": (1, 2, 2, "heads", 2, False),
    "dp2_tp2": (2, 1, 2, "heads", 1, False),
    "dp2_tp2_zero": (2, 1, 2, "heads", 1, True),
}


def _np(tree):
    return tree_map(lambda t: t.detach().float().numpy(), tree)


def _replicas_differ(tree, specs, mesh):
    """Leaves whose bits differ across an axis they are replicated over."""
    from paddle_tpu_torch.parallel.train import _spec_axes

    bad = 0
    for t, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        split = {a for _, a in _spec_axes(spec)}
        for a in (DP, PP, TP):
            group = mesh.groups.get(a)
            if a in split or group is None:
                continue
            both = col.backend_all_gather(t.detach().reshape(1, -1), group, 0)
            bad += not all(torch.equal(both[0], b) for b in both[1:])
    return bad


def _bert(inp, key):
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel.train import (gather_pytree, grads_of,
                                                 shard_batch, sync_grads)
    from paddle_tpu_torch.parallel.transformer import (
        grad_sync_axes, transformer_param_specs)

    dp, pp, tp, mode, mb, zero = MESHES[key]
    cfg = bert.bert_tiny_config(tp=tp, pp=pp, attn_mode=mode)
    spec = MeshSpec(dp=dp, pp=pp, tp=tp, zero=zero)
    params = inp["bert_params"]["pp%d" % pp]
    batch = {k: torch.from_numpy(v) for k, v in inp["bert_batch"].items()}
    pspecs = transformer_param_specs(cfg)
    out = {}
    for name, opt in (("adam", optim.adam()), ("lamb", optim.lamb())):
        tr = bert.build_bert_trainer(cfg, spec, optimizer=opt,
                                     n_microbatches=mb, device="cpu",
                                     params=params)
        if name == "adam":
            local = shard_batch(tr.mesh, bert.batch_specs(), batch)
            with tr.mesh:
                loss, grads = grads_of(bert.make_loss_fn(cfg, mb),
                                       tr.state["params"], local)
                grads = sync_grads(grads, grad_sync_axes(cfg))
            out["loss"] = float(loss)
            out["grads"] = _np(gather_pytree(grads, pspecs, tr.mesh))
        out["step_loss_" + name] = float(tr.step(batch, LR))
        out["params_" + name] = _np(gather_pytree(tr.state["params"], pspecs,
                                                  tr.mesh))
        out["replicas_differ_" + name] = _replicas_differ(
            tr.state["params"], pspecs, tr.mesh)
        if zero:
            out["m_" + name] = _np(gather_pytree(
                tr.state["opt"]["m"], tr.specs["opt"]["m"], tr.mesh))
            out["sharded_" + name] = [
                m.shape != p.shape for m, p in zip(
                    tree_leaves(tr.state["opt"]["m"]),
                    tree_leaves(tr.state["params"]))]
    if not zero:
        # ``run_steps`` over staged batches (this rank's dp rows) against
        # ``step`` over the global ones, twice each, from the same state
        from paddle_tpu_torch.parallel.train import stack_batches

        runs = []
        for multi in (True, False):
            tr = bert.build_bert_trainer(cfg, spec, optimizer=optim.adam(),
                                         n_microbatches=mb, device="cpu",
                                         params=params)
            if multi:
                staged = stack_batches(tr.mesh, bert.batch_specs(),
                                       [inp["bert_batch"]] * 2,
                                       dtypes=bert.batch_dtypes())
                losses = tr.run_steps(staged, LR).tolist()
            else:
                losses = [float(tr.step(batch, LR)) for _ in range(2)]
            runs.append((losses, [t.clone() for t in
                                  tree_leaves(tr.state["params"])]))
        out["multi_bit_for_bit"] = runs[0][0] == runs[1][0] and all(
            torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    return out


def _bert_scenario(key):
    def run(inp, world):
        return _bert(inp, key)

    run.__name__ = "bert_" + key
    return run


class _CountP2P:
    """Counts ``dist.batch_isend_irecv`` calls inside the block."""

    def __enter__(self):
        self.calls, self._orig = 0, dist.batch_isend_irecv

        def counted(ops):
            self.calls += 1
            return self._orig(ops)

        dist.batch_isend_irecv = counted
        return self

    def __exit__(self, *exc):
        dist.batch_isend_irecv = self._orig
        return False


def ring_attention(inp, world):
    """``ring_attention`` over tp = world on this rank's sequence chunk,
    causal and not, with the key mask: the output and the gradients of a
    seeded cotangent, with the shift's route and its point-to-point calls."""
    from paddle_tpu_torch.parallel.ring_attention import ring_attention as ra

    rank, case = dist.get_rank(), inp["ring"][world]
    S = case["q"].shape[1]
    sl = slice(rank * S // world, (rank + 1) * S // world)
    out = {}
    with make_mesh(tp=world, device="cpu") as mesh, _CountP2P() as p2p:
        for causal in (False, True):
            q, k, v = (torch.from_numpy(case[n][:, sl]).requires_grad_(True)
                       for n in ("q", "k", "v"))
            mask = torch.from_numpy(case["mask"][:, sl])
            o = ra(q, k, v, axis=TP, causal=causal, kv_mask=mask)
            g = torch.autograd.grad(
                (o * torch.from_numpy(case["cot"][:, sl])).sum(), (q, k, v))
            out[causal] = {"o": o.detach().numpy(),
                           "grads": [t.numpy() for t in g]}
        out["route"] = col.permute_route(q, mesh.groups[TP])
    out["p2p_calls"] = p2p.calls
    return out


def gpipe(inp, world):
    """``gpipe`` over pp = world: stage s is tanh(x @ w[s] + b[s]); the
    last stage's outputs and the gradients of a seeded cotangent of them
    (every rank's own stage parameters and rank 0's microbatch inputs)."""
    from paddle_tpu_torch.parallel.pipeline import gpipe as gp

    rank, case = dist.get_rank(), inp["gpipe"]
    w = torch.from_numpy(case["w"][rank]).requires_grad_(True)
    b = torch.from_numpy(case["b"][rank]).requires_grad_(True)
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    with make_mesh(pp=world, device="cpu"):
        ys = gp(lambda p, h: torch.tanh(h @ p[0] + p[1]), (w, b), x)
        last = float(col.axis_index(PP) == world - 1)
        loss = col.psum((ys * torch.from_numpy(case["cot"])).sum() * last, PP)
        gw, gb, gx = torch.autograd.grad(loss, (w, b, x))
    return {"ys": ys.detach().numpy(), "gw": gw.numpy(), "gb": gb.numpy(),
            "gx": gx.numpy()}


def moe(inp, world):
    """``moe_ffn`` with its experts over dp = world: this rank's tokens'
    outputs and the gradients of a seeded cotangent (tokens, the router,
    this rank's experts)."""
    from paddle_tpu_torch.parallel.moe import moe_ffn

    rank, case = dist.get_rank(), inp["moe"][world]
    n_local = case["w1"].shape[0] // world
    ex = slice(rank * n_local, (rank + 1) * n_local)
    x = torch.from_numpy(case["x"][rank]).requires_grad_(True)
    params = {"router": torch.from_numpy(case["router"]).requires_grad_(True),
              "w1": torch.from_numpy(case["w1"][ex]).requires_grad_(True),
              "w2": torch.from_numpy(case["w2"][ex]).requires_grad_(True)}
    with make_mesh(dp=world, device="cpu"):
        y = moe_ffn(params, x, capacity_factor=case["cf"])
        cot = torch.from_numpy(case["cot"][rank])
        g = torch.autograd.grad((y * cot).sum(), [x, params["router"],
                                                  params["w1"], params["w2"]])
    return {"y": y.detach().numpy(), "grads": [t.numpy() for t in g]}


def mesh_layout(inp, world):
    """At world 4, meshes (2, 1, 2) and (1, 2, 2): this rank's coordinates,
    the ranks of each axis group, and a psum of the world rank over each
    axis."""
    out = {}
    for dp, pp, tp in ((2, 1, 2), (1, 2, 2)):
        mesh = make_mesh(dp=dp, pp=pp, tp=tp, device="cpu")
        rec = {"coords": dict(mesh.coords),
               "groups": {a: dist.get_process_group_ranks(g)
                          for a, g in mesh.groups.items()},
               "axis_groups": {a: axis_groups(mesh.shape, a)
                               for a in (DP, PP, TP)}}
        with mesh:
            r = torch.tensor([float(dist.get_rank())])
            rec["psum"] = {a: float(col.psum(r, a)) for a in (DP, PP, TP)}
        rec["world_key"] = WORLD in mesh.groups
        out[(dp, pp, tp)] = rec
    return out


def _resnet(inp, axis):
    from paddle_tpu_torch.models import resnet

    cfg = resnet.resnet_tiny_config(sync_bn=True, **inp["resnet_tiny"])
    spec = MeshSpec(**{axis: dist.get_world_size()})
    tr = resnet.build_resnet_trainer(
        cfg, spec, optimizer=optim.momentum(0.9), device="cpu",
        params=inp["resnet_params"], bn_state=inp["resnet_bn"])
    losses = [float(tr.step({k: torch.from_numpy(v) for k, v in b.items()},
                            inp["resnet_lr"])) for b in inp["resnet_batches"]]
    return {"losses": losses, "params": _np(tr.state["params"]),
            "bn": _np(tr.bn_state)}


def resnet_tp(inp, world):
    return _resnet(inp, "tp")


def resnet_pp(inp, world):
    return _resnet(inp, "pp")


def pipeline_program(fluid, pipelined=True, amp=False, bn=False,
                     reduce="mean", microbatches=4):
    """``tests/test_pipeline_optimizer.py``'s model: three fc layers (w1,
    w2, w3), optionally a batch norm after the first, a mean (or summed)
    squared error, SGD(0.1), cut after each hidden layer."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", shape=[16], dtype="float32")
        y = L.data("y", shape=[1], dtype="float32")
        h1 = L.fc(x, 32, act="relu", param_attr=fluid.ParamAttr(name="w1"))
        if bn:
            h1 = L.batch_norm(h1)
        h2 = L.fc(h1, 32, act="relu", param_attr=fluid.ParamAttr(name="w2"))
        pred = L.fc(h2, 1, param_attr=fluid.ParamAttr(name="w3"))
        cost = L.square_error_cost(pred, y)
        loss = L.mean(cost) if reduce == "mean" else L.reduce_sum(cost)
        opt = fluid.optimizer.SGD(0.1)
        if pipelined:
            opt = fluid.optimizer.PipelineOptimizer(
                opt, cut_list=[[h1], [h2]], num_microbatches=microbatches)
        if amp:
            from importlib import import_module

            opt = import_module(fluid.__name__ + ".amp").decorate(opt)
        opt.minimize(loss)
    return main, startup, {"loss": loss, "h1": h1, "h2": h2}


def pipeline_feed(n=32, seed=11):
    """``tests/test_pipeline_optimizer.py``'s ``_data``."""
    import numpy as np

    rng = np.random.RandomState(seed)
    xv = rng.rand(n, 16).astype("f4")
    return {"x": xv, "y": (xv @ rng.rand(16, 1).astype("f4")).astype("f4")}


def pipeline_dp(inp, world):
    """The pipelined program (with a batch norm) run data-parallel over the
    world, each rank fed the global batch: the losses, the parameters and
    the running statistics."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert

    main, _, v = pipeline_program(fluid, bn=True)
    scope = convert.scope_from_numpy(inp["pipeline"], fluid.Scope(), "cpu")
    prog = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=v["loss"].name)
    exe = fluid.Executor(fluid.CPUPlace())
    losses = [float(exe.run(prog, feed=pipeline_feed(), fetch_list=[v["loss"]],
                            scope=scope)[0]) for _ in range(3)]
    return {"losses": losses,
            "state": convert.scope_to_numpy(scope, sorted(inp["pipeline"]))}


SCENARIOS = {f.__name__: f for f in (
    [_bert_scenario(k) for k in MESHES]
    + [ring_attention, gpipe, moe, mesh_layout, resnet_tp, resnet_pp,
       pipeline_dp])}

if __name__ == "__main__":
    W.main(sys.argv[1:], scenarios=SCENARIOS)
