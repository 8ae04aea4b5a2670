"""One rank of a gloo world on the CPU for the port's multi-rank tests.

``python tests/torch_dp_worker.py RANK WORLD STORE IN OUT SCENARIO...``
joins the world through a ``FileStore`` (``file://STORE``), reads the
inputs the test wrote (a pickle of numpy trees, ``IN``), runs each named
scenario of ``SCENARIOS`` in turn and writes ``OUT/<scenario>.r<rank>.pkl``.
It imports the port only: the tests hold these results to the JAX package
in their own process.  A scenario that fails fails the process (its exit
code is the test's to read).
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from paddle_tpu_torch._tree import tree_leaves, tree_map
from paddle_tpu_torch.parallel import collectives as col
from paddle_tpu_torch.parallel import optim
from paddle_tpu_torch.parallel.mesh import DP, MeshSpec, make_mesh


def _np(tree):
    return tree_map(lambda t: t.detach().float().numpy()
                    if t.dtype == torch.bfloat16 else t.detach().numpy(), tree)


def _bert(inp, mesh_spec, optimizer, steps, lr):
    from paddle_tpu_torch.models import bert

    trainer = bert.build_bert_trainer(bert.bert_tiny_config(), mesh_spec,
                                      optimizer=optimizer, device="cpu",
                                      params=inp["bert_params"])
    batch = {k: torch.from_numpy(v) for k, v in inp["bert_batch"].items()}
    losses = [float(trainer.step(batch, lr)) for _ in range(steps)]
    out = {"losses": losses, "params": _np(trainer.state["params"])}
    if mesh_spec.zero:
        params = trainer.state["params"]
        sharded = tree_map(lambda m, p: m.shape != p.shape,
                           trainer.state["opt"]["m"], params)
        with trainer.mesh:      # each rank's moment shards, gathered
            out["m"] = _np(tree_map(
                lambda m, p: col.all_gather(m, DP, 0) if m.shape != p.shape
                else m, trainer.state["opt"]["m"], params))
        out["sharded"] = tree_leaves(sharded)
    return out


def bert_dp2_adam(inp, world):
    return _bert(inp, MeshSpec(dp=world), optim.adam(), 3, 1e-3)


def bert_dp2_sgd(inp, world):
    return _bert(inp, MeshSpec(dp=world), optim.sgd(), 1, 0.1)


def bert_dp4_zero_lamb(inp, world):
    return _bert(inp, MeshSpec(dp=world, zero=True), optim.lamb(), 3, 1e-3)


def _resnet(inp, fuse_bn, world):
    from paddle_tpu_torch.models import resnet

    cfg = resnet.resnet_tiny_config(fuse_bn=fuse_bn, sync_bn=True,
                                    **inp["resnet_tiny"])
    trainer = resnet.build_resnet_trainer(
        cfg, MeshSpec(dp=world), optimizer=optim.momentum(0.9), device="cpu",
        params=inp["resnet_params"], bn_state=inp["resnet_bn"])
    losses = []
    for b in inp["resnet_batches"]:
        losses.append(float(trainer.step(
            {k: torch.from_numpy(v) for k, v in b.items()}, inp["resnet_lr"])))
    return {"losses": losses, "params": _np(trainer.state["params"]),
            "velocity": _np(trainer.state["opt"]["velocity"]),
            "bn": _np(trainer.bn_state)}


def resnet_dp2_sync_fused(inp, world):
    return _resnet(inp, True, world)


def resnet_dp2_sync_unfused(inp, world):
    return _resnet(inp, False, world)


def batch_norm_rule_sync(inp, world):
    """The batch_norm rule with ``_sync_axis`` on this rank's rows, forward
    and the gradients of a seeded cotangent."""
    from paddle_tpu_torch.registry import get_lowering
    import paddle_tpu_torch.ops  # noqa: F401  (registers the rules)

    rank = dist.get_rank()
    case = inp["bn_rule"]
    ins = {k: [torch.from_numpy(v[rank] if k == "X" else v)] for k, v in
           case["ins"].items()}
    for k in ("X", "Scale", "Bias"):
        ins[k][0].requires_grad_(True)
    with make_mesh(dp=world, device="cpu"):
        outs = get_lowering("batch_norm")(ins, case["attrs"], None)
        y = outs["Y"][0]
        grads = torch.autograd.grad(
            (y * torch.from_numpy(case["cot"][rank])).sum(),
            [ins[k][0] for k in ("X", "Scale", "Bias")])
    return {"outs": {k: v[0].detach().numpy() for k, v in outs.items()},
            "grads": [g.numpy() for g in grads]}


def dygraph_dp(inp, world):
    """DataParallel over a Linear layer: this rank's rows of the batch,
    scale_loss, backward, apply_collective_grads, one SGD step."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph as dy

    rank = dist.get_rank()
    os.environ["PADDLE_TRAINERS_NUM"] = str(world)
    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    case = inp["dygraph"]
    with dy.guard(fluid.CPUPlace()):
        nranks = dy.prepare_context().nranks
        net = dy.Linear(6, 3)
        net.set_dict(case["state"])
        model = dy.DataParallel(net)
        out = model(dy.to_variable(case["x"][rank]))
        loss = dy.nn._lowering_apply("mean", ("X",), {}, "Out", out * out)
        loss = model.scale_loss(loss)
        loss.backward()
        model.apply_collective_grads()
        grads = [p.gradient for p in model.parameters()]
        fluid.optimizer.SGD(case["lr"]).minimize(
            loss, parameter_list=model.parameters())
        params = [p.numpy() for p in model.parameters()]
    return {"nranks": nranks, "loss": float(loss.numpy()), "grads": grads,
            "params": params}


# (id, per-rank input shape, differentiable): every wrapper of
# parallel/collectives.py over the dp axis of the world
WRAPPER_CASES = [
    ("psum", (3, 4), True), ("pmean", (3, 4), True),
    ("pmax", (3, 4), False), ("pmin", (3, 4), False),
    ("all_gather_0", (2, 3), True), ("all_gather_1", (2, 3), True),
    ("reduce_scatter_0", (4, 3), True), ("reduce_scatter_1", (3, 4), True),
    ("ppermute_1", (2, 3), True), ("ppermute_m1", (2, 3), True),
    ("all_to_all_0_1", (4, 3), True), ("all_to_all_1_0", (3, 4), True),
    ("global_mean_loss", (3, 4), True),
]


def wrapper_fn(col_mod, case_id, axis="dp"):
    """The wrapper call of a case, on either package's collectives module."""
    return {
        "psum": lambda x: col_mod.psum(x, axis),
        "pmean": lambda x: col_mod.pmean(x, axis),
        "pmax": lambda x: col_mod.pmax(x, axis),
        "pmin": lambda x: col_mod.pmin(x, axis),
        "all_gather_0": lambda x: col_mod.all_gather(x, axis, 0),
        "all_gather_1": lambda x: col_mod.all_gather(x, axis, 1),
        "reduce_scatter_0": lambda x: col_mod.reduce_scatter(x, axis, 0),
        "reduce_scatter_1": lambda x: col_mod.reduce_scatter(x, axis, 1),
        "ppermute_1": lambda x: col_mod.ppermute_shift(x, axis, 1),
        "ppermute_m1": lambda x: col_mod.ppermute_shift(x, axis, -1),
        "all_to_all_0_1": lambda x: col_mod.all_to_all(x, axis, 0, 1),
        "all_to_all_1_0": lambda x: col_mod.all_to_all(x, axis, 1, 0),
        "global_mean_loss": lambda x: col_mod.global_mean_loss(
            (x * x).sum(), 40.0, axis),
    }[case_id]


def collectives(inp, world):
    """Each wrapper's forward on this rank's x and the gradient of
    sum(out * w) for a seeded cotangent w, with the x and w used."""
    import numpy as np

    rank = dist.get_rank()
    out = {"axis_index": None, "axis_size": None, "cases": {}}
    with make_mesh(dp=world, device="cpu"):
        out["axis_index"] = col.axis_index(DP)
        out["axis_size"] = col.axis_size_in(DP)
        for i, (cid, shape, diff) in enumerate(WRAPPER_CASES):
            rng = np.random.RandomState(1000 * world + i)
            x = torch.from_numpy(rng.randn(world, *shape).astype("f4")[rank])
            x.requires_grad_(diff)
            y = wrapper_fn(col, cid)(x)
            w = torch.from_numpy(np.array(np.random.RandomState(7 + i).randn(
                world, *y.shape).astype("f4")[rank]))
            g = (torch.autograd.grad((y * w).sum(), x)[0].numpy() if diff
                 else None)
            out["cases"][cid] = {"x": x.detach().numpy(), "w": w.numpy(),
                                 "y": y.detach().numpy(), "g": g}
    return out


def collective_rules(inp, world):
    """The 15 collective op rules with ring 0 on the dp axis: each row's
    outputs and the gradients of a seeded cotangent into its grad slots."""
    import numpy as np

    import paddle_tpu_torch.ops  # noqa: F401  (registers the rules)
    from paddle_tpu_torch.registry import OpLoweringContext, get_lowering
    from paddle_tpu_torch.tools.rule_cases import COLLECTIVE_CASES

    rank = dist.get_rank()
    res = {}
    ctx = OpLoweringContext(None, torch.Generator(), axis_env={0: DP})
    with make_mesh(dp=world, device="cpu"):
        for i, (cid, op, ins, attrs, gslots, gout) in enumerate(COLLECTIVE_CASES):
            t_ins = {k: [torch.from_numpy(a[rank]) for a in v]
                     for k, v in ins.items()}
            for k in gslots:
                t_ins[k][0].requires_grad_(True)
            outs = get_lowering(op)(t_ins, attrs, ctx)
            rec = {"outs": {k: [o.detach().numpy() for o in v]
                            for k, v in outs.items()}, "grads": {}}
            if gslots:
                y = outs[gout][0]
                cot = torch.from_numpy(np.array(np.random.RandomState(
                    50 + i).randn(world, *y.shape).astype("f4")[rank]))
                gs = torch.autograd.grad((y * cot).sum(),
                                         [t_ins[k][0] for k in gslots],
                                         allow_unused=True)
                rec["cot"] = cot.numpy()
                rec["grads"] = {k: (np.zeros_like(t_ins[k][0].detach().numpy())
                                    if g is None else g.numpy())
                                for k, g in zip(gslots, gs)}
            res[cid] = rec
    return res


SCENARIOS = {f.__name__: f for f in (
    collectives, collective_rules,
    bert_dp2_adam, bert_dp2_sgd, bert_dp4_zero_lamb, resnet_dp2_sync_fused,
    resnet_dp2_sync_unfused, batch_norm_rule_sync, dygraph_dp)}


# -- the tests' side: start a world, wait for it, read what it wrote ---------

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 240


def spawn_world(tmp, world, inputs, scenarios, script=__file__):
    """Start ``world`` ranks of ``script`` (this one, or another worker
    whose ``main`` is this one's) on ``scenarios``, a fresh interpreter
    each; returns (the output dir, the processes)."""
    inp = tmp / ("inputs%d.pkl" % world)
    with open(inp, "wb") as f:
        pickle.dump(inputs, f)
    out = tmp / ("out%d" % world)
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world),
         str(tmp / ("store%d" % world)), str(inp), str(out)] + list(scenarios),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    return out, procs


def join_world(out, procs, scenarios):
    """Wait for every rank (each must exit 0) and load its results:
    ``{scenario: [rank 0's, rank 1's, ...]}``."""
    logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    rcs = [p.returncode for p in procs]
    assert rcs == [0] * len(procs), "\n".join(logs)[-6000:]
    res = {}
    for name in scenarios:
        res[name] = []
        for r in range(len(procs)):
            with open(out / ("%s.r%d.pkl" % (name, r)), "rb") as f:
                res[name].append(pickle.load(f))
    return res


def main(argv, scenarios=SCENARIOS):
    rank, world, store, in_path, out_dir = argv[:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=world)
    with open(in_path, "rb") as f:
        inp = pickle.load(f)
    for name in argv[5:]:
        res = scenarios[name](inp, world)
        with open(os.path.join(out_dir, "%s.r%d.pkl" % (name, rank)), "wb") as f:
            pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
