"""One rank of a gloo world for the program-mode tensor-parallel tests
(ROADMAP item 5-C′): ``tests/test_torch_program_tp.py``.

``python tests/torch_program_tp_worker.py RANK WORLD STORE IN OUT
SCENARIO...``, as ``torch_dp_worker.py`` runs (its ``spawn_world`` and
``join_world`` start this script with ``script=__file__``).  Each rank is
fed the global batch and runs the Fluid program through the port's
``Executor(CPUPlace())`` with ``tensor_parallel_degree = 2`` (world 2: tp =
2; world 4: dp = 2 x tp = 2), from the parameters the test carried across
from the JAX startup.  The program builders take the package as ``fluid``,
so the test builds the same programs (and var names) on the JAX package.
"""

import os
import shutil
import sys
import tempfile

import numpy as np

import torch_dp_worker as base

TP = 2
TP_B, TP_STEPS = 16, 6
FLEET_B, FLEET_STEPS = 32, 15
KRED_STEPS = 2


# -- the programs, on either package -------------------------------------------

def tp_program(fluid, make_opt, tp_split=True, head_split=True):
    """``tests/test_tensor_parallel.py``'s model: embedding "col", fc
    (gelu) "col", fc "row", the logits fc "col" (with ``head_split``), the
    mean softmax cross entropy."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    mark = lambda kind: kind if tp_split else None
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        ids = L.data("ids", shape=[1], dtype="int64")
        lab = L.data("lab", shape=[1], dtype="int64")
        emb = L.embedding(ids, size=[64, 32], param_attr="tp_emb",
                          tp_split=mark("col"))
        h = L.fc(emb, 64, act="gelu", param_attr="tp_fc1",
                 tp_split=mark("col"))
        h = L.fc(h, 32, param_attr="tp_fc2", tp_split=mark("row"))
        logits = L.fc(h, 64, param_attr="tp_head",
                      tp_split=mark("col") if head_split else None)
        loss = L.mean(L.softmax_with_cross_entropy(logits, lab))
        make_opt(fluid).minimize(loss)
    return main, startup, {"loss": loss}


def tp_feeds(steps=TP_STEPS, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        ids = rng.randint(0, 64, (TP_B, 1)).astype("int64")
        out.append({"ids": ids, "lab": ((ids * 7 + 3) % 64).astype("int64")})
    return out


def fleet_program(fluid, fleet_mod):
    """``test_tp_via_fleet_strategy``'s model under a fleet
    ``DistributedStrategy`` with ``tensor_parallel_degree = 2``, SGD."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", shape=[16], dtype="float32")
        y = L.data("y", shape=[1], dtype="int64")
        h = L.fc(x, 32, act="relu", tp_split="col")
        logits = L.fc(h, 8, tp_split="row")
        loss = L.mean(L.softmax_with_cross_entropy(logits, y))
        strategy = fleet_mod.DistributedStrategy()
        strategy.tensor_parallel_degree = TP
        fleet_mod._Fleet().distributed_optimizer(
            fluid.optimizer.SGD(0.1), strategy).minimize(loss)
    return main, startup, {"loss": loss}


def fleet_feeds():
    rng = np.random.RandomState(1)
    W = rng.randn(16, 8).astype("f4")
    out = []
    for _ in range(FLEET_STEPS):
        xs = rng.randn(FLEET_B, 16).astype("f4")
        out.append({"x": xs,
                    "y": np.argmax(xs @ W, 1).reshape(-1, 1).astype("int64")})
    return out


def dryrun_program(fluid):
    """The reference dryrun's program: embedding and fc1 "col", fc2 "row",
    the head whole; Adam (its moments under kReduce)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        ids = L.data("ids", shape=[1], dtype="int64")
        lab = L.data("lab", shape=[1], dtype="int64")
        emb = L.embedding(ids, size=[64, 32], param_attr="pp_emb",
                          tp_split="col")
        h = L.fc(emb, 64, act="gelu", param_attr="pp_fc1", tp_split="col")
        h = L.fc(h, 32, param_attr="pp_fc2", tp_split="row")
        logits = L.fc(h, 64, param_attr="pp_head")
        loss = L.mean(L.softmax_with_cross_entropy(logits, lab))
        fluid.optimizer.Adam(1e-2).minimize(loss)
    return main, startup, {"loss": loss}


def dryrun_feeds(n):
    rng = np.random.RandomState(3)
    out = []
    for _ in range(KRED_STEPS):
        ids = rng.randint(0, 64, (2 * n, 1)).astype("int64")
        out.append({"ids": ids, "lab": ((ids * 7 + 3) % 64).astype("int64")})
    return out


def indivisible_program(fluid):
    """A "col" fc of 7 outputs: 7 does not divide over tp = 2, so its
    weight and bias stay whole."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", shape=[6], dtype="float32")
        h = L.fc(x, 7, act="tanh", tp_split="col",
                 param_attr=fluid.ParamAttr(name="odd_w"),
                 bias_attr=fluid.ParamAttr(name="odd_b"))
        loss = L.mean(L.square(h))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, {"loss": loss}


def indivisible_feed():
    return {"x": np.random.RandomState(8).randn(8, 6).astype("f4")}


def row_table_program(fluid):
    """A "row" embedding (64 x 16, ``padding_idx`` 0) into a "col" fc and a
    "row" fc, SGD: the lookup is a masked gather of the rows a rank owns,
    a partial sum over the model group."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 13
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        ids = L.data("ids", shape=[3], dtype="int64")
        lab = L.data("lab", shape=[1], dtype="int64")
        emb = L.embedding(ids, size=[64, 16], padding_idx=0,
                          param_attr="row_emb", tp_split="row")
        h = L.fc(emb, 32, num_flatten_dims=1, act="tanh",
                 param_attr="row_fc1", tp_split="col")
        h = L.fc(h, 8, param_attr="row_fc2", tp_split="row")
        loss = L.mean(L.softmax_with_cross_entropy(h, lab))
        fluid.optimizer.SGD(0.5).minimize(loss)
    return main, startup, {"loss": loss}


def row_table_feeds(steps=2):
    """Ids with repeats and padding rows, across both ranks' row blocks."""
    rng = np.random.RandomState(9)
    return [{"ids": rng.randint(0, 64, (16, 3)).astype("int64"),
             "lab": rng.randint(0, 8, (16, 1)).astype("int64")}
            for _ in range(steps)]


def encoder_cfg(optimizer="sgd"):
    from paddle_tpu_torch.tools.programs import EncoderConfig

    return EncoderConfig(vocab=64, hidden=64, layers=2, heads=4, ffn=128,
                         seq=8, batch=8, dropout=0.0, lr=0.05,
                         optimizer=optimizer)


def params_of(main):
    return sorted(p.name for p in main.global_block().all_parameters())


def grad_names(main):
    return [p + "@GRAD" for p in params_of(main)]


# -- the port's side ------------------------------------------------------------

def _scope(inp, key):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert

    return convert.scope_from_numpy(inp[key], fluid.Scope(), "cpu")


def _state(scope, names):
    """Each var whole (a collective for a split one: every rank calls)."""
    return {n: scope.find_tensor_as_numpy(n) for n in names}


def _compiled(fluid, main, v, tp=TP, reduce=False):
    bs = fluid.BuildStrategy()
    bs.tensor_parallel_degree = tp
    if reduce:
        bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
    return fluid.CompiledProgram(main).with_data_parallel(
        loss_name=v["loss"].name, build_strategy=bs)


def _train(program, scope, feeds, fetch):
    import paddle_tpu_torch as fluid

    exe = fluid.Executor(fluid.CPUPlace())
    return [exe.run(program, feed=f, fetch_list=fetch, scope=scope)
            for f in feeds]


def _local_shapes(scope, main):
    return {n: scope.local_shape(n) for n in params_of(main)}


def tp_adam(inp, world):
    """Six Adam steps of the marked model; then the scope saved and loaded
    back at one rank."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel import model_axes

    main, _, v = tp_program(fluid, lambda f: f.optimizer.Adam(1e-2))
    scope = _scope(inp, "tp_adam")
    model_axes.reset_counts()
    out = _train(_compiled(fluid, main, v), scope, tp_feeds(), [v["loss"]])
    counts = model_axes.counts()
    names = sorted(x.name for x in main.list_vars() if x.persistable)
    whole = _state(scope, names)
    # every rank saves (a collective gathers each split var): the files hold
    # the whole values, which a one-rank load reads back
    save_dir = tempfile.mkdtemp(prefix="tp_save")
    with fluid.scope_guard(scope):
        fluid.io.save_persistables(fluid.Executor(fluid.CPUPlace()), save_dir,
                                   main)
    loaded = fluid.Scope()
    with fluid.scope_guard(loaded):
        fluid.io.load_persistables(fluid.Executor(fluid.CPUPlace()), save_dir,
                                   main)
    shutil.rmtree(save_dir)
    return {"losses": [float(o[0]) for o in out], "counts": counts,
            "local": _local_shapes(scope, main),
            "split": {n: scope.split(n) for n in names},
            "params": {n: whole[n] for n in params_of(main)},
            "whole": whole,
            "loaded": {n: loaded.find_tensor_as_numpy(n) for n in names}}


def tp_sgd_one_step(inp, world):
    """One SGD step: the gathered gradients and parameters, and the same
    step at one rank of the port (the plain program on the same feed), for
    the update ratio."""
    import paddle_tpu_torch as fluid

    main, _, v = tp_program(fluid, lambda f: f.optimizer.SGD(0.5))
    grads = grad_names(main)
    scope = _scope(inp, "tp_sgd")
    out = _train(_compiled(fluid, main, v), scope, tp_feeds(1),
                 [v["loss"]] + grads)
    plain = _scope(inp, "tp_sgd")
    ref = _train(main, plain, tp_feeds(1), [v["loss"]] + grads)
    return {"loss": float(out[0][0]), "grads": dict(zip(grads, out[0][1:])),
            "params": _state(scope, params_of(main)),
            "one_rank": {"loss": float(ref[0][0]),
                         "grads": dict(zip(grads, ref[0][1:])),
                         "params": _state(plain, params_of(main))}}


def pp_mesh_sgd(inp, world):
    """One SGD step over an explicit mesh with a pp axis (world 4): dp = 2 x
    pp = 2 with no tensor parallelism, and pp = 2 x tp = 2.  Program mode
    runs every pp coordinate as a replica, so a whole gradient sums over
    the data and model groups alone: the gradients are the one-rank ones."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for key, dp, tp in (("dp2_pp2", 2, 1), ("pp2_tp2", 1, 2)):
        main, _, v = tp_program(fluid, lambda f: f.optimizer.SGD(0.5),
                                tp_split=tp > 1)
        grads = grad_names(main)
        bs = fluid.BuildStrategy()
        bs.tensor_parallel_degree = tp
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=v["loss"].name, build_strategy=bs,
            mesh=make_mesh(dp=dp, pp=2, tp=tp, device="cpu"))
        got = _train(prog, _scope(inp, "tp_sgd"), tp_feeds(1),
                     [v["loss"]] + grads)[0]
        ref = _train(main, _scope(inp, "tp_sgd"), tp_feeds(1),
                     [v["loss"]] + grads)[0]
        out[key] = {"loss": float(got[0]), "grads": dict(zip(grads, got[1:])),
                    "one_rank": {"loss": float(ref[0]),
                                 "grads": dict(zip(grads, ref[1:]))}}
    return out


def tp_lamb(inp, world):
    """LAMB on the marked model: its trust ratio from the norms summed over
    the model group."""
    import paddle_tpu_torch as fluid

    main, _, v = tp_program(fluid, lambda f: f.optimizer.Lamb(0.01))
    scope = _scope(inp, "tp_lamb")
    out = _train(_compiled(fluid, main, v), scope, tp_feeds(3), [v["loss"]])
    return {"losses": [float(o[0]) for o in out],
            "params": _state(scope, params_of(main))}


def fleet_tp(inp, world):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.distributed import fleet

    main, _, v = fleet_program(fluid, fleet)
    scope = _scope(inp, "fleet_tp")
    out = _train(main, scope, fleet_feeds(), [v["loss"]])
    return {"losses": [float(o[0]) for o in out],
            "local": _local_shapes(scope, main),
            "params": _state(scope, params_of(main))}


def encoder_tp(inp, world):
    """The tiny marked encoder (dropout 0, SGD): losses, parameters and the
    fallback's gathers (of an activation: none)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel import model_axes
    from paddle_tpu_torch.tools.programs import (bert_encoder_program,
                                                 encoder_feed)

    cfg = encoder_cfg()
    main, _, v = bert_encoder_program(fluid, cfg, tp_split=True)
    scope = _scope(inp, "encoder")
    model_axes.reset_counts()
    out = _train(_compiled(fluid, main, v), scope,
                 [encoder_feed(cfg, s) for s in range(2)], [v["loss"]])
    return {"losses": [float(o[0]) for o in out],
            "counts": model_axes.counts(),
            "local": _local_shapes(scope, main),
            "params": _state(scope, params_of(main))}


def kreduce_tp(inp, world):
    """The reference dryrun's program at dp x tp with kReduce: the split
    weights' blocks, the whole head's moments as 1/dp of their rows."""
    import paddle_tpu_torch as fluid

    main, _, v = dryrun_program(fluid)
    scope = _scope(inp, "kreduce")
    out = _train(_compiled(fluid, main, v, reduce=True), scope,
                 dryrun_feeds(8), [v["loss"]])
    names = ["pp_fc1", "pp_head", "pp_fc1_moment1_0", "pp_head_moment1_0"]
    return {"losses": [float(o[0]) for o in out],
            "local": {n: scope.local_shape(n) for n in names},
            "row_shards": {n: scope.row_shards(n) for n in names},
            "split": {n: scope.split(n) for n in names},
            "params": _state(scope, params_of(main))}


def indivisible(inp, world):
    """A "col" weight whose dim does not divide stays whole, and the run is
    the one-rank run's."""
    import paddle_tpu_torch as fluid

    main, _, v = indivisible_program(fluid)
    scope = _scope(inp, "odd")
    out = _train(_compiled(fluid, main, v), scope, [indivisible_feed()] * 2,
                 [v["loss"]])
    plain = _scope(inp, "odd")
    ref = _train(main, plain, [indivisible_feed()] * 2, [v["loss"]])
    return {"losses": [float(o[0]) for o in out],
            "one_rank": [float(o[0]) for o in ref],
            "local": _local_shapes(scope, main),
            "split": {n: scope.split(n) for n in params_of(main)},
            "params": _state(scope, params_of(main)),
            "one_rank_params": _state(plain, params_of(main))}


def row_table(inp, world):
    """The "row" embedding at tp = 2 against the plain program at one rank
    from the same parameters and feeds."""
    import paddle_tpu_torch as fluid

    main, _, v = row_table_program(fluid)
    grads = ["row_emb@GRAD"]
    scope = _scope(inp, "row_table")
    out = _train(_compiled(fluid, main, v), scope, row_table_feeds(),
                 [v["loss"]] + grads)
    plain = _scope(inp, "row_table")
    ref = _train(main, plain, row_table_feeds(), [v["loss"]] + grads)
    return {"losses": [float(o[0]) for o in out],
            "grads": [o[1] for o in out],
            "one_rank": [float(o[0]) for o in ref],
            "one_rank_grads": [o[1] for o in ref],
            "local": _local_shapes(scope, main),
            "split": {n: scope.split(n) for n in params_of(main)},
            "params": _state(scope, params_of(main)),
            "one_rank_params": _state(plain, params_of(main))}


SCENARIOS = {f.__name__: f for f in (
    tp_adam, tp_sgd_one_step, pp_mesh_sgd, tp_lamb, fleet_tp, encoder_tp,
    kreduce_tp, indivisible, row_table)}


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    base.main(sys.argv[1:], SCENARIOS)
