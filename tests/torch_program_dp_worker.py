"""One rank of a gloo world for the program-mode data-parallel tests
(ROADMAP item 5-B): ``tests/test_torch_program_dp.py``.

``python tests/torch_program_dp_worker.py RANK WORLD STORE IN OUT
SCENARIO...``, as ``torch_dp_worker.py`` runs (its ``spawn_world`` and
``join_world`` start this script with ``script=__file__``).  Each rank is
fed the global batch and runs the Fluid program through the port's
``Executor(CPUPlace())``, from the parameters the test carried across from
the JAX startup.  The program builders take the package as ``fluid``, so the
test builds the same programs (and the same var names) on the JAX package.
"""

import os
import shutil
import sys
import tempfile

import numpy as np
import torch.distributed as dist

import torch_dp_worker as base

LR_B, LR_STEPS = 32, 5
CONV_B, CONV_STEPS = 16, 3
SPARSE_B, SPARSE_STEPS, SPARSE_V = 16, 3, 50
KREDUCE_STEPS = 4
DROP_B, DROP_STEPS = 16, 2
GEO_B, GEO_STEPS, GEO_K = 16, 6, 3


# -- the programs, on either package -------------------------------------------

def lr_program(fluid, make_opt):
    """``tests/test_distributed.py``'s linear model: fc(8 -> 1) named w, b
    and the mean squared error."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[8], dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(x, size=1, param_attr=fluid.ParamAttr(name="w"),
                               bias_attr=fluid.ParamAttr(name="b"))
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        make_opt(fluid).minimize(loss)
    return main, startup, {"loss": loss, "pred": pred}


def lr_feed(n=LR_B):
    """``tests/test_distributed.py``'s ``_data``."""
    rng = np.random.RandomState(7)
    xv = rng.rand(n, 8).astype("f4")
    return {"x": xv, "y": (xv @ rng.rand(8, 1).astype("f4")).astype("f4")}


def conv_bn_program(fluid):
    """conv -> batch_norm(relu) -> fc(softmax), cross entropy, accuracy;
    Momentum."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        img = L.data("img", shape=[2, 8, 8], dtype="float32")
        label = L.data("label", shape=[1], dtype="int64")
        h = L.batch_norm(L.conv2d(img, num_filters=4, filter_size=3,
                                  padding=1), act="relu")
        pred = L.fc(h, size=4, act="softmax")
        loss = L.mean(L.cross_entropy(pred, label))
        acc = L.accuracy(pred, label)
        fluid.optimizer.Momentum(0.1, momentum=0.9).minimize(loss)
    return main, startup, {"loss": loss, "acc": acc, "pred": pred}


def conv_feed(step):
    rng = np.random.RandomState(20 + step)
    return {"img": rng.randn(CONV_B, 2, 8, 8).astype("f4"),
            "label": rng.randint(0, 4, (CONV_B, 1)).astype("int64")}


def bn_stats(main):
    """The batch norm's running mean and variance."""
    return sorted(v.name for v in main.list_vars() if v.persistable
                  and v.name.startswith("batch_norm")
                  and v.name.split(".")[-1].split("_")[0] in ("mean", "var"))


def sparse_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        ids = L.data("ids", shape=[1], dtype="int64")
        label = L.data("label", shape=[1], dtype="int64")
        emb = L.embedding(ids, size=[SPARSE_V, 8], is_sparse=True,
                          param_attr=fluid.ParamAttr(name="emb"))
        pred = L.fc(emb, size=3, act="softmax")
        loss = L.mean(L.cross_entropy(pred, label))
        fluid.optimizer.SGD(0.5).minimize(loss)
    return main, startup, {"loss": loss}


def sparse_feed(step):
    rng = np.random.RandomState(40 + step)
    return {"ids": rng.randint(0, SPARSE_V, (SPARSE_B, 1)).astype("int64"),
            "label": rng.randint(0, 3, (SPARSE_B, 1)).astype("int64")}


def dropout_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", shape=[8], dtype="float32")
        h = L.dropout(L.fc(x, 16), dropout_prob=0.5,
                      dropout_implementation="upscale_in_train")
        loss = L.mean(L.fc(h, 1))
        fluid.optimizer.SGD(0.1).minimize(loss)
    mask = next(op.outputs["Mask"][0] for op in main.global_block().ops
                if op.type == "dropout")
    return main, startup, {"loss": loss, "h": h, "mask": mask}


def drop_feed(step):
    return {"x": np.random.RandomState(60 + step).randn(DROP_B, 8).astype("f4")}


def encoder_cfg():
    from paddle_tpu_torch.tools.programs import EncoderConfig

    return EncoderConfig(vocab=64, hidden=16, layers=1, heads=2, ffn=32,
                         seq=8, batch=8, dropout=0.0, lr=0.05, optimizer="sgd")


# -- the port's side ------------------------------------------------------------

def _scope(inp, key):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert

    return convert.scope_from_numpy(inp[key], fluid.Scope(), "cpu")


def _state(scope, names):
    return {n: scope.find_tensor_as_numpy(n) for n in names}


def _params(main):
    return sorted(p.name for p in main.global_block().all_parameters())


def _sgd(fluid):
    return fluid.optimizer.SGD(0.1)


def _fleet_sgd(fluid):
    from paddle_tpu_torch.distributed import fleet

    return fleet._Fleet().distributed_optimizer(fluid.optimizer.SGD(0.1))


def _train(main, scope, feeds, fetch, program=None):
    import paddle_tpu_torch as fluid

    exe = fluid.Executor(fluid.CPUPlace())
    return [exe.run(program or main, feed=f, fetch_list=fetch, scope=scope)
            for f in feeds]


def fleet_lr(inp, world):
    import paddle_tpu_torch as fluid

    main, _, v = lr_program(fluid, _fleet_sgd)
    scope = _scope(inp, "lr_sgd")
    out = _train(main, scope, [lr_feed()] * LR_STEPS, [v["loss"], v["pred"]])
    return {"losses": [float(o[0]) for o in out], "pred": out[-1][1],
            "params": _state(scope, ["w", "b"])}


def _transpiled(inp, world, mode):
    import paddle_tpu_torch as fluid

    main, _, v = lr_program(fluid, _sgd)
    config = fluid.transpiler.DistributeTranspilerConfig()
    config.mode = mode
    t = fluid.transpiler.DistributeTranspiler(config)
    eps = ",".join("127.0.0.1:%d" % (6170 + r) for r in range(world))
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # pserver mode's note
        t.transpile(dist.get_rank(), program=main, pservers=eps,
                    trainers=world)
    scope = _scope(inp, "lr_sgd")
    out = _train(t.get_trainer_program(), scope, [lr_feed()] * LR_STEPS,
                 [v["loss"]])
    return {"losses": [float(o[0]) for o in out],
            "params": _state(scope, ["w", "b"]),
            "mode": main._dist_info["mode"]}


def transpiler_collective(inp, world):
    return _transpiled(inp, world, "collective")


def transpiler_pserver(inp, world):
    return _transpiled(inp, world, "pserver")


def _conv(inp, world, sync):
    import paddle_tpu_torch as fluid

    main, _, v = conv_bn_program(fluid)
    bs = fluid.BuildStrategy()
    bs.sync_batch_norm = sync
    compiled = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=v["loss"].name, build_strategy=bs)
    scope = _scope(inp, "conv")
    out = _train(main, scope, [conv_feed(s) for s in range(CONV_STEPS)],
                 [v["loss"], v["acc"], v["pred"]], program=compiled)
    return {"losses": [float(o[0]) for o in out],
            "accs": [float(o[1]) for o in out],
            "pred": [o[2] for o in out],
            "bn": _state(scope, bn_stats(main)),
            "params": _state(scope, _params(main))}


def conv_bn(inp, world):
    return _conv(inp, world, False)


def conv_sync_bn(inp, world):
    return _conv(inp, world, True)


def _momentum(fluid):
    return fluid.optimizer.Momentum(0.1, momentum=0.9)


def velocity_name(main):
    return next(v.name for v in main.list_vars()
                if getattr(v, "_is_optimizer_accumulator", False)
                and v.name.startswith("w"))


def _lr_momentum(inp, reduce):
    import paddle_tpu_torch as fluid

    main, _, v = lr_program(fluid, _momentum)
    vel = velocity_name(main)
    bs = fluid.BuildStrategy()
    if reduce:
        bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
    compiled = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=v["loss"].name, build_strategy=bs)
    scope = _scope(inp, "lr_momentum")
    out = _train(main, scope, [lr_feed()] * KREDUCE_STEPS, [v["loss"], vel],
                 program=compiled)
    held = scope.find_var(vel)
    # every rank saves (a collective gathers the rows): the file holds the
    # global velocity
    save_dir = tempfile.mkdtemp(prefix="kreduce_save")
    with fluid.scope_guard(scope):
        fluid.io.save_persistables(fluid.Executor(fluid.CPUPlace()), save_dir,
                                   main)
    saved = np.load(os.path.join(save_dir, vel + ".npy"))
    shutil.rmtree(save_dir)
    return {"losses": [float(o[0]) for o in out], "velocity": out[-1][1],
            "saved_velocity": saved,
            "held_shape": tuple(held.shape),
            "held_bytes": held.numel() * held.element_size(),
            "row_shards": scope.row_shards(vel),
            "params": _state(scope, ["w", "b"])}


def kreduce(inp, world):
    return {"reduce": _lr_momentum(inp, True),
            "allreduce": _lr_momentum(inp, False)}


def kreduce_lamb(inp, world):
    """LAMB under kReduce: its moments held as 1/n of their rows a rank,
    its trust ratio from the norms summed over the ranks."""
    import paddle_tpu_torch as fluid

    main, _, v = lr_program(fluid, lambda f: f.optimizer.Lamb(0.01))
    moments = sorted(x.name for x in main.list_vars()
                     if getattr(x, "_is_optimizer_accumulator", False)
                     and "moment" in x.name and x.name.startswith("w"))
    bs = fluid.BuildStrategy()
    bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
    compiled = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=v["loss"].name, build_strategy=bs)
    scope = _scope(inp, "lr_lamb")
    out = _train(main, scope, [lr_feed()] * KREDUCE_STEPS,
                 [v["loss"]] + moments, program=compiled)
    return {"losses": [float(o[0]) for o in out],
            "moments": dict(zip(moments, out[-1][1:])),
            "held_shapes": {n: tuple(scope.find_var(n).shape)
                            for n in moments},
            "params": _state(scope, ["w", "b"])}


def sparse_embedding(inp, world):
    import paddle_tpu_torch as fluid

    main, _, v = sparse_program(fluid)
    compiled = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=v["loss"].name)
    scope = _scope(inp, "sparse")
    out = _train(main, scope, [sparse_feed(s) for s in range(SPARSE_STEPS)],
                 [v["loss"]], program=compiled)
    return {"losses": [float(o[0]) for o in out],
            "params": _state(scope, _params(main))}


def encoder(inp, world):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.programs import (bert_encoder_program,
                                                 encoder_feed)

    cfg = encoder_cfg()
    main, _, v = bert_encoder_program(fluid, cfg)
    compiled = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=v["loss"].name)
    scope = _scope(inp, "encoder")
    out = _train(main, scope, [encoder_feed(cfg, s) for s in range(2)],
                 [v["loss"]], program=compiled)
    return {"losses": [float(o[0]) for o in out],
            "params": _state(scope, _params(main))}


def sgd_one_step(inp, world):
    """One SGD step under fleet: the update of every parameter."""
    import paddle_tpu_torch as fluid

    main, _, v = lr_program(fluid, _fleet_sgd)
    scope = _scope(inp, "lr_sgd")
    _train(main, scope, [lr_feed()], [v["loss"]])
    after = _state(scope, ["w", "b"])
    return {n: after[n] - inp["lr_sgd"][n] for n in ("w", "b")}


def dropout_dp(inp, world):
    import paddle_tpu_torch as fluid

    main, _, v = dropout_program(fluid)
    compiled = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=v["loss"].name)
    scope = _scope(inp, "dropout")
    out = _train(main, scope, [drop_feed(s) for s in range(DROP_STEPS)],
                 [v["loss"], v["h"], v["mask"]], program=compiled)
    return {"losses": [float(o[0]) for o in out], "h": [o[1] for o in out],
            "mask": [o[2] for o in out], "params": _state(scope, _params(main))}


def indivisible(inp, world):
    """A global batch the world's size does not divide."""
    import paddle_tpu_torch as fluid

    main, _, v = lr_program(fluid, _fleet_sgd)
    scope = _scope(inp, "lr_sgd")
    try:
        _train(main, scope, [lr_feed(world * 4 + 1)], [v["loss"]])
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": None}


def geo(inp, world):
    """``tests/dist_worker_geo.py`` on the port: different data a rank,
    K = 3, 6 local steps; each reconcile's parameters before and after."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import Communicator, DistributeTranspiler
    from paddle_tpu_torch.distributed.transpiler import (
        DistributeTranspilerConfig)

    rank = dist.get_rank()
    main, startup, v = lr_program(fluid, lambda f: f.optimizer.SGD(0.05))
    cfg = DistributeTranspilerConfig()
    cfg.geo_sgd_mode = True
    cfg.geo_sgd_need_push_nums = GEO_K
    DistributeTranspiler(cfg).transpile(rank, program=main, pservers="",
                                        trainers=world)
    comm = Communicator(main, geo_sgd_need_push_nums=GEO_K)
    comm.start()
    scope = fluid.global_scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    convert.scope_from_numpy({n: inp["lr_sgd"][n] for n in ("w", "b")},
                             scope, "cpu")
    syncs = []
    average = comm._average_params

    def watched(scope_=None):
        pre = _state(scope, ["w", "b"])
        average(scope_)
        syncs.append({"pre": pre, "post": _state(scope, ["w", "b"])})

    comm._average_params = watched
    rng = np.random.RandomState(100 + rank)
    W = np.full((8, 1), 0.5, "f4")
    for _ in range(GEO_STEPS):
        xv = rng.rand(GEO_B, 8).astype("f4")
        exe.run(main, feed={"x": xv, "y": (xv @ W).astype("f4")},
                fetch_list=[v["loss"]])
    comm.stop()
    w, b = (scope.find_tensor_as_numpy(n) for n in ("w", "b"))
    digest = float(np.sum(w * 1000).round(3) + np.sum(b * 1000).round(3))
    return {"sync_count": comm.sync_count, "digest": digest, "syncs": syncs}


SCENARIOS = {f.__name__: f for f in (
    fleet_lr, transpiler_collective, transpiler_pserver, conv_bn,
    conv_sync_bn, kreduce, kreduce_lamb, sparse_embedding, encoder,
    sgd_one_step,
    dropout_dp, indivisible, geo)}


if __name__ == "__main__":
    base.main(sys.argv[1:], SCENARIOS)
