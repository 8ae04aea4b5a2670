"""One rank of a gloo world for the second file of program-mode data
parallelism tests (``tests/test_torch_program_dp_more.py``): the tied
extremes of ``reduce_max`` / ``reduce_min``, the data path, the LoD, CRF,
CTC and ``scan`` ops of the batch-axis table, and kReduce with optimizers
that read whole parameters.

``python tests/torch_program_dp_more_worker.py RANK WORLD STORE IN OUT
SCENARIO...``, as ``torch_dp_worker.py`` runs (its ``spawn_world`` and
``join_world`` start this script with ``script=__file__``).  Each rank is
fed the global batch (or reads it from a dataset, or a ``py_reader``) and
runs the Fluid program through the port's ``Executor(CPUPlace())`` from the
parameters the test carried across from the JAX startup.  The program
functions take the package as ``fluid``, so the test builds the same
programs (and the same var names) on the JAX package.
"""

import sys

import numpy as np

import torch_dp_worker as base
import torch_program_dp_worker as PW

STEPS = 2
PROBE_X = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, 0]], "f4")
PROBES = ("max", "min", "max_keep_all", "max_mixed_dims")
CTR_B, CTR_FILES, CTR_ROWS = 32, 2, 64
BOOK_B, BOOK_LR = 8, 0.05
BOOKS = ("word2vec_nce", "word2vec_hsigmoid", "recommender",
         "rnn_encoder_decoder")
KREDUCE = ("lamb", "lars", "dgc", "dpsgd")
SPARSE_V, SPARSE_B = 48, 16


# -- the programs, on either package -------------------------------------------

def probe_program(fluid, kind):
    """ROADMAP Queue 3 entry 11's probe and its variants: h = fc(x, w = 1,
    no bias) of a [4, 3] x, a loss through a max or min over the batch,
    one SGD step at lr 1 (the update of w is minus its gradient).

    - ``max``: mean(reduce_max(h, dim=[0])); ``min``: the reduce_min of -h;
    - ``max_keep_all``: reduce_max(fc(x, 2), reduce_all, keep_dim);
    - ``max_mixed_dims``: reduce_max over dims [0, 2] of h2 [4, 2, 2]."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", shape=[3], dtype="float32")
        one = fluid.ParamAttr(name="w",
                              initializer=fluid.initializer.Constant(1.0))
        if kind in ("max", "min"):
            h = L.fc(x, 1, param_attr=one, bias_attr=False)
            r = (L.reduce_max(h, dim=[0]) if kind == "max"
                 else L.reduce_min(L.scale(h, -1.0), dim=[0]))
        elif kind == "max_keep_all":
            h = L.fc(x, 2, param_attr=one, bias_attr=False)
            r = L.reduce_max(h, dim=None, keep_dim=True)
        else:
            h = L.reshape(L.fc(x, 4, param_attr=one, bias_attr=False),
                          [-1, 2, 2])
            r = L.reduce_max(h, dim=[0, 2])
        loss = L.mean(r)
        fluid.optimizer.SGD(1.0).minimize(loss)
    return main, startup, {"loss": loss}


def probe_x(world):
    """ROADMAP's 4 x 3 probe at world 2 (a maximum tied across the ranks
    and inside one); at world 4 it twice over, so that a rank holds two
    rows and ties inside it too."""
    return PROBE_X if world == 2 else np.concatenate([PROBE_X, PROBE_X])


def reader_program(fluid, with_reader):
    """``lr_program``'s model (Momentum), its x and y read from a
    ``py_reader`` when ``with_reader``."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", shape=[8], dtype="float32")
        y = L.data("y", shape=[1], dtype="float32")
        reader = (L.create_py_reader_by_data(capacity=2, feed_list=[x, y])
                  if with_reader else None)
        pred = L.fc(x, size=1, param_attr=fluid.ParamAttr(name="w"),
                    bias_attr=fluid.ParamAttr(name="b"))
        loss = L.mean(L.square_error_cost(pred, y))
        fluid.optimizer.Momentum(0.1, momentum=0.9).minimize(loss)
    return main, startup, {"loss": loss, "reader": reader}


def reader_feeds():
    return [PW.lr_feed() for _ in range(1)] + [
        {k: v[::-1].copy() for k, v in PW.lr_feed().items()}]


def kreduce_optimizer(fluid, kind):
    opt = fluid.optimizer
    return {"lamb": lambda: opt.Lamb(0.05),
            "lars": lambda: opt.LarsMomentum(0.1, momentum=0.9,
                                             lars_coeff=0.01),
            "dgc": lambda: opt.DGCMomentumOptimizer(0.1, 0.9,
                                                    sparsity=[0.5]),
            "dpsgd": lambda: opt.Dpsgd(0.1, clip=0.5, batch_size=32.0,
                                       sigma=0.0)}[kind]()


def sparse_adam_program(fluid):
    """An ``is_sparse`` embedding of SPARSE_V rows (divisible by 2 and 4
    ranks) into a softmax fc, Adam: a SelectedRows gradient."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        ids = L.data("ids", shape=[1], dtype="int64")
        label = L.data("label", shape=[1], dtype="int64")
        emb = L.embedding(ids, size=[SPARSE_V, 8], is_sparse=True,
                          param_attr=fluid.ParamAttr(name="emb"))
        pred = L.fc(emb, size=3, act="softmax")
        loss = L.mean(L.cross_entropy(pred, label))
        fluid.optimizer.Adam(0.1).minimize(loss)
    return main, startup, {"loss": loss}


def sparse_feed(step):
    rng = np.random.RandomState(80 + step)
    return {"ids": rng.randint(0, SPARSE_V, (SPARSE_B, 1)).astype("int64"),
            "label": rng.randint(0, 3, (SPARSE_B, 1)).astype("int64")}


def crnn_cfg():
    from paddle_tpu_torch.tools.programs import CRNNConfig

    return CRNNConfig(batch=8, height=16, width=32, classes=9,
                      channels=(4, 4, 8, 8), hidden=8, label_min=1,
                      label_max=3, lr=0.05, momentum=0.9, l2=4e-4)


def lac_cfg():
    from paddle_tpu_torch.tools.programs import LACConfig

    return LACConfig(batch=8, seq_len=6, vocab=50, emb=8, hidden=8, tags=7,
                     len_min=2, len_max=6, lr=1e-2)


def book_sgd(fluid, lr):
    return fluid.optimizer.SGD(BOOK_LR)


def eval_var(program, op_type, slot):
    return next(op.outputs[slot][0] for op in program.global_block().ops
                if op.type == op_type)


# -- the port's side ------------------------------------------------------------

def _fluid():
    import paddle_tpu_torch as fluid

    return fluid


def _dp(fluid, program, loss=None, reduce=False):
    bs = fluid.BuildStrategy()
    if reduce:
        bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
    return fluid.CompiledProgram(program).with_data_parallel(
        loss_name=None if loss is None else loss.name, build_strategy=bs)


def _run(exe, program, feeds, fetch, scope):
    return [exe.run(program, feed=f, fetch_list=fetch, scope=scope)
            for f in feeds]


def probes(inp, world):
    fluid = _fluid()
    res = {}
    for kind in PROBES:
        main, _, v = probe_program(fluid, kind)
        scope = PW._scope(inp, "probe_" + kind)
        exe = fluid.Executor(fluid.CPUPlace())
        (lv,) = exe.run(_dp(fluid, main, v["loss"]),
                        feed={"x": probe_x(world)},
                        fetch_list=[v["loss"]], scope=scope)
        res[kind] = {"loss": float(lv),
                     "w": scope.find_tensor_as_numpy("w")}
    return res


def data_path(inp, world):
    """train_from_dataset of the fleet-tagged CTR program over an
    InMemoryDataset, the pipe on; infer_from_dataset of its test clone
    under with_data_parallel; feed_converter's staged rows; a py_reader."""
    import torch

    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.executor import _LocalRows
    from paddle_tpu_torch.tools import ctr_program as cp

    fluid = _fluid()
    prog = cp.build_ctr_program(fluid, wrap_optimizer=lambda o: fleet._Fleet(
        ).distributed_optimizer(o))
    test = prog.main.clone(for_test=True)
    scope = PW._scope(inp, "ctr")
    exe = fluid.Executor(fluid.CPUPlace())
    losses, staged = [], []
    run, convert = exe.run, exe.feed_converter

    def recorded(*a, **kw):
        res = run(*a, **kw)
        losses.append(float(res[0].detach().numpy()))
        return res

    def converter(program=None):
        conv = convert(program)

        def watched(feed):
            out = conv(feed)
            staged.append({k: tuple(v.shape) for k, v in out.items()})
            return out

        return watched

    exe.run, exe.feed_converter = recorded, converter
    ds = cp.make_dataset(fluid, "InMemoryDataset", inp["ctr_files"], prog,
                         CTR_B, 1)
    ds.load_into_memory()
    exe.train_from_dataset(prog.main, ds, scope=scope, fetch_list=[prog.loss])
    train = list(losses)
    del losses[:]
    exe.infer_from_dataset(_dp(fluid, test), ds, scope=scope,
                           fetch_list=[prog.loss])
    exe.run, exe.feed_converter = run, convert
    out = {"train_losses": train, "infer_losses": list(losses),
           "staged": staged,
           "params": PW._state(scope, cp.persistable_names(prog.main))}

    # feed_converter: this rank's rows, run as they are; the global batch
    # staged is cut; any other row count is refused
    batch = next(ds._iter_batches())
    dp_test = _dp(fluid, test)
    local = exe.feed_converter(dp_test)(batch)
    want = exe.run(dp_test, feed=batch, fetch_list=[prog.loss], scope=scope)
    got = exe.run(dp_test, feed=local, fetch_list=[prog.loss], scope=scope)
    whole = _LocalRows({k: torch.from_numpy(v) for k, v in batch.items()},
                       local.global_rows)
    got_whole = exe.run(dp_test, feed=whole, fetch_list=[prog.loss],
                        scope=scope)
    bad = _LocalRows(dict(local, feat_ids=local["feat_ids"][:1]),
                     local.global_rows)
    try:
        exe.run(dp_test, feed=bad, fetch_list=[prog.loss], scope=scope)
        refused = None
    except ValueError as e:
        refused = str(e)
    out["converter"] = {
        "type": type(local).__name__,
        "rows": {k: int(v.shape[0]) for k, v in local.items()},
        "same_as_global_feed": got[0].tobytes() == want[0].tobytes(),
        "global_staged_same": got_whole[0].tobytes() == want[0].tobytes(),
        "refused": refused}

    # a py_reader feeding a with_data_parallel program: the global batch
    main, _, v = reader_program(fluid, True)
    rscope = PW._scope(inp, "reader")
    feeds = reader_feeds()
    v["reader"].decorate_batch_generator(
        lambda: iter([(f["x"], f["y"]) for f in feeds]),
        places=fluid.CPUPlace())
    v["reader"].start()
    rl = []
    compiled = _dp(fluid, main, v["loss"])
    try:
        while True:
            rl.append(float(exe.run(compiled, fetch_list=[v["loss"]],
                                    scope=rscope)[0]))
    except fluid.EOFException:
        pass
    out["reader"] = {"losses": rl,
                     "params": PW._state(rscope, ["w", "b"])}
    return out


def crnn(inp, world):
    from paddle_tpu_torch.tools.programs import crnn_ctc_program, crnn_feed

    fluid = _fluid()
    cfg = crnn_cfg()
    main, startup, test, v = crnn_ctc_program(fluid, cfg)
    scope = PW._scope(inp, "crnn")
    exe = fluid.Executor(fluid.CPUPlace())
    out = _run(exe, _dp(fluid, main, v["loss"]),
               [crnn_feed(cfg, s) for s in range(STEPS)], [v["loss"]], scope)
    seq_num = eval_var(test, "edit_distance", "SequenceNum")
    fetch = [v["decoded"], v["decoded_length"], v["distance"], seq_num]
    ev = exe.run(_dp(fluid, test), feed=crnn_feed(cfg, STEPS),
                 fetch_list=fetch, scope=scope)
    names = sorted(x.name for x in startup.list_vars() if x.persistable)
    return {"losses": [float(o[0]) for o in out],
            "eval": ev, "state": PW._state(scope, names)}


def lac(inp, world):
    from paddle_tpu_torch.tools.programs import lac_feed, lac_program

    fluid = _fluid()
    cfg = lac_cfg()
    main, startup, test, v = lac_program(fluid, cfg)
    scope = PW._scope(inp, "lac")
    exe = fluid.Executor(fluid.CPUPlace())
    counts = [v[k] for k in ("num_infer", "num_label", "num_correct")]
    out = _run(exe, _dp(fluid, main, v["loss"]),
               [lac_feed(cfg, s) for s in range(STEPS)], [v["loss"]] + counts,
               scope)
    fetch = [v[k] for k in ("decoded", "num_infer", "num_label",
                            "num_correct", "precision", "recall", "f1")]
    ev = exe.run(_dp(fluid, test), feed=lac_feed(cfg, STEPS),
                 fetch_list=fetch, scope=scope)
    names = sorted(x.name for x in startup.list_vars() if x.persistable)
    return {"losses": [float(o[0]) for o in out],
            "counts": [[int(c) for c in o[1:]] for o in out],
            "eval": ev, "state": PW._state(scope, names)}


def book_run(fluid, model, pin=True):
    """A book program on ``fluid`` with that package's own ``models.book``
    and ``datasets``."""
    import importlib

    from paddle_tpu_torch.tools import book_suite

    pkg = fluid.__name__
    book = importlib.import_module(pkg + ".models.book")
    datasets = importlib.import_module(pkg + ".datasets")
    run = book_suite.build(fluid, book, datasets, model, optimizer=book_sgd,
                           n=BOOK_B)
    if pin:
        book_suite.pin_random_ops(run.main)
    return run


def books(inp, world):
    fluid = _fluid()
    res = {}
    for model in BOOKS:
        run = book_run(fluid, model)
        scope = PW._scope(inp, "book_" + model)
        exe = fluid.Executor(fluid.CPUPlace())
        out = _run(exe, _dp(fluid, run.main, run.cost), [run.feed] * STEPS,
                   [run.cost], scope)
        res[model] = {"losses": [float(o[0]) for o in out],
                      "params": PW._state(scope, PW._params(run.main))}
    return res


def nce_draw(inp, world):
    """word2vec's nce with its sampler on: the negatives the one-rank run
    draws for the global batch, this rank's rows."""
    fluid = _fluid()
    run = book_run(fluid, "word2vec_nce", pin=False)
    scope = PW._scope(inp, "book_word2vec_nce")
    labels = eval_var(run.main, "nce", "SampleLabels")
    exe = fluid.Executor(fluid.CPUPlace())
    out = _run(exe, _dp(fluid, run.main, run.cost), [run.feed] * STEPS,
               [run.cost, labels], scope)
    return {"losses": [float(o[0]) for o in out],
            "sample_labels": [o[1] for o in out],
            "params": PW._state(scope, PW._params(run.main))}


def kreduce(inp, world):
    """lr_program under kReduce with LAMB, LARS, DGC and DPSGD, and the
    sparse Adam program: losses, parameters, the accumulators fetched whole
    and the bytes a rank holds of each."""
    fluid = _fluid()
    res = {}
    cases = [(k, lambda f, k=k: PW.lr_program(
        f, lambda g: kreduce_optimizer(g, k)), PW.lr_feed, "kreduce_" + k)
             for k in KREDUCE]
    cases.append(("sparse", sparse_adam_program, sparse_feed, "sparse_adam"))
    for kind, build, feed, key in cases:
        main, _, v = build(fluid)
        accs = sorted(x.name for x in main.list_vars()
                      if getattr(x, "_is_optimizer_accumulator", False))
        scope = PW._scope(inp, key)
        exe = fluid.Executor(fluid.CPUPlace())
        feeds = ([feed(s) for s in range(STEPS + 1)] if kind == "sparse"
                 else [feed()] * (STEPS + 1))
        out = _run(exe, _dp(fluid, main, v["loss"], reduce=True), feeds,
                   [v["loss"]] + accs, scope)
        res[kind] = {
            "losses": [float(o[0]) for o in out],
            "accs": dict(zip(accs, out[-1][1:])),
            "held": {n: (tuple(scope.find_var(n).shape),
                         scope.row_shards(n)) for n in accs},
            "params": PW._state(scope, PW._params(main))}
    return res


SCENARIOS = {f.__name__: f for f in (probes, data_path, crnn, lac, books,
                                     nce_draw, kreduce)}


if __name__ == "__main__":
    base.main(sys.argv[1:], SCENARIOS)
