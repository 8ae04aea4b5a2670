"""Program-mode data parallelism (ROADMAP item 5-B) held to the JAX package.

One gloo world of 2 ranks and one of 4 (``tests/torch_program_dp_worker.py``,
one process a rank, started once for the module) run every Fluid program
through the port's ``Executor``, each rank fed the global batch; while they
run, the JAX package runs the same programs with ``with_data_parallel`` on
the 8 simulated CPU devices of ``tests/conftest.py`` (GSPMD: the one-device
program's function on the global batch), from the same JAX startup
parameters (carried to the ranks as numpy) and the same seeded feeds:

- ``tests/test_distributed.py``'s linear model under ``fleet`` (5 SGD
  steps, B = 32) at worlds 2 and 4, and through the transpiler in
  "collective" and "pserver" modes;
- conv -> batch_norm -> fc with ``accuracy`` and a batch-shaped fetch under
  ``with_data_parallel`` (Momentum, 3 steps) at worlds 2 and 4: losses,
  accuracies, the fetched predictions, the running statistics and the
  parameters; with ``sync_batch_norm=True`` held to JAX's one-device run
  (the reference's own raises, pinned below);
- kReduce (Momentum): the velocity held as 1/n of its bytes a rank, the
  losses equal to AllReduce's bit for bit, the fetched velocity equal to
  JAX's; LAMB under kReduce (its norms summed over the ranks) against
  JAX's;
- an ``is_sparse`` embedding (SGD) and a narrow Fluid-layers BERT encoder
  (dropout 0, SGD);
- one SGD step at world 2 against the port's world 1 (update ratio 1.0);
- a dropout program at world 2 against the port's world 1: the masks bit
  for bit;
- a batch the world's size does not divide raises.

Tolerance: f32, rtol 1e-5 and atol 1e-6 (each side sums the batch in
another order: the port each rank's rows, then the ranks).  Every rank's
replica is equal bit for bit.
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu_torch import convert
from paddle_tpu_torch.tools.programs import (bert_encoder_program,
                                             encoder_feed)

import torch_dp_worker as W
import torch_program_dp_worker as PW


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WORLD2 = ["fleet_lr", "transpiler_collective", "transpiler_pserver",
          "conv_bn", "conv_sync_bn", "kreduce", "kreduce_lamb",
          "sparse_embedding", "encoder",
          "sgd_one_step", "dropout_dp", "indivisible", "geo"]
WORLD4 = ["fleet_lr", "conv_bn", "kreduce", "indivisible"]
TOL = dict(rtol=1e-5, atol=1e-6)


def _start(build):
    """A program built on the JAX package, its startup run: (main, vars,
    scope, executor, the startup's persistables as numpy)."""
    main, startup, v = build(jfluid)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe.run(startup, scope=scope)
    names = sorted(x.name for x in startup.list_vars() if x.persistable)
    return main, v, scope, exe, convert.scope_to_numpy(scope, names)


def _jfleet_sgd(fluid):
    return jfleet._Fleet().distributed_optimizer(fluid.optimizer.SGD(0.1))


def _dp(main, v, bs=None):
    return jfluid.CompiledProgram(main).with_data_parallel(
        loss_name=v["loss"].name, build_strategy=bs)


def _np(scope, names):
    return {n: np.asarray(scope.find_var(n)) for n in names}


def _jax_references(starts):
    ref = {}
    main, v, scope, exe, _ = starts["fleet"]
    out = [exe.run(main, feed=PW.lr_feed(), fetch_list=[v["loss"], v["pred"]],
                   scope=scope) for _ in range(PW.LR_STEPS)]
    ref["fleet_lr"] = {"losses": [float(o[0]) for o in out],
                       "pred": np.asarray(out[-1][1]),
                       "params": _np(scope, ["w", "b"])}
    for mode in ("collective", "pserver"):
        main, v, scope, exe, _ = starts["transpiler_" + mode]
        config = jfluid.transpiler.DistributeTranspilerConfig()
        config.mode = mode
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jfluid.transpiler.DistributeTranspiler(config).transpile(
                0, program=main, pservers="127.0.0.1:6170,127.0.0.1:6171",
                trainers=2)
        out = [exe.run(main, feed=PW.lr_feed(), fetch_list=[v["loss"]],
                       scope=scope) for _ in range(PW.LR_STEPS)]
        ref["transpiler_" + mode] = {"losses": [float(o[0]) for o in out],
                                     "params": _np(scope, ["w", "b"])}
    for key, sync in (("conv_bn", False), ("conv_sync_bn", True)):
        main, v, scope, exe, _ = starts[key]
        # the reference's sync_batch_norm raises (pinned below): its
        # one-device run is what the port's sync-BN program computes
        prog = main if sync else _dp(main, v)
        out = [exe.run(prog, feed=PW.conv_feed(s),
                       fetch_list=[v["loss"], v["acc"], v["pred"]],
                       scope=scope) for s in range(PW.CONV_STEPS)]
        params = sorted(p.name for p in main.global_block().all_parameters())
        ref[key] = {"losses": [float(o[0]) for o in out],
                    "accs": [float(o[1]) for o in out],
                    "pred": [np.asarray(o[2]) for o in out],
                    "bn": _np(scope, PW.bn_stats(main)),
                    "params": _np(scope, params)}
    main, v, scope, exe, _ = starts["kreduce"]
    vel = PW.velocity_name(main)
    bs = jfluid.BuildStrategy()
    bs.reduce_strategy = jfluid.BuildStrategy.ReduceStrategy.Reduce
    prog = _dp(main, v, bs)
    out = [exe.run(prog, feed=PW.lr_feed(), fetch_list=[v["loss"], vel],
                   scope=scope) for _ in range(PW.KREDUCE_STEPS)]
    ref["kreduce"] = {"losses": [float(o[0]) for o in out],
                      "velocity": np.asarray(out[-1][1]),
                      "params": _np(scope, ["w", "b"])}
    main, v, scope, exe, _ = starts["lamb"]
    moments = sorted(x.name for x in main.list_vars()
                     if getattr(x, "_is_optimizer_accumulator", False)
                     and "moment" in x.name and x.name.startswith("w"))
    prog = _dp(main, v, bs)
    out = [exe.run(prog, feed=PW.lr_feed(), fetch_list=[v["loss"]] + moments,
                   scope=scope) for _ in range(PW.KREDUCE_STEPS)]
    ref["kreduce_lamb"] = {"losses": [float(o[0]) for o in out],
                           "moments": dict(zip(moments, [
                               np.asarray(m) for m in out[-1][1:]])),
                           "params": _np(scope, ["w", "b"])}
    for key, feeds in (("sparse_embedding", [PW.sparse_feed(s) for s in
                                             range(PW.SPARSE_STEPS)]),
                       ("encoder", [encoder_feed(PW.encoder_cfg(), s)
                                    for s in range(2)])):
        main, v, scope, exe, _ = starts[key]
        prog = _dp(main, v)
        out = [exe.run(prog, feed=f, fetch_list=[v["loss"]], scope=scope)
               for f in feeds]
        params = sorted(p.name for p in main.global_block().all_parameters())
        ref[key] = {"losses": [float(o[0]) for o in out],
                    "params": _np(scope, params)}
    return ref


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' results by scenario and rank, and the JAX package's
    references, computed while the ranks run."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        starts = {
            "fleet": _start(lambda f: PW.lr_program(f, _jfleet_sgd)),
            "transpiler_collective": _start(
                lambda f: PW.lr_program(f, lambda g: g.optimizer.SGD(0.1))),
            "transpiler_pserver": _start(
                lambda f: PW.lr_program(f, lambda g: g.optimizer.SGD(0.1))),
            "conv_bn": _start(PW.conv_bn_program),
            "conv_sync_bn": _start(PW.conv_bn_program),
            "kreduce": _start(lambda f: PW.lr_program(
                f, lambda g: g.optimizer.Momentum(0.1, momentum=0.9))),
            "lamb": _start(lambda f: PW.lr_program(
                f, lambda g: g.optimizer.Lamb(0.01))),
            "sparse_embedding": _start(PW.sparse_program),
            "encoder": _start(lambda f: bert_encoder_program(
                f, PW.encoder_cfg())),
            "dropout": _start(PW.dropout_program),
        }
    inputs = {"lr_sgd": starts["fleet"][4],
              "lr_momentum": starts["kreduce"][4],
              "lr_lamb": starts["lamb"][4],
              "conv": starts["conv_bn"][4],
              "sparse": starts["sparse_embedding"][4],
              "encoder": starts["encoder"][4],
              "dropout": starts["dropout"][4]}
    tmp = tmp_path_factory.mktemp("program_dp")
    runs = [(W.spawn_world(tmp, world, inputs, names, script=PW.__file__),
             names) for world, names in ((2, WORLD2), (4, WORLD4))]
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = _jax_references(starts)
    finally:
        got = {world: W.join_world(out, procs, names) for world, (
            (out, procs), names) in zip((2, 4), runs)}
    return got, ref, inputs


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), err_msg=what,
                               **TOL)


def _replicas_alike(per_rank):
    """Every rank's result equal to rank 0's, bit for bit."""
    def same(a, b, path):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), path
            for k in a:
                same(a[k], b[k], path + "/" + str(k))
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, "%s/%d" % (path, i))
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
        else:
            assert a == b, path

    for r, res in enumerate(per_rank[1:], 1):
        same(res, per_rank[0], "rank %d" % r)


@pytest.mark.parametrize("world", [2, 4])
def test_fleet_linear_model_matches_jax(worlds, world):
    got, ref, _ = worlds
    res = got[world]["fleet_lr"]
    _replicas_alike(res)
    want = ref["fleet_lr"]
    _close(res[0]["losses"], want["losses"], "losses")
    _close(res[0]["pred"], want["pred"], "the batch-shaped fetch")
    for n in ("w", "b"):
        _close(res[0]["params"][n], want["params"][n], n)


@pytest.mark.parametrize("mode", ["collective", "pserver"])
def test_transpiled_linear_model_matches_jax(worlds, mode):
    got, ref, _ = worlds
    res = got[2]["transpiler_" + mode]
    _replicas_alike(res)
    assert res[0]["mode"] == mode
    want = ref["transpiler_" + mode]
    _close(res[0]["losses"], want["losses"], "losses")
    for n in ("w", "b"):
        _close(res[0]["params"][n], want["params"][n], n)


@pytest.mark.parametrize("world,key", [(2, "conv_bn"), (4, "conv_bn"),
                                       (2, "conv_sync_bn")])
def test_conv_batch_norm_program_matches_jax(worlds, world, key):
    """Global BN statistics (running and in the loss), the global
    accuracy, a batch-shaped fetch gathered to the global batch."""
    got, ref, _ = worlds
    res = got[world][key]
    _replicas_alike(res)
    want, res = ref[key], res[0]
    _close(res["losses"], want["losses"], "losses")
    assert res["accs"] == want["accs"]
    for s in range(PW.CONV_STEPS):
        assert res["pred"][s].shape == (PW.CONV_B, 4)
        _close(res["pred"][s], want["pred"][s], "pred at step %d" % s)
    assert sorted(res["bn"]) == sorted(want["bn"]) and len(res["bn"]) == 2
    for n in res["bn"]:
        _close(res["bn"][n], want["bn"][n], n)
    for n in want["params"]:
        _close(res["params"][n], want["params"][n], n)


def test_the_references_sync_batch_norm_raises():
    """``BuildStrategy.sync_batch_norm`` in the JAX package: ``lax.pmean``
    outside ``shard_map`` (ROADMAP Queue 3, not queued)."""
    main, v, scope, exe, _ = _start(PW.conv_bn_program)
    bs = jfluid.BuildStrategy()
    bs.sync_batch_norm = True
    with pytest.raises(Exception, match="unbound axis name: data"):
        exe.run(_dp(main, v, bs), feed=PW.conv_feed(0),
                fetch_list=[v["loss"]], scope=scope)


@pytest.mark.parametrize("world", [2, 4])
def test_kreduce_holds_a_rank_s_rows_of_the_velocity(worlds, world):
    got, ref, _ = worlds
    res = got[world]["kreduce"]
    _replicas_alike(res)
    red, full = res[0]["reduce"], res[0]["allreduce"]
    assert red["held_shape"] == (8 // world, 1)
    assert red["held_bytes"] * world == full["held_bytes"] == 8 * 4
    assert red["row_shards"] == world and full["row_shards"] == 1
    assert red["losses"] == full["losses"]
    for n in ("w", "b"):
        assert red["params"][n].tobytes() == full["params"][n].tobytes()
    assert red["velocity"].tobytes() == full["velocity"].tobytes()
    assert red["saved_velocity"].tobytes() == red["velocity"].tobytes()
    want = ref["kreduce"]
    _close(red["losses"], want["losses"], "losses")
    _close(red["velocity"], want["velocity"], "the fetched velocity")


def test_kreduce_lamb_matches_jax(worlds):
    """LAMB's trust ratio reads the whole parameter's norms: under kReduce
    each rank sums its rows' squares with the other ranks', updates its
    rows, and holds half of each moment; JAX's kReduce is the one-device
    function."""
    got, ref, _ = worlds
    res = got[2]["kreduce_lamb"]
    _replicas_alike(res)
    want, res = ref["kreduce_lamb"], res[0]
    _close(res["losses"], want["losses"], "losses")
    for n in ("w", "b"):
        _close(res["params"][n], want["params"][n], n)
    assert sorted(res["moments"]) == sorted(want["moments"]) and \
        len(want["moments"]) == 2
    for n, whole in want["moments"].items():
        _close(res["moments"][n], whole, n)
        assert res["held_shapes"][n] == (whole.shape[0] // 2,) + whole.shape[1:]


@pytest.mark.parametrize("key", ["sparse_embedding", "encoder"])
def test_sparse_and_encoder_programs_match_jax(worlds, key):
    got, ref, _ = worlds
    res = got[2][key]
    _replicas_alike(res)
    want = ref[key]
    _close(res[0]["losses"], want["losses"], "losses")
    for n in want["params"]:
        _close(res[0]["params"][n], want["params"][n], n)


def _port_world1(build, scope_values, feeds, fetch):
    main, _, v = build(pfluid)
    scope = convert.scope_from_numpy(scope_values, pfluid.Scope(), "cpu")
    exe = pfluid.Executor(pfluid.CPUPlace())
    out = [exe.run(main, feed=f, fetch_list=[v[k] for k in fetch],
                   scope=scope) for f in feeds]
    return main, scope, out


def test_one_sgd_step_at_world_2_moves_as_world_1(worlds):
    """Program mode gives the one-device gradient (an update ratio of 1.0;
    the functional path's psum gives 2.0, ROADMAP Queue 3)."""
    got, _, inputs = worlds
    _replicas_alike(got[2]["sgd_one_step"])
    _, scope, _ = _port_world1(lambda f: PW.lr_program(f, PW._sgd),
                               inputs["lr_sgd"], [PW.lr_feed()], ["loss"])
    for n in ("w", "b"):
        one = scope.find_tensor_as_numpy(n) - inputs["lr_sgd"][n]
        two = got[2]["sgd_one_step"][0][n]
        ratio = np.abs(two).sum() / np.abs(one).sum()
        assert abs(ratio - 1.0) <= 1e-5, (n, ratio)
        _close(two, one, n)


def test_dropout_at_world_2_equals_the_ports_world_1(worlds):
    """Each rank draws the global batch's mask and keeps its rows."""
    got, _, inputs = worlds
    res = got[2]["dropout_dp"]
    _replicas_alike(res)
    main, scope, out = _port_world1(
        PW.dropout_program, inputs["dropout"],
        [PW.drop_feed(s) for s in range(PW.DROP_STEPS)],
        ["loss", "h", "mask"])
    for s in range(PW.DROP_STEPS):
        assert res[0]["mask"][s].tobytes() == out[s][2].tobytes()
        assert 0 < res[0]["mask"][s].mean() < 1
        _close(res[0]["h"][s], out[s][1], "h at step %d" % s)
        _close(res[0]["losses"][s], out[s][0], "loss at step %d" % s)
    for n, want in convert.scope_to_numpy(
            scope, [p.name for p in main.global_block().all_parameters()]).items():
        _close(res[0]["params"][n], want, n)


@pytest.mark.parametrize("world", [2, 4])
def test_an_indivisible_batch_raises(worlds, world):
    for res in worlds[0][world]["indivisible"]:
        assert res["raised"] and "divisible by %d" % world in res["raised"]


def test_geo_sgd_reconciles_replicas(worlds):
    """``tests/dist_worker_geo.py`` on the port: equal digests, the
    reference's sync count (steps 3 and 6, then stop()'s), and each
    reconcile the numpy mean of the ranks' parameters before it."""
    res = worlds[0][2]["geo"]
    assert [r["sync_count"] for r in res] == [3, 3]
    assert res[0]["digest"] == res[1]["digest"]
    for k in range(3):
        for n in ("w", "b"):
            pre = [r["syncs"][k]["pre"][n] for r in res]
            want = np.mean(np.stack(pre), axis=0).astype(pre[0].dtype)
            for r in res:
                assert r["syncs"][k]["post"][n].tobytes() == want.tobytes()
    for n in ("w", "b"):                   # the two ranks trained apart
        assert not np.array_equal(res[0]["syncs"][0]["pre"][n],
                                  res[1]["syncs"][0]["pre"][n])


# -- at one rank: what the table refuses, the data path, the communicator -------

def _dp_program(build_extra):
    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.unique_name.guard(), pfluid.program_guard(main, startup):
        x = pfluid.layers.data("x", shape=[4], dtype="float32")
        loss = pfluid.layers.mean(build_extra(pfluid.layers, x))
        pfluid.optimizer.SGD(0.1).minimize(loss)
    exe, scope = pfluid.Executor(pfluid.CPUPlace()), pfluid.Scope()
    exe.run(startup, scope=scope)
    cp = pfluid.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
    return cp, loss, exe, scope


def test_an_op_outside_the_batch_axis_table_raises():
    """``cumsum`` reads the batch-sharded x: no default, the run raises
    naming the op and item 5-B (at one rank too)."""
    cp, loss, exe, scope = _dp_program(lambda L, x: L.cumsum(L.fc(x, 3), axis=1))
    with pytest.raises(Exception, match="'cumsum'.*item 5-B"):
        exe.run(cp, feed={"x": np.ones((4, 4), "f4")}, fetch_list=[loss],
                scope=scope)


def test_replicated_ops_run_outside_the_table():
    """An op of the table's absence that reads only replicated values (the
    optimizer's, a parameter's cumsum) runs as it is."""
    def build(L, x):
        w = L.create_parameter([4, 3], "float32", name="w_cs")
        return L.elementwise_mul(L.matmul(x, L.cumsum(w, axis=1)),
                                 L.fill_constant([1], "float32", 2.0))

    cp, loss, exe, scope = _dp_program(build)
    (l,) = exe.run(cp, feed={"x": np.ones((4, 4), "f4")}, fetch_list=[loss],
                   scope=scope)
    assert np.isfinite(l)


def test_the_data_path_under_data_parallelism_runs(tmp_path):
    """At one rank, train_from_dataset of a with_data_parallel program (the
    feed pipe staging through ``feed_converter``) is the plain program's
    run bit for bit; the converter marks its staged rows."""
    from paddle_tpu_torch.executor import _LocalRows
    from paddle_tpu_torch.tools import ctr_program as cp

    files = cp.write_ctr_files(str(tmp_path), n_files=1, rows_per_file=64)
    runs = []
    for dp in (False, True):
        prog = cp.build_ctr_program(pfluid)
        exe, scope = pfluid.Executor(pfluid.CPUPlace()), pfluid.Scope()
        exe.run(prog.startup, scope=scope)
        if runs:
            for n, val in runs[0][1].items():
                scope.set(n, torch.from_numpy(val.copy()))
        init = {n: scope.find_tensor_as_numpy(n).copy()
                for n in cp.persistable_names(prog.main)}
        program = (pfluid.CompiledProgram(prog.main).with_data_parallel(
            loss_name=prog.loss.name) if dp else prog.main)
        ds = cp.make_dataset(pfluid, "QueueDataset", files, prog, 16)
        exe.train_from_dataset(program, ds, scope=scope,
                               fetch_list=[prog.loss])
        runs.append((dp, init, {n: scope.find_tensor_as_numpy(n)
                                for n in init}))
        if dp:
            staged = exe.feed_converter(program)(next(ds._iter_batches()))
            assert isinstance(staged, _LocalRows)
            assert staged.global_rows == {"feat_ids": 16, "label": 16}
            assert staged["feat_ids"].shape[0] == 16
    for n, val in runs[0][2].items():
        assert val.tobytes() == runs[1][2][n].tobytes(), n
    assert any(not np.array_equal(runs[0][1][n], runs[0][2][n])
               for n in runs[0][1])


def _fake_run(n=2, rank=1):
    from paddle_tpu_torch.parallel import batch_axes

    class Info:
        pass

    info = Info()
    info.n, info.rank, info.group = n, rank, None
    info.rows = lambda size: (rank * size // n, (rank + 1) * size // n)
    return batch_axes.Run(info, [])


@pytest.mark.parametrize("shape,attr_shape,want_local,want_axis", [
    ((4, 6, 8), [0, 0, 2, 4], (4, 6, 2, 4), 0),      # heads: 0 copies
    ((4, 6, 8), [48, 8], (24, 8), 0),                # the global B S literal
    ((4, 6, 8), [-1, 8], (24, 8), 0),
    ((4, 6, 8), [1, 8, 6, 8], (1, 4, 6, 8), 1),      # a leading 1
])
def test_reshape_resolves_against_the_global_batch(shape, attr_shape,
                                                   want_local, want_axis):
    """A rank of two holds 4 of the global 8 rows; the shape attr is the
    global program's."""
    from paddle_tpu_torch.parallel import batch_axes
    from paddle_tpu_torch.registry import get_lowering

    v = torch.arange(float(np.prod(shape))).reshape(shape)
    outs, axes = batch_axes.TABLE["reshape2"](
        get_lowering("reshape2"), {"X": [v]}, {"X": [0]},
        {"shape": attr_shape}, None, _fake_run(), "reshape2")
    assert tuple(outs["Out"][0].shape) == want_local
    assert axes == {"Out": want_axis}


def test_reshape_mixing_the_batch_with_earlier_axes_raises():
    from paddle_tpu_torch.parallel import batch_axes
    from paddle_tpu_torch.registry import get_lowering

    v = torch.zeros(3, 4, 2)          # the batch on axis 1 (global 8)
    with pytest.raises(NotImplementedError, match="item 5-B"):
        batch_axes.TABLE["reshape2"](
            get_lowering("reshape2"), {"X": [v]}, {"X": [1]},
            {"shape": [48, 1]}, None, _fake_run(), "reshape2")


def test_squeeze_keeps_a_local_batch_of_one():
    """Global batch 2 over 2 ranks: each holds one row, which the global
    squeeze (of the size-1 axes) does not drop."""
    from paddle_tpu_torch.parallel import batch_axes
    from paddle_tpu_torch.registry import get_lowering

    outs, axes = batch_axes.TABLE["squeeze2"](
        get_lowering("squeeze2"), {"X": [torch.zeros(1, 3, 1)]}, {"X": [0]},
        {"axes": []}, None, _fake_run(), "squeeze2")
    assert tuple(outs["Out"][0].shape) == (1, 3) and axes == {"Out": 0}


def test_communicator_at_one_rank():
    """Outside a world the average is the value itself; the tick and stop
    counts follow the reference's contract."""
    from paddle_tpu_torch.distributed import Communicator

    main = pfluid.Program()
    main._dist_info = {"mode": "geo", "geo_sgd_need_push_nums": 2}
    comm = Communicator(main)
    assert comm.mode == "GEO" and comm.push_nums == 2
    assert not comm.tick()               # not started
    comm.start()
    assert main._communicator is comm and comm.is_running()
    assert [comm.tick(pfluid.Scope()) for _ in range(4)] == [
        False, True, False, True]
    comm.stop()
    assert comm.sync_count == 3 and main._communicator is None
    with pytest.warns(UserWarning, match="ASYNC"):
        Communicator(pfluid.Program())
