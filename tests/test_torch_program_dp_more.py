"""Program-mode data parallelism beyond the first slice, held to the JAX
package: the tied extremes of ``reduce_max`` / ``reduce_min`` over the
batch, the data path, the LoD, CRF, CTC and ``scan`` ops of the batch-axis
table, and kReduce with optimizers that read whole parameters.

One gloo world of 2 ranks and one of 4 (``tests/torch_program_dp_more_worker.py``,
one process a rank, started once for the module) run every program through
the port's ``Executor``; while they run, the JAX package runs the same
programs with ``with_data_parallel`` on the simulated CPU devices of
``tests/conftest.py`` (GSPMD: the one-device program's function on the
global batch), from the same JAX startup parameters and the same seeded
feeds:

- ROADMAP Queue 3 entry 11's probe (one SGD step at lr 1 through
  ``mean(reduce_max(h, dim=[0]))`` with a maximum tied across ranks), its
  ``reduce_min(-h)`` twin, ``reduce_all`` with ``keep_dim`` and dims that
  mix the batch with another axis, on a mesh of 2 and of 4 devices (at 4
  the probe's x twice over, so that ties fall inside a rank as well);
- the fleet-tagged CTR program through ``train_from_dataset`` over an
  ``InMemoryDataset`` with the feed pipe on (each rank stages only its
  rows), ``infer_from_dataset``, ``feed_converter``'s staged feeds and a
  ``py_reader`` feeding a ``with_data_parallel`` program;
- narrow CRNN-CTC and LAC programs (``im2sequence``, ``warpctc``,
  ``arg_max``, ``ctc_align``, ``edit_distance``, ``linear_chain_crf``,
  ``crf_decoding``, ``chunk_eval``, ``sequence_reverse`` and the
  ``dynamic_gru`` ``scan`` bodies): losses, the metrics' counts exactly,
  the state;
- four book programs under SGD: word2vec's ``nce`` (negatives pinned) and
  ``hierarchical_sigmoid`` heads, the recommender (``sequence_pool``,
  ``sequence_conv``, ``cos_sim``) and the RNN encoder-decoder
  (``sequence_mask``, ``expand`` and ``scan``); ``nce``'s own draws at
  world 2 against the port's world 1;
- kReduce with LAMB, LARS, DGC and DPSGD (sigma 0: its noise comes from
  another generator than JAX's), and a SelectedRows gradient under Adam:
  the accumulators held as 1/n of their rows a rank.

Tolerance: f32, rtol 1e-5 and atol 1e-6 (each side sums the batch in
another order), and for a state that cancels (the CRNN's batch-norm means
and the conv biases before them, as ``tests/test_torch_crnn_ctc.py``
holds them) relative to the largest magnitude of its group.  Every rank's
replica is equal bit for bit.  At one rank in this process: ops of a
``cond`` body that read a batch-sharded value still raise, naming item
5-B.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu_torch import convert
from paddle_tpu_torch.tools import ctr_program as cp
from paddle_tpu_torch.tools.programs import (crnn_ctc_program, crnn_feed,
                                             lac_feed, lac_program)

import torch_dp_worker as W
import torch_program_dp_worker as PW
import torch_program_dp_more_worker as MW


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WORLD2 = ["probes", "data_path", "crnn", "lac", "books", "nce_draw",
          "kreduce"]
WORLD4 = ["probes", "data_path", "crnn", "lac", "books", "kreduce"]
TOL = dict(rtol=1e-5, atol=1e-6)


def _values(scope, startup):
    names = sorted(x.name for x in startup.list_vars() if x.persistable)
    return convert.scope_to_numpy(scope, names)


def _start(main, startup):
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe.run(startup, scope=scope)
    return exe, scope, _values(scope, startup)


def _dp(main, loss=None, reduce=False, world=None):
    bs = jfluid.BuildStrategy()
    if reduce:
        bs.reduce_strategy = jfluid.BuildStrategy.ReduceStrategy.Reduce
    mesh = None
    if world is not None:
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:world]), ("data",))
    return jfluid.CompiledProgram(main).with_data_parallel(
        loss_name=None if loss is None else loss.name, build_strategy=bs,
        mesh=mesh)


def _np(scope, names):
    return {n: np.asarray(scope.find_var(n)) for n in names}


def _jfleet_wrap(opt):
    return jfleet._Fleet().distributed_optimizer(opt)


def _record(exe, out):
    run = exe.run

    def wrapped(*args, **kwargs):
        res = run(*args, **kwargs)
        out.append(float(np.asarray(res[0])))
        return res

    exe.run = wrapped
    return run


def _references(tmp):
    """The programs started on the JAX package (the ranks' inputs) and the
    JAX package's ``with_data_parallel`` runs of them."""
    inputs, ref, later = {}, {}, []

    # entry 11's probes on meshes of 2 and 4 devices
    for kind in MW.PROBES:
        main, startup, v = MW.probe_program(jfluid, kind)
        _, _, vals = _start(main, startup)
        inputs["probe_" + kind] = vals

        def probe(kind=kind, main=main, startup=startup, v=v):
            for world in (2, 4):
                exe, scope, _ = _start(main, startup)
                (lv,) = exe.run(_dp(main, v["loss"], world=world),
                                feed={"x": MW.probe_x(world)},
                                fetch_list=[v["loss"]], scope=scope)
                ref["probe_%s_%d" % (kind, world)] = {
                    "loss": float(lv), "w": np.asarray(scope.find_var("w"))}
        later.append(probe)

    # the data path: the fleet-tagged CTR program over a dataset
    files = cp.write_ctr_files(str(tmp / "ctr"), n_files=MW.CTR_FILES,
                               rows_per_file=MW.CTR_ROWS)
    inputs["ctr_files"] = files
    prog = cp.build_ctr_program(jfluid, wrap_optimizer=_jfleet_wrap)
    exe, scope, inputs["ctr"] = _start(prog.main, prog.startup)

    def ctr(prog=prog, exe=exe, scope=scope):
        test = prog.main.clone(for_test=True)
        ds = cp.make_dataset(jfluid, "InMemoryDataset", files, prog,
                             MW.CTR_B, 1)
        ds.load_into_memory()
        losses = []
        run = _record(exe, losses)
        exe.train_from_dataset(prog.main, ds, scope=scope,
                               fetch_list=[prog.loss])
        train = list(losses)
        del losses[:]
        exe.infer_from_dataset(_dp(test), ds, scope=scope,
                               fetch_list=[prog.loss])
        exe.run = run
        ref["ctr"] = {"train_losses": train, "infer_losses": list(losses),
                      "params": _np(scope, cp.persistable_names(prog.main))}
    later.append(ctr)

    main, startup, v = MW.reader_program(jfluid, False)
    exe, scope, inputs["reader"] = _start(main, startup)

    def reader(main=main, v=v, exe=exe, scope=scope):
        out = [exe.run(_dp(main, v["loss"]), feed=f, fetch_list=[v["loss"]],
                       scope=scope) for f in MW.reader_feeds()]
        ref["reader"] = {"losses": [float(o[0]) for o in out],
                         "params": _np(scope, ["w", "b"])}
    later.append(reader)

    # the CRNN-CTC and LAC
    for key, build, cfg, feed, fetch in (
            ("crnn", crnn_ctc_program, MW.crnn_cfg(), crnn_feed,
             ["decoded", "decoded_length", "distance"]),
            ("lac", lac_program, MW.lac_cfg(), lac_feed,
             ["decoded", "num_infer", "num_label", "num_correct",
              "precision", "recall", "f1"])):
        main, startup, test, v = build(jfluid, cfg)
        exe, scope, inputs[key] = _start(main, startup)

        def model(key=key, main=main, test=test, v=v, exe=exe, scope=scope,
                  cfg=cfg, feed=feed, fetch=fetch):
            counts = ([v[k] for k in ("num_infer", "num_label",
                                      "num_correct")] if key == "lac" else [])
            out = [exe.run(_dp(main, v["loss"]), feed=feed(cfg, s),
                           fetch_list=[v["loss"]] + counts, scope=scope)
                   for s in range(MW.STEPS)]
            extra = ([MW.eval_var(test, "edit_distance", "SequenceNum")]
                     if key == "crnn" else [])
            ev = exe.run(_dp(test), feed=feed(cfg, MW.STEPS),
                         fetch_list=[v[k] for k in fetch] + extra,
                         scope=scope)
            ref[key] = {"losses": [float(o[0]) for o in out],
                        "counts": [[int(c) for c in o[1:]] for o in out],
                        "eval": ev, "state": _np(scope, sorted(inputs[key]))}
        later.append(model)

    # the book programs
    for model in MW.BOOKS:
        run = MW.book_run(jfluid, model)
        exe, scope, inputs["book_" + model] = _start(run.main, run.startup)

        def book(model=model, run=run, exe=exe, scope=scope):
            out = [exe.run(_dp(run.main, run.cost), feed=run.feed,
                           fetch_list=[run.cost], scope=scope)
                   for _ in range(MW.STEPS)]
            params = sorted(p.name for p in
                            run.main.global_block().all_parameters())
            ref["book_" + model] = {"losses": [float(o[0]) for o in out],
                                    "params": _np(scope, params)}
        later.append(book)

    # kReduce
    cases = [(k, lambda f, k=k: PW.lr_program(
        f, lambda g: MW.kreduce_optimizer(g, k)), PW.lr_feed, "kreduce_" + k)
             for k in MW.KREDUCE]
    cases.append(("sparse", MW.sparse_adam_program, MW.sparse_feed,
                  "sparse_adam"))
    for kind, build, feed, key in cases:
        main, startup, v = build(jfluid)
        exe, scope, inputs[key] = _start(main, startup)

        def kred(kind=kind, main=main, v=v, exe=exe, scope=scope, feed=feed):
            accs = sorted(x.name for x in main.list_vars()
                          if getattr(x, "_is_optimizer_accumulator", False))
            feeds = ([feed(s) for s in range(MW.STEPS + 1)]
                     if kind == "sparse" else [feed()] * (MW.STEPS + 1))
            prog = _dp(main, v["loss"], reduce=True)
            out = [exe.run(prog, feed=f, fetch_list=[v["loss"]] + accs,
                           scope=scope) for f in feeds]
            params = sorted(p.name for p in main.global_block().all_parameters())
            ref["kreduce_" + kind] = {
                "losses": [float(o[0]) for o in out],
                "accs": dict(zip(accs, [np.asarray(a) for a in out[-1][1:]])),
                "params": _np(scope, params)}
        later.append(kred)
    return inputs, ref, later


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' results by scenario and rank, the JAX package's
    references (computed while the ranks run) and the ranks' inputs."""
    tmp = tmp_path_factory.mktemp("program_dp_more")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        inputs, ref, later = _references(tmp)
    runs = [(W.spawn_world(tmp, world, inputs, names, script=MW.__file__),
             names) for world, names in ((2, WORLD2), (4, WORLD4))]
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for fn in later:
                fn()
    finally:
        got = {world: W.join_world(out, procs, names) for world, (
            (out, procs), names) in zip((2, 4), runs)}
    return got, ref, inputs


def _close(got, want, what, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), err_msg=what,
                               **(tol or TOL))


def _group_close(got, want, names, what):
    """A group of values held together: to 1e-5 of its largest magnitude."""
    scale = max(np.abs(np.asarray(want[n], np.float64)).max(initial=0.0)
                for n in names)
    for n in names:
        err = np.abs(np.asarray(got[n], np.float64)
                     - np.asarray(want[n], np.float64)).max(initial=0.0)
        assert err <= 1e-5 * max(scale, 1e-30), (what, n, err, scale)


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


# -- Queue 3 entry 11: tied extremes over the batch -----------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", MW.PROBES)
def test_a_tied_extreme_splits_its_gradient_as_jax(worlds, kind, world):
    """The cotangent splits evenly over every tied element of all ranks
    (ROADMAP's probe: [1/3, 1/3, 1/3], not [0.25, 0.25, 0.5])."""
    got, ref, inputs = worlds
    res = [r[kind] for r in got[world]["probes"]]
    _replicas_alike(res)
    want = ref["probe_%s_%d" % (kind, world)]
    _close(res[0]["loss"], want["loss"], "loss")
    _close(res[0]["w"], want["w"], "w after one SGD step at lr 1")
    if kind in ("max", "min"):
        sign = 1.0 if kind == "max" else -1.0
        _close(1.0 - res[0]["w"].reshape(-1), [sign / 3.0] * 3,
               "the gradient")


def test_a_tied_extreme_at_world_1_is_the_plain_rule():
    """At one rank the table runs the plain rule: the with_data_parallel
    run is the untagged program's bit for bit."""
    for kind in MW.PROBES:
        outs = []
        for dp in (False, True):
            main, startup, v = MW.probe_program(pfluid, kind)
            exe, scope = pfluid.Executor(pfluid.CPUPlace()), pfluid.Scope()
            exe.run(startup, scope=scope)
            prog = MW._dp(pfluid, main, v["loss"]) if dp else main
            (lv,) = exe.run(prog, feed={"x": MW.PROBE_X},
                            fetch_list=[v["loss"]], scope=scope)
            outs.append((lv.tobytes(), scope.find_tensor_as_numpy("w").tobytes()))
        assert outs[0] == outs[1], kind


# -- the data path ---------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_train_and_infer_from_dataset_match_jax(worlds, world):
    got, ref, _ = worlds
    res = got[world]["data_path"]
    _replicas_alike([{k: r[k] for k in ("train_losses", "infer_losses",
                                        "params")} for r in res])
    want, res = ref["ctr"], res[0]
    steps = MW.CTR_FILES * MW.CTR_ROWS // MW.CTR_B
    assert len(res["train_losses"]) == len(want["train_losses"]) == steps
    _close(res["train_losses"], want["train_losses"], "train losses")
    _close(res["infer_losses"], want["infer_losses"], "infer losses")
    for n in want["params"]:
        _close(res["params"][n], want["params"][n], n)
    # the feed pipe staged this rank's rows of every batch
    assert len(res["staged"]) == 2 * steps
    for shapes in res["staged"]:
        assert shapes["feat_ids"][0] == shapes["label"][0] == MW.CTR_B // world


@pytest.mark.parametrize("world", [2, 4])
def test_feed_converter_stages_a_ranks_rows(worlds, world):
    for res in worlds[0][world]["data_path"]:
        conv = res["converter"]
        assert conv["type"] == "_LocalRows"
        assert conv["rows"] == {"feat_ids": MW.CTR_B // world,
                                "label": MW.CTR_B // world}
        assert conv["same_as_global_feed"] and conv["global_staged_same"]
        assert conv["refused"] and "neither the global batch" in conv["refused"]


@pytest.mark.parametrize("world", [2, 4])
def test_a_py_reader_feeds_a_data_parallel_program(worlds, world):
    got, ref, _ = worlds
    res = [r["reader"] for r in got[world]["data_path"]]
    _replicas_alike(res)
    _close(res[0]["losses"], ref["reader"]["losses"], "losses")
    for n in ("w", "b"):
        _close(res[0]["params"][n], ref["reader"]["params"][n], n)


# -- the CRNN-CTC and LAC: CTC, CRF, chunk and edit metrics, scan bodies ---------

@pytest.mark.parametrize("world", [2, 4])
def test_crnn_ctc_matches_jax(worlds, world):
    got, ref, inputs = worlds
    res = got[world]["crnn"]
    _replicas_alike(res)
    want, res = ref["crnn"], res[0]
    _close(res["losses"], want["losses"], "losses")
    dec, dec_len, dist, seq_num = res["eval"]
    np.testing.assert_array_equal(dec, want["eval"][0])
    np.testing.assert_array_equal(dec_len, want["eval"][1])
    _close(dist, want["eval"][2], "edit distances")
    assert int(seq_num) == int(want["eval"][3]) == MW.crnn_cfg().batch
    state = [n for n in inputs["crnn"] if "velocity" not in n
             and "learning_rate" not in n]
    means = [n for n in state if n.endswith(".mean_0")]
    biases = [n for n in state if n.startswith("conv2d_") and ".b_" in n]
    _group_close(res["state"], want["state"], means, "BN means")
    for n in biases:        # a bias before a batch norm: rounding noise
        assert np.abs(res["state"][n]).max() <= 1e-5 * 0.05 * MW.STEPS, n
    for n in state:
        if n not in means and n not in biases:
            _close(res["state"][n], want["state"][n], n)


@pytest.mark.parametrize("world", [2, 4])
def test_lac_matches_jax(worlds, world):
    got, ref, inputs = worlds
    res = got[world]["lac"]
    _replicas_alike(res)
    want, res = ref["lac"], res[0]
    _close(res["losses"], want["losses"], "losses")
    assert res["counts"] == want["counts"]
    for i in range(4):
        np.testing.assert_array_equal(res["eval"][i], want["eval"][i])
    for i in range(4, 7):
        _close(res["eval"][i], want["eval"][i], "precision, recall, F1")
    # the state as vectors: parameters, first and second moments
    state = [n for n in inputs["lac"] if "learning_rate" not in n
             and "beta" not in n]
    for group in ("moment1", "moment2"):
        _group_close(res["state"], want["state"],
                     [n for n in state if group in n], group)
    _group_close(res["state"], want["state"],
                 [n for n in state if "moment" not in n], "parameters")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("model", MW.BOOKS)
def test_book_programs_match_jax(worlds, model, world):
    got, ref, _ = worlds
    res = [r[model] for r in got[world]["books"]]
    _replicas_alike(res)
    want = ref["book_" + model]
    _close(res[0]["losses"], want["losses"], "losses")
    for n in want["params"]:
        _close(res[0]["params"][n], want["params"][n], n)


def test_nce_draws_the_global_batch_at_world_2(worlds):
    """Unpinned, ``nce`` draws one row of negatives a row for the global
    batch, and each rank keeps its rows: world 2 is the port's world 1."""
    got, _, inputs = worlds
    res = got[2]["nce_draw"]
    _replicas_alike(res)
    run = MW.book_run(pfluid, "word2vec_nce", pin=False)
    scope = convert.scope_from_numpy(inputs["book_word2vec_nce"],
                                     pfluid.Scope(), "cpu")
    labels = MW.eval_var(run.main, "nce", "SampleLabels")
    exe = pfluid.Executor(pfluid.CPUPlace())
    out = [exe.run(run.main, feed=run.feed, fetch_list=[run.cost, labels],
                   scope=scope) for _ in range(MW.STEPS)]
    for s in range(MW.STEPS):
        assert res[0]["sample_labels"][s].tobytes() == out[s][1].tobytes()
        _close(res[0]["losses"][s], out[s][0], "loss at step %d" % s)
    assert not np.array_equal(out[0][1][:, 1:], out[1][1][:, 1:])
    for n, want in convert.scope_to_numpy(scope, PW._params(run.main)).items():
        _close(res[0]["params"][n], want, n)


# -- kReduce beyond row-separable updates ------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", MW.KREDUCE + ("sparse",))
def test_kreduce_whole_parameter_optimizers_match_jax(worlds, kind, world):
    """LAMB and LARS sum their norms over the ranks, DGC and DPSGD run on
    whole tensors, a SelectedRows gradient updates a rank's rows: each
    matches JAX's kReduce, with its accumulators held as 1/n of their
    rows a rank."""
    got, ref, inputs = worlds
    res = [r[kind] for r in got[world]["kreduce"]]
    _replicas_alike(res)
    want, res = ref["kreduce_" + kind], res[0]
    _close(res["losses"], want["losses"], "losses")
    for n in want["params"]:
        _close(res["params"][n], want["params"][n], n)
    assert sorted(res["accs"]) == sorted(want["accs"])
    sharded = 0
    for n, whole in want["accs"].items():
        _close(res["accs"][n], whole, n)
        shape, shards = res["held"][n]
        if whole.ndim and whole.shape[0] >= world and whole.shape[0] % world == 0:
            assert shape[0] * world == whole.shape[0] and shards == world, n
            sharded += 1
        else:
            assert shape == whole.shape and shards == 1, n
    assert sharded >= (0 if kind == "dpsgd" else 1)


# -- at one rank, in this process ------------------------------------------------

def test_a_cond_body_reading_a_sharded_value_raises():
    """Only ``scan`` bodies go through the table: an op of a ``cond``
    branch that reads the batch-sharded x raises naming item 5-B."""
    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.unique_name.guard(), pfluid.program_guard(main, startup):
        L = pfluid.layers
        x = L.data("x", shape=[4], dtype="float32")
        pred = L.less_than(L.fill_constant([1], "float32", 0.0),
                           L.fill_constant([1], "float32", 1.0))
        out = L.cond(pred, lambda: L.scale(x, 2.0), lambda: L.scale(x, 3.0))
        loss = L.mean(out)
    exe, scope = pfluid.Executor(pfluid.CPUPlace()), pfluid.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(Exception, match="'scale' in a sub-block.*item 5-B"):
        exe.run(MW._dp(pfluid, main), feed={"x": np.ones((4, 4), "f4")},
                fetch_list=[loss], scope=scope)
    (plain,) = exe.run(main, feed={"x": np.ones((4, 4), "f4")},
                       fetch_list=[loss], scope=scope)
    assert float(plain) == 2.0
