"""The port's deployment path against the JAX package's on the CPU:
``io`` (savers, loaders, ``save_inference_model`` and the program's plain
pickle, in the same file format, so that either package loads what the
other wrote), ``inference`` (``Predictor``, ``clone``, the exported
predictor with its batch buckets and ``swap_state``), ``metrics``,
``compiler`` (``CompiledProgram`` at one device) and ``serving.lattice``.

Tolerances: weights saved and loaded bit for bit; predictions of the same
weights through the two packages, or through the port's Predictor and its
exported predictor, to 1e-5 of the largest magnitude (f32; the two
frameworks sum the convolutions in other orders); the metrics exactly.

The exported predictor captures CUDA graphs only on the card; here its
module runs on the CPU, the route the CPU tests take.

``Program._prune`` walks the global block only, in the JAX package and so
in the port: a var that only a ``while`` body reads is pruned with its
producer, and the saved model fails in the same way in both
(``test_prune_drops_a_var_only_a_while_body_reads_in_both``; ROADMAP
Queue 3 logs it as a fault of the reference).
"""

import os
import pickle
import pickletools

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu.models import lenet as jlenet
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import lenet as plenet
from paddle_tpu_torch.serving import RequestTooLarge
from paddle_tpu_torch.tools import programs

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max(initial=0.0)
    scale = max(np.abs(want).max(initial=0.0), 1e-30)
    assert err <= tol * scale, "%s: %.3g of %.3g" % (what, err, scale)


def lenet(fluid, opt="sgd"):
    models = plenet if fluid is pfluid else jlenet
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[1, 28, 28], dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        pred, loss, acc = models.build_lenet(img, label)
        {"sgd": lambda: fluid.optimizer.SGD(0.05),
         "adam": lambda: fluid.optimizer.Adam(1e-3)}[opt]().minimize(loss)
    return main, startup, {"img": img, "label": label, "pred": pred,
                           "loss": loss, "acc": acc}


def images(seed, n):
    return np.random.RandomState(seed).rand(n, 1, 28, 28).astype("f4")


def cpu_predictor(dirname, fluid=pfluid):
    config = fluid.inference.AnalysisConfig(dirname)
    config.disable_gpu()
    return fluid.inference.create_predictor(config)


@pytest.fixture(scope="module")
def jax_lenet_dir(tmp_path_factory):
    """LeNet + Adam built by the JAX package, started, trained two steps and
    saved with its save_inference_model."""
    d = str(tmp_path_factory.mktemp("jax_lenet"))
    main, startup, v = lenet(jfluid, "adam")
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        for s in range(2):
            exe.run(main, feed={"img": images(s, 8),
                                "label": np.arange(8).reshape(8, 1) % 10},
                    fetch_list=[v["loss"]])
        jfluid.io.save_inference_model(d, ["img"], [v["pred"]], exe, main)
    return d


@pytest.fixture(scope="module")
def port_lenet(tmp_path_factory):
    """The port's LeNet + Adam from its own startup run, saved by its
    save_inference_model; returns (dir, main, scope, vars)."""
    d = str(tmp_path_factory.mktemp("port_lenet"))
    main, startup, v = lenet(pfluid, "adam")
    exe, scope = pfluid.Executor(pfluid.CPUPlace()), pfluid.Scope()
    with pfluid.scope_guard(scope):
        exe.run(startup)
        exe.run(main, feed={"img": images(0, 8),
                            "label": np.arange(8).reshape(8, 1) % 10},
                fetch_list=[v["loss"]])
        pfluid.io.save_inference_model(d, ["img"], [v["pred"]], exe, main)
    return d, main, scope, v


# -- io -------------------------------------------------------------------------

@pytest.mark.parametrize("saver,filename", [
    ("save_persistables", None), ("save_persistables", "__all__.npz"),
    ("save_params", None), ("save_params", "params.npz")])
def test_save_load_round_trips_bit_exact(saver, filename, port_lenet, tmp_path):
    _, main, scope, _ = port_lenet
    exe = pfluid.Executor(pfluid.CPUPlace())
    with pfluid.scope_guard(scope):
        getattr(pfluid.io, saver)(exe, str(tmp_path), main, filename=filename)
    fresh = pfluid.Scope()
    getattr(pfluid.io, saver.replace("save", "load"))(
        exe, str(tmp_path), main, filename=filename, scope=fresh)
    pred = (lambda v: isinstance(v, pfluid.Parameter)) if saver == "save_params" \
        else (lambda v: v.persistable and not v.is_data)
    names = [v.name for v in main.list_vars() if pred(v)]
    assert len(names) >= 6 and sorted(fresh.local_var_names()) == sorted(names)
    for n in names:
        a, b = scope.find_var(n), fresh.find_var(n)
        assert a.dtype == b.dtype and torch.equal(a, b), n
    # the JAX package reads the same files
    jscope = jfluid.Scope()
    getattr(jfluid.io, saver.replace("save", "load"))(
        None, str(tmp_path), lenet(jfluid, "adam")[0], filename=filename,
        scope=jscope)
    for n in names:
        np.testing.assert_array_equal(np.asarray(jscope.find_var(n)),
                                      scope.find_tensor_as_numpy(n))


def test_fluid_save_and_load_and_a_missing_var_raises(port_lenet, tmp_path):
    _, main, scope, _ = port_lenet
    path = str(tmp_path / "ckpt")
    with pfluid.scope_guard(scope):
        assert pfluid.save(main, path) == path + ".pdparams"
    fresh = pfluid.Scope()
    with pfluid.scope_guard(fresh):
        pfluid.load(main, path)
    persist = [v.name for v in main.list_vars() if v.persistable]
    for n in persist:
        assert torch.equal(fresh.find_var(n), scope.find_var(n)), n
    # the JAX package's load of the same file, and of a var it lacks
    jmain = lenet(jfluid, "adam")[0]
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.load(jmain, path)
    for n in persist:
        np.testing.assert_array_equal(np.asarray(jscope.find_var(n)),
                                      scope.find_tensor_as_numpy(n))
    for fluid, prog in ((pfluid, lenet(pfluid, "adam")[0]), (jfluid, jmain)):
        extra = prog.global_block().create_var(name="not_saved", shape=(2,),
                                               dtype="float32", persistable=True)
        with pytest.raises(RuntimeError, match=r"\['not_saved'\] not found"):
            fluid.load(prog, path)
        prog.global_block().vars.pop(extra.name)


def test_bf16_persistable_save_raises(tmp_path):
    scope = pfluid.Scope()
    main = pfluid.Program()
    main.global_block().create_var(name="w", shape=(2,), dtype="bfloat16",
                                   persistable=True)
    scope.var("w")
    scope.set("w", torch.ones(2, dtype=torch.bfloat16))
    with pfluid.scope_guard(scope):
        with pytest.raises(NotImplementedError, match="amp.py"):
            pfluid.io.save_persistables(None, str(tmp_path), main)
        with pytest.raises(NotImplementedError, match="amp.py"):
            pfluid.save(main, str(tmp_path / "ckpt"))


def _has_class_reference(path):
    with open(path, "rb") as f:
        return any(op.name in ("GLOBAL", "STACK_GLOBAL", "INST", "OBJ")
                   for op, _, _ in pickletools.genops(f.read()))


def test_model_file_is_plain_data_and_matches_jax(jax_lenet_dir, port_lenet):
    pdir = port_lenet[0]
    for d in (jax_lenet_dir, pdir):
        assert not _has_class_reference(os.path.join(d, "__model__"))
    with open(os.path.join(jax_lenet_dir, "__model__"), "rb") as f:
        jdesc = pickle.load(f)
    with open(os.path.join(pdir, "__model__"), "rb") as f:
        pdesc = pickle.load(f)
    assert pdesc["feed_names"] == jdesc["feed_names"] == ["img"]
    assert pdesc["fetch_names"] == jdesc["fetch_names"]
    jops, pops = (d["program"]["blocks"][0]["ops"] for d in (jdesc, pdesc))
    assert [o["type"] for o in pops] == [o["type"] for o in jops] == [
        "conv2d", "elementwise_add", "relu", "pool2d"] * 2 + [
        "mul", "elementwise_add", "softmax"]
    assert pops == jops
    assert pdesc["program"]["blocks"][0]["vars"] == jdesc["program"]["blocks"][0]["vars"]
    with np.load(os.path.join(pdir, "__params__.npz")) as p, \
            np.load(os.path.join(jax_lenet_dir, "__params__.npz")) as j:
        assert sorted(p.files) == sorted(j.files)


def test_sparse_shards_round_trip_across_packages(tmp_path):
    rng = np.random.RandomState(0)
    rows = rng.choice(1000, 37, replace=False).astype(np.int64)
    arrays = {"w": rng.randn(37, 4).astype("f4"), "m": rng.randn(37, 4).astype("f4")}
    for save, load in ((pfluid.io, jfluid.io), (jfluid.io, pfluid.io)):
        d = str(tmp_path / save.__name__)
        assert save.save_sparse_shards(d, "emb", rows, arrays, {"dim": 4},
                                       rows_per_shard=16) == 3
        assert load.load_sparse_meta(d, "emb")["meta"] == {"dim": 4}
        got = list(load.load_sparse_shards(d, "emb"))
        np.testing.assert_array_equal(np.concatenate([r for r, _ in got]), rows)
        for k in arrays:
            np.testing.assert_array_equal(
                np.concatenate([a[k] for _, a in got]), arrays[k])


# -- Predictor ---------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 5])
def test_jax_saved_lenet_served_by_the_port(jax_lenet_dir, batch):
    x = images(10 + batch, batch)
    port = cpu_predictor(jax_lenet_dir)
    jax_ = cpu_predictor(jax_lenet_dir, jfluid)
    assert port.get_input_names() == jax_.get_input_names() == ["img"]
    assert port.get_output_names() == jax_.get_output_names()
    (got,) = port.run([x])
    (want,) = jax_.run({"img": x})
    close(got, np.asarray(want), TOL, "prediction")
    assert got.shape == (batch, 10)


def test_port_saved_lenet_loaded_by_the_jax_package(port_lenet):
    d, main, scope, v = port_lenet
    x = images(20, 6)
    program, feeds, fetch = jfluid.io.load_inference_model(
        d, jfluid.Executor(jfluid.CPUPlace()), scope=jfluid.Scope())
    assert feeds == ["img"] and [f.name for f in fetch] == [v["pred"].name]
    (want,) = cpu_predictor(d, jfluid).run([x])
    (got,) = cpu_predictor(d).run([x])
    close(got, np.asarray(want), TOL, "prediction")
    # and the port's predictor equals the training program's test clone
    test = pfluid.Executor(pfluid.CPUPlace()).run(
        main.clone(for_test=True), feed={"img": x, "label": np.zeros((6, 1), "int64")},
        fetch_list=[v["pred"]], scope=scope)[0]
    close(got, test, 0.0, "test clone")


def test_clone_shares_the_weights_and_the_plans(port_lenet):
    p = cpu_predictor(port_lenet[0])
    c = p.clone()
    assert c._scope is p._scope and c._exe is p._exe
    x = images(30, 3)
    np.testing.assert_array_equal(p.run([x])[0], c.run([x])[0])
    assert len(p._exe._cache) == 1          # one plan for both
    for n in p._scope.local_var_names():
        assert c._scope.find_var(n).data_ptr() == p._scope.find_var(n).data_ptr()
    c2 = c.clone()
    assert c2._scope is p._scope and c2.get_output_names() == p.get_output_names()


# -- the exported predictor -----------------------------------------------------------

@pytest.fixture(scope="module")
def exported(port_lenet, tmp_path_factory):
    """The port's saved LeNet with a poly-batch export beside it."""
    d = port_lenet[0]
    path = pfluid.inference.export_inference_model(
        d, {"img": (1, 1, 28, 28)}, poly_batch=True, device="cpu")
    assert os.path.basename(path) == "__exported__"
    return d


def test_export_writes_the_references_meta(exported):
    with open(os.path.join(exported, "__exported__.meta"), "rb") as f:
        meta = pickle.load(f)
    assert {"feed_names", "fetch_names", "state_names", "feed_shapes",
            "poly"} <= set(meta)
    assert meta["poly"] == {"img": {0: "b"}}
    assert meta["feed_names"] == ["img"] and len(meta["state_names"]) == 6


@pytest.mark.parametrize("batch", [1, 5, 64])
def test_exported_predictor_matches_the_predictor(exported, batch):
    x = images(40 + batch, batch)
    ep = pfluid.inference.load_exported_model(exported, device="cpu")
    assert ep.get_input_names() == ["img"]
    (want,) = cpu_predictor(exported).run([x])
    (got,) = ep.run({"img": x})
    close(got, want, TOL, "exported")
    assert got.shape == (batch, 10)


def test_a_fixed_shape_export_serves_its_shape(port_lenet, tmp_path):
    import shutil

    d = str(tmp_path / "fixed")
    shutil.copytree(port_lenet[0], d)
    pfluid.inference.export_inference_model(d, {"img": (4, 1, 28, 28)},
                                            device="cpu")
    ep = pfluid.inference.load_exported_model(d, device="cpu")
    x = images(50, 4)
    close(ep.run([x])[0], cpu_predictor(d).run([x])[0], TOL, "fixed")
    with pytest.raises(Exception):
        ep.run([images(51, 3)])


def test_buckets_pad_and_slice(exported):
    ep = pfluid.inference.load_exported_model(exported, device="cpu")
    ep.declare_batch_buckets([1, 8, 64])
    x = images(60, 5)
    (got,) = ep.run([x])
    assert got.shape == (5, 10)
    close(got, cpu_predictor(exported).run([x])[0], TOL, "bucketed")
    # the pad rows are zeros: equal, bit for bit, to a run of the padded batch
    padded = np.concatenate([x, np.zeros((3, 1, 28, 28), "f4")])
    np.testing.assert_array_equal(got, ep.run([padded])[0][:5])
    for b in (1, 8, 64):
        ep.ensure_compiled({"img": ((b, 1, 28, 28), "float32")})
    before = ep.compiled_signature_count()
    for n in (1, 2, 7, 8, 9, 33, 64, 3):
        assert ep.run([images(n, n)])[0].shape == (n, 10)
    assert ep.compiled_signature_count() == before
    with pytest.raises(RequestTooLarge):
        ep.run([images(0, 65)])
    with pytest.raises(ValueError, match="strictly ascending"):
        ep.declare_batch_buckets([8, 4])


def test_buckets_refuse_feeds_of_two_leading_dims(port_lenet, tmp_path):
    """A two-feed model whose feeds disagree on the batch cannot pad."""
    d = str(tmp_path / "two")
    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.unique_name.guard(), pfluid.program_guard(main, startup):
        a = pfluid.layers.data("a", shape=[3], dtype="float32")
        b = pfluid.layers.data("b", shape=[3], dtype="float32")
        out = pfluid.layers.fc(pfluid.layers.elementwise_add(a, b), 2)
    exe, scope = pfluid.Executor(pfluid.CPUPlace()), pfluid.Scope()
    with pfluid.scope_guard(scope):
        exe.run(startup)
        pfluid.io.save_inference_model(d, ["a", "b"], [out], exe, main)
    pfluid.inference.export_inference_model(
        d, {"a": (2, 3), "b": (2, 3)}, poly_batch=True, device="cpu")
    ep = pfluid.inference.load_exported_model(d, device="cpu")
    x = np.ones((3, 3), "f4")
    close(ep.run({"a": x, "b": x})[0], cpu_predictor(d).run({"a": x, "b": x})[0],
          TOL, "two feeds")
    ep.declare_batch_buckets([4])
    with pytest.raises(ValueError, match="share one leading dim"):
        ep.run({"a": x, "b": np.ones((2, 3), "f4")})


def test_signatures_are_shared_by_predictors_over_one_artifact(exported):
    a = pfluid.inference.load_exported_model(exported, device="cpu")
    b = pfluid.inference.load_exported_model(exported, device="cpu")
    a.run([images(70, 11)])
    n = b.compiled_signature_count()
    assert n == a.compiled_signature_count() >= 1
    b.run([images(71, 11)])
    assert a.compiled_signature_count() == n
    assert a.ensure_compiled({"img": ((11, 1, 28, 28), "float32")}) == ("cached", None)
    assert b.ensure_compiled({"img": ((13, 1, 28, 28), "float32")})[0] == "compiled"
    assert a.compiled_signature_count() == n + 1


def test_swap_state(exported, port_lenet):
    _, main, scope, v = port_lenet
    ep = pfluid.inference.load_exported_model(exported, device="cpu")
    other = pfluid.inference.load_exported_model(exported, device="cpu")
    x = images(80, 4)
    before = ep.run([x])[0]
    state = {n: t.clone() for n, t in ep._state.items()}
    w = next(n for n in state if ".w_" in n)
    with pytest.raises(KeyError, match="missing weight"):
        ep.swap_state({n: t for n, t in state.items() if n != w})
    with pytest.raises(ValueError, match="signature change cannot hot-swap"):
        ep.swap_state({**state, w: torch.zeros(3, 3)})
    with pytest.raises(ValueError, match="signature change cannot hot-swap"):
        ep.swap_state({**state, w: state[w].double()})
    np.testing.assert_array_equal(ep.run([x])[0], before)   # nothing moved
    count = ep.compiled_signature_count()
    new = {n: (t * 0.5).numpy() for n, t in state.items()}
    new["unused_extra"] = np.zeros(1)
    assert ep.swap_state(new) == len(state)
    # the answers are the new weights' (the scaled weights through the
    # executor), the other predictor keeps its own
    sc = convert.scope_from_numpy({n: a for n, a in new.items() if n in state},
                                  pfluid.Scope(), "cpu")
    test = main.clone(for_test=True)
    want = pfluid.Executor(pfluid.CPUPlace()).run(
        test, feed={"img": x, "label": np.zeros((4, 1), "int64")},
        fetch_list=[v["pred"]], scope=sc)[0]
    close(ep.run([x])[0], want, TOL, "swapped")
    assert np.abs(ep.run([x])[0] - before).max() > 1e-3
    np.testing.assert_array_equal(other.run([x])[0], before)
    assert ep.compiled_signature_count() == count


def test_export_of_a_program_with_sub_blocks_raises(tmp_path):
    d = str(tmp_path / "decode")
    main, startup, v = programs.while_beam_decode(pfluid, 3, 2, 2, 5)
    exe, scope = pfluid.Executor(pfluid.CPUPlace()), pfluid.Scope()
    with pfluid.scope_guard(scope):
        exe.run(startup)
        pfluid.io.save_inference_model(d, ["lp", "ps", "pi"], [v["sent"]],
                                       exe, main)
    with pytest.raises(NotImplementedError, match="export of sub-blocks"):
        pfluid.inference.export_inference_model(
            d, {"lp": (3, 2, 2, 5), "ps": (2, 2), "pi": (2, 2)}, device="cpu")


def test_warm_dir_raises(exported, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_WARM_DIR", str(exported))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 8"):
        pfluid.inference.load_exported_model(exported, device="cpu")


def test_entry_points_run_on_the_card_or_raise(exported, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = pfluid.inference.AnalysisConfig(exported)
    assert config.use_gpu and config.use_tpu
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pfluid.inference.create_predictor(config)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pfluid.inference.load_exported_model(exported)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pfluid.inference.export_inference_model(exported, {"img": (1, 1, 28, 28)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pfluid.Executor()
    config.use_tpu = False
    assert not config.use_gpu
    assert pfluid.inference.create_predictor(config)._exe.device.type == "cpu"


# -- programs with sub-blocks through save_inference_model ---------------------------

def test_beam_decode_saves_and_serves_in_both(tmp_path):
    """A loop whose closure reads are feeds keeps them through _prune: the
    saved decode serves the same sentences as the program it came from."""
    T, B, K, V = 4, 2, 3, 6
    rng = np.random.RandomState(4)
    feed = {"lp": np.exp(rng.randn(T, B, K, V) * 0.5 - 1.0).astype("f4"),
            "ps": (np.where(np.arange(K)[None] == 0, 0.0, -1e9)
                   * np.ones((B, 1))).astype("f4"),
            "pi": np.full((B, K), -1, "i4")}
    got = {}
    for fluid in (jfluid, pfluid):
        d = str(tmp_path / fluid.__name__)
        main, startup, v = programs.while_beam_decode(fluid, T, B, K, V)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            direct = exe.run(main, feed=feed, fetch_list=[v["sent"]])[0]
            fluid.io.save_inference_model(d, ["lp", "ps", "pi"], [v["sent"]],
                                          exe, main)
        served = cpu_predictor(d, fluid).run(feed)[0]
        np.testing.assert_array_equal(np.asarray(served), np.asarray(direct))
        got[fluid] = np.asarray(served)
    np.testing.assert_array_equal(got[pfluid], got[jfluid])


def _prune_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[3], dtype="float32",
                              append_batch_size=False)
        k = fluid.layers.scale(x, 2.0)
        acc = fluid.layers.fill_constant([3], "float32", 0.0)
        i = fluid.layers.fill_constant([1], "int64", 0)
        n = fluid.layers.fill_constant([1], "int64", 4)
        c = fluid.layers.less_than(i, n)
        w = fluid.layers.While(c)
        with w.block():
            fluid.layers.assign(acc + k, acc)
            fluid.layers.increment(i)
            fluid.layers.less_than(i, n, cond=c)
    return main, startup, acc


def test_prune_drops_a_var_only_a_while_body_reads_in_both(tmp_path):
    """The reference's fault, kept in the port: _prune walks the global
    block, so the scale op that only the loop body reads is dropped and the
    saved model fails in the loop body in both packages."""
    feed = {"x": np.array([0.0, 1.0, 2.0], "f4")}
    for fluid in (jfluid, pfluid):
        d = str(tmp_path / fluid.__name__)
        main, startup, acc = _prune_program(fluid)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            (direct,) = exe.run(main, feed=feed, fetch_list=[acc])
            np.testing.assert_array_equal(np.asarray(direct), [0.0, 8.0, 16.0])
            fluid.io.save_inference_model(d, ["x"], [acc], exe, main)
            program, _, fetch = fluid.io.load_inference_model(d, exe)
            assert [op.type for op in program.global_block().ops] == [
                "fill_constant"] * 3 + ["less_than", "while"]
            with pytest.raises(fluid.enforce.EnforceNotMet,
                               match="op 'elementwise_add' failed during lowering"):
                exe.run(program, feed=feed, fetch_list=fetch)


# -- metrics ----------------------------------------------------------------------

def _metric_runs(metrics):
    rng = np.random.RandomState(0)
    out = []
    acc = metrics.Accuracy()
    for _ in range(3):
        acc.update(float(rng.rand()), weight=float(rng.randint(1, 9)))
    out.append(acc.eval())
    preds = rng.rand(50, 1)
    labels = (rng.rand(50, 1) > 0.5).astype("int64")
    for cls in (metrics.Precision, metrics.Recall):
        m = cls()
        m.update(preds, labels)
        m.update(preds[::-1], labels)
        out.append(m.eval())
    auc = metrics.Auc(num_thresholds=200)
    auc.update(np.concatenate([1 - preds, preds], 1), labels)
    out.append(auc.eval())
    comp = metrics.CompositeMetric()
    comp.add_metric(metrics.Precision())
    comp.add_metric(metrics.Recall())
    comp.update(preds, labels)
    out.append(comp.eval())
    chunk = metrics.ChunkEvaluator()
    chunk.update(10, 12, 7)
    chunk.update(5, 4, 3)
    out.append(chunk.eval())
    ed = metrics.EditDistance()
    ed.update(np.array([[0.0], [2.0], [1.0]]), 3)
    ed.update(np.array([[4.0]]), 1)
    out.append(ed.eval())
    for version in ("integral", "11point"):
        dm = metrics.DetectionMAP(ap_version=version)
        dm.update([[0, 0.9, 0, 0, 10, 10], [1, 0.8, 5, 5, 15, 15],
                   [0, 0.3, 20, 20, 30, 30], [-1, 0, 0, 0, 0, 0]],
                  [[0, 0, 10, 10], [6, 6, 15, 15]], [0, 1])
        dm.update([[0, 0.7, 1, 1, 9, 9]], [[0, 0, 10, 10], [40, 40, 50, 50]],
                  [0, 1], [False, True])
        out.append(dm.eval())
    return out


def test_metrics_match_the_jax_package_exactly():
    got, want = _metric_runs(pfluid.metrics), _metric_runs(jfluid.metrics)
    assert len(got) == 9
    for g, w in zip(got, want):
        if isinstance(w, tuple) or isinstance(w, list):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_lattice_routes_as_the_jax_package():
    from paddle_tpu.serving.lattice import BucketLattice as JaxLattice
    from paddle_tpu_torch.serving import BucketLattice

    for args in (([1, 8, 64],), ([4, 16], [32, 128])):
        p, j = BucketLattice(*args), JaxLattice(*args)
        assert p.points() == j.points() and len(p) == len(j)
        assert p.describe() == j.describe()
        for rows in (1, 3, 8, 9, 16):
            if rows <= j.max_batch:
                seq = 40 if j.seq_buckets else None
                assert p.route(rows, seq) == j.route(rows, seq)


# -- compiler ------------------------------------------------------------------------

def test_one_device_compiled_program_matches_the_plain_program():
    """One SGD step through CompiledProgram(main).with_data_parallel and one
    through main itself, from the same weights: equal, bit for bit."""
    main, startup, v = lenet(pfluid, "sgd")
    exe = pfluid.Executor(pfluid.CPUPlace())
    init = pfluid.Scope()
    exe.run(startup, scope=init)
    names = [x.name for x in startup.list_vars() if x.persistable]
    values = convert.scope_to_numpy(init, names)
    params = [p.name for p in main.all_parameters()]
    feed = {"img": images(90, 16), "label": np.arange(16).reshape(16, 1) % 10}
    compiled = pfluid.CompiledProgram(main).with_data_parallel(
        loss_name=v["loss"].name, places=[pfluid.CPUPlace()],
        build_strategy=pfluid.BuildStrategy(),
        exec_strategy=pfluid.ExecutionStrategy())
    runs = []
    for prog in (main, compiled):
        scope = convert.scope_from_numpy(values, pfluid.Scope(), "cpu")
        out = exe.run(prog, feed=feed, fetch_list=[v["loss"]] + [
            p + "@GRAD" for p in params], scope=scope)
        runs.append((out, convert.scope_to_numpy(scope, params)))
    for a, b in zip(runs[0][0], runs[1][0]):
        np.testing.assert_array_equal(a, b)
    for n in params:
        np.testing.assert_array_equal(runs[0][1][n], runs[1][1][n])
    assert not np.array_equal(runs[0][1][params[0]], values[params[0]])


@pytest.mark.parametrize("case", ["two_places", "mesh", "trainers",
                                  "tensor_parallel", "sync_bn", "changed_later"])
def test_compiled_program_refuses_other_layouts(case):
    main, startup, v = lenet(pfluid, "sgd")
    cp = pfluid.CompiledProgram(main)
    bs = pfluid.BuildStrategy()
    kw = {"loss_name": v["loss"].name, "build_strategy": bs}
    if case == "two_places":
        kw["places"] = [pfluid.CUDAPlace(0), pfluid.CUDAPlace(1)]
    if case == "mesh":
        kw["mesh"] = object()
    if case == "trainers":
        bs.num_trainers = 2
    if case == "tensor_parallel":
        bs.tensor_parallel_degree = 2
    if case == "sync_bn":
        bs.sync_batch_norm = True
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 5"):
        if case == "changed_later":
            cp.with_data_parallel(**kw)
            bs.num_trainers = 4
            exe, scope = pfluid.Executor(pfluid.CPUPlace()), pfluid.Scope()
            exe.run(startup, scope=scope)
            exe.run(cp, feed={"img": images(0, 2),
                              "label": np.zeros((2, 1), "int64")},
                    fetch_list=[v["loss"]], scope=scope)
        else:
            cp.with_data_parallel(**kw)
