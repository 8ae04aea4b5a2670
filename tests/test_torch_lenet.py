"""The port's Fluid program mode against the JAX package's on the CPU: the
book's LeNet (``models/lenet.py``, BASELINE config 1) and MLP, built with
``import paddle_tpu_torch as fluid`` and with ``import paddle_tpu as
fluid``, run through each package's ``Executor(CPUPlace())``.

Both sides start from the same weights: the JAX package's startup program
runs, its persistables are read out as numpy
(``Scope.find_tensor_as_numpy``) and loaded into the port's scope
(``convert.scope_from_numpy``).  The port does not reproduce ``jax.random``
streams; its own initializers are held to their stated moments instead.

Tolerances, f32, relative to the largest magnitude of the JAX value: the
loss, the accuracy and every ``<param>@GRAD`` after one step to 1e-5; the
parameters after 5 SGD steps to 1e-5; the test clone's fetches to 1e-5.
One Adam step moves a parameter by about lr * sign(g) wherever |g| is well
above epsilon, so where rounding differences flip the sign of a tiny
gradient the two sides part by up to 2 * lr: Adam's parameters are held to
1e-6 (absolute) where |g| > 1e-5 and to 2 * lr elsewhere, and the count of
the latter is printed.  Integer feeds and outputs: with x64 off JAX holds
the int64 label as int32; the port keeps int64, so values are compared,
not dtypes.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu.models import lenet as jlenet
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import lenet as plenet

REL_TOL = 1e-5
ADAM_LR, ADAM_TOL, ADAM_SMALL_G = 1e-3, 1e-6, 1e-5
SGD_LR, SGD_STEPS, B = 0.05, 5, 16


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Tiny ops: with a team of intra-op threads, test processes side by
    side wait on each other's spinning threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OPTIMIZERS = {
    "sgd": lambda fluid: fluid.optimizer.SGD(SGD_LR),
    "adam": lambda fluid: fluid.optimizer.Adam(ADAM_LR),
    "momentum": lambda fluid: fluid.optimizer.Momentum(0.01, 0.9),
}


def build(fluid, model="lenet", opt="sgd"):
    """(main, startup, {"pred", "loss", "acc"}) of the book's model with an
    optimizer, names from a fresh generator."""
    models = plenet if fluid is pfluid else jlenet
    fn = models.build_lenet if model == "lenet" else models.build_mlp
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[1, 28, 28], dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        pred, loss, acc = fn(img, label)
        if opt is not None:
            OPTIMIZERS[opt](fluid).minimize(loss)
    return main, startup, {"pred": pred, "loss": loss, "acc": acc}


def digits(seed, n=B):
    """The JAX package's convergence batch (tests/test_models.py): a bright
    (k+2) x (k+2) corner square marks digit k."""
    rng = np.random.RandomState(seed)
    ys = rng.randint(0, 10, (n, 1)).astype("int64")
    xs = rng.rand(n, 1, 28, 28).astype("f4") * 0.1
    for i, k in enumerate(ys[:, 0]):
        xs[i, 0, :k + 2, :k + 2] += 1.0
    return {"img": xs, "label": ys}


def start_both(model="lenet", opt="sgd"):
    """Both packages' programs, the JAX startup run, its persistables
    carried into a port scope.  Returns (jax side, port side), each
    (executor, scope, main, vars)."""
    jmain, jstart, jvars = build(jfluid, model, opt)
    pmain, pstart, pvars = build(pfluid, model, opt)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    names = [v.name for v in jstart.list_vars() if v.persistable]
    values = convert.scope_to_numpy(jscope, names)
    pscope = convert.scope_from_numpy(values, pfluid.Scope(), "cpu")
    pexe = pfluid.Executor(pfluid.CPUPlace())
    return (jexe, jscope, jmain, jvars), (pexe, pscope, pmain, pvars)


def close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max(initial=0.0)
    scale = max(np.abs(want).max(initial=0.0), 1e-30)
    assert err <= tol * scale, "%s: %.3g of %.3g" % (what, err, scale)


@pytest.mark.parametrize("model,opt", [("lenet", "sgd"), ("lenet", "adam"),
                                       ("lenet", "momentum"), ("mlp", "adam")])
def test_programs_match_the_jax_package(model, opt):
    jmain, jstart, _ = build(jfluid, model, opt)
    pmain, pstart, _ = build(pfluid, model, opt)
    for jp, pp in ((jmain, pmain), (jstart, pstart)):
        jb, pb = jp.global_block(), pp.global_block()
        assert [op.type for op in pb.ops] == [op.type for op in jb.ops]
        for jo, po in zip(jb.ops, pb.ops):
            assert (po.inputs, po.outputs, po.attrs) == (jo.inputs, jo.outputs, jo.attrs)
        assert sorted(pb.vars) == sorted(jb.vars)
        for n, jv in jb.vars.items():
            pv = pb.vars[n]
            assert (pv.shape, pv.dtype, pv.persistable, pv.stop_gradient,
                    type(pv).__name__) == (jv.shape, jv.dtype, jv.persistable,
                                           jv.stop_gradient, type(jv).__name__), n
    lenet_ops = ["conv2d", "elementwise_add", "relu", "pool2d"] * 2 + [
        "mul", "elementwise_add", "softmax", "cross_entropy", "mean", "top_k",
        "accuracy", "backward_meta"]
    if model == "lenet":
        assert [op.type for op in pmain.global_block().ops][:16] == lenet_ops


@pytest.fixture(scope="module")
def sgd_runs():
    """SGD_STEPS steps of LeNet + SGD on both sides from the same weights:
    per step the loss, the accuracy, every gradient and every parameter."""
    (jexe, jscope, jmain, jv), (pexe, pscope, pmain, pv) = start_both()
    params = [p.name for p in pmain.all_parameters()]
    fetch = [jv["loss"].name, jv["acc"].name] + [p + "@GRAD" for p in params]
    runs = {"jax": [], "port": [], "params": params}
    for step in range(SGD_STEPS):
        feed = digits(step)
        for key, exe, main, scope in (("jax", jexe, jmain, jscope),
                                      ("port", pexe, pmain, pscope)):
            out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            runs[key].append({"fetch": out, "params": convert.scope_to_numpy(
                scope, params)})
    return runs


def test_one_step_loss_accuracy_and_gradients_match_jax(sgd_runs):
    jf, pf = sgd_runs["jax"][0]["fetch"], sgd_runs["port"][0]["fetch"]
    names = ["loss", "acc"] + [p + "@GRAD" for p in sgd_runs["params"]]
    assert len(names) == 2 + 6          # two convs and the fc, w and b
    for name, j, p in zip(names, jf, pf):
        close(p, j, REL_TOL, name)
    assert np.isfinite(pf[0]) and 0.0 <= pf[1] <= 1.0


def test_sgd_trajectory_matches_jax(sgd_runs):
    for step in range(SGD_STEPS):
        jp, pp = sgd_runs["jax"][step]["params"], sgd_runs["port"][step]["params"]
        for name in sgd_runs["params"]:
            close(pp[name], jp[name], REL_TOL, "step %d %s" % (step, name))
        close(sgd_runs["port"][step]["fetch"][0],
              sgd_runs["jax"][step]["fetch"][0], REL_TOL, "step %d loss" % step)


def test_one_adam_step_matches_jax():
    (jexe, jscope, jmain, jv), (pexe, pscope, pmain, pv) = start_both(opt="adam")
    params = [p.name for p in pmain.all_parameters()]
    fetch = [jv["loss"].name] + [p + "@GRAD" for p in params]
    feed = digits(7)
    jout = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
    pout = pexe.run(pmain, feed=feed, fetch_list=fetch, scope=pscope)
    close(pout[0], jout[0], REL_TOL, "loss")
    small = 0
    for name, jg in zip(params, jout[1:]):
        jp = jscope.find_tensor_as_numpy(name)
        pp = pscope.find_tensor_as_numpy(name)
        err = np.abs(pp.astype(np.float64) - jp)
        big = np.abs(jg) > ADAM_SMALL_G
        assert (err[big] <= ADAM_TOL).all(), (name, err[big].max())
        assert (err[~big] <= 2 * ADAM_LR).all(), (name, err[~big].max())
        small += int((~big).sum())
    for name in ("beta1_pow_acc", "beta2_pow_acc", "moment1", "moment2"):
        for n in [v.name for v in pmain.list_vars() if name in v.name]:
            close(pscope.find_tensor_as_numpy(n), jscope.find_tensor_as_numpy(n),
                  REL_TOL, n)
    print("adam: %d of %d parameter elements have |g| <= %g"
          % (small, sum(pscope.find_var(p).numel() for p in params), ADAM_SMALL_G))


def test_test_clone_fetches_match_jax():
    (jexe, jscope, jmain, jv), (pexe, pscope, pmain, pv) = start_both()
    jtest, ptest = jmain.clone(for_test=True), pmain.clone(for_test=True)
    assert [op.type for op in ptest.global_block().ops] == [
        op.type for op in jtest.global_block().ops]
    assert "sgd" not in [op.type for op in ptest.global_block().ops]
    fetch = [jv[k].name for k in ("loss", "acc", "pred")]
    feed = digits(100, n=32)                 # held out: seeds 0-9 train
    jout = jexe.run(jtest, feed=feed, fetch_list=fetch, scope=jscope)
    pout = pexe.run(ptest, feed=feed, fetch_list=fetch, scope=pscope)
    for name, j, p in zip(("loss", "acc", "pred"), jout, pout):
        close(p, j, REL_TOL, name)
    # the test program trained nothing
    for p in pmain.all_parameters():
        close(pscope.find_tensor_as_numpy(p.name),
              jscope.find_tensor_as_numpy(p.name), 0.0, p.name)


def test_stop_gradient_var_blocks_the_gradient_as_in_jax():
    """A non-persistable var marked stop_gradient is cut from autograd where
    the executor writes it (the JAX executor's lax.stop_gradient at the same
    place): the layer below it gets a zero gradient on both sides."""
    def build_sg(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[6], dtype="float32")
            h = fluid.layers.fc(x, 5, act="tanh")
            h.stop_gradient = True
            loss = fluid.layers.mean(fluid.layers.fc(h, 3))
            fluid.optimizer.SGD(0.1).minimize(loss)
        return main, startup, loss

    jmain, jstart, jloss = build_sg(jfluid)
    pmain, _, _ = build_sg(pfluid)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    names = [v.name for v in jstart.list_vars() if v.persistable]
    pscope = convert.scope_from_numpy(convert.scope_to_numpy(jscope, names),
                                      pfluid.Scope(), "cpu")
    params = [p.name for p in pmain.all_parameters()]
    fetch = [jloss.name] + [p + "@GRAD" for p in params]
    feed = {"x": np.random.RandomState(3).randn(4, 6).astype("f4")}
    jout = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
    pout = pfluid.Executor(pfluid.CPUPlace()).run(pmain, feed=feed,
                                                  fetch_list=fetch, scope=pscope)
    for name, j, p in zip(["loss"] + params, jout, pout):
        close(p, j, REL_TOL, name)
    assert not pout[1].any() and not pout[2].any()      # fc_0 below the cut
    assert pout[3].any()


def test_lenet_program_mode_converges():
    """A port copy of tests/test_models.py::test_lenet_program_mode_converges:
    the book contract (test_recognize_digits.py:126-147), accuracy >= 0.9
    within 150 Adam steps on one batch, no NaN."""
    fluid = pfluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[1, 28, 28], dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        pred, loss, acc = plenet.build_lenet(img, label)
        fluid.optimizer.Adam(1e-3).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    batch = digits(0, n=64)
    accs = []
    for i in range(150):
        lv, av = exe.run(main, feed=batch, fetch_list=[loss, acc], scope=scope)
        assert np.isfinite(lv).all(), i
        accs.append(float(np.asarray(av).mean()))
        if accs[-1] >= 0.9:
            break
    assert accs[-1] >= 0.9, accs[-5:]


def test_initializers_draw_their_stated_moments():
    """The port's own startup run: every gaussian_random and uniform_random
    output at its op's mean and std (5 standard errors), uniform draws
    inside [min, max], constants exact, and the same seed the same bits."""
    _, startup, _ = build(pfluid, "lenet", "adam")
    exe = pfluid.Executor(pfluid.CPUPlace())
    scope = pfluid.Scope()
    exe.run(startup, scope=scope)
    again = pfluid.Scope()
    pfluid.Executor(pfluid.CPUPlace()).run(startup, scope=again)
    kinds = set()
    for op in startup.global_block().ops:
        name = op.outputs["Out"][0]
        v = scope.find_tensor_as_numpy(name).astype(np.float64).ravel()
        np.testing.assert_array_equal(v, again.find_tensor_as_numpy(name).ravel())
        a, n = op.attrs, v.size
        kinds.add(op.type)
        if op.type == "fill_constant":
            assert (v == np.float32(a["value"])).all(), name
            continue
        if op.type == "gaussian_random":
            mean, std = a["mean"], a["std"]
        else:
            assert v.min() >= a["min"] and v.max() <= a["max"], name
            mean, std = (a["min"] + a["max"]) / 2, (a["max"] - a["min"]) / 12 ** 0.5
        assert abs(v.mean() - mean) <= 5 * std / n ** 0.5, (name, v.mean(), mean)
        assert abs(v.std() - std) <= 5 * std / (2 * n) ** 0.5 + 1e-12, (name, v.std(), std)
    assert kinds == {"fill_constant", "gaussian_random", "uniform_random"}
    # each random op its own stream
    w = [scope.find_tensor_as_numpy(p.name) for p in startup.all_parameters()
         if ".w_0" in p.name]
    assert len(w) == 3 and not np.allclose(w[0].ravel()[:50], w[1].ravel()[:50])


def test_data_feeder_and_mnist_match_jax():
    from paddle_tpu.datasets import mnist as jmnist
    from paddle_tpu_torch.datasets import mnist as pmnist

    jmain, _, jv = build(jfluid, opt=None)
    pmain, _, pv = build(pfluid, opt=None)
    rows = [r for _, r in zip(range(B), pmnist.train()())]
    jrows = [r for _, r in zip(range(B), jmnist.train()())]
    for (px, py), (jx, jy) in zip(rows, jrows):
        np.testing.assert_array_equal(px, jx)
        assert py == jy
    pfeed = pfluid.DataFeeder(["img", "label"], program=pmain).feed(rows)
    jfeed = jfluid.DataFeeder(["img", "label"], program=jmain).feed(rows)
    for k in ("img", "label"):
        np.testing.assert_array_equal(pfeed[k], jfeed[k])
        assert pfeed[k].dtype == jfeed[k].dtype
    assert pfeed["img"].shape == (B, 1, 28, 28) and pfeed["label"].shape == (B, 1)


def test_executor_runs_on_the_card_or_raises(monkeypatch):
    assert pfluid.Executor(pfluid.CPUPlace()).device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for place in (None, pfluid.CUDAPlace(0), pfluid.TPUPlace()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pfluid.Executor(place)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert pfluid.Executor().device == torch.device("cuda", 0)
    assert pfluid.TPUPlace is pfluid.CUDAPlace


def _unported(case, monkeypatch):
    fluid = pfluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[1, 28, 28], dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        if case == "unported_op":
            img = fluid.layers.layer_norm(img)
        _, loss, _ = plenet.build_mlp(img, label)
        opt = fluid.optimizer.SGD(0.1)
        if case == "pipeline":
            opt = fluid.optimizer.PipelineOptimizer(opt, num_microbatches=2)
        if case == "recompute":
            opt = fluid.optimizer.RecomputeOptimizer(opt)
        opt.minimize(loss)
    if case == "fleet":
        main._fleet_strategy = object()
    if case == "py_reader":
        main._py_readers = [object()]
    if case == "warm_store":
        monkeypatch.setenv("PADDLE_TPU_WARM_DIR", "/nonexistent")
    if case == "compiled_program":
        # a one-device CompiledProgram runs; one asked to span trainers waits
        main = fluid.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
        main._build_strategy.num_trainers = 2
    return main, loss


@pytest.mark.parametrize("case,item", [
    ("pipeline", "item 5"), ("recompute", "item 3"),
    ("fleet", "item 5"), ("py_reader", "item 4"),
    ("warm_store", "item 8"),
    ("compiled_program", "item 5"), ("unported_op", None),
])
def test_unported_branches_raise(case, item, monkeypatch):
    main, loss = _unported(case, monkeypatch)
    exe = pfluid.Executor(pfluid.CPUPlace())
    feed = digits(0, n=2)
    match = ("ROADMAP Queue 1 " + item) if item else "no lowering registered"
    with pytest.raises(NotImplementedError, match=match):
        exe.run(main, feed=feed, fetch_list=[loss], scope=pfluid.Scope())


def test_monitor_env_run_writes_a_timeline(tmp_path, monkeypatch):
    """``PADDLE_TPU_MONITOR=1`` switches the monitor on at the first run (it
    was refused until the monitor was ported): the run succeeds and the
    session writes its timeline into ``PADDLE_TPU_MONITOR_DIR``."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.monitor import session

    main, startup, v = build(pfluid)
    monkeypatch.setenv("PADDLE_TPU_MONITOR", "1")
    monkeypatch.setenv("PADDLE_TPU_MONITOR_DIR", str(tmp_path))
    monkeypatch.setattr(session, "_env_checked", False)
    monitor.disable()
    try:
        exe = pfluid.Executor(pfluid.CPUPlace())
        scope = pfluid.Scope()
        exe.run(startup, scope=scope)
        (lv,) = exe.run(main, feed=digits(0, n=2), fetch_list=[v["loss"]],
                        scope=scope)
        assert np.isfinite(lv).all() and monitor.active() is not None
    finally:
        monitor.disable()
    steps = monitor.read_events(str(tmp_path / "timeline.jsonl"), ev="step")
    assert len(steps) == 2 and steps[-1]["compiled"] is True


def test_dygraph_minimize_raises():
    from paddle_tpu_torch import framework

    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.program_guard(main, startup):
        x = pfluid.layers.data("x", shape=[3], dtype="float32")
        loss = pfluid.layers.mean(pfluid.layers.fc(x, 2))
    with framework._dygraph_guard(object()):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 3"):
            pfluid.optimizer.SGD(0.1).minimize(loss)


def test_missing_state_and_op_errors_name_their_cause():
    main, startup, v = build(pfluid)
    exe = pfluid.Executor(pfluid.CPUPlace())
    with pytest.raises(RuntimeError, match="run the startup program first"):
        exe.run(main, feed=digits(0, 2), fetch_list=[v["loss"]],
                scope=pfluid.Scope())
    scope = pfluid.Scope()
    exe.run(startup, scope=scope)
    bad = digits(0, 2)
    bad["img"] = bad["img"][:, :, :20]        # too small for the fc weight
    with pytest.raises(pfluid.enforce.EnforceNotMet, match="op 'mul' failed"):
        exe.run(main, feed=bad, fetch_list=[v["loss"]], scope=scope)
