"""Program-mode ``PipelineOptimizer`` in the port's executor held to the JAX
package's (``tests/test_pipeline_optimizer.py``'s five cases, and more).

Each program is built on both packages (the same names), the JAX one's
startup run and its parameters carried to the port's scope as numpy; both
executors then run it on the same feeds.  The sync pipeline computes plain
batch SGD: the microbatch gradients summed and scaled by 1/M for a mean
loss (1 for a sum), the optimizer section once, the forward's persistable
outputs (batch norm's running statistics) carried from microbatch to
microbatch.  Data-parallel over a gloo world of 2 (each rank its rows of
every global microbatch), the program computes the one-device run's.

Tolerances: f32 rtol 1e-5 / atol 1e-5 (the JAX test's own); AMP's bf16
forward 0.02 (the JAX test's).
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu.executor import _split_sections as jsplit
from paddle_tpu_torch import convert
from paddle_tpu_torch.executor import _split_sections as psplit

import torch_dp_worker as W
import torch_model_parallel_worker as MW


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(**kw):
    """The program on both packages, JAX's startup run and its state
    carried to a port scope: (jax (main, v, scope), port (main, v, scope),
    the state's names)."""
    jmain, jstart, jv = MW.pipeline_program(jfluid, **kw)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstart, scope=jscope)
    names = sorted(x.name for x in jstart.list_vars() if x.persistable)
    state = convert.scope_to_numpy(jscope, names)
    pmain, _, pv = MW.pipeline_program(pfluid, **kw)
    pscope = convert.scope_from_numpy(state, pfluid.Scope(), "cpu")
    return (jmain, jv, jscope), (pmain, pv, pscope), names


def _train(fluid, main, v, scope, steps, feed=None):
    exe = fluid.Executor(fluid.CPUPlace())
    feed = feed or MW.pipeline_feed()
    return [float(exe.run(main, feed=feed, fetch_list=[v["loss"]],
                          scope=scope)[0]) for _ in range(steps)]


def _state(fluid, scope, names):
    return {n: np.asarray(scope.find_var(n), np.float32)
            if fluid is jfluid else scope.find_tensor_as_numpy(n)
            for n in names}


@pytest.mark.parametrize("kw", [dict(), dict(bn=True), dict(reduce="sum"),
                                dict(microbatches=2)],
                         ids=["mean", "batch_norm", "sum", "two_microbatches"])
def test_pipeline_matches_jax_and_the_unpipelined_program(kw):
    """4 steps: the losses and the state (parameters, running statistics)
    against JAX's pipelined run; without a batch norm (whose statistics
    are a microbatch's), also against the port's unpipelined run."""
    (jmain, jv, jscope), (pmain, pv, pscope), names = _pair(**kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _train(jfluid, jmain, jv, jscope, 4)
    got = _train(pfluid, pmain, pv, pscope, 4)
    np.testing.assert_allclose(got, want, **TOL)
    js, ps = _state(jfluid, jscope, names), _state(pfluid, pscope, names)
    for n in names:
        np.testing.assert_allclose(ps[n], js[n], err_msg=n, **TOL)
    if not kw.get("bn"):
        _, (umain, uv, uscope), _ = _pair(pipelined=False, **{
            k: v for k, v in kw.items() if k != "microbatches"})
        np.testing.assert_allclose(got, _train(pfluid, umain, uv, uscope, 4),
                                   **TOL)


def test_sections_split_at_cuts():
    main, _, v = MW.pipeline_program(pfluid, microbatches=2)
    jmain, _, jv = MW.pipeline_program(jfluid, microbatches=2)
    assert main._pipeline["cut_vars"] == [v["h1"].name, v["h2"].name]
    ops = main.global_block().ops
    bwd = next(i for i, op in enumerate(ops) if op.type == "backward_meta")
    sections = psplit(ops[:bwd], [v["h1"].name, v["h2"].name])
    jops = jmain.global_block().ops
    jbwd = next(i for i, op in enumerate(jops) if op.type == "backward_meta")
    jsections = jsplit(jops[:jbwd], [jv["h1"].name, jv["h2"].name])
    assert len(sections) == 3
    assert [[op.type for op in s] for s in sections] == \
        [[op.type for op in s] for s in jsections]
    assert v["h1"].name in sections[0][-1].output_arg_names
    assert v["h2"].name in sections[1][-1].output_arg_names
    with pytest.raises(ValueError, match="not produced"):
        psplit(ops[:bwd], ["nonexistent_var"])


def test_bad_microbatch_divisor_raises():
    _, (pmain, pv, pscope), _ = _pair()
    with pytest.raises(ValueError, match="does not divide into 4"):
        _train(pfluid, pmain, pv, pscope, 1, feed=MW.pipeline_feed(n=30))


def test_pipeline_with_amp_bf16():
    """bf16 microbatch forwards with f32 masters: step 0 near the f32
    pipeline's and JAX's AMP run's, and the loss halves, as JAX's test
    holds its own (10 steps: the trajectory overshoots before settling)."""
    (jmain, jv, jscope), (pmain, pv, pscope), _ = _pair(amp=True)
    _, (fmain, fv, fscope), _ = _pair()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _train(jfluid, jmain, jv, jscope, 10)
    bf16 = _train(pfluid, pmain, pv, pscope, 10)
    f32 = _train(pfluid, fmain, fv, fscope, 1)
    assert all(np.isfinite(bf16))
    np.testing.assert_allclose(bf16[0], f32[0], rtol=0.02, atol=0.02)
    np.testing.assert_allclose(bf16[0], want[0], rtol=0.02, atol=0.02)
    assert bf16[-1] < bf16[0] * 0.5 and want[-1] < want[0] * 0.5


def test_pipeline_amp_keeps_f32_masters():
    _, (pmain, pv, pscope), _ = _pair(amp=True, microbatches=2)
    _train(pfluid, pmain, pv, pscope, 1)
    assert pscope.find_tensor_as_numpy("w1").dtype == np.float32


def test_intermediate_fetch_is_refused():
    _, (pmain, pv, pscope), _ = _pair()
    exe = pfluid.Executor(pfluid.CPUPlace())
    with pytest.raises(NotImplementedError, match="per-microbatch forward "
                                                  "intermediates"):
        exe.run(pmain, feed=MW.pipeline_feed(), fetch_list=[pv["h1"]],
                scope=pscope)


def test_pipeline_with_recompute_raises_naming_item_3():
    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.unique_name.guard(), pfluid.program_guard(main, startup):
        x = pfluid.layers.data("x", shape=[16], dtype="float32")
        h = pfluid.layers.fc(x, 4)
        loss = pfluid.layers.mean(h)
        inner = pfluid.optimizer.RecomputeOptimizer(pfluid.optimizer.SGD(0.1))
        inner._set_checkpoints([h])
        pfluid.optimizer.PipelineOptimizer(
            inner, cut_list=[[h]], num_microbatches=2).minimize(loss)
    assert main._pipeline is not None
    exe = pfluid.Executor(pfluid.CPUPlace())
    exe.run(startup)
    with pytest.raises(NotImplementedError, match="item 3"):
        exe.run(main, feed={"x": np.ones((4, 16), "f4")}, fetch_list=[loss])


def test_pipeline_under_data_parallelism_matches_jax(tmp_path):
    """JAX's executor runs a pipelined program under ``with_data_parallel``
    as its one-device pipelined run (GSPMD); two gloo ranks of the port,
    each keeping its rows of every global microbatch, compute the same
    (with a batch norm, whose statistics are a microbatch's)."""
    (jmain, jv, jscope), (_, _, pscope), names = _pair(bn=True)
    state = _state(pfluid, pscope, names)
    out, procs = W.spawn_world(tmp_path, 2, {"pipeline": state},
                               ["pipeline_dp"], script=MW.__file__)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            prog = jfluid.CompiledProgram(jmain).with_data_parallel(
                loss_name=jv["loss"].name)
            want = _train(jfluid, prog, jv, jscope, 3)
    finally:
        got = W.join_world(out, procs, ["pipeline_dp"])["pipeline_dp"]
    js = _state(jfluid, jscope, names)
    for res in got:
        np.testing.assert_allclose(res["losses"], want, **TOL)
        for n in names:
            np.testing.assert_allclose(res["state"][n], js[n], err_msg=n,
                                       **TOL)


def test_sparse_lookup_and_unknown_reduction_warn():
    """An ``is_sparse`` table falls back to the dense gradient under the
    pipeline, and a loss whose reduction the executor cannot tell is taken
    as a mean; each warns, as the JAX executor does, and the run matches
    JAX's."""
    def program(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            ids = fluid.layers.data("ids", shape=[1], dtype="int64")
            emb = fluid.layers.embedding(ids, size=[20, 8], is_sparse=True)
            h = fluid.layers.fc(emb, 8, act="tanh")
            loss = fluid.layers.reduce_mean(fluid.layers.square(h)) * 2.0
            fluid.optimizer.PipelineOptimizer(
                fluid.optimizer.SGD(0.1), cut_list=[[h]],
                num_microbatches=2).minimize(loss)
        return main, startup, loss

    jmain, jstart, jloss = program(jfluid)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstart, scope=jscope)
    names = sorted(x.name for x in jstart.list_vars() if x.persistable)
    state = convert.scope_to_numpy(jscope, names)
    feed = {"ids": np.random.RandomState(3).randint(0, 20, (8, 1))}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = [float(jfluid.Executor(jfluid.CPUPlace()).run(
            jmain, feed=feed, fetch_list=[jloss], scope=jscope)[0])
            for _ in range(2)]
    pmain, _, ploss = program(pfluid)
    pscope = convert.scope_from_numpy(state, pfluid.Scope(), "cpu")
    exe = pfluid.Executor(pfluid.CPUPlace())
    with pytest.warns(UserWarning) as rec:
        got = [float(exe.run(pmain, feed=feed, fetch_list=[ploss],
                             scope=pscope)[0]) for _ in range(2)]
    text = " ".join(str(w.message) for w in rec)
    assert "falls back to the DENSE" in text
    assert "cannot tell whether loss" in text
    np.testing.assert_allclose(got, want, **TOL)
