"""The small modules ported beside item 3-B's tranche 5, each against the
JAX package's: ``ir`` (the ``Pass`` registry and ``PassManager``),
``transpiler`` and ``distributed.transpiler`` (the
``DistributeTranspiler`` tags a program, which the port's Executor then
refuses with the item-5 error), ``install_check.run_check`` on a CPU
place, ``contrib.layers`` (each builder's program op for op, and the ones
whose ops wait raising the registry's error), ``layers.py_func`` and
``data_norm`` with ``update_stats`` through both Executors."""

import re

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu_torch import convert
from test_torch_fluid_ops import _both_programs, _data, _programs_match


# -- ir ------------------------------------------------------------------------

def test_the_pass_registry_and_pass_manager_match_jax():
    from paddle_tpu import ir as jir
    from paddle_tpu_torch import ir as pir

    assert pir.__all__ == jir.__all__
    builtins = {"quantization_transform_pass", "quantization_freeze_pass",
                "convert_to_int8_pass", "transform_for_mobile_pass"}
    assert builtins <= set(pir.registered_passes())
    assert builtins <= set(jir.registered_passes())
    for ir, fluid in ((jir, jfluid), (pir, pfluid)):
        @ir.register_pass("test_torch_small_modules_tag")
        class Tag(ir.Pass):
            def __init__(self, label="x"):
                self.label = label

            def apply(self, program):
                program._tags = getattr(program, "_tags", []) + [self.label]
                return program

        assert Tag.name == "test_torch_small_modules_tag"
        prog = fluid.Program()
        pm = ir.PassManager().append("test_torch_small_modules_tag", "a")
        pm.append(Tag("b"))
        assert pm.apply(prog) is prog and prog._tags == ["a", "b"]
        assert ir.apply_pass(fluid.Program(), "test_torch_small_modules_tag",
                             label="c")._tags == ["c"]
        with pytest.raises(KeyError, match="no pass registered"):
            ir.get_pass("no_such_pass")


def test_the_slim_passes_wait_for_item_3d():
    from paddle_tpu_torch import ir

    for name in ("quantization_freeze_pass", "convert_to_int8_pass"):
        with pytest.raises(NotImplementedError, match="item 3-D"):
            ir.get_pass(name)


# -- the transpilers -----------------------------------------------------------

def _tiny(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.fc(x, 2))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("geo", [False, True])
def test_the_transpiler_tags_as_jax_and_the_executor_refuses(geo):
    tags, progs = [], []
    for fluid in (jfluid, pfluid):
        main, startup, loss = _tiny(fluid)
        config = fluid.transpiler.DistributeTranspilerConfig()
        config.geo_sgd_mode = geo
        t = fluid.transpiler.DistributeTranspiler(config)
        with pytest.warns(UserWarning, match="pserver mode"):
            t.transpile(1, program=main, pservers="127.0.0.1:6174,127.0.0.1:6175",
                        trainers=3, startup_program=startup)
        assert t.get_trainer_program() is main
        assert t.get_startup_program() is startup
        assert not t.get_pserver_program("127.0.0.1:6174").global_block().ops
        tags.append(main._dist_info)
        progs.append((main, startup, loss))
    assert tags[0] == tags[1]
    assert tags[1]["mode"] == ("geo" if geo else "pserver")
    # since item 5-B the executor runs the tagged program: data-parallel
    # (the JAX package over its 8 CPU devices, the port over its world of
    # one), or locally in geo mode (warning that no Communicator started)
    (jmain, jstart, jloss), (pmain, _, ploss) = progs
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    names = sorted(v.name for v in jstart.list_vars() if v.persistable)
    pscope = convert.scope_from_numpy(convert.scope_to_numpy(jscope, names),
                                      pfluid.Scope(), "cpu")
    feed = {"x": np.arange(32, dtype=np.float32).reshape(8, 4) / 10}
    with warnings.catch_warnings(record=True) as said:
        warnings.simplefilter("always")
        for _ in range(2):
            want = jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)
            got = pfluid.Executor(pfluid.CPUPlace()).run(
                pmain, feed=feed, fetch_list=[ploss], scope=pscope)
            np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    assert geo == any("WITHOUT a started Communicator" in str(w.message)
                      for w in said)


@pytest.mark.parametrize("sync", [True, False])
def test_the_ports_transpiler_warns_that_the_executor_refuses(sync):
    """Since item 5-B the executor runs the transpiled program: the
    warnings say what pserver mode and sync_mode=False fold into, and no
    longer that the executor refuses."""
    main, startup, _ = _tiny(pfluid)
    t = pfluid.transpiler.DistributeTranspiler()
    with pytest.warns(UserWarning) as said:
        t.transpile(0, program=main, pservers="127.0.0.1:6174",
                    trainers=2, sync_mode=sync, startup_program=startup)
    texts = [str(w.message) for w in said]
    assert len(texts) == (1 if sync else 2)
    assert not any("refuses" in x or "item 5" in x for x in texts)
    assert any("every rank is a trainer" in x for x in texts)
    assert sync or any("sync_mode=False" in x for x in texts)


def test_the_distributed_package_exports_only_the_transpiler():
    """The transpiler, since item 5-A fleet and the role makers, and since
    item 5-B the GeoSGD Communicator: the JAX package's exports."""
    assert pfluid.distributed.__all__ == [
        "fleet", "PaddleCloudRoleMaker", "UserDefinedRoleMaker", "Role",
        "DistributeTranspiler", "DistributeTranspilerConfig", "Communicator"]
    jnames = {n for n in dir(jfluid.distributed) if not n.startswith("_")}
    assert set(pfluid.distributed.__all__) == jnames - {
        "communicator", "heartbeat", "launch", "role_maker", "transpiler"}
    assert (pfluid.distributed.DistributeTranspiler
            is pfluid.transpiler.DistributeTranspiler)
    assert jfluid.transpiler.__all__ == pfluid.transpiler.__all__


def test_the_dispatchers_and_memory_optimize_match_jax():
    class V:
        def __init__(self, name):
            self.name = name

    eps = ["a:1", "b:2", "c:3"]
    vs = [V("w%d" % i) for i in range(7)]
    for name in ("HashName", "RoundRobin"):
        j = getattr(jfluid.transpiler, name)(eps)
        p = getattr(pfluid.transpiler, name)(eps)
        assert p.dispatch(vs) == j.dispatch(vs)
        p.reset()
        j.reset()
        assert p.dispatch(vs[:2]) == j.dispatch(vs[:2])
    prog = pfluid.Program()
    assert pfluid.transpiler.memory_optimize(prog) is prog
    assert pfluid.transpiler.release_memory(prog) is prog


# -- install_check -----------------------------------------------------------

def test_run_check_on_the_cpu_and_not_without_a_card(capsys, monkeypatch):
    loss = pfluid.install_check.run_check(pfluid.CPUPlace())
    said = capsys.readouterr().out
    assert np.isfinite(loss) and "works on the CPU" in said
    assert "TPU" not in said and "loss=%.4f" % loss in said
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pfluid.install_check.run_check()


# -- contrib.layers ---------------------------------------------------------------

def _contrib_programs(build):
    progs = []
    for fluid in (jfluid, pfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            out = build(fluid, fluid.contrib.layers)
        progs.append((main, startup, out))
    return progs


_CONTRIB = {
    "match_matrix_tensor": lambda f, C: C.match_matrix_tensor(
        _data(f, "x", "float32", (2, 3, 4)), _data(f, "y", "float32", (2, 5, 4)),
        3, act="tanh")[0],
    "var_conv_2d": lambda f, C: C.var_conv_2d(
        _data(f, "x", "float32", (2, 2, 5, 6)), _data(f, "r", "int64", (2,)),
        _data(f, "c", "int64", (2,)), 2, 3, [3, 2], stride=[1, 2]),
    "sequence_topk_avg_pooling": lambda f, C: C.sequence_topk_avg_pooling(
        _data(f, "x", "float32", (2, 3, 4, 5)), _data(f, "r", "int64", (2,)),
        _data(f, "c", "int64", (2,)), [1, 3], 3),
    "tree_conv": lambda f, C: C.tree_conv(
        _data(f, "n", "float32", (2, 6, 3)), _data(f, "e", "int32", (2, 5, 2)),
        4, num_filters=2),
    "fused_embedding_seq_pool": lambda f, C: C.fused_embedding_seq_pool(
        _data(f, "ids", "int64", (2, 5)), [11, 4]),
    "fused_elemwise_activation_binary_first": lambda f, C:
        C.fused_elemwise_activation(
            _data(f, "x", "float32", (2, 3)), _data(f, "y", "float32", (2, 3)),
            ["elementwise_add", "relu"]),
    "fused_elemwise_activation_unary_first": lambda f, C:
        C.fused_elemwise_activation(
            _data(f, "x", "float32", (2, 3)), _data(f, "y", "float32", (2, 3)),
            ["scale", "elementwise_mul"], scale=0.5),
    "search_pyramid_hash": lambda f, C: C.search_pyramid_hash(
        _data(f, "ids", "int32", (2, 6)), 8, 100, 3, 4, seed=3),
    "multiclass_nms2": lambda f, C: C.multiclass_nms2(
        _data(f, "b", "float32", (1, 5, 4)), _data(f, "s", "float32", (1, 3, 5)),
        0.1, 4, 3, return_index=True)[0],
}


def _params_dropped(attrs):
    """An op's attrs as comparable data (a callable's identity differs)."""
    return {k: v for k, v in attrs.items() if not callable(v)}


@pytest.mark.parametrize("name", sorted(_CONTRIB))
def test_contrib_layers_build_the_jax_packages_programs(name):
    (jm, js, jo), (pm, ps, po) = _contrib_programs(_CONTRIB[name])
    for jp, pp in ((jm, pm), (js, ps)):
        jops, pops = jp.global_block().ops, pp.global_block().ops
        assert [o.type for o in pops] == [o.type for o in jops]
        for j, p in zip(jops, pops):
            assert p.inputs == j.inputs and p.outputs == j.outputs
            assert _params_dropped(p.attrs) == _params_dropped(j.attrs), p.type
    assert tuple(po.shape) == tuple(jo.shape)
    assert pfluid.contrib.layers.__all__ == jfluid.contrib.layers.__all__


@pytest.mark.parametrize("name,op", [("match_matrix_tensor", "match_matrix_tensor"),
                                     ("search_pyramid_hash", "pyramid_hash")])
def test_contrib_ops_that_wait_raise_the_registry_error(name, op):
    (_, _, _), (pm, ps, po) = _contrib_programs(_CONTRIB[name])
    exe = pfluid.Executor(pfluid.CPUPlace())
    with pytest.raises(NotImplementedError,
                       match="no lowering registered for op type '%s'" % op):
        exe.run(pm, feed={}, fetch_list=[po], scope=pfluid.Scope())


def test_contrib_layers_of_ported_ops_run_as_jax():
    def build(fluid):
        C = fluid.contrib.layers
        x, y = _data(fluid, "x", "float32", (2, 3)), _data(fluid, "y", "float32", (2, 3))
        return [C.fused_embedding_seq_pool(_data(fluid, "ids", "int64", (2, 5)),
                                           [11, 4]),
                C.fused_elemwise_activation(x, y, ["elementwise_add", "relu"]),
                C.fused_elemwise_activation(x, y, ["scale", "elementwise_mul"],
                                            scale=0.5),
                C.tree_conv(_data(fluid, "n", "float32", (2, 6, 3)),
                            _data(fluid, "e", "int32", (2, 5, 2)), 4,
                            num_filters=2)]
    rng = np.random.RandomState(720)
    _programs_match(build, {
        "ids": rng.randint(0, 11, (2, 5)).astype(np.int64),
        "x": rng.randn(2, 3).astype(np.float32),
        "y": rng.randn(2, 3).astype(np.float32),
        "n": rng.randn(2, 6, 3).astype(np.float32),
        "e": np.array([[[1, 2], [1, 3], [2, 4], [2, 5], [3, 6]],
                       [[1, 2], [2, 3], [1, 4], [0, 0], [4, 5]]], np.int32)})


# -- py_func ---------------------------------------------------------------------

def _py_func_program(fluid, fn, out_shape=(2, 3), out_dtype="float32"):
    def build(fluid):
        a = _data(fluid, "a", "float32", (2, 3))
        b = _data(fluid, "b", "int32", (2, 3))
        block = fluid.default_main_program().global_block()
        outs = [block.create_var(name="pyf_out", shape=out_shape,
                                 dtype=out_dtype),
                block.create_var(name="pyf_max", shape=(), dtype="int32")]
        fluid.layers.py_func(fn, [a, b], outs)
        return [fluid.layers.scale(outs[0], 2.0), outs[1]]
    return build


_SEEN = []


def _host_fn(a, b):
    _SEEN.append((type(a), type(b)))
    a, b = np.asarray(a), np.asarray(b)
    return a * 2 + b, b.max()


def test_py_func_runs_the_host_function_in_both_executors():
    """The callback sees numpy arrays; each result is cast to its declared
    dtype (an int64 max to int32, f32 from an f32 + int32 sum) and comes back
    on the executor's device; the fetches match JAX's."""
    feed = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.array([[1, 5, -2], [0, 3, 7]], np.int32)}
    del _SEEN[:]
    jout, pout = _both_programs(_py_func_program(None, _host_fn), feed)
    assert _SEEN[-1] == (np.ndarray, np.ndarray)         # the port's call
    np.testing.assert_array_equal(pout[0], jout[0])
    np.testing.assert_array_equal(pout[0], (feed["a"] * 2 + feed["b"]) * 2)
    assert int(pout[1]) == int(jout[1]) == 7


def test_py_func_checks_the_declared_shape():
    feed = {"a": np.zeros((2, 3), np.float32), "b": np.zeros((2, 3), np.int32)}
    with pytest.raises(Exception, match="shape"):
        _both_programs(_py_func_program(None, _host_fn, out_shape=(3, 2)), feed)


def test_py_func_has_no_gradient_in_either_package():
    """``jax.pure_callback`` has no JVP; the port's results are new leaves:
    differentiating through the op raises in both."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops.misc_ops4 import register_py_func as jreg
    from paddle_tpu.registry import OpLoweringContext as JC
    from paddle_tpu.registry import get_lowering as jrule
    from paddle_tpu_torch.ops.misc_ops4 import register_py_func as preg
    from paddle_tpu_torch.registry import OpLoweringContext as PC
    from paddle_tpu_torch.registry import get_lowering as prule

    fn = lambda v: np.asarray(v) * 3   # noqa: E731
    attrs = {"out_shapes": [[2]], "out_dtypes": ["float32"]}
    with pytest.raises(Exception):
        jax.grad(lambda v: jrule("py_func")(
            {"X": [v]}, dict(attrs, forward_callable_id=jreg(fn)),
            JC(None, None, seed_root=0))["Out"][0].sum())(jnp.ones(2))
    leaf = torch.ones(2, requires_grad=True)
    y = prule("py_func")({"X": [leaf]}, dict(attrs, forward_callable_id=preg(fn)),
                         PC(None, torch.Generator()))["Out"][0]
    assert torch.equal(y, torch.full((2,), 3.0)) and not y.requires_grad
    with pytest.raises(RuntimeError):
        torch.autograd.grad(y.sum(), [leaf])


def test_the_port_keeps_its_own_callback_table():
    from paddle_tpu.ops import misc_ops4 as jops
    from paddle_tpu_torch.ops import misc_ops4 as pops

    assert pops._PY_FUNCS is not jops._PY_FUNCS
    n = len(jops._PY_FUNCS)
    pops.register_py_func(len)
    assert len(jops._PY_FUNCS) == n


# -- data_norm with update_stats ----------------------------------------------------

def _data_norm_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = _data(fluid, "x", "float32", (4, 3))
        y = fluid.layers.data_norm(x, param_attr=fluid.ParamAttr(
            initializer=fluid.initializer.Constant(2.0)))
        op = [o for o in main.global_block().ops if o.type == "data_norm"][0]
        op.attrs["update_stats"] = True
        for slot in ("BatchSize", "BatchSum", "BatchSquareSum"):
            op.outputs[slot + "Out"] = list(op.inputs[slot])
        stats = [op.inputs[s][0] for s in ("BatchSize", "BatchSum",
                                           "BatchSquareSum")]
    return main, startup, y, stats


def test_data_norm_update_stats_threads_its_accumulators_in_both_executors():
    """Two runs: the stat persistables come back from the op's
    BatchSizeOut / BatchSumOut / BatchSquareSumOut, so the second run
    normalises by statistics that include the first batch, as in the JAX
    package's Executor."""
    from paddle_tpu_torch import convert

    (jm, js, jy, jst), (pm, _, py, pst) = (_data_norm_program(jfluid),
                                           _data_norm_program(pfluid))
    assert jst == pst
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    pscope = convert.scope_from_numpy(convert.scope_to_numpy(jscope, jst),
                                      pfluid.Scope(), "cpu")
    pexe = pfluid.Executor(pfluid.CPUPlace())
    rng = np.random.RandomState(721)
    for _ in range(2):
        feed = {"x": rng.randn(4, 3).astype(np.float32)}
        (j,) = jexe.run(jm, feed=feed, fetch_list=[jy], scope=jscope)
        (p,) = pexe.run(pm, feed=feed, fetch_list=[py], scope=pscope)
        np.testing.assert_allclose(p, j, rtol=1e-6, atol=1e-6)
    jv = convert.scope_to_numpy(jscope, jst)
    pv = convert.scope_to_numpy(pscope, pst)
    for n in jst:
        np.testing.assert_allclose(pv[n], jv[n], rtol=1e-6)
    assert pv[pst[0]].tolist() == [10.0] * 3          # 2 + 4 + 4 rows
    assert re.match(r"data_norm", pst[0])


# -- monitor/memscope.min_device_bytes_limit -------------------------------------

def test_min_device_bytes_limit_prefers_the_configured_limit(monkeypatch):
    """The configured override first; with none, on a host without a card,
    the caller's fallback (the JAX helper's order: override, devices,
    fallback)."""
    from paddle_tpu_torch.monitor import memscope

    monkeypatch.delenv("PADDLE_TPU_MEMSCOPE_LIMIT", raising=False)
    memscope.reset()
    try:
        assert not torch.cuda.is_available()
        assert memscope.min_device_bytes_limit() is None
        assert memscope.min_device_bytes_limit(fallback=123) == 123
        memscope.configure(bytes_limit=4 << 20)
        assert memscope.min_device_bytes_limit(fallback=123) == 4 << 20
        memscope.reset()
        monkeypatch.setenv("PADDLE_TPU_MEMSCOPE_LIMIT", "2048")
        assert memscope.min_device_bytes_limit(fallback=123) == 2048
    finally:
        memscope.reset()
