"""The port's control flow against the JAX package's on the CPU: the op rules
that control-flow programs and ``Switch`` run (``paddle_tpu_torch/ops``
against ``paddle_tpu/ops``, each rule through ``registry.get_lowering`` on
both sides from the same seeded numpy inputs), and whole programs with
sub-blocks (``While``, ``cond``, ``Switch``, ``scan``,
``conditional_block``) through each package's ``Executor(CPUPlace())``.

Tolerances: f32 forwards and gradients to 1e-5 of the largest magnitude of
the JAX value (the gradients of a seeded random cotangent, ``jax.vjp``
against ``torch.autograd.grad``); integers and bools exactly, as values
(with x64 off JAX holds int64 as int32).  The While beam decode is exact.

The JAX package's ``lax.while_loop`` has no reverse-mode derivative: a
differentiated value carried through ``while`` fails ``jax.grad`` with a
``ValueError``, and the port's eager loop raises one in the same case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.ops  # noqa: F401  (registers the JAX rules)
from paddle_tpu.registry import OpLoweringContext as JaxContext
from paddle_tpu.registry import get_lowering as jax_rule
import paddle_tpu_torch as pfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.ops import beam_search_ops, control_flow_ops
from paddle_tpu_torch.registry import OpLoweringContext as PortContext
from paddle_tpu_torch.registry import get_lowering as port_rule
from paddle_tpu_torch.tools import programs

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    got, want = got.astype(np.float64), want.astype(np.float64)
    assert not (np.isnan(got) ^ np.isnan(want)).any(), what
    got, want = np.nan_to_num(got), np.nan_to_num(want)
    err = np.abs(got - want).max(initial=0.0)
    scale = max(np.abs(want).max(initial=0.0), 1e-30)
    assert err <= tol * scale, "%s: %.3g of %.3g" % (what, err, scale)


def run_rule(op, ins, attrs, grad_slots=(), grad_out=None):
    """Both rules on ``ins`` ({slot: [numpy]}): every output compared, then
    the gradients into ``grad_slots`` of <cotangent, outputs[grad_out]>."""
    jctx = JaxContext(None, None, seed_root=0)
    pctx = PortContext(None, torch.Generator().manual_seed(0))
    jouts = jax_rule(op)({k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
                         attrs, jctx)
    pouts = port_rule(op)({k: [torch.from_numpy(np.array(a)) for a in v]
                           for k, v in ins.items()}, attrs, pctx)
    assert set(pouts) == set(jouts), op
    for slot in jouts:
        assert len(pouts[slot]) == len(jouts[slot])
        for j, p in zip(jouts[slot], pouts[slot]):
            close(p.detach().numpy(), np.asarray(j), TOL, "%s %s" % (op, slot))
    if not grad_slots:
        return jouts, pouts
    ct = np.random.RandomState(11).standard_normal(
        np.shape(jouts[grad_out][0])).astype(np.float32)

    def jf(*diff):
        j_ins = {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}
        for slot, d in zip(grad_slots, diff):
            j_ins[slot] = [d] + j_ins[slot][1:]
        return jax_rule(op)(j_ins, attrs, jctx)[grad_out][0]

    _, vjp = jax.vjp(jf, *[jnp.asarray(ins[s][0]) for s in grad_slots])
    jgrads = vjp(jnp.asarray(ct))
    leaves = [torch.from_numpy(np.array(ins[s][0])).requires_grad_(True)
              for s in grad_slots]
    p_ins = {k: [torch.from_numpy(np.array(a)) for a in v] for k, v in ins.items()}
    for slot, leaf in zip(grad_slots, leaves):
        p_ins[slot] = [leaf] + p_ins[slot][1:]
    y = port_rule(op)(p_ins, attrs, pctx)[grad_out][0]
    pgrads = torch.autograd.grad(y, leaves, torch.from_numpy(ct),
                                 allow_unused=True)
    for slot, j, p in zip(grad_slots, jgrads, pgrads):
        p = np.zeros(np.shape(j), np.float32) if p is None else p.numpy()
        close(p, np.asarray(j), TOL, "%s d%s" % (op, slot))
    return jouts, pouts


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ints(seed, *shape, lo=-3, hi=4):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(np.int32)


# -- op rules -----------------------------------------------------------------

@pytest.mark.parametrize("op", ["elementwise_sub", "elementwise_mul",
                                "elementwise_div"])
@pytest.mark.parametrize("xs,ys,axis", [((4, 5), (4, 5), -1),
                                        ((2, 5, 3), (5,), 1),
                                        ((2, 3, 4), (4,), -1)])
def test_elementwise_binaries(op, xs, ys, axis):
    y = _randn(2, *ys)
    if op == "elementwise_div":
        y = np.where(np.abs(y) < 0.3, 1.0, y).astype(np.float32)
    run_rule(op, {"X": [_randn(1, *xs)], "Y": [y]}, {"axis": axis},
             ["X", "Y"], "Out")


@pytest.mark.parametrize("op", ["elementwise_sub", "elementwise_mul",
                                "elementwise_div"])
def test_elementwise_binaries_on_integers(op):
    y = _ints(4, 3, 4)
    y[y == 0] = 2
    run_rule(op, {"X": [_ints(3, 3, 4)], "Y": [y]}, {})


@pytest.mark.parametrize("op", ["less_than", "less_equal", "greater_than",
                                "greater_equal", "equal", "not_equal"])
@pytest.mark.parametrize("kind", ["float", "int"])
def test_compares_with_ties(op, kind):
    make = _ints if kind == "int" else (
        lambda seed, *s: _ints(seed, *s).astype(np.float32))
    a, b = make(5, 4, 6), make(6, 4, 6)
    b[0] = a[0]                                   # equal values, exactly
    run_rule(op, {"X": [a], "Y": [b]}, {})
    run_rule(op, {"X": [a], "Y": [b[:1, :1].reshape(1)]}, {})   # [1] bound


@pytest.mark.parametrize("op", ["logical_and", "logical_or"])
def test_logical_binaries(op):
    rng = np.random.RandomState(7)
    run_rule(op, {"X": [rng.rand(3, 5) > 0.5], "Y": [rng.rand(3, 5) > 0.5]}, {})


def test_logical_not():
    run_rule("logical_not", {"X": [np.random.RandomState(8).rand(4, 3) > 0.5]}, {})


@pytest.mark.parametrize("attrs", [{"scale": 2.5, "bias": 0.5},
                                   {"scale": -1.0, "bias": 1.0,
                                    "bias_after_scale": False}, {}])
def test_scale(attrs):
    run_rule("scale", {"X": [_randn(9, 3, 4)]}, attrs, ["X"], "Out")


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.bool_])
def test_scale_of_integers_and_bools(dtype):
    """Integers compute in f32 and cast back; bools give f32 (JAX's
    promotion of an array times a Python float)."""
    v = _ints(10, 2, 5, lo=-40, hi=40)
    v = v > 0 if dtype is np.bool_ else v.astype(dtype)
    run_rule("scale", {"X": [v]}, {"scale": 1.7, "bias": 0.6})


def test_assign():
    run_rule("assign", {"X": [_randn(12, 3, 2)]}, {}, ["X"], "Out")


@pytest.mark.parametrize("src,dst", [("float32", "int32"), ("int32", "float32"),
                                     ("float32", "bool"), ("bool", "int32"),
                                     ("int64", "float32")])
def test_cast(src, dst):
    v = _randn(13, 4, 5) * 3
    v = v > 0 if src == "bool" else v.astype(src)
    grad = ["X"] if src == dst == "float32" else []
    run_rule("cast", {"X": [v]}, {"out_dtype": dst}, grad, "Out" if grad else None)


@pytest.mark.parametrize("shape", [[0, -1], [4, 0, 2], [-1, 4], [1, 2, 3, 4]])
def test_reshape2(shape):
    run_rule("reshape2", {"X": [_randn(14, 2, 3, 4)]}, {"shape": shape},
             ["X"], "Out")


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_concat_and_stack(axis):
    xs = [_randn(15 + i, 2, 3) for i in range(3)]
    run_rule("concat", {"X": xs}, {"axis": axis}, ["X"], "Out")
    run_rule("stack", {"X": xs}, {"axis": axis}, ["X"], "Y")


@pytest.mark.parametrize("idx", [[2, 0, 2], [-1, 1], [[3], [0]], [5, -6, 1]],
                         ids=["plain", "negative", "2d", "out_of_range"])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bool"])
def test_gather(idx, dtype):
    """jnp.take's fill semantics: a negative index counts from the end and an
    index still outside [0, n) reads NaN / the least int / True and takes
    no gradient."""
    v = _randn(16, 5, 3) * 4
    v = v > 0 if dtype == "bool" else v.astype(dtype)
    grad = ["X"] if dtype == "float32" else []
    run_rule("gather", {"X": [v], "Index": [np.array(idx, np.int32)]}, {},
             grad, "Out" if grad else None)


@pytest.mark.parametrize("ids", [[[0], [3], [1]], [2, 0], [[-1], [4], [2]]],
                         ids=["column", "flat", "out_of_range"])
def test_one_hot(ids):
    run_rule("one_hot", {"X": [np.array(ids, np.int32)]}, {"depth": 4})


@pytest.mark.parametrize("v,step", [(np.array([3], np.int32), 1.0),
                                    (np.array([3, -2], np.int64), -1.5),
                                    (np.array([0.25], np.float32), 0.5)])
def test_increment(v, step):
    run_rule("increment", {"X": [v]}, {"step": step})


def test_where():
    rng = np.random.RandomState(17)
    c = rng.rand(3, 4) > 0.5
    run_rule("where", {"Condition": [c], "X": [_randn(18, 3, 4)],
                       "Y": [_randn(19, 3, 4)]}, {}, ["X", "Y"], "Out")
    run_rule("where", {"Condition": [np.array([True])], "X": [_randn(20, 1)],
                       "Y": [_randn(21, 1)]}, {}, ["X"], "Out")


@pytest.mark.parametrize("mask", [0, 1, 2])
def test_select_input(mask):
    xs = [_randn(22 + i, 2, 3) for i in range(3)]
    run_rule("select_input", {"X": xs, "Mask": [np.array([mask], np.int32)]},
             {}, ["X"], "Out")


@pytest.mark.parametrize("accumulated", [True, False])
def test_beam_search_op(accumulated):
    """Frozen beams (pre_id == end_id) and planted ties in the scores."""
    rng = np.random.RandomState(3)
    B, K, V = 2, 3, 7
    pre_scores = rng.randn(B, K).astype("f4")
    logp = (rng.randn(B, K, V) * 0.5 - 1.0).astype("f4")
    logp[0, 1, 2:5] = logp[0, 1, 1]                   # ties within a beam
    scores = (pre_scores[..., None] + logp) if accumulated else np.exp(logp)
    pre_ids = np.array([[1, 0, 2], [5, 5, 1]], "i4")   # 0 = end_id
    run_rule("beam_search", {"pre_scores": [pre_scores],
                             "scores": [scores.astype("f4")],
                             "pre_ids": [pre_ids]},
             {"beam_size": K, "end_id": 0, "is_accumulated": accumulated})


@pytest.mark.parametrize("with_scores", [False, True])
def test_beam_search_decode_op(with_scores):
    rng = np.random.RandomState(5)
    T, B, K = 4, 2, 3
    ins = {"Ids": [rng.randint(0, 9, (T, B, K)).astype("i4")],
           "ParentIdx": [rng.randint(0, K, (T, B, K)).astype("i4")]}
    if with_scores:
        ins["Scores"] = [rng.randn(B, K).astype("f4")]
    run_rule("beam_search_decode", ins, {})


def test_print_op_prints_and_passes_through(capsys):
    v = _randn(23, 2, 2)
    pouts = port_rule("print")({"In": [torch.from_numpy(v)]},
                               {"message": "value"}, None)
    np.testing.assert_array_equal(pouts["Out"][0].numpy(), v)
    assert capsys.readouterr().out.startswith("value [[")


def test_backward_meta_in_a_sub_block_raises():
    with pytest.raises(RuntimeError, match="cannot appear in a sub-block"):
        port_rule("backward_meta")({}, {}, None)


# -- programs -----------------------------------------------------------------

def both(build, feed, fetch=None, steps=1):
    """Run ``build(fluid)`` -> (main, startup, fetch vars) on both packages,
    the port from the JAX startup's values; returns (jax runs, port runs),
    one list of fetches per step."""
    jmain, jstart, jfetch = build(jfluid)
    pmain, _, _ = build(pfluid)
    fetch = fetch or [v.name for v in jfetch]
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    names = [v.name for v in jstart.list_vars() if v.persistable]
    pscope = convert.scope_from_numpy(convert.scope_to_numpy(jscope, names),
                                      pfluid.Scope(), "cpu")
    pexe = pfluid.Executor(pfluid.CPUPlace())
    feeds = feed if isinstance(feed, list) else [feed] * steps
    jout = [jexe.run(jmain, feed=f, fetch_list=fetch, scope=jscope) for f in feeds]
    pout = [pexe.run(pmain, feed=f, fetch_list=fetch, scope=pscope) for f in feeds]
    return jout, pout


def _counter_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[3], dtype="float32",
                              append_batch_size=False)
        n = fluid.layers.data("n", shape=[1], dtype="int64",
                              append_batch_size=False)
        k = fluid.layers.scale(x, 2.0)
        acc = fluid.layers.fill_constant([3], "float32", 1.0)
        i = fluid.layers.fill_constant([1], "int64", 0)
        c = fluid.layers.less_than(i, n)
        w = fluid.layers.While(c)
        with w.block():
            fluid.layers.assign(acc * k + 1.0, acc)
            fluid.layers.increment(i)
            fluid.layers.less_than(i, n, cond=c)
    return main, startup, [acc, i, c]


@pytest.mark.parametrize("n", [0, 1, 4])
def test_while_counter_matches_jax(n):
    """The loop bound is a feed the body reads as a closure; n = 0 runs the
    body no time.  One host read of the condition per iteration, plus the
    one that ends the loop."""
    feed = {"x": np.array([0.5, -1.0, 2.0], "f4"), "n": np.array([n], "int64")}
    control_flow_ops.reset_host_syncs()
    jout, pout = both(_counter_program, feed)
    assert control_flow_ops.host_syncs["while"] == n + 1
    for name, j, p in zip(("acc", "i", "cond"), jout[0], pout[0]):
        close(p, j, TOL, name)
    assert int(pout[0][1][0]) == n


def _array_program(fluid):
    from importlib import import_module

    cf = import_module(fluid.__name__ + ".layers.control_flow")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        a = fluid.layers.data("a", shape=[3], dtype="float32")
        b = fluid.layers.data("b", shape=[3], dtype="float32")
        i = fluid.layers.data("i", shape=[1], dtype="int64",
                              append_batch_size=False)
        arr = cf.array_write(a, 0)
        arr = cf.array_write(b, 1, arr)
        r = cf.array_read(arr, i)
        n = cf.array_length(arr)
        s = cf.array_read(arr, 1)
    return main, startup, [r, n, s]


@pytest.mark.parametrize("idx", [1, 0])
def test_array_write_and_read_with_a_runtime_index(idx):
    """tests/test_io_datasets_jit.py::test_dynamic_array_read on both."""
    av, bv = np.ones((2, 3), "f4"), np.full((2, 3), 5, "f4")
    jout, pout = both(_array_program, {"a": av, "b": bv,
                                       "i": np.array([idx], "int64")})
    for j, p in zip(jout[0], pout[0]):
        close(p, j, 0.0, "array")
    np.testing.assert_array_equal(pout[0][0], (av, bv)[idx])
    assert int(pout[0][1][0]) == 2


def _decode_inputs(T, B, K, V, seed=4):
    rng = np.random.RandomState(seed)
    probs = np.exp(rng.randn(T, B, K, V) * 0.5 - 1.0).astype("f4")
    ps0 = (np.where(np.arange(K)[None] == 0, 0.0, -1e9)
           * np.ones((B, 1))).astype("f4")
    return {"lp": probs, "ps": ps0, "pi": np.full((B, K), -1, "i4")}


def _plain_decode(feed, K, end_id=0):
    """The same decode as a plain loop over the port's beam_search_step and
    beam_backtrack."""
    probs = torch.from_numpy(feed["lp"])
    scores, ids = torch.from_numpy(feed["ps"]), torch.from_numpy(feed["pi"])
    toks, pars = [], []
    for t in range(probs.shape[0]):
        scores, ids, parent = beam_search_ops.beam_search_step(
            scores, torch.log(probs[t].clamp_min(1e-20)), K, end_id,
            ids == end_id)
        toks.append(ids)
        pars.append(parent)
    return beam_search_ops.beam_backtrack(torch.stack(toks),
                                          torch.stack(pars)).numpy()


@pytest.mark.parametrize("T,B,K,V,end_id", [(4, 2, 3, 6, 0), (6, 3, 4, 5, 2)])
def test_while_beam_decode_is_exact(T, B, K, V, end_id):
    """tests/test_rnn_beam_ops.py:213's program-mode decode: the While loop
    reads the fed probabilities and its bound as closures.  The sentences
    equal the JAX package's and a plain loop's exactly; the second case
    ends beams early (end_id 2 of V = 5)."""
    def build(fluid):
        main, startup, v = programs.while_beam_decode(fluid, T, B, K, V, end_id)
        return main, startup, [v["sent"]]

    feed = _decode_inputs(T, B, K, V)
    jout, pout = both(build, feed)
    np.testing.assert_array_equal(pout[0][0], np.asarray(jout[0][0]))
    np.testing.assert_array_equal(pout[0][0], _plain_decode(feed, K, end_id))
    assert pout[0][0].shape == (B, K, T)


def test_cond_as_in_the_jax_tests():
    """tests/test_ops_tensor.py::test_cond_op_via_layers on both."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[1], dtype="float32",
                                  append_batch_size=False)
            big = fluid.layers.fill_constant([1], "float32", 10.0)
            small = fluid.layers.fill_constant([1], "float32", 0.1)
            pred = fluid.layers.less_than(
                x, fluid.layers.fill_constant([1], "float32", 0.5))
            r = fluid.layers.cond(pred, lambda: big, lambda: small)
        return main, startup, [r]

    jout, pout = both(build, [{"x": np.array([0.2], "f4")},
                              {"x": np.array([0.9], "f4")}])
    assert float(pout[0][0][0]) == 10.0 and float(pout[1][0][0]) == np.float32(0.1)
    for j, p in zip(jout, pout):
        close(p[0], j[0], 0.0, "cond")


def test_cond_in_a_trained_program_matches_jax():
    """Both branches hold an fc layer; batches take either branch.  Each
    step's loss, branch and every gradient (the untaken branch's are 0 on
    both sides), and the parameters after the steps, to 1e-5."""
    feeds = [{"x": np.random.RandomState(s).randn(5, 8).astype("f4")}
             for s in range(4)]
    main, _, v = programs.cond_program(pfluid)
    params = [p.name for p in main.all_parameters()]
    fetch = [v["loss"].name, v["pred"].name] + [p + "@GRAD" for p in params]
    jout, pout = both(programs.cond_program, feeds, fetch=fetch)
    taken = [bool(p[1][0]) for p in pout]
    assert True in taken and False in taken
    for step, (j, p) in enumerate(zip(jout, pout)):
        for name, a, b in zip(["loss", "pred"] + params, j, p):
            close(b, a, TOL, "step %d %s" % (step, name))
        branch = params[2:4] if taken[step] else params[4:6]
        idle = params[4:6] if taken[step] else params[2:4]
        assert all(np.abs(p[2 + params.index(n)]).max() > 0 for n in branch)
        assert all(not p[2 + params.index(n)].any() for n in idle)


def test_switch_last_matching_case_wins_as_in_jax():
    feeds = [{"step": np.array([s], "f4")} for s in (0, 4, 5, 9, 10, 20)]
    jout, pout = both(programs.switch_program, feeds, fetch=["switch_lr"])
    got = [float(p[0][0]) for p in pout]
    assert got == [float(np.float32(v)) for v in (0.2, 0.2, 0.2, 0.2, 0.3, 0.3)]
    for j, p in zip(jout, pout):
        close(p[0], j[0], 0.0, "lr")


def scan_block(fluid, carry_inits, xs, body_builder):
    """The JAX package's layers/rnn.py scan_block, on the framework API both
    packages share (the port's layers/rnn.py waits)."""
    from importlib import import_module

    helper = import_module(fluid.__name__ + ".layer_helper").LayerHelper("scan")
    program = fluid.default_main_program()
    sub = program._create_block()
    carry_vars = [sub.create_var(name=helper.name + ".c%d" % i, shape=c.shape,
                                 dtype=c.dtype) for i, c in enumerate(carry_inits)]
    x_vars = [sub.create_var(name=helper.name + ".x%d" % i,
                             shape=tuple(x.shape[1:]), dtype=x.dtype)
              for i, x in enumerate(xs)]
    new_carries, ys = body_builder(carry_vars, x_vars)
    for cv, nc in zip(carry_vars, new_carries):
        sub.append_op(type="assign", inputs={"X": [nc]}, outputs={"Out": [cv.name]})
    program._rollback()
    t = xs[0].shape[0]
    carry_outs = [helper.create_variable_for_type_inference(c.dtype, c.shape)
                  for c in carry_inits]
    ys_outs = [helper.create_variable_for_type_inference(y.dtype, (t,) + tuple(y.shape))
               for y in ys]
    program.current_block().append_op(
        type="scan", inputs={"Carry": list(carry_inits), "Xs": list(xs)},
        outputs={"CarryOut": carry_outs, "Ys": ys_outs},
        attrs={"sub_block_index": sub.idx,
               "carry_names": [c.name for c in carry_vars],
               "xs_names": [x.name for x in x_vars],
               "ys_names": [y.name for y in ys]})
    return carry_outs, ys_outs


def _scan_program(fluid):
    """An RNN-like scan over T = 5 steps: h' = tanh(h * x_t + w_t) with w_t
    from an fc of the feed, trained by SGD: the loss reads the last carry
    and the stacked outputs."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        layers = fluid.layers
        xs = layers.data("xs", shape=[5, 4], dtype="float32",
                         append_batch_size=False)
        w = layers.fc(xs, 4)                            # [5, 4]
        h0 = layers.fill_constant([4], "float32", 0.5)

        def body(carry, x_t):
            h = layers.tanh(layers.elementwise_add(
                layers.elementwise_mul(carry[0], x_t[0]), x_t[1]))
            return [h], [layers.scale(h, 3.0)]

        (hT,), (ys,) = scan_block(fluid, [h0], [xs, w], body)
        loss = layers.elementwise_add(layers.mean(hT), layers.mean(ys))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, [loss, hT, ys]


def test_scan_forward_and_gradients_match_jax():
    main, _, _ = _scan_program(pfluid)
    params = [p.name for p in main.all_parameters()]
    jm, _, jv = _scan_program(jfluid)
    fetch = [v.name for v in jv] + [p + "@GRAD" for p in params]
    feeds = [{"xs": np.random.RandomState(s).randn(5, 4).astype("f4")}
             for s in range(2)]
    jout, pout = both(_scan_program, feeds, fetch=fetch)
    for step, (j, p) in enumerate(zip(jout, pout)):
        for name, a, b in zip(["loss", "hT", "ys"] + params, j, p):
            close(b, a, TOL, "step %d %s" % (step, name))
    assert pout[0][2].shape == (5, 4)


def _conditional_block_program(fluid):
    """conditional_block built on the framework API (no ported layer emits
    it): if c, acc = acc * 3 + x."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[2], dtype="float32",
                              append_batch_size=False)
        c = fluid.layers.data("c", shape=[1], dtype="bool",
                              append_batch_size=False)
        acc = fluid.layers.fill_constant([2], "float32", 2.0)
        sub = main._create_block()
        fluid.layers.assign(fluid.layers.elementwise_add(
            fluid.layers.scale(acc, 3.0), x), acc)
        main._rollback()
        main.global_block().append_op(
            type="conditional_block", inputs={"Cond": [c], "X": [acc]},
            outputs={"Out": [acc]},
            attrs={"sub_block_index": sub.idx, "carried_var_names": [acc.name]})
    return main, startup, [acc]


@pytest.mark.parametrize("taken", [True, False])
def test_conditional_block_matches_jax(taken):
    feed = {"x": np.array([1.0, -2.0], "f4"), "c": np.array([taken])}
    jout, pout = both(_conditional_block_program, feed)
    close(pout[0][0], jout[0][0], 0.0, "acc")
    np.testing.assert_array_equal(pout[0][0], [7.0, 4.0] if taken else [2.0, 2.0])


def _while_grad_program(fluid, through_loop):
    """h = fc(x); a While loop adds h to acc three times (or, when not
    through_loop, only counts); loss = mean(acc) + mean(h); SGD."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[2, 4], dtype="float32",
                              append_batch_size=False)
        h = fluid.layers.fc(x, 3)
        acc = fluid.layers.fill_constant([2, 3], "float32", 0.0)
        i = fluid.layers.fill_constant([1], "int64", 0)
        n = fluid.layers.fill_constant([1], "int64", 3)
        c = fluid.layers.less_than(i, n)
        w = fluid.layers.While(c)
        with w.block():
            if through_loop:
                fluid.layers.assign(acc + h, acc)
            fluid.layers.increment(i)
            fluid.layers.less_than(i, n, cond=c)
        loss = fluid.layers.elementwise_add(fluid.layers.mean(acc),
                                            fluid.layers.mean(h))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, [loss, i]


def test_gradient_through_while_raises_in_both():
    """A differentiated value carried through the loop: jax.grad refuses
    lax.while_loop; the port refuses the same program before it adds a
    gradient the reference lacks."""
    feed = {"x": np.ones((2, 4), "f4")}
    for fluid in (jfluid, pfluid):
        main, startup, fetch = _while_grad_program(fluid, True)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)
        with pytest.raises(ValueError, match="Reverse-mode differentiation "
                                             "does not work"):
            exe.run(main, feed=feed, fetch_list=fetch, scope=scope)


def test_while_that_carries_no_differentiated_value_trains_as_in_jax():
    main, _, _ = _while_grad_program(pfluid, False)
    params = [p.name for p in main.all_parameters()]
    jm, _, jv = _while_grad_program(jfluid, False)
    fetch = [v.name for v in jv] + [p + "@GRAD" for p in params]
    jout, pout = both(lambda f: _while_grad_program(f, False),
                      {"x": np.random.RandomState(2).randn(2, 4).astype("f4")},
                      fetch=fetch, steps=2)
    for j, p in zip(jout, pout):
        for name, a, b in zip(["loss", "i"] + params, j, p):
            close(b, a, TOL, name)


def test_clone_for_test_copies_sub_blocks_as_jax():
    for build in (programs.cond_program, _scan_program,
                  lambda f: programs.while_beam_decode(f, 3, 2, 2, 4)):
        jmain, _, _ = build(jfluid)
        pmain, _, _ = build(pfluid)
        for for_test in (False, True):
            jc, pc = jmain.clone(for_test), pmain.clone(for_test)
            assert len(pc.blocks) == len(jc.blocks) == len(pmain.blocks) > 1
            for jb, pb in zip(jc.blocks, pc.blocks):
                assert pb.parent_idx == jb.parent_idx
                assert [op.type for op in pb.ops] == [op.type for op in jb.ops]
                assert [(op.inputs, op.outputs, op.attrs) for op in pb.ops] == [
                    (op.inputs, op.outputs, op.attrs) for op in jb.ops]
