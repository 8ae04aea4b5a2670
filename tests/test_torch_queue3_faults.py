"""ROADMAP Queue 3's eight faults in the rules of item 3-B's tranches 1-3,
each held to the JAX rule on the CPU at the input that showed it, then as
a Fluid program through both Executors where a layer builds the op:

1. ``elementwise_floordiv`` by zero: NaN for floats; XLA's -2 (or -1 at
   0) for integers, where torch raises.
2. ``abs``: the gradient at +0 and -0 is 1, as ``jnp.abs``'s.
3. ``p_norm`` at a zero vector: ``jnp.linalg.norm``'s gradients for
   porder 1, 2, 3 and inf ([1, 1, 1], NaN, NaN, [1/6, 1/6, 1/6]).
4. ``p_norm``'s matrix 2-norm of a matrix holding a NaN: NaN, where
   torch's SVD raises.
5. ``gelu`` (erf form) of +inf: inf.
6. ``pad2d`` in reflect mode with a pad as long as the axis or longer:
   reflected again and again, as ``jnp.pad``.
7. ``roll`` with several shifts and no axis: the flattened tensor rolled
   by their sum.
8. Every row of ``tools/rule_cases.py`` with its float slots cast to int32
   (round(2 x)) and to bool (x > 0), ``cast_rows()``: the port computes
   where the JAX rule does, in the dtype JAX's promotion gives, to the
   values it gives.  The converse rows, where the port computes and the
   JAX rule raises, are listed (``CONVERSE``) and stay so (ROADMAP Queue
   3, not queued).

Tolerances are ``tests/test_torch_fluid_ops.py``'s: forward 1e-6 and
gradients 1e-5 of the largest magnitude (f32), integers exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.registry import OpLoweringContext as JaxContext
from paddle_tpu.registry import get_lowering as jax_rule
from paddle_tpu_torch.registry import OpLoweringContext as PortContext
from paddle_tpu_torch.registry import get_lowering as port_rule
from paddle_tpu_torch.tools.rule_cases import cast_rows
from test_torch_fluid_ops import _data, _programs_match, _rule_matches, _run


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NAN, INF = float("nan"), float("inf")


def _port(op, ins, attrs):
    return port_rule(op)({k: [torch.from_numpy(np.array(a)) for a in v]
                          for k, v in ins.items()}, dict(attrs),
                         PortContext(None, torch.Generator().manual_seed(0)))


def _grad_of_sum(op, ins, attrs, slot, out_slot="Out"):
    """The port's gradient of sum(outs[out_slot]) into ``slot``."""
    leaf = torch.from_numpy(np.array(ins[slot][0])).requires_grad_(True)
    t = {k: [torch.from_numpy(np.array(a)) for a in v] for k, v in ins.items()}
    t[slot] = [leaf]
    y = port_rule(op)(t, dict(attrs), PortContext(None, torch.Generator()))
    (g,) = torch.autograd.grad(y[out_slot][0].sum(), [leaf])
    return g.numpy()


# -- 1. elementwise_floordiv by zero ------------------------------------------

@pytest.mark.parametrize("xs,ys", [
    (np.array([1, -1, 0, 3.5], np.float32), np.zeros(4, np.float32)),
    (np.array([5, 0, -5, -7, 7], np.int32), np.array([0, 0, 0, 2, -2], np.int32)),
    (np.array([np.iinfo(np.int32).min, 9], np.int32), np.array([-1, -1], np.int32)),
    (np.array([True, False, True]), np.array([False, True, True])),
], ids=["f32_by_zero", "int32_by_zero", "int32_min_by_minus_one", "bool"])
def test_floordiv_by_zero_matches_jax(xs, ys):
    _rule_matches("elementwise_floordiv", {"X": [xs], "Y": [ys]}, {})


def test_floordiv_by_zero_values():
    got = _port("elementwise_floordiv", {"X": [np.array([1, -1, 0, 3.5], np.float32)],
                                         "Y": [np.zeros(4, np.float32)]}, {})
    assert torch.isnan(got["Out"][0]).all()
    got = _port("elementwise_floordiv", {"X": [np.array([5, 0], np.int32)],
                                         "Y": [np.array([0, 0], np.int32)]}, {})
    assert got["Out"][0].tolist() == [-2, -1]


def test_executor_floordiv_by_zero_matches_jax():
    def build(fluid):
        L = fluid.layers
        a, b = _data(fluid, "a", "float32", (4,)), _data(fluid, "b", "float32", (4,))
        i, j = _data(fluid, "i", "int32", (3,)), _data(fluid, "j", "int32", (3,))
        return [L.elementwise_floordiv(a, b), L.elementwise_floordiv(i, j)]
    _programs_match(build, {"a": np.array([1, -1, 0, 3.5], np.float32),
                            "b": np.array([0, 0, 0, 2], np.float32),
                            "i": np.array([5, 0, -7], np.int32),
                            "j": np.array([0, 0, 2], np.int32)})


# -- 2. abs: the gradient at +-0 ------------------------------------------------

def test_abs_gradient_at_zero_matches_jax():
    x = np.array([0.0, -0.0, 1.0, -1.0, 2.5, -0.0], np.float32)
    _run("abs", {"X": [x]}, {}, ["X"], "Out")
    assert _grad_of_sum("abs", {"X": [x]}, {}, "X").tolist() == [1, 1, 1, -1, 1, 1]
    y = _port("abs", {"X": [x]}, {})["Out"][0]
    assert not torch.signbit(y).any()            # -0 comes out +0


def test_executor_abs_gradient_at_zero_matches_jax():
    """sum |w| from w = [0, -0, 1, -1] and one SGD step at lr 1: the JAX
    package moves the zeros to -1, as its gradient there is 1."""
    def build(fluid):
        w = fluid.layers.create_parameter(
            [4], "float32", name="w",
            default_initializer=fluid.initializer.NumpyArrayInitializer(
                np.array([0.0, -0.0, 1.0, -1.0], np.float32)))
        loss = fluid.layers.reduce_sum(fluid.layers.abs(w))
        fluid.optimizer.SGD(1.0).minimize(loss)
        return [loss, w]
    _programs_match(build, {})


# -- 3. p_norm at a zero vector --------------------------------------------------

@pytest.mark.parametrize("porder,want", [
    (1.0, [1.0, 1.0, 1.0]), (2.0, [NAN] * 3), (3.0, [NAN] * 3),
    (INF, [1 / 6] * 3)], ids=["p1", "p2", "p3", "inf"])
def test_p_norm_gradient_at_zero_matches_jax(porder, want):
    ins = {"X": [np.zeros((2, 3), np.float32)]}
    attrs = {"porder": porder, "axis": -1}
    _run("p_norm", ins, attrs, ["X"], "Out")
    got = _grad_of_sum("p_norm", ins, attrs, "X")
    np.testing.assert_allclose(got, np.array([want, want], np.float32),
                               rtol=1e-6)


# -- 4. p_norm's matrix 2-norm of a NaN ----------------------------------------

@pytest.mark.parametrize("bad", [NAN, INF], ids=["nan", "inf"])
def test_p_norm_matrix_of_a_non_finite_is_nan(bad):
    x = np.array([[1, bad, 2], [3, 4, 5]], np.float32)
    _rule_matches("p_norm", {"X": [x]}, {"porder": 2.0})
    assert torch.isnan(_port("p_norm", {"X": [x]}, {})["Out"][0]).all()


# -- 5. gelu of +inf ----------------------------------------------------------------

@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
def test_gelu_of_infinities_matches_jax(approximate):
    x = np.array([INF, -INF, 1.0, -2.0, 0.0], np.float32)
    _rule_matches("gelu", {"X": [x]}, {"approximate": approximate})
    assert float(_port("gelu", {"X": [x]}, {"approximate": approximate})
                 ["Out"][0][0]) == INF


def test_executor_gelu_of_infinity_matches_jax():
    def build(fluid):
        return [fluid.layers.gelu(_data(fluid, "x", "float32", (3,)))]
    _programs_match(build, {"x": np.array([INF, -INF, 0.5], np.float32)})


# -- 6. pad2d reflect past the axis ---------------------------------------------

_PAD_X = np.arange(24, dtype=np.float32).reshape(1, 2, 3, 4)


@pytest.mark.parametrize("paddings", [[0, 0, 4, 0], [3, 0, 0, 0], [5, 7, 9, 3],
                                      [1, 2, 3, 3]])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bool"])
def test_pad2d_reflect_past_the_axis_matches_jax(paddings, dtype):
    x = _PAD_X if dtype == "float32" else (
        _PAD_X.astype(np.int32) if dtype == "int32" else _PAD_X % 3 > 0)
    ins = {"X": [x]}
    attrs = {"paddings": paddings, "mode": "reflect"}
    if dtype == "float32":
        _run("pad2d", ins, attrs, ["X"], "Out")
    else:
        _rule_matches("pad2d", ins, attrs)


def test_pad2d_reflect_example_row():
    got = _port("pad2d", {"X": [_PAD_X]}, {"paddings": [0, 0, 4, 0],
                                          "mode": "reflect"})["Out"][0]
    assert got[0, 0, 0].tolist() == [2, 3, 2, 1, 0, 1, 2, 3]


def test_pad2d_reflect_of_an_axis_of_one_matches_jax():
    _run("pad2d", {"X": [np.arange(6, dtype=np.float32).reshape(1, 2, 1, 3)]},
         {"paddings": [2, 1, 4, 4], "mode": "reflect"}, ["X"], "Out")


def test_executor_pad2d_reflect_past_the_axis_matches_jax():
    def build(fluid):
        x = _data(fluid, "x", "float32", (1, 2, 3, 4))
        return [fluid.layers.pad2d(x, paddings=[3, 4, 4, 5], mode="reflect")]
    _programs_match(build, {"x": _PAD_X})


# -- 7. roll with several shifts and no axis -------------------------------------

@pytest.mark.parametrize("shifts", [[1, 2], [5, -7, 3], [-30]])
def test_roll_with_several_shifts_and_no_axis_matches_jax(shifts):
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    _run("roll", {"X": [x]}, {"shifts": shifts}, ["X"], "Out")


def test_roll_example():
    got = _port("roll", {"X": [np.arange(24, dtype=np.float32).reshape(2, 3, 4)]},
                {"shifts": [1, 2]})["Out"][0]
    assert got.reshape(-1)[:4].tolist() == [21, 22, 23, 0]


# -- 8. the rows on int32 and bool ---------------------------------------------------

_CAST_ROWS = cast_rows()

# the port computes where the JAX rule raises (not queued)
CONVERSE = {"round_halves_bool", "rsqrt_int32", "rsqrt_bool", "kron_bool",
            "kron_3d_bool", "log_softmax_bool", "log_softmax_axis1_bool",
            "scatter_add_repeats_bool", "scatter_out_of_range_False_bool",
            "logsigmoid_bool", "softshrink_bool",
            # item 3-B tranche 4: bool window sums and scatter-adds
            "pool3d_avg_exclusive_bool", "pool3d_avg_inclusive_ceil_bool",
            "spp_avg_bool", "sequence_scatter_bool"}


@pytest.mark.parametrize("row", _CAST_ROWS, ids=[r[0] for r in _CAST_ROWS])
def test_rows_on_int32_and_bool_match_jax(row):
    """Value and kind (bool, integer, float) of every output; where the JAX
    rule raises, the port raises too, or the row is a listed converse
    one."""
    cid, op, ins, attrs = row
    try:
        jax_rule(op)({k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
                     dict(attrs), JaxContext(None, None, seed_root=0))
    except Exception:
        try:
            _port(op, ins, attrs)
        except Exception:
            return
        assert cid in CONVERSE, "the JAX rule raises on %s" % cid
        return
    assert cid not in CONVERSE
    _rule_matches(op, ins, attrs)


def test_executor_activations_of_int32_and_bool_match_jax():
    """relu6, brelu, gelu, softplus (f32 from integers
    and bool), abs of bool and a bool matmul, through both Executors."""
    def build(fluid):
        L = fluid.layers
        i = _data(fluid, "i", "int32", (2, 3))
        b = _data(fluid, "b", "bool", (2, 3))
        bt = _data(fluid, "bt", "bool", (3, 2))
        outs = []
        for v in (i, b):
            outs += [L.relu6(v), L.brelu(v, t_min=-1.0, t_max=4.0),
                     L.gelu(v),
                     L.softplus(v)]
        return outs + [L.abs(b), L.matmul(b, bt)]
    _programs_match(build, {"i": np.array([[-3, 0, 2], [7, 1, -1]], np.int32),
                            "b": np.array([[True, False, True], [False, False, True]]),
                            "bt": np.array([[True, False], [False, True],
                                            [False, False]])})


# -- found by this slice's probes in older rules ---------------------------------

@pytest.mark.parametrize("row", [[0.0, -0.0, 1.0], [-0.0, 0.0, 1.0],
                                 [-0.0, 2.0, 0.0, -0.0]])
def test_top_k_puts_plus_zero_above_minus_zero_as_lax(row):
    """``lax.top_k`` orders floats totally (+0 above -0); a sort takes the
    two as equal and keeps their order."""
    x = np.array([row], np.float32)
    _rule_matches("top_k", {"X": [x]}, {"k": len(row) - 1})


@pytest.mark.parametrize("dtype", ["int32", "bool"])
def test_clip_of_int32_and_bool_is_f32_as_jax(dtype):
    x = np.array([-3, 0, 2, 7]).astype(dtype)
    _rule_matches("clip", {"X": [x]}, {"min": -1.0, "max": 4.0})
