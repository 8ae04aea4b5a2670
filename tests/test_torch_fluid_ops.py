"""The port's Fluid op rules (``paddle_tpu_torch/ops``) against the JAX
package's (``paddle_tpu/ops``) on the CPU: each rule through
``registry.get_lowering`` on both sides, from the same seeded numpy inputs.
The forward and, for the float inputs, the gradients of a seeded random
cotangent (``jax.vjp`` against ``torch.autograd.grad``).

Tolerances, f32: the forward to 1e-6 and the gradients to 1e-5 of the
largest magnitude of the JAX side's value (the two frameworks sum in other
orders).  Integer outputs exactly, as values: with x64 off JAX holds int64
as int32, and the port keeps int64, so dtypes are not compared.

Planted cases: ``top_k`` and ``pool2d`` ties (the first maximum of a window
takes its gradient in both), ``cross_entropy`` at ``ignore_index`` and at a
probability of 0 (clipped at 1e-20, no gradient), the ``elementwise_add``
axis broadcast, ``mul`` at ``x_num_col_dims`` 1 and 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401  (registers the JAX rules)
from paddle_tpu.registry import OpLoweringContext as JaxContext
from paddle_tpu.registry import get_lowering as jax_rule
import paddle_tpu_torch.ops  # noqa: F401  (registers the port's rules)
from paddle_tpu_torch.registry import OpLoweringContext as PortContext
from paddle_tpu_torch.registry import get_lowering as port_rule
from paddle_tpu_torch.sparse import SelectedRows


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FWD_TOL, GRAD_TOL = 1e-6, 1e-5


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    # NaN where the other side has NaN, and the same infinity, match
    same = (np.isnan(got) & np.isnan(want)) | (np.isinf(want) & (got == want))
    assert not (np.isnan(got) ^ np.isnan(want)).any(), what
    assert not (np.isinf(got) ^ np.isinf(want)).any(), what
    scale = max(np.abs(np.where(same, 0, want)).max(initial=0.0), 1e-30)
    err = np.abs(np.where(same, 0, got - want)).max(initial=0.0)
    assert err <= tol * scale, "%s: %.3g of %.3g" % (what, err, scale)


def _run(op, ins, attrs, grad_slots=(), grad_out=None, seed=0):
    """Both rules on ``ins`` ({slot: [numpy]}); compares every output, then
    the gradients into ``grad_slots`` of <cotangent, outputs[grad_out]>."""
    jctx = JaxContext(None, None, seed_root=0)
    pctx = PortContext(None, torch.Generator().manual_seed(0))
    jouts = jax_rule(op)({k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
                         attrs, jctx)
    pouts = port_rule(op)({k: [torch.from_numpy(np.array(a)) for a in v]
                           for k, v in ins.items()}, attrs, pctx)
    assert set(pouts) == set(jouts), op
    for slot in jouts:
        for j, p in zip(jouts[slot], pouts[slot]):
            j, p = np.asarray(j), p.detach().numpy()
            if np.issubdtype(j.dtype, np.floating):
                _close(p, j, FWD_TOL, "%s %s" % (op, slot))
            else:          # values, not dtypes (int32 under JAX's x64 off)
                np.testing.assert_array_equal(p, j, err_msg="%s %s" % (op, slot))
    if not grad_slots:
        return jouts, pouts
    ct = np.asarray(np.random.RandomState(seed + 1).standard_normal(
        np.shape(jouts[grad_out][0])), np.float32)

    def jf(*diff):
        j_ins = {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}
        for slot, d in zip(grad_slots, diff):
            j_ins[slot] = [d]
        return jax_rule(op)(j_ins, attrs, jctx)[grad_out][0]

    _, vjp = jax.vjp(jf, *[jnp.asarray(ins[s][0]) for s in grad_slots])
    jgrads = vjp(jnp.asarray(ct))
    leaves = [torch.from_numpy(np.array(ins[s][0])).requires_grad_(True)
              for s in grad_slots]
    p_ins = {k: [torch.from_numpy(np.array(a)) for a in v] for k, v in ins.items()}
    for slot, leaf in zip(grad_slots, leaves):
        p_ins[slot] = [leaf]
    y = port_rule(op)(p_ins, attrs, pctx)[grad_out][0]
    pgrads = torch.autograd.grad(y, leaves, torch.from_numpy(ct),
                                 allow_unused=True)
    for slot, j, p in zip(grad_slots, jgrads, pgrads):
        p = np.zeros(np.shape(j), np.float32) if p is None else p.numpy()
        _close(p, np.asarray(j), GRAD_TOL, "%s d%s" % (op, slot))
    return jouts, pouts


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("op", ["relu", "tanh", "sigmoid"])
def test_activations(op):
    v = _randn(0, 4, 5, 3)
    v[0, :2] = 0.0                       # relu's kink, exactly
    _run(op, {"X": [v]}, {}, ["X"], "Out")


@pytest.mark.parametrize("axis", [-1, 1])
def test_softmax(axis):
    _run("softmax", {"X": [_randn(1, 3, 7, 2) * 3]}, {"axis": axis}, ["X"], "Out")


@pytest.mark.parametrize("attrs", [
    {},                                                      # LeNet's
    {"strides": [2, 1], "paddings": [1, 2], "dilations": [1, 2]},
    {"strides": [1, 1], "paddings": [1, 1], "groups": 2},
])
def test_conv2d(attrs):
    cin = 4
    w = _randn(3, 6, cin // attrs.get("groups", 1), 3, 3)
    _run("conv2d", {"Input": [_randn(2, 2, cin, 9, 8)], "Filter": [w]}, attrs,
         ["Input", "Filter"], "Output")


def _tied(seed, *shape):
    """Values on four levels, two of them negative: most 2x2 windows hold
    tied maxima, and a window all below 0 shows what a pad contributes."""
    return np.random.RandomState(seed).randint(-2, 2, shape).astype(np.float32)


@pytest.mark.parametrize("attrs", [
    {"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2]},     # LeNet's
    {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]},
    {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2], "ceil_mode": True},
    {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]},
    {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1],
     "exclusive": False, "ceil_mode": True},
    {"pooling_type": "max", "global_pooling": True},
    {"pooling_type": "avg", "global_pooling": True},
    {"pooling_type": "max", "ksize": [2, 3], "adaptive": True},
], ids=["max2", "max3pad", "max3ceil", "avg3pad", "avg3incl_ceil", "gmax",
        "gavg", "adaptive"])
def test_pool2d_with_ties(attrs):
    """No ReLU before the pool: the ties are the input's own."""
    _run("pool2d", {"X": [_tied(4, 2, 3, 8, 9)]}, attrs, ["X"], "Out")


def test_pool2d_tie_gradient_goes_to_the_first_maximum():
    v = np.array([[[[1.0, 1.0], [1.0, 0.0]]]], np.float32)
    _, pouts = _run("pool2d", {"X": [v]}, {"pooling_type": "max", "ksize": [2, 2],
                                           "strides": [2, 2]}, ["X"], "Out")
    leaf = torch.from_numpy(v).requires_grad_(True)
    y = port_rule("pool2d")({"X": [leaf]}, {"pooling_type": "max", "ksize": [2, 2],
                                            "strides": [2, 2]}, None)["Out"][0]
    (g,) = torch.autograd.grad(y.sum(), [leaf])
    assert g.flatten().tolist() == [1.0, 0.0, 0.0, 0.0]


@pytest.mark.parametrize("case", ["hard", "ignore_index", "ignore_in_range",
                                  "p_zero", "soft", "out_of_range",
                                  "negative_label"])
def test_cross_entropy(case):
    rng = np.random.RandomState(5)
    p = rng.rand(6, 10).astype(np.float32) + 0.05
    p /= p.sum(-1, keepdims=True)
    label = rng.randint(0, 10, (6, 1)).astype(np.int64)
    attrs = {}
    if case == "ignore_index":
        label[[1, 4], 0] = -100              # the default ignore_index
    if case == "ignore_in_range":
        label[[1, 4], 0] = 3
        attrs = {"ignore_index": 3}
    if case == "p_zero":
        p[0, label[0, 0]] = 0.0              # clipped at 1e-20: loss 46.05
        p[3, label[3, 0]] = 1e-30
    if case == "out_of_range":
        label[2, 0] = -100                   # ignored: zero loss
        label[4, 0] = 12                     # NaN loss, as JAX's fill gather
    if case == "negative_label":
        label[2, 0] = -1                     # the last class, as JAX wraps it
    if case == "soft":
        label = rng.rand(6, 10).astype(np.float32)
        label /= label.sum(-1, keepdims=True)
        attrs = {"soft_label": True}
    jouts, _ = _run("cross_entropy", {"X": [p], "Label": [label]}, attrs,
                    ["X"], "Y")
    y = np.asarray(jouts["Y"][0])
    if case.startswith("ignore"):
        assert (y[[1, 4], 0] == 0).all() and (y[[0, 2, 3, 5], 0] > 0).all()
    if case == "p_zero":
        np.testing.assert_allclose(y[[0, 3], 0], -np.log(np.float32(1e-20)),
                                   rtol=1e-6)
    if case == "negative_label":
        np.testing.assert_allclose(y[2, 0], -np.log(p[2, 9]), rtol=1e-6)


@pytest.mark.parametrize("xs,ys,axis", [
    ((2, 5, 3, 4), (5,), 1),             # conv bias
    ((6, 10), (10,), 1),                 # fc bias, axis = ndim - 1
    ((2, 5, 3, 4), (5, 3), 1),           # a run of two dims
    ((4, 3), (4, 3), -1),
    ((2, 3, 4), (4,), -1),               # numpy-style trailing broadcast
])
def test_elementwise_add_axis_broadcast(xs, ys, axis):
    _run("elementwise_add", {"X": [_randn(6, *xs)], "Y": [_randn(7, *ys)]},
         {"axis": axis}, ["X", "Y"], "Out")


@pytest.mark.parametrize("xs,ys,xd,yd", [
    ((6, 50, 4, 4), (800, 10), 1, 1),    # LeNet's fc
    ((2, 3, 4, 5), (20, 7), 2, 1),
    ((3, 4, 5), (5, 2, 3), 2, 1),
])
def test_mul(xs, ys, xd, yd):
    _run("mul", {"X": [_randn(8, *xs)], "Y": [_randn(9, *ys) * 0.1]},
         {"x_num_col_dims": xd, "y_num_col_dims": yd}, ["X", "Y"], "Out")


def test_mean():
    _run("mean", {"X": [_randn(10, 6, 1)]}, {}, ["X"], "Out")


@pytest.mark.parametrize("k", [1, 3])
def test_top_k_ties_go_to_the_lower_index(k):
    v = _tied(11, 5, 9)
    v[0] = 2.0                           # a row of one value
    _, pouts = _run("top_k", {"X": [v]}, {"k": k}, ["X"], "Out")
    idx = pouts["Indices"][0].numpy()
    assert idx[0].tolist() == list(range(k))


def test_accuracy():
    rng = np.random.RandomState(12)
    idx = rng.randint(0, 10, (16, 2)).astype(np.int64)
    label = rng.randint(0, 10, (16, 1)).astype(np.int64)
    label[:5, 0] = idx[:5, 1]
    _run("accuracy", {"Indices": [idx], "Label": [label]}, {})


def test_fill_constant():
    _run("fill_constant", {}, {"shape": [1], "dtype": "float32", "value": 0.9})
    _run("fill_constant", {}, {"shape": [2, 3], "dtype": "int64", "value": 7})


def _opt_ins(seed, shape=(5, 4)):
    rng = np.random.RandomState(seed)
    return {"Param": [rng.randn(*shape).astype(np.float32)],
            "Grad": [rng.randn(*shape).astype(np.float32) * 1e-2],
            "LearningRate": [np.array([0.1], np.float32)]}


def test_sgd():
    _run("sgd", _opt_ins(13), {})


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum(nesterov):
    ins = _opt_ins(14)
    ins["Velocity"] = [_randn(15, 5, 4)]
    _run("momentum", ins, {"mu": 0.9, "use_nesterov": nesterov})


def test_adam_dense():
    ins = _opt_ins(16)
    ins.update(Moment1=[_randn(17, 5, 4) * 1e-2],
               Moment2=[np.abs(_randn(18, 5, 4)) * 1e-4],
               Beta1Pow=[np.array([0.9 ** 3], np.float32)],
               Beta2Pow=[np.array([0.999 ** 3], np.float32)])
    _run("adam", ins, {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8})


@pytest.mark.parametrize("op", ["sgd", "momentum", "adam"])
def test_sparse_gradients_update_as_in_jax(op):
    """A SelectedRows gradient with a duplicated row: the port's rule
    against the JAX rule, every output (tests/test_torch_sparse_executor.py
    holds each branch's edge cases)."""
    from paddle_tpu.sparse import SelectedRows as JaxSelectedRows

    rows = np.array([0, 2, 2, 4], np.int64)
    vals = _randn(19, 4, 3)
    ins = {"Param": [_randn(20, 5, 3)], "LearningRate": [np.array([0.1], np.float32)],
           "Velocity": [_randn(21, 5, 3)], "Moment1": [_randn(22, 5, 3) * 1e-2],
           "Moment2": [np.abs(_randn(23, 5, 3)) * 1e-4],
           "Beta1Pow": [np.array([0.9], np.float32)],
           "Beta2Pow": [np.array([0.999], np.float32)]}
    jouts = jax_rule(op)(dict({k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
                              Grad=[JaxSelectedRows(jnp.asarray(rows), jnp.asarray(vals), 5)]),
                         {}, JaxContext(None, None, seed_root=0))
    pouts = port_rule(op)(dict({k: [torch.from_numpy(a) for a in v] for k, v in ins.items()},
                               Grad=[SelectedRows(torch.from_numpy(rows), torch.from_numpy(vals), 5)]),
                          {}, None)
    assert set(pouts) == set(jouts)
    for slot in jouts:
        _close(pouts[slot][0].numpy(), np.asarray(jouts[slot][0]), FWD_TOL, slot)


def test_an_unported_op_raises_the_registry_error():
    # prroi_pool waits for item 3-B's tranche 6 (affine_channel, the
    # example here until tranche 5 ported it; maxout until tranche 4,
    # layer_norm before tranches 1-3)
    with pytest.raises(NotImplementedError, match="no lowering registered"):
        port_rule("prroi_pool")


# -- integer, bool, empty-dim and out-of-range inputs ---------------------------
# ROADMAP Queue 3's faults 1-4 and the wider probe's: each rule through
# registry.get_lowering on both sides, compared by value (NaN where NaN, the
# same infinities, floats to FWD_TOL) and by kind (bool, integer or float;
# JAX's int32 stands for the port's int64 under x64 off), then one Fluid
# program per fault through each package's Executor(CPUPlace()).

def _kind(a):
    return "b" if a.dtype == np.bool_ else (
        "i" if np.issubdtype(a.dtype, np.integer) else "f")


def _numpy(t):
    """A rule's output as numpy: bf16 (JAX's and torch's) as f32."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    t = np.asarray(t)
    return t.astype(np.float32) if t.dtype == jnp.bfloat16 else t


def _same(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert _kind(got) == _kind(want), (what, got.dtype, want.dtype)
    if _kind(want) == "f":
        _close(got, want, FWD_TOL, what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _rule_matches(op, ins, attrs):
    """Both rules on ``ins`` ({slot: [numpy]}); every output compared by
    value and kind."""
    jctx = JaxContext(None, None, seed_root=0)
    pctx = PortContext(None, torch.Generator().manual_seed(0))
    jouts = jax_rule(op)({k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
                         dict(attrs), jctx)
    pouts = port_rule(op)({k: [torch.from_numpy(np.array(a)) for a in v]
                           for k, v in ins.items()}, dict(attrs), pctx)
    assert set(pouts) == set(jouts), op
    for slot in jouts:
        for j, p in zip(jouts[slot], pouts[slot]):
            _same(_numpy(p), _numpy(j), "%s %s" % (op, slot))
    return jouts, pouts


REDUCE_OPS = ["reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
              "reduce_prod", "reduce_all", "reduce_any"]
_SMALL = {"float32": np.array([[1, 0], [2, -3]], np.float32),
          "int32": np.array([[1, 0], [2, -3]], np.int32),
          "bool": np.array([[True, False], [True, True]])}


@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bool"])
@pytest.mark.parametrize("mode", ["empty_dim", "reduce_all"])
@pytest.mark.parametrize("op", REDUCE_OPS)
def test_reduce_over_an_empty_dim_list_matches_jax(op, mode, dtype, keep):
    """Queue 3 fault 1: ``dim=[]`` without reduce_all reduces no axis, as
    ``jnp.sum(axis=())``, in the dtype JAX gives (bool from all/any, f32
    from the mean of integers); reduce_all still reduces every axis."""
    attrs = {"dim": [], "keep_dim": keep, "reduce_all": mode == "reduce_all"}
    _rule_matches(op, {"X": [_SMALL[dtype]]}, attrs)


@pytest.mark.parametrize("op,ins,attrs", [
    ("mean", {"X": [np.array([[1, 2], [3, 4]], np.int32)]}, {}),
    ("mean", {"X": [_SMALL["bool"]]}, {}),
    ("reduce_mean", {"X": [_SMALL["bool"]]}, {"dim": [0]}),
    ("reduce_mean", {"X": [_SMALL["int32"]]}, {"dim": [1], "keep_dim": True}),
    ("reduce_mean", {"X": [_SMALL["int32"]]}, {"reduce_all": True}),
    ("softmax", {"X": [np.array([[1, 2, 3]], np.int32)]}, {}),
    ("softmax", {"X": [_SMALL["int32"]]}, {"axis": 0}),
    ("where", {"Condition": [np.array([1, 0], np.int32)],
               "X": [np.array([1., 2.], np.float32)],
               "Y": [np.array([3., 4.], np.float32)]}, {}),
    ("where", {"Condition": [np.array([np.nan, 0.0, -2.0], np.float32)],
               "X": [np.array([1., 2., 3.], np.float32)],
               "Y": [np.array([4., 5., 6.], np.float32)]}, {}),
], ids=["mean_int32", "mean_bool", "reduce_mean_bool", "reduce_mean_int32_keep",
        "reduce_mean_int32_all", "softmax_int32", "softmax_int32_axis0",
        "where_int32_condition", "where_f32_condition_nan"])
def test_integer_and_bool_inputs_match_jax(op, ins, attrs):
    """Queue 3 fault 2: integer and bool inputs go to f32 where ``jnp.mean``
    and ``jax.nn.softmax`` promote them; ``where`` takes a nonzero
    condition (NaN included) as true."""
    _rule_matches(op, ins, attrs)


_OOR = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, -1.7, 255.5, 256, 300,
                 0.5, -3, 0, 70000, -129], np.float32)


@pytest.mark.parametrize("out_dtype", ["uint8", "int8", "int16", "int32",
                                       "bool", "float16", "bfloat16",
                                       "float32"])
@pytest.mark.parametrize("case", ["out_of_range", "small", "int32_input"])
def test_cast_saturates_as_jax(case, out_dtype):
    """Queue 3 fault 3: a float going to an integer type maps NaN to 0 and
    saturates at the type's range, as XLA's convert (``Tensor.to`` wraps);
    integer inputs wrap in both.  int64 is left out: JAX holds it as int32
    under x64 off, so a value past int32's range differs by design."""
    x = {"out_of_range": _OOR, "small": _SMALL["float32"],
         "int32_input": np.array([-3, 0, 300, 2 ** 31 - 1, -2 ** 31],
                                 np.int32)}[case]
    _rule_matches("cast", {"X": [x]}, {"out_dtype": out_dtype})


@pytest.mark.parametrize("value", [1e10, -1e10, float("nan"), 3.7, -3.7,
                                   255.5, 300.0, 16777217.0])
@pytest.mark.parametrize("dtype", ["int32", "uint8", "bool", "float16",
                                   "bfloat16", "float32"])
def test_fill_constant_converts_as_jax(dtype, value):
    """Queue 3 fault 3's sibling: the value goes through f32 (x64 off), then
    saturates for integer types, as ``jnp.full`` converts it; a float16
    overflow is inf.  The batch-size-like variant the same."""
    _rule_matches("fill_constant", {}, {"shape": [2], "dtype": dtype,
                                        "value": value})
    _rule_matches("fill_constant_batch_size_like", {"Input": [_SMALL["int32"]]},
                  {"shape": [-1, 3], "dtype": dtype, "value": value})


_X12 = np.arange(12, dtype=np.float32).reshape(3, 4)


@pytest.mark.parametrize("lengths", [[0, 1, 6], [9, 4, 100], [-1, 2, 4]],
                         ids=["past_t", "far_past_t", "negative"])
@pytest.mark.parametrize("dtype", ["float32", "int32", "uint8", "bool",
                                   "float32_3d"])
def test_sequence_reverse_past_t_fills_as_jax(dtype, lengths):
    """Queue 3 fault 4: a length past T reads steps past T, which
    ``jnp.take_along_axis`` fills (NaN for floats, the least value of a
    signed integer, the largest of an unsigned one, True for bool); the
    port used to raise IndexError."""
    x = {"float32": _X12, "int32": _X12.astype(np.int32),
         "uint8": _X12.astype(np.uint8), "bool": _X12 % 3 == 0,
         "float32_3d": np.arange(24, dtype=np.float32).reshape(3, 4, 2)}[dtype]
    _rule_matches("sequence_reverse", {"X": [x], "SeqLen": [
        np.array(lengths, np.int64)]}, {})


def test_sequence_reverse_past_t_takes_no_gradient_past_t():
    """The filled steps take no gradient; the others take the reversed
    cotangent, as under jax.vjp."""
    _run("sequence_reverse", {"X": [_randn(8, 3, 4, 2)],
                              "SeqLen": [np.array([0, 3, 6], np.int64)]},
         {}, ["X"], "Y")


_SEQ = np.arange(24, dtype=np.float32).reshape(3, 4, 2)


@pytest.mark.parametrize("op,ins,attrs", [
    ("relu", {"X": [_SMALL["bool"]]}, {}),
    ("floor", {"X": [_SMALL["bool"]]}, {}),
    ("floor", {"X": [_SMALL["int32"]]}, {}),
    ("elementwise_pow", {"X": [_SMALL["bool"]], "Y": [_SMALL["bool"]]}, {}),
    ("softmax_with_cross_entropy", {"Logits": [_SMALL["int32"]],
                                    "Label": [np.array([[1], [0]], np.int64)]},
     {}),
    ("pool2d", {"X": [np.arange(32, dtype=np.int32).reshape(1, 2, 4, 4)]},
     {"pooling_type": "avg", "ksize": [2, 2], "strides": [2, 2]}),
    ("pool2d", {"X": [np.arange(32, dtype=np.int32).reshape(1, 2, 4, 4)]},
     {"pooling_type": "avg", "global_pooling": True}),
    ("pool2d", {"X": [np.arange(32, dtype=np.int32).reshape(1, 2, 4, 4)]},
     {"pooling_type": "avg", "ksize": [2, 2], "adaptive": True}),
    ("sequence_pool", {"X": [_SEQ.astype(np.int32)],
                       "SeqLen": [np.array([1, 2, 3], np.int64)]},
     {"pooltype": "SUM"}),
    ("sequence_pool", {"X": [_SEQ.astype(np.int32)],
                       "SeqLen": [np.array([0, 2, 3], np.int64)]},
     {"pooltype": "AVERAGE"}),
    ("sequence_pool", {"X": [_SEQ.astype(np.int32)],
                       "SeqLen": [np.array([1, 2, 4], np.int64)]},
     {"pooltype": "SQRT"}),
    ("sequence_pool", {"X": [_SEQ], "SeqLen": [np.array([0, 2, 9], np.int64)]},
     {"pooltype": "LAST"}),
    ("sequence_pool", {"X": [_SEQ.astype(np.int32)],
                       "SeqLen": [np.array([0, 2, 9], np.int64)]},
     {"pooltype": "LAST"}),
], ids=["relu_bool", "floor_bool", "floor_int32", "pow_bool",
        "softmax_xent_int32_logits", "avg_pool_int32", "global_avg_pool_int32",
        "adaptive_avg_pool_int32", "seq_sum_int32", "seq_avg_int32",
        "seq_sqrt_int32", "seq_last_past_t", "seq_last_past_t_int32"])
def test_probe_repairs_match_jax(op, ins, attrs):
    """What the wider probe of the ported rules found beside Queue 3's four
    faults, each a few lines: bool and integer inputs the JAX rules take
    (promoting to int32 or f32 as they do), and ``sequence_pool(LAST)``
    with a length past T, filled as ``take_along_axis`` fills."""
    _rule_matches(op, ins, attrs)


# -- the same faults as whole Fluid programs -------------------------------------

import paddle_tpu as jfluid                 # noqa: E402
import paddle_tpu_torch as pfluid           # noqa: E402
from paddle_tpu_torch import convert        # noqa: E402


def _both_programs(build, feed):
    """``build(fluid)`` -> (main, startup, fetch vars) on both packages under
    a fresh ``unique_name.guard()``, run once by each ``Executor(CPUPlace())``
    from the JAX startup's values; returns (JAX fetches, port fetches)."""
    outs = []
    for fluid in (jfluid, pfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            fetch = build(fluid)
        outs.append((fluid, main, startup, [v.name for v in fetch]))
    (jf, jmain, jstart, names), (pf, pmain, _, _) = outs
    jexe, jscope = jf.Executor(jf.CPUPlace()), jf.Scope()
    jexe.run(jstart, scope=jscope)
    persist = [v.name for v in jstart.list_vars() if v.persistable]
    pscope = convert.scope_from_numpy(convert.scope_to_numpy(jscope, persist),
                                      pf.Scope(), "cpu")
    jout = jexe.run(jmain, feed=feed, fetch_list=names, scope=jscope)
    pout = pf.Executor(pf.CPUPlace()).run(pmain, feed=feed, fetch_list=names,
                                          scope=pscope)
    return jout, pout


def _programs_match(build, feed):
    jout, pout = _both_programs(build, feed)
    assert len(jout) == len(pout)
    for i, (j, p) in enumerate(zip(jout, pout)):
        _same(_numpy(p), _numpy(j), "fetch %d" % i)


def _data(fluid, name, dtype, shape=(2, 2)):
    return fluid.layers.data(name, shape=list(shape), dtype=dtype,
                             append_batch_size=False)


def test_executor_reduce_over_an_empty_dim_list_matches_jax():
    def build(fluid):
        x = _data(fluid, "x", "float32")
        L = fluid.layers
        return [L.reduce_sum(x, dim=[]), L.reduce_mean(x, dim=[], keep_dim=True),
                L.reduce_max(x, dim=[]), L.reduce_min(x, dim=[]),
                L.reduce_prod(x, dim=[]), L.reduce_all(x, dim=[]),
                L.reduce_any(x, dim=[]), L.reduce_sum(x)]
    _programs_match(build, {"x": _SMALL["float32"]})


def test_executor_integer_inputs_match_jax():
    def build(fluid):
        L = fluid.layers
        i = _data(fluid, "i", "int32")
        c = _data(fluid, "c", "int32", (2,))
        a, b = _data(fluid, "a", "float32", (2,)), _data(fluid, "b", "float32", (2,))
        return [L.mean(i), L.reduce_mean(i, dim=[0]), L.softmax(i),
                L.where(c, a, b)]
    _programs_match(build, {"i": np.array([[1, 2], [3, 4]], np.int32),
                            "c": np.array([1, 0], np.int32),
                            "a": np.array([1., 2.], np.float32),
                            "b": np.array([3., 4.], np.float32)})


def test_executor_cast_and_fill_constant_saturate_as_jax():
    """The casts of fed values saturate in both Executors.  ``fill_constant``
    only at values that both of JAX's paths agree on: under the JAX
    Executor's jit the value is folded while tracing by numpy's cast (1e10
    to int32 gives its least value, -3.7 to uint8 253), where the JAX rule
    run eagerly saturates, as the port does (ROADMAP Queue 3)."""
    def build(fluid):
        L = fluid.layers
        x = _data(fluid, "x", "float32")
        o = _data(fluid, "o", "float32", (len(_OOR),))
        return [L.cast(x, "uint8"), L.cast(o, "int32"), L.cast(o, "uint8"),
                L.cast(o, "int8"), L.cast(o, "bool"), L.cast(o, "float16"),
                L.fill_constant([2], "int32", 3.7),
                L.fill_constant([2], "uint8", 255.5),
                L.fill_constant([2], "float16", 1e10)]
    _programs_match(build, {"x": _SMALL["float32"], "o": _OOR})


def test_executor_sequence_reverse_past_t_matches_jax():
    def build(fluid):
        L = fluid.layers
        x = _data(fluid, "x", "float32", (3, 4))
        xi = _data(fluid, "xi", "int32", (3, 4))
        n = _data(fluid, "n", "int64", (3,))
        return [L.sequence_reverse(x, seq_len=n), L.sequence_reverse(xi, seq_len=n)]
    _programs_match(build, {"x": _X12, "xi": _X12.astype(np.int32),
                            "n": np.array([0, 1, 6], np.int64)})


# -- Queue 3's logged faults: out-of-range labels and lengths, integer BN --------
# Each input runs through both rules (value and kind), then as a Fluid program
# through both Executors.  The port's rules read an index out of range as the
# JAX rules' gathers read it (``ops/common.py`` ``clamp_index``,
# ``take_steps``) where they used to raise IndexError.

def _crf_case(labels, lengths):
    rng = np.random.RandomState(0)
    return {"Emission": [rng.randn(3, 4, 3).astype(np.float32)],
            "Transition": [rng.randn(5, 3).astype(np.float32)],
            "Label": [np.array(labels, np.int64)],
            "Length": [np.array(lengths, np.int64)]}


def _hsig_case():
    rng = np.random.RandomState(0)
    return {"X": [rng.randn(3, 4).astype(np.float32)],
            "W": [rng.randn(4, 4).astype(np.float32)],
            "Bias": [np.zeros(4, np.float32)],
            "Label": [np.array([1, 7, -1], np.int64)]}


def _nce_case():
    rng = np.random.RandomState(0)
    return {"Input": [rng.randn(3, 4).astype(np.float32)],
            "Label": [np.array([[1], [7], [-1]], np.int64)],
            "Weight": [rng.randn(5, 4).astype(np.float32)],
            "Bias": [rng.randn(5).astype(np.float32)]}


def _bn_case():
    rng = np.random.RandomState(0)
    return {"X": [rng.randn(2, 3, 2, 2).astype(np.int32)],
            "Scale": [np.ones(3, np.float32)], "Bias": [np.zeros(3, np.float32)],
            "Mean": [np.zeros(3, np.float32)], "Variance": [np.ones(3, np.float32)]}


QUEUE3_CASES = {
    "crf_length_past_t": ("linear_chain_crf",
                          _crf_case([[0, 1, 2, 0]] * 3, [2, 4, 6]), {}),
    "crf_label_out_of_range": ("linear_chain_crf",
                               _crf_case([[0, 5, -1, 0]] * 3, [2, 4, 3]), {}),
    "crf_label_and_length": ("linear_chain_crf",
                             _crf_case([[0, 2, 1, 0], [3, 1, 0, 2], [1, 1, 7, 0]],
                                       [9, 4, 2]), {}),
    "hsigmoid_label_out_of_range": ("hierarchical_sigmoid", _hsig_case(),
                                    {"num_classes": 5}),
    "nce_label_out_of_range": ("nce", _nce_case(),
                               {"num_total_classes": 5,
                                "custom_neg_classes": [0, 3]}),
    "nce_label_out_of_range_log_uniform": ("nce", _nce_case(),
                                           {"num_total_classes": 5, "sampler": 1,
                                            "custom_neg_classes": [4, 2]}),
    "batch_norm_int32_training": ("batch_norm", _bn_case(), {}),
    "batch_norm_int32_nhwc": ("batch_norm", _bn_case(),
                              {"data_layout": "NHWC"}),
}


@pytest.mark.parametrize("case", sorted(QUEUE3_CASES))
def test_queue3_logged_faults_match_jax(case):
    """ROADMAP Queue 3's four logged faults: ``linear_chain_crf`` with a
    length past T or a label outside [0, D) (finite values and NaN alike),
    ``hierarchical_sigmoid`` and ``nce`` with a label outside the classes,
    ``batch_norm`` of an int32 X in training (int32 Y, f32 statistics)."""
    op, ins, attrs = QUEUE3_CASES[case]
    if op == "batch_norm" and attrs.get("data_layout") == "NHWC":
        ins = dict(ins, X=[ins["X"][0].transpose(0, 2, 3, 1).copy()])
    _rule_matches(op, ins, attrs)


def test_crf_gradient_matches_jax():
    """In range, the repaired CRF's gradients into Emission and Transition
    against ``jax.vjp``."""
    _run("linear_chain_crf", _crf_case([[0, 1, 2, 0], [2, 2, 1, 0], [1, 0, 0, 2]],
                                       [2, 4, 3]),
         {}, ["Emission", "Transition"], "LogLikelihood")


def test_hsigmoid_and_nce_gradients_with_out_of_range_labels_match_jax():
    """A clamped row takes the gradient of every read of it, as JAX's
    gather gives it."""
    _run("hierarchical_sigmoid", _hsig_case(), {"num_classes": 5},
         ["X", "W"], "Out")
    _run("nce", _nce_case(), {"num_total_classes": 5, "custom_neg_classes": [0, 3]},
         ["Input", "Weight"], "Cost")


def _pin_nce_negatives(fluid, negatives):
    for op in fluid.default_main_program().global_block().ops:
        if op.type == "nce":
            op.attrs["custom_neg_classes"] = list(negatives)


def test_executor_crf_with_out_of_range_labels_and_lengths_matches_jax():
    ins = _crf_case([[0, 2, 1, 0], [3, 1, 0, 2], [1, 1, 7, 0]], [9, 4, 2])

    def build(fluid):
        L = fluid.layers
        em = _data(fluid, "em", "float32", (3, 4, 3))
        lab = _data(fluid, "lab", "int64", (3, 4))
        ln = _data(fluid, "ln", "int64", (3,))
        return [L.linear_chain_crf(em, lab, length=ln)]

    feed = {"em": ins["Emission"][0], "lab": ins["Label"][0],
            "ln": ins["Length"][0]}
    _programs_match(build, feed)
    feed["lab"] = np.array([[0, 5, -1, 0]] * 3, np.int64)
    _programs_match(build, feed)


def test_executor_hsigmoid_and_nce_with_out_of_range_labels_match_jax():
    def build(fluid):
        L = fluid.layers
        xv = _data(fluid, "x", "float32", (3, 4))
        lab = _data(fluid, "lab", "int64", (3, 1))
        h = L.hsigmoid(xv, lab, 5)
        n = L.nce(xv, lab, 5, num_neg_samples=2)
        _pin_nce_negatives(fluid, [0, 3])
        return [h, n]

    _programs_match(build, {"x": _hsig_case()["X"][0],
                            "lab": np.array([[1], [7], [-1]], np.int64)})


def test_executor_batch_norm_of_int32_matches_jax():
    def build(fluid):
        xv = _data(fluid, "x", "int32", (2, 3, 2, 2))
        return [fluid.layers.batch_norm(xv)]

    _programs_match(build, {"x": _bn_case()["X"][0]})
