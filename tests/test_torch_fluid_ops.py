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
    with pytest.raises(NotImplementedError, match="no lowering registered"):
        port_rule("layer_norm")
