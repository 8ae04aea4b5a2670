"""The op rules the Fluid book suite adds to the port (``dropout``,
``batch_norm``, ``lookup_table``, the losses, the tensor and reduction
ops, ``cos_sim``, the sequence, CRF and sampling ops, ``adagrad``) against
the JAX package's rules on the CPU: each rule through
``registry.get_lowering`` on both sides from the same seeded numpy inputs,
the forward and the gradients of a seeded random cotangent (``jax.vjp``
against ``torch.autograd.grad``), with the harness of
``test_torch_fluid_ops.py``.

Tolerances, f32, relative to the largest magnitude of the JAX side's value:
the forward to 1e-6 and the gradients to 1e-5 (``FWD_TOL``, ``GRAD_TOL``
there); NaN and infinities where JAX gives them; integer outputs
exactly, as values.

Planted traps: ``lookup_table`` ids outside [0, V) (NaN rows, -1 counting
from the end, the gradient reaching only in-range rows); ties in
``crf_decoding``'s Viterbi argmax (the first index wins, as ``jnp.argmax``)
and in ``sequence_pool(max)`` and ``reduce_max`` (tied maxima share the
gradient, as ``jnp.max``); padding past each row's length, and lengths of
0, 1 and T; ``nce`` with ``custom_neg_classes`` under samplers 0/1/2;
``hierarchical_sigmoid`` on the default and a custom tree;
``batch_norm`` in training and test mode in both layouts;
``softmax_with_cross_entropy`` with soft labels and ``ignore_index``.
Training-mode ``dropout`` draws from the port's own generator, so it is
held to its keep rate and scaling, not to JAX's bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.registry import OpLoweringContext as JaxContext
from paddle_tpu.registry import get_lowering as jax_rule
from paddle_tpu.sparse import SelectedRows as JaxRows
from paddle_tpu_torch.registry import OpLoweringContext as PortContext
from paddle_tpu_torch.registry import get_lowering as port_rule
from paddle_tpu_torch.registry import registered_ops
from paddle_tpu_torch.sparse import SelectedRows
from test_torch_fluid_ops import _close, _randn, _run

BOOK_OPS = """batch_norm cos_sim crf_decoding dropout elementwise_pow expand
fill_constant_batch_size_like floor hierarchical_sigmoid linear_chain_crf
lookup_table nce reduce_sum sequence_conv sequence_mask sequence_pool
sequence_reverse softmax_with_cross_entropy split square_error_cost squeeze2
sum transpose2 unsqueeze2""".split()


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_book_suites_op_types_are_registered():
    ops = set(registered_ops())
    assert set(BOOK_OPS) <= ops, sorted(set(BOOK_OPS) - ops)
    assert {"lookup_table_v2", "adagrad", "reduce_mean", "reduce_max"} <= ops
    assert len(ops) >= 73


# -- dropout ------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_dropout_at_test_time_matches_jax(impl):
    _run("dropout", {"X": [_randn(0, 4, 6)]},
         {"dropout_prob": 0.3, "is_test": True, "dropout_implementation": impl},
         ["X"], "Out")


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_dropout_in_training_keeps_its_rate_and_scale(impl):
    """100,000 values at p = 0.3: the kept share within 5 standard errors
    of 0.7; a kept value is x (downgrade_in_infer) or x / 0.7
    (upscale_in_train), a dropped one 0; Mask marks the kept; the gradient
    is Mask times the same scale; the same run seed and op seed give the
    same mask, another run seed another."""
    p, n = 0.3, 100_000
    v = torch.from_numpy(np.abs(_randn(1, n)) + 0.5).requires_grad_(True)
    attrs = {"dropout_prob": p, "dropout_implementation": impl, "seed": 7}

    def run(run_seed):
        ctx = PortContext(None, torch.Generator().manual_seed(run_seed))
        return port_rule("dropout")({"X": [v]}, attrs, ctx)

    outs = run(3)
    y, mask = outs["Out"][0], outs["Mask"][0]
    kept = mask.bool()
    share = kept.float().mean().item()
    assert abs(share - (1 - p)) <= 5 * (p * (1 - p) / n) ** 0.5, share
    scale = 1.0 / (1 - p) if impl == "upscale_in_train" else 1.0
    torch.testing.assert_close(y[kept], v[kept] * scale, rtol=1e-6, atol=0)
    assert (y[~kept] == 0).all()
    (g,) = torch.autograd.grad(y.sum(), [v])
    torch.testing.assert_close(g, mask * scale, rtol=1e-6, atol=0)
    assert torch.equal(run(3)["Mask"][0], mask)
    assert not torch.equal(run(4)["Mask"][0], mask)


# -- batch_norm -----------------------------------------------------------------

@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("is_test", [False, True])
def test_batch_norm(layout, is_test):
    shape = (4, 3, 5, 6) if layout == "NCHW" else (4, 5, 6, 3)
    ins = {"X": [_randn(2, *shape) * 2 + 1], "Scale": [_randn(3, 3)],
           "Bias": [_randn(4, 3)], "Mean": [_randn(5, 3) * 0.1],
           "Variance": [np.abs(_randn(6, 3)) + 0.5]}
    _run("batch_norm", ins, {"epsilon": 1e-5, "momentum": 0.9,
                             "data_layout": layout, "is_test": is_test},
         ["X", "Scale", "Bias"], "Y")


def test_batch_norm_after_an_fc():
    """VGG's batch_norm over [B, C] (fc1 of ``vgg_bn_drop``)."""
    ins = {"X": [_randn(7, 16, 8)], "Scale": [_randn(8, 8)],
           "Bias": [_randn(9, 8)], "Mean": [np.zeros(8, np.float32)],
           "Variance": [np.ones(8, np.float32)]}
    _run("batch_norm", ins, {}, ["X", "Scale", "Bias"], "Y")


# -- lookup_table -----------------------------------------------------------------

@pytest.mark.parametrize("op", ["lookup_table", "lookup_table_v2"])
@pytest.mark.parametrize("ids_shape,pad", [((6, 1), -1), ((3, 4), 2),
                                           ((5,), 0)])
def test_lookup_table(op, ids_shape, pad):
    ids = np.random.RandomState(10).randint(0, 7, ids_shape).astype(np.int64)
    ids.reshape(-1)[:3] = [2, 2, 0]              # duplicates and the padding id
    _run(op, {"W": [_randn(11, 7, 5)], "Ids": [ids]}, {"padding_idx": pad},
         ["W"], "Out")


def test_lookup_table_out_of_range_ids_match_jax():
    """A 4-row table and ids [-5, -1, 0, 3, 4, 9]: NaN rows for -5, 4 and
    9, row 3 for -1, and the gradient reaches rows 0 and 3 only (row 3
    twice), as ``jnp.take`` gives them."""
    w = _randn(12, 4, 3)
    ids = np.array([[-5], [-1], [0], [3], [4], [9]], np.int64)
    jouts, pouts = _run("lookup_table", {"W": [w], "Ids": [ids]}, {},
                        ["W"], "Out")
    r = pouts["Out"][0].numpy()
    assert np.isnan(r[[0, 4, 5]]).all()
    np.testing.assert_array_equal(r[[1, 2, 3]], w[[3, 0, 3]])
    leaf = torch.from_numpy(w).requires_grad_(True)
    out = port_rule("lookup_table")({"W": [leaf], "Ids": [torch.from_numpy(ids)]},
                                    {}, None)["Out"][0]
    (g,) = torch.autograd.grad(out[[1, 2, 3]].sum(), [leaf])
    np.testing.assert_array_equal(g.numpy()[:, 0], [1.0, 0.0, 0.0, 2.0])


# -- losses -----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["hard", "soft", "ignore_default",
                                  "ignore_in_range", "out_of_range", "3d"])
def test_softmax_with_cross_entropy(case):
    rng = np.random.RandomState(13)
    logits = rng.randn(6, 10).astype(np.float32) * 3
    label = rng.randint(0, 10, (6, 1)).astype(np.int64)
    attrs = {}
    if case == "soft":
        label = rng.rand(6, 10).astype(np.float32)
        label /= label.sum(-1, keepdims=True)
        attrs = {"soft_label": True}
    if case == "ignore_default":
        label[[1, 4], 0] = -100
    if case == "ignore_in_range":
        label[[1, 4], 0] = 3
        attrs = {"ignore_index": 3}
    if case == "out_of_range":
        label[2, 0] = -1                     # the last class, as JAX wraps it
        label[4, 0] = 12                     # NaN, as JAX's filling gather
    if case == "3d":                         # the RNN encoder-decoder's
        logits = rng.randn(3, 4, 10).astype(np.float32)
        label = rng.randint(0, 10, (3, 4, 1)).astype(np.int64)
    jouts, _ = _run("softmax_with_cross_entropy",
                    {"Logits": [logits], "Label": [label]}, attrs,
                    ["Logits"], "Loss")
    loss = np.asarray(jouts["Loss"][0])
    if case.startswith("ignore"):
        assert (loss[[1, 4], 0] == 0).all() and (loss[[0, 2, 3, 5], 0] > 0).all()
    if case == "out_of_range":
        assert np.isnan(loss[4, 0]) and np.isfinite(loss[2, 0])


def test_square_error_cost():
    _run("square_error_cost", {"X": [_randn(14, 8, 1)], "Y": [_randn(15, 8, 1)]},
         {}, ["X", "Y"], "Out")


# -- tensor ops --------------------------------------------------------------------

@pytest.mark.parametrize("attrs", [
    {"shape": [1, 16], "input_dim_idx": 0, "output_dim_idx": 0},
    {"shape": [3, 1, 2], "input_dim_idx": 1, "output_dim_idx": 1,
     "dtype": "int64", "value": 4},
])
def test_fill_constant_batch_size_like(attrs):
    _run("fill_constant_batch_size_like", {"Input": [_randn(16, 5, 7)]},
         dict({"dtype": "float32", "value": 0.5}, **attrs))


def test_transpose2():
    _run("transpose2", {"X": [_randn(17, 2, 3, 4)]}, {"axis": [1, 0, 2]},
         ["X"], "Out")


@pytest.mark.parametrize("attrs", [{"num": 4, "axis": 1},
                                   {"sections": [3, 1, 4], "axis": 1},
                                   {"num": 2, "axis": 0}])
def test_split(attrs):
    jouts, pouts = _run("split", {"X": [_randn(18, 4, 8)]}, attrs)
    v = torch.from_numpy(_randn(18, 4, 8)).requires_grad_(True)
    parts = port_rule("split")({"X": [v]}, attrs, None)["Out"]
    (g,) = torch.autograd.grad(sum((i + 1) * t.sum() for i, t in enumerate(parts)), [v])
    assert len(parts) == len(jouts["Out"]) and g.unique().numel() == len(parts)


@pytest.mark.parametrize("axes", [[2], [0, 2], [], [1]])
def test_squeeze2(axes):
    """A listed axis of another size than 1 stays, as in the JAX rule."""
    _run("squeeze2", {"X": [_randn(19, 1, 3, 1, 2)]}, {"axes": axes},
         ["X"], "Out")


@pytest.mark.parametrize("axes", [[1], [0, 3], [2, 0]])
def test_unsqueeze2(axes):
    _run("unsqueeze2", {"X": [_randn(20, 3, 2)]}, {"axes": axes}, ["X"], "Out")


@pytest.mark.parametrize("times", [[1, 6, 1], [2, 1, 3], [2, 3]])
def test_expand(times):
    _run("expand", {"X": [_randn(21, 2, 1, 3)]}, {"expand_times": times},
         ["X"], "Out")


# -- math ---------------------------------------------------------------------------

def test_sum():
    _run("sum", {"X": [_randn(22, 3, 4), _randn(23, 3, 4), _randn(24, 3, 4)]},
         {}, ["X"], "Out")


@pytest.mark.parametrize("op", ["reduce_sum", "reduce_mean", "reduce_max",
                                "reduce_min", "reduce_prod"])
@pytest.mark.parametrize("attrs", [{"dim": [1]}, {"dim": [0, 2], "keep_dim": True},
                                   {"dim": [-1]}, {"reduce_all": True}])
def test_reductions_with_ties(op, attrs):
    """Integer-valued inputs on four levels: the max and min reductions
    meet ties, which share the gradient in both."""
    v = np.random.RandomState(25).randint(-2, 2, (3, 4, 5)).astype(np.float32)
    if op == "reduce_prod":
        v = v * 0.5 + 1.25
    _run(op, {"X": [v]}, attrs, ["X"], "Out")


@pytest.mark.parametrize("op", ["reduce_all", "reduce_any"])
def test_boolean_reductions(op):
    v = np.random.RandomState(26).rand(3, 4, 5) > 0.3
    for attrs in ({"dim": [1]}, {"dim": [0, 2]}, {"reduce_all": True}):
        _run(op, {"X": [v]}, attrs)


def test_elementwise_pow_and_floor():
    """``exponential_decay``'s pair: the decay rate to the (floored) step
    ratio."""
    base = np.abs(_randn(27, 6)) + 0.5
    _run("elementwise_pow", {"X": [base], "Y": [_randn(28, 6)]}, {},
         ["X", "Y"], "Out")
    _run("elementwise_pow", {"X": [np.array([0.5], np.float32)],
                             "Y": [np.array([2.0], np.float32)]}, {})
    _run("floor", {"X": [_randn(29, 7) * 3]}, {}, ["X"], "Out")


@pytest.mark.parametrize("yrows", [5, 1])
def test_cos_sim(yrows):
    _run("cos_sim", {"X": [_randn(30, 5, 4)], "Y": [_randn(31, yrows, 4)]}, {},
         ["X", "Y"], "Out")


# -- sequence ops -------------------------------------------------------------------

LENGTHS = np.array([1, 6, 0, 3], np.int64)      # 1, the full T = 6, 0, inside


def _seq(seed, D=3, ties=False):
    data = _randn(seed, 4, 6, D)
    if ties:
        data = np.random.RandomState(seed).randint(-1, 2, (4, 6, D)).astype(np.float32)
    data[0, 1:] = 50.0                           # padding that must not leak
    data[3, 3:] = 50.0
    return data


@pytest.mark.parametrize("maxlen,dtype", [(6, "int64"), (8, "float32")])
def test_sequence_mask(maxlen, dtype):
    _run("sequence_mask", {"X": [LENGTHS]}, {"maxlen": maxlen, "out_dtype": dtype})


@pytest.mark.parametrize("ptype", ["SUM", "AVERAGE", "SQRT", "MAX", "LAST",
                                   "FIRST"])
def test_sequence_pool(ptype):
    """Lengths 1, T, 0 and 3 with 50s planted past them; MAX on inputs with
    ties (the full row holds tied maxima)."""
    ins = {"X": [_seq(32, ties=(ptype == "MAX"))], "SeqLen": [LENGTHS]}
    jouts, pouts = _run("sequence_pool", ins, {"pooltype": ptype}, ["X"], "Out")
    r = pouts["Out"][0].numpy()
    assert (r[[0, 1, 3]] < 50).all()
    if ptype == "MAX":
        assert np.isneginf(r[2]).all()          # an empty row, as jnp.max


def test_sequence_pool_without_lengths():
    _run("sequence_pool", {"X": [_randn(33, 3, 5, 2)]}, {"pooltype": "AVERAGE"},
         ["X"], "Out")


@pytest.mark.parametrize("with_len", [True, False])
def test_sequence_reverse(with_len):
    ins = {"X": [_seq(34)]}
    if with_len:
        ins["SeqLen"] = [LENGTHS]
    _, pouts = _run("sequence_reverse", ins, {}, ["X"], "Y")
    if with_len:                                 # the padding stays put
        np.testing.assert_array_equal(pouts["Y"][0].numpy()[3, 3:], 50.0)


@pytest.mark.parametrize("ctx_len,ctx_start", [(3, -1), (4, -1), (3, 0),
                                               (2, -3)])
@pytest.mark.parametrize("with_len", [True, False])
def test_sequence_conv(ctx_len, ctx_start, with_len):
    ins = {"X": [_seq(35)], "Filter": [_randn(36, ctx_len * 3, 5)]}
    if with_len:
        ins["SeqLen"] = [LENGTHS]
    _, pouts = _run("sequence_conv", ins,
                    {"contextLength": ctx_len, "contextStart": ctx_start},
                    ["X", "Filter"], "Out")
    if with_len:                                 # no 50 leaks into the window
        r = pouts["Out"][0].numpy()
        assert (r[2] == 0).all() and (r[0, 1:] == 0).all()
        assert np.abs(r[[0, 3]]).max() < 50


# -- CRF ----------------------------------------------------------------------------------

def _crf_ins(seed, B=4, T=6, D=5, lengths=LENGTHS):
    rng = np.random.RandomState(seed)
    return {"Emission": [rng.randn(B, T, D).astype(np.float32)],
            "Transition": [rng.randn(D + 2, D).astype(np.float32) * 0.5],
            "Label": [rng.randint(0, D, (B, T)).astype(np.int64)],
            "Length": [lengths]}


def test_linear_chain_crf():
    jouts, pouts = _run("linear_chain_crf", _crf_ins(37), {},
                        ["Emission", "Transition"], "LogLikelihood")
    ll = pouts["LogLikelihood"][0].numpy()
    assert ll[2, 0] == 0.0 and (ll[[0, 1, 3]] > 0).all()


@pytest.mark.parametrize("with_label", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_crf_decoding(with_label, ties):
    """With ties, emissions and transitions on two levels make most Viterbi
    steps a tie: the first index must win, as ``jnp.argmax``."""
    ins = _crf_ins(38)
    if ties:
        rng = np.random.RandomState(39)
        ins["Emission"] = [rng.randint(0, 2, (4, 6, 5)).astype(np.float32)]
        ins["Transition"] = [rng.randint(0, 2, (7, 5)).astype(np.float32)]
    if not with_label:
        ins.pop("Label")
    _run("crf_decoding", ins, {})


# -- sampling ops ---------------------------------------------------------------------------

def _nce_ins(seed, sampler, B=6, D=4, C=9):
    rng = np.random.RandomState(seed)
    ins = {"Input": [rng.randn(B, D).astype(np.float32)],
           "Label": [rng.randint(0, C, (B, 1)).astype(np.int64)],
           "Weight": [rng.randn(C, D).astype(np.float32) * 0.5],
           "Bias": [rng.randn(C, 1).astype(np.float32) * 0.1]}
    if sampler == 2:
        probs = rng.rand(C).astype(np.float32) + 0.1
        ins["CustomDistProbs"] = [probs / probs.sum()]
    return ins


@pytest.mark.parametrize("sampler", [0, 1, 2])
def test_nce_with_custom_negatives(sampler):
    attrs = {"num_total_classes": 9, "num_neg_samples": 3, "sampler": sampler,
             "custom_neg_classes": [1, 4, 8]}
    _run("nce", _nce_ins(40, sampler), attrs, ["Input", "Weight", "Bias"], "Cost")


@pytest.mark.parametrize("sampler", [0, 1, 2])
def test_nce_sampled_negatives_lie_in_range(sampler):
    """Without custom negatives the port draws from its own generator: the
    sampled labels lie in [0, C), the true labels come first, the cost is
    finite and positive."""
    ins = {k: [torch.from_numpy(a) for a in v]
           for k, v in _nce_ins(41, sampler).items()}
    attrs = {"num_total_classes": 9, "num_neg_samples": 50, "sampler": sampler}
    outs = port_rule("nce")(ins, attrs, PortContext(
        None, torch.Generator().manual_seed(0)))
    labels = outs["SampleLabels"][0]
    assert labels.shape == (6, 51) and int(labels.min()) >= 0
    assert int(labels.max()) < 9
    assert torch.equal(labels[:, :1], ins["Label"][0])
    cost = outs["Cost"][0]
    assert torch.isfinite(cost).all() and (cost > 0).all()


@pytest.mark.parametrize("num_classes", [6, 8, 2])
def test_hierarchical_sigmoid_default_tree(num_classes):
    rng = np.random.RandomState(42)
    ins = {"X": [rng.randn(5, 4).astype(np.float32)],
           "W": [rng.randn(num_classes - 1, 4).astype(np.float32)],
           "Label": [rng.randint(0, num_classes, (5, 1)).astype(np.int64)],
           "Bias": [rng.randn(num_classes - 1, 1).astype(np.float32)]}
    _run("hierarchical_sigmoid", ins, {"num_classes": num_classes},
         ["X", "W", "Bias"], "Out")


def test_hierarchical_sigmoid_custom_tree():
    rng = np.random.RandomState(43)
    path = np.array([[0, 2, -1], [0, 1, 3], [0, -1, -1], [0, 2, 4]], np.int64)
    code = rng.randint(0, 2, path.shape).astype(np.int64)
    ins = {"X": [rng.randn(4, 3).astype(np.float32)],
           "W": [rng.randn(5, 3).astype(np.float32)],
           "Label": [np.array([[0], [1], [2], [3]], np.int64)],
           "Bias": [rng.randn(5, 1).astype(np.float32)],
           "PathTable": [path], "PathCode": [code]}
    _run("hierarchical_sigmoid", ins, {"num_classes": 5},
         ["X", "W", "Bias"], "Out")


# -- adagrad and the sparse-aware math rules -------------------------------------------------

def test_adagrad_dense():
    rng = np.random.RandomState(44)
    _run("adagrad", {"Param": [rng.randn(5, 4).astype(np.float32)],
                     "Grad": [rng.randn(5, 4).astype(np.float32)],
                     "Moment": [np.abs(rng.randn(5, 4)).astype(np.float32)],
                     "LearningRate": [np.array([0.1], np.float32)]},
         {"epsilon": 1e-6})


def _both_rows(rows, vals, height):
    return (JaxRows(jnp.asarray(rows), jnp.asarray(vals), height),
            SelectedRows(torch.from_numpy(rows), torch.from_numpy(vals), height))


@pytest.mark.parametrize("op,attrs,dense", [
    ("scale", {"scale": 0.5, "bias": 0.0}, None),
    ("elementwise_mul", {}, np.array([0.25], np.float32)),
    ("elementwise_div", {}, np.array(4.0, np.float32)),
    ("sum", {}, "rows"),                        # SelectedRows + SelectedRows
    ("sum", {}, "dense"),                       # + a dense term (regularizer)
])
def test_sparse_gradients_pass_the_math_rules_as_in_jax(op, attrs, dense):
    rows = np.array([3, 0, 3, 6], np.int64)
    vals = _randn(45, 4, 2)
    jg, pg = _both_rows(rows, vals, 6)
    if op == "sum":
        if dense == "rows":
            jg2, pg2 = _both_rows(np.array([1, 3], np.int64), _randn(46, 2, 2), 6)
        else:
            d = _randn(47, 6, 2)
            jg2, pg2 = jnp.asarray(d), torch.from_numpy(d)
        jins, pins = {"X": [jg, jg2]}, {"X": [pg, pg2]}
    else:
        jins, pins = {"X": [jg]}, {"X": [pg]}
        if dense is not None:
            jins["Y"], pins["Y"] = [jnp.asarray(dense)], [torch.from_numpy(dense)]
    j = jax_rule(op)(jins, attrs, JaxContext(None, None, seed_root=0))["Out"][0]
    p = port_rule(op)(pins, attrs, None)["Out"][0]
    assert isinstance(p, SelectedRows) and p.height == j.height
    np.testing.assert_array_equal(p.rows.numpy(), np.asarray(j.rows))
    _close(p.values.numpy(), np.asarray(j.values), 1e-6, op)
