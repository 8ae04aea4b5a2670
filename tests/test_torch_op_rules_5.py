"""Item 3-B's tranche 5: the 59 rules of ``ops/misc_ops.py`` (20),
``ops/misc_ops2.py`` (7), ``ops/misc_ops3.py`` (16) and
``ops/misc_ops4.py`` (16), each against the JAX package's rule through
``registry.get_lowering`` on the CPU, with
``tests/test_torch_fluid_ops.py``'s harness: the forward to 1e-6 and the
gradients of a seeded cotangent to 1e-5 of the largest magnitude (f32);
integer and bool outputs exactly.

- the registry: 302 of the JAX registry's 357 op types (287 after tranche
  5, then tranche 8's 15 collective ops), 55 left, none of
  this tranche;
- every row of ``tools/rule_cases_5.py``'s ``RULE_CASES_5`` forward and
  backward (the kinks and attribute edges are rows), and each under
  ``tools/fp_bounds.py``'s ``BoundMode`` (the CPU's f32 result within the
  derived bound, as the card's phase 44 holds it);
- the probes and the refusals: ``tests/test_torch_op_rules_5_probes.py``;
- by contract, what the port does not take from ``jax.random``
  (``random_crop``, ``uniform_random_batch_size_like``,
  ``gaussian_random_batch_size_like``): shape, dtype, range, mean and std
  within a derived sampling bound, the crop's starts, SeedOut, and the
  same seed giving the same values;
- ``cvm``'s identity gradient where show and click make it differ from the
  log's; ``hash``'s uint32 bits at values that wrap; the SelectedRows of
  ``get_tensor_from_selected_rows`` and ``merge_selected_rows`` against the
  JAX rules'; ``gru_unit`` and ``lstm_unit`` reached through
  ``registry.get_lowering`` only (both packages' layers compose
  primitives);
- each layer that builds one of these ops, as a Fluid program through both
  Executors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401  (registers the JAX rules)
from paddle_tpu.registry import OpLoweringContext as JaxContext
from paddle_tpu.registry import get_lowering as jax_rule
from paddle_tpu.registry import registered_ops as jax_registered
from paddle_tpu_torch.registry import OpLoweringContext as PortContext
from paddle_tpu_torch.registry import get_lowering as port_rule
from paddle_tpu_torch.registry import registered_ops
from paddle_tpu_torch.tools import fp_bounds as fb
from paddle_tpu_torch.tools.rule_cases_5 import RULE_CASES_5, TRANCHE_5
from test_torch_fluid_ops import (FWD_TOL, _close, _data, _programs_match,
                                  _randn, _rule_matches, _run)

NOT_ROWS = {"random_crop", "uniform_random_batch_size_like",
            "gaussian_random_batch_size_like", "py_func"}


def test_the_59_rules_are_registered_and_70_types_are_left():
    assert len(TRANCHE_5) == len(set(TRANCHE_5)) == 59
    port, ref = set(registered_ops()), set(jax_registered())
    assert set(TRANCHE_5) <= port and port <= ref
    # tranche 5 left 70 types; tranche 8 (the 15 collective ops, item 5-A)
    # took 15 more
    assert len(port) == 302 and len(ref) == 357
    left = ref - port
    assert len(left) == 55 and not left & set(TRANCHE_5)
    assert {c[1] for c in RULE_CASES_5} == set(TRANCHE_5) - NOT_ROWS


@pytest.mark.parametrize("case", RULE_CASES_5, ids=[c[0] for c in RULE_CASES_5])
def test_rule_matches_jax(case):
    _, op, ins, attrs, grad_slots, grad_out = case
    _run(op, ins, dict(attrs), grad_slots, grad_out)


def _f32_rule(case):
    """The rule in f32 on the CPU: outputs, cotangent, gradients."""
    _, op, ins, attrs, grad_slots, grad_out = case
    ctx = PortContext(None, torch.Generator().manual_seed(0))
    t = {k: [torch.from_numpy(np.array(a)) for a in v] for k, v in ins.items()}
    leaves = [t[s][0].requires_grad_(True) for s in grad_slots]
    outs = port_rule(op)(t, dict(attrs), ctx)
    ct, grads = None, {}
    if grad_slots:
        y = outs[grad_out][0]
        ct = torch.from_numpy(np.random.RandomState(1).standard_normal(
            tuple(y.shape)).astype(np.float32))
        grads = dict(zip(grad_slots, torch.autograd.grad(
            y, leaves, ct, allow_unused=True)))
    return outs, ct, grads


@pytest.mark.parametrize("case", RULE_CASES_5, ids=[c[0] for c in RULE_CASES_5])
def test_rule_bounds_hold_on_the_cpu(case):
    """``BoundMode`` knows every ATen op each rule and its gradient
    dispatch, and the CPU's f32 results lie within the derived bounds
    (integer and bool outputs exactly)."""
    cid, op, ins, attrs, grad_slots, grad_out = case
    outs, ct, grads = _f32_rule(case)
    t_ins = {k: [torch.from_numpy(np.array(a)) for a in v] for k, v in ins.items()}
    res, gres, _ = fb.rule_bounds(port_rule(op), t_ins, attrs, grad_slots,
                                  grad_out, ct)
    checks = [(slot, got, rb) for slot, vals in res.items()
              for got, rb in zip(outs[slot], vals)]
    checks += [("d" + s, grads[s], gres[s]) for s in grad_slots
               if gres[s] is not None]
    assert checks
    for slot, got, (ref, bound) in checks:
        rec = fb.hold_to_bound(got, ref, bound)
        assert rec["ok"], (cid, slot, rec)


def _jax_outs(op, ins, attrs):
    return jax_rule(op)({k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
                        dict(attrs), JaxContext(None, None, seed_root=0))


# -- the named traps ---------------------------------------------------------------

def test_cvm_gradient_is_the_identity_through_the_log():
    """At show / click values where d log(x + 1) / dx is far from 1, both
    rules pass the cotangent through unchanged (cvm_op.h's backward)."""
    x = np.array([[9.0, 3.0, 0.5], [0.0, 0.0, -1.0], [40.0, 39.0, 2.0]],
                 np.float32)
    ct = np.arange(9, dtype=np.float32).reshape(3, 3) + 1
    _, vjp = jax.vjp(lambda v: jax_rule("cvm")({"X": [v]}, {}, JaxContext(
        None, None, seed_root=0))["Y"][0], jnp.asarray(x))
    leaf = torch.from_numpy(x).requires_grad_(True)
    y = port_rule("cvm")({"X": [leaf]}, {}, PortContext(None, torch.Generator()))
    (g,) = torch.autograd.grad(y["Y"][0], [leaf], torch.from_numpy(ct))
    np.testing.assert_array_equal(g.numpy(), ct)
    np.testing.assert_array_equal(np.asarray(vjp(jnp.asarray(ct))[0]), ct)
    assert abs(float(y["Y"][0][0, 0]) - np.log(10.0)) < 1e-6


def test_hash_wraps_as_uint32():
    """Ids whose products pass 2^32 and 2^63 (int64 ids past 2^32 wrap
    into uint32 first), negative ids, and a modulus past 2^31: the bits
    of JAX's uint32 arithmetic."""
    x = np.array([[2 ** 32 - 1, -(2 ** 31)], [2 ** 62 + 3, -1], [0, 0]],
                 np.int64)
    for attrs in ({"num_hash": 4, "mod_by": 2 ** 32 - 5},
                  {"num_hash": 1, "mod_by": 7}):
        jouts, pouts = _rule_matches("hash", {"X": [x]}, attrs)
        assert pouts["Out"][0].dtype == torch.int32


def _sr_pair(rows, values, height):
    from paddle_tpu.sparse import SelectedRows as JaxRows
    from paddle_tpu_torch.sparse import SelectedRows as PortRows

    return (JaxRows(jnp.asarray(rows), jnp.asarray(values), height),
            PortRows(torch.from_numpy(rows), torch.from_numpy(values), height))


@pytest.mark.parametrize("op", ["get_tensor_from_selected_rows",
                                "merge_selected_rows"])
def test_selected_rows_are_merged_as_jax_merges_them(op):
    """Duplicate rows summed, the unique rows sorted and compacted to the
    front, the free slots at row ``height`` (``sparse.py``'s "xla"
    layout), values as JAX's."""
    rows = np.array([4, 1, 4, 0, 1, 4], np.int64)
    values = _randn(700, 6, 3)
    jsr, psr = _sr_pair(rows, values, 7)
    j = jax_rule(op)({"X": [jsr]}, {}, JaxContext(None, None, seed_root=0))["Out"][0]
    p = port_rule(op)({"X": [psr]}, {}, PortContext(None, torch.Generator()))["Out"][0]
    if op == "merge_selected_rows":
        np.testing.assert_array_equal(p.rows.numpy(), np.asarray(j.rows))
        assert p.rows.tolist() == [0, 1, 4, 7, 7, 7] and p.height == j.height
        j, p = j.values, p.values
    _close(p.numpy(), np.asarray(j), FWD_TOL, op)
    np.testing.assert_allclose(p.numpy()[:3], np.stack([
        values[3], values[1] + values[4], values[0] + values[2] + values[5]]),
        rtol=1e-6)


@pytest.mark.parametrize("op,ins,attrs,out_slot", [
    ("gru_unit", {"Input": [_randn(701, 2, 6)], "HiddenPrev": [_randn(702, 2, 2)],
                  "Weight": [_randn(703, 2, 6)]},
     {"gate_activation": "sigmoid", "activation": 2}, "Hidden"),
    ("lstm_unit", {"X": [_randn(704, 2, 8)], "C_prev": [_randn(705, 2, 2)]},
     {}, "C"),
])
def test_the_unit_rules_are_reached_through_the_registry(op, ins, attrs, out_slot):
    """``layers.gru_unit`` / ``lstm_unit`` compose primitives in both
    packages; the rules (for the dygraph layers of item 3-C) are held here
    through ``registry.get_lowering``, forward and backward, with an int
    enum and a name for the activations."""
    _run(op, ins, attrs, list(ins), out_slot)


# -- the random rules, by contract --------------------------------------------------

def _draw(op, ins, attrs, seed=0):
    return port_rule(op)({k: [torch.from_numpy(np.array(a)) for a in v]
                          for k, v in ins.items()}, dict(attrs),
                         PortContext(None, torch.Generator().manual_seed(seed)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uniform_random_batch_size_like_by_contract(dtype):
    """Shape with the batch dim from ``input_dim_idx``, dtype, range, mean
    within 6 standard errors of (min + max) / 2 at n = 2e5, the seed."""
    ins = {"Input": [np.zeros((7, 20000), np.float32)]}
    attrs = {"shape": [-1, 40000], "input_dim_idx": 1, "output_dim_idx": 1,
             "min": -2.0, "max": 3.0, "seed": 5, "dtype": dtype}
    attrs["shape"] = [5, -1]
    a = _draw("uniform_random_batch_size_like", ins, attrs)["Out"][0]
    b = _draw("uniform_random_batch_size_like", ins, attrs)["Out"][0]
    c = _draw("uniform_random_batch_size_like", ins, attrs, seed=1)["Out"][0]
    assert tuple(a.shape) == (5, 20000) and str(a.dtype) == "torch." + dtype
    assert float(a.min()) >= -2.0 and float(a.max()) < 3.0
    se = 5.0 / np.sqrt(12.0) / np.sqrt(a.numel())
    assert abs(float(a.double().mean()) - 0.5) < 6 * se
    assert torch.equal(a, b) and not torch.equal(a, c)
    j = _jax_outs("uniform_random_batch_size_like", ins, attrs)["Out"][0]
    assert np.shape(j) == tuple(a.shape)


def test_gaussian_random_batch_size_like_by_contract():
    """Mean and std within 6 standard errors at n = 2e5 (the std's
    standard error sigma / sqrt(2 n)), shape, dtype, the seed."""
    ins = {"Input": [np.zeros((3, 4), np.float32)]}
    attrs = {"shape": [50000, 4], "input_dim_idx": 1, "output_dim_idx": 1,
             "mean": 1.5, "std": 2.0, "seed": 2}
    a = _draw("gaussian_random_batch_size_like", ins, attrs)["Out"][0]
    b = _draw("gaussian_random_batch_size_like", ins, attrs)["Out"][0]
    n = a.numel()
    assert tuple(a.shape) == (50000, 4) and a.dtype == torch.float32
    assert abs(float(a.double().mean()) - 1.5) < 6 * 2.0 / np.sqrt(n)
    assert abs(float(a.double().std()) - 2.0) < 6 * 2.0 / np.sqrt(2 * n)
    assert torch.equal(a, b)
    j = _jax_outs("gaussian_random_batch_size_like", ins, attrs)["Out"][0]
    assert np.shape(j) == tuple(a.shape)


def test_random_crop_by_contract():
    """Each crop a window of X at starts in [0, dim - size] on every
    cropped axis, the leading axes whole, SeedOut the seed, the same seed
    the same crop, and over seeds every start reached."""
    x = np.arange(2 * 5 * 6, dtype=np.float32).reshape(2, 5, 6)
    attrs = {"shape": [3, 4], "seed": 9}
    starts = set()
    for s in range(60):
        out = _draw("random_crop", {"X": [x]}, attrs, seed=s)
        o = out["Out"][0].numpy()
        assert o.shape == (2, 3, 4) and int(out["SeedOut"][0]) == 9
        i, j = divmod(int(o[0, 0, 0]), 6)
        assert 0 <= i <= 2 and 0 <= j <= 2
        np.testing.assert_array_equal(o, x[:, i:i + 3, j:j + 4])
        starts.add((i, j))
    assert len(starts) == 9
    a = _draw("random_crop", {"X": [x]}, attrs, seed=3)["Out"][0]
    assert torch.equal(a, _draw("random_crop", {"X": [x]}, attrs, seed=3)["Out"][0])
    j = _jax_outs("random_crop", {"X": [x]}, attrs)
    assert np.shape(j["Out"][0]) == (2, 3, 4) and int(j["SeedOut"][0]) == 9


# -- the layers as Fluid programs -----------------------------------------------

def test_executor_loss_and_tensor_layers_match_jax():
    def build(fluid):
        L = fluid.layers
        p = _data(fluid, "p", "float32", (4, 1))
        lab = _data(fluid, "lab", "float32", (4, 1))
        sc = _data(fluid, "sc", "float32", (4, 5))
        cls = _data(fluid, "cls", "int64", (4, 1))
        img = _data(fluid, "img", "float32", (2, 4, 4, 6))
        ids = _data(fluid, "ids", "int32", (4, 1))
        return [L.log_loss(p, lab), L.rank_loss(lab, p, lab * 0.5),
                L.bpr_loss(sc, cls),
                L.sigmoid_focal_loss(sc, L.cast(cls, "int32"),
                                     L.fill_constant([1], "int32", 2)),
                L.multiplex([sc, sc * 2.0, sc - 1.0], ids),
                L.pad_constant_like(img, L.slice(img, [1], [0], [3]), 0.5),
                L.unfold(img, [2, 3], strides=[1, 2], paddings=[1, 0]),
                L.space_to_depth(img, 2), L.shuffle_channel(img, 2),
                L.reverse(img, [-1, 1])]
    _programs_match(build, {
        "p": np.random.RandomState(706).uniform(0.1, 0.9, (4, 1)).astype(np.float32),
        "lab": np.array([[1], [0], [1], [0]], np.float32),
        "sc": _randn(707, 4, 5), "cls": np.array([[0], [4], [2], [1]], np.int64),
        "img": _randn(708, 2, 4, 4, 6),
        "ids": np.array([[0], [2], [1], [2]], np.int32)})


def test_executor_parameter_layers_match_jax():
    """The layers that make parameters (from the JAX startup's values):
    affine_channel, row_conv, bilinear_tensor_product, spectral_norm,
    deformable_conv, conv3d_transpose, tree_conv, center_loss; and
    cvm, crop_tensor, add_position_encoding, ones_like (fill_any_like),
    teacher_student_sigmoid_loss, fsp."""
    def build(fluid):
        L = fluid.layers
        img = _data(fluid, "img", "float32", (2, 4, 5, 6))
        seq = _data(fluid, "seq", "float32", (2, 5, 3))
        a = _data(fluid, "a", "float32", (3, 4))
        b = _data(fluid, "b", "float32", (3, 5))
        off = _data(fluid, "off", "float32", (2, 18, 5, 6))
        vol = _data(fluid, "vol", "float32", (1, 2, 2, 3, 2))
        nodes = _data(fluid, "nodes", "float32", (2, 6, 3))
        edges = _data(fluid, "edges", "int32", (2, 5, 2))
        lab = _data(fluid, "lab", "int64", (3, 1))
        w = L.create_parameter([4, 3, 2], "float32", name="sn_w")
        scale = L.create_parameter([4], "float32", name="ac_scale")
        bias = L.create_parameter([4], "float32", name="ac_bias")
        return [L.affine_channel(img, scale, bias), L.row_conv(seq, 2),
                L.bilinear_tensor_product(a, b, 3),
                L.spectral_norm(w, dim=0, power_iters=2),
                L.deformable_conv(img, off, L.sigmoid(L.slice(
                    off, [1], [0], [9])), 4, 3, padding=1),
                L.conv3d_transpose(vol, 3, filter_size=2, stride=2),
                L.tree_conv(nodes, edges, 4, num_filters=2, max_depth=2),
                L.center_loss(a, lab, 3, 0.1),
                L.continuous_value_model(L.abs(b), None, use_cvm=True),
                L.crop_tensor(img, shape=[1, -1, 3, 4], offsets=[1, 0, 2, 1]),
                L.add_position_encoding(L.reshape(a, [3, 2, 2]), 0.5, 2.0),
                L.ones_like(a),
                L.teacher_student_sigmoid_loss(a, L.abs(a)),
                L.fsp_matrix(img, img * 2.0)]
    edges = np.array([[[1, 2], [1, 3], [2, 4], [2, 5], [3, 6]],
                      [[1, 2], [2, 3], [1, 4], [0, 0], [4, 5]]], np.int32)
    _programs_match(build, {
        "img": _randn(709, 2, 4, 5, 6), "seq": _randn(710, 2, 5, 3),
        "a": _randn(711, 3, 4), "b": _randn(712, 3, 5),
        "off": _randn(713, 2, 18, 5, 6), "vol": _randn(714, 1, 2, 2, 3, 2),
        "nodes": _randn(715, 2, 6, 3), "edges": edges,
        "lab": np.array([[0], [2], [1]], np.int64)})


def test_executor_metric_and_sequence_layers_match_jax():
    """chunk_eval (three schemes through the layer), mean_iou, lod_reset,
    sequence_reshape, hash, size and unique."""
    def build(fluid):
        L = fluid.layers
        inf = _data(fluid, "inf", "int64", (3, 7))
        lab = _data(fluid, "lab", "int64", (3, 7))
        n = _data(fluid, "n", "int64", (3,))
        x = _data(fluid, "x", "float32", (2, 4, 6))
        outs = []
        for scheme, types in (("IOB", 3), ("IOE", 3), ("plain", 6)):
            outs += list(L.chunk_eval(inf, lab, scheme, types,
                                      excluded_chunk_types=[1], seq_length=n))
        outs += list(L.mean_iou(L.cast(inf, "int32"), L.cast(lab, "int32"), 7))
        outs += [L.sequence_reshape(x, 3), L.lod_reset(x, target_lod=[0, 1, 4]),
                 L.hash(inf, 1000, num_hash=2), L.size(x)]
        outs += list(L.unique(L.reshape(lab, [-1]), dtype="int64"))
        return outs
    rng = np.random.RandomState(716)
    lab = rng.randint(0, 7, (3, 7)).astype(np.int64)
    inf = np.where(rng.rand(3, 7) < 0.3, rng.randint(0, 7, (3, 7)), lab)
    _programs_match(build, {"inf": inf.astype(np.int64), "lab": lab,
                            "n": np.array([7, 4, 0], np.int64),
                            "x": _randn(717, 2, 4, 6)})
