"""The 18 op rules that the port's own clip, regularizer, initializer,
weight-norm and optimizer classes emit (ROADMAP Queue 1 item 3-A), each
against the JAX package's rule through ``registry.get_lowering`` on the
CPU, with ``tests/test_torch_fluid_ops.py``'s harness: the forward to 1e-6
and the gradients of a seeded cotangent to 1e-5 of the largest magnitude
(f32), on dense input and, where the JAX rule has a SelectedRows branch,
on sparse input (duplicate ids merged first).

The random rules draw another stream than ``jax.random`` by design:
``truncated_gaussian_random`` is held by its support and first two moments
at n = 1e5, ``dpsgd`` exactly at sigma = 0 and by its noise's mean and std
at sigma > 0.
"""

import math

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
from test_torch_fluid_ops import FWD_TOL, _close, _randn, _rule_matches, _run


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RULES_3A = """clip clip_by_norm squared_l2_norm sqrt elementwise_max sign
truncated_gaussian_random weight_norm dgc_momentum lars_momentum adamax dpsgd
decayed_adagrad adadelta rmsprop ftrl lamb elementwise_mod""".split()


def test_the_18_rules_are_registered():
    assert len(RULES_3A) == 18
    assert set(RULES_3A) <= set(registered_ops())
    assert len(registered_ops()) >= 99


# -- math rules ------------------------------------------------------------------

def test_sqrt():
    _run("sqrt", {"X": [np.abs(_randn(40, 4, 5)) + 0.1]}, {}, ["X"], "Out")


def test_sign_of_zero_and_nan():
    v = np.array([-2.0, -0.0, 0.0, 3.5, np.nan, np.inf, -np.inf], np.float32)
    _rule_matches("sign", {"X": [v]}, {})
    _rule_matches("sign", {"X": [np.array([-3, 0, 4], np.int32)]}, {})
    _run("sign", {"X": [_randn(41, 3, 4)]}, {}, ["X"], "Out")


@pytest.mark.parametrize("ys,axis", [((4, 5), -1), ((4,), 1), ((1, 5), -1)])
def test_elementwise_max_with_ties(ys, axis):
    a = np.round(_randn(42, 3, 4, 5))          # many ties at integers
    b = np.round(_randn(43, *ys))
    _run("elementwise_max", {"X": [a], "Y": [b]}, {"axis": axis},
         ["X", "Y"], "Out")
    a[0, 0, 0] = np.nan
    _rule_matches("elementwise_max", {"X": [a], "Y": [b]}, {"axis": axis})


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_elementwise_mod_takes_the_divisors_sign(dtype):
    """``jnp.mod`` follows the divisor's sign, as ``torch.remainder``."""
    a = np.array([[7, -7, 7, -7, 0, 5], [3, -3, 9, -9, 8, -1]]).astype(dtype)
    b = np.array([3, 3, -3, -3, 2, 4]).astype(dtype)
    _rule_matches("elementwise_mod", {"X": [a], "Y": [b]}, {})
    _rule_matches("elementwise_mod", {"X": [a], "Y": [b[:2]]}, {"axis": 0})
    if dtype == "float32":
        _run("elementwise_mod", {"X": [_randn(44, 3, 4) * 5],
                                 "Y": [_randn(45, 3, 4) + 3]}, {},
             ["X", "Y"], "Out")
        _rule_matches("elementwise_mod", {"X": [a * 0.75 + 0.3], "Y": [b * 1.5]},
                      {})


def test_clip_at_and_past_its_bounds():
    v = _randn(46, 4, 6)
    v[0, :3] = [-0.5, 0.5, 0.0]                 # exactly at a bound
    _run("clip", {"X": [v]}, {"min": -0.5, "max": 0.5}, ["X"], "Out")


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_norm(max_norm):
    _run("clip_by_norm", {"X": [_randn(47, 5, 3)]}, {"max_norm": max_norm},
         ["X"], "Out")


def test_squared_l2_norm():
    _run("squared_l2_norm", {"X": [_randn(48, 6, 2)]}, {}, ["X"], "Out")


def _sparse_both(op, rows, vals, height, attrs):
    jout = jax_rule(op)({"X": [JaxRows(jnp.asarray(rows), jnp.asarray(vals),
                                       height)]}, dict(attrs),
                        JaxContext(None, None, seed_root=0))["Out"][0]
    pout = port_rule(op)({"X": [SelectedRows(torch.from_numpy(rows),
                                             torch.from_numpy(vals), height)]},
                         dict(attrs), None)["Out"][0]
    return jout, pout


@pytest.mark.parametrize("op,attrs", [("clip", {"min": -0.3, "max": 0.4}),
                                      ("clip_by_norm", {"max_norm": 1.0}),
                                      ("clip_by_norm", {"max_norm": 100.0}),
                                      ("squared_l2_norm", {})])
def test_sparse_inputs_merge_duplicates_first(op, attrs):
    """Duplicate ids sum before the clip or the norm, as the dense gradient
    would; the merged rows (out-of-range slots at ``height``) and values
    equal JAX's."""
    rows = np.array([4, 0, 2, 2, 4, 4], np.int64)
    vals = _randn(49, 6, 3)
    jout, pout = _sparse_both(op, rows, vals, 6, attrs)
    if op == "squared_l2_norm":
        _close(pout.numpy(), np.asarray(jout), FWD_TOL, op)
        return
    np.testing.assert_array_equal(pout.rows.numpy(), np.asarray(jout.rows))
    _close(pout.values.numpy(), np.asarray(jout.values), FWD_TOL, op)
    assert pout.height == jout.height


# -- weight norm -------------------------------------------------------------

@pytest.mark.parametrize("dim", [None, 0, 1])
def test_weight_norm(dim):
    v = _randn(50, 5, 4)
    g = (np.abs(_randn(51, 1)) + 0.5 if dim is None
         else np.abs(_randn(51, v.shape[dim])) + 0.5)
    _run("weight_norm", {"V": [v], "G": [g]}, {"dim": dim}, ["V", "G"], "Out")


# -- the truncated normal ------------------------------------------------------

TRUNC_VAR = 1.0 - 4.0 * math.exp(-2.0) / math.sqrt(2 * math.pi) / math.erf(
    2.0 / math.sqrt(2.0))       # a standard normal's variance cut to [-2, 2]


@pytest.mark.parametrize("mean,std", [(0.0, 1.0), (1.5, 0.02)])
def test_truncated_gaussian_random_support_and_moments(mean, std):
    """Support [mean - 2 std, mean + 2 std]; the mean to 0.02 std and the
    variance to 2% of std^2 * TRUNC_VAR (0.7737) at n = 1e5, where the
    sampling error is about 0.003 std and 0.4%; JAX's draw is held to the
    same bounds."""
    attrs = {"shape": [100000], "mean": mean, "std": std, "seed": 3,
             "dtype": "float32"}
    ctx = PortContext(None, torch.Generator().manual_seed(7))
    got = port_rule("truncated_gaussian_random")({}, attrs, ctx)["Out"][0].numpy()
    want = np.asarray(jax_rule("truncated_gaussian_random")(
        {}, attrs, JaxContext(None, None, seed_root=0))["Out"][0])
    for v in (got, want):
        assert v.dtype == np.float32 and v.shape == (100000,)
        assert v.min() >= mean - 2 * std - 1e-6 * abs(mean)
        assert v.max() <= mean + 2 * std + 1e-6 * abs(mean)
        assert abs(v.mean() - mean) <= 0.02 * std
        assert abs(v.var() / (std * std * TRUNC_VAR) - 1.0) <= 0.02


# -- optimizer rules -------------------------------------------------------------

def _opt(seed, **slots):
    rng = np.random.RandomState(seed)
    ins = {"Param": [rng.randn(5, 4).astype(np.float32)],
           "Grad": [(rng.randn(5, 4) * 0.1).astype(np.float32)],
           "LearningRate": [np.array([0.05], np.float32)]}
    for name, kind in slots.items():
        shape = (1,) if kind in ("pow1", "pow2") else (5, 4)
        if kind == "pos":
            v = np.abs(rng.randn(*shape)) * 1e-2 + 1e-3
        elif kind == "pow1":
            v = np.array([0.9 ** 3])
        elif kind == "pow2":
            v = np.array([0.999 ** 3])
        else:
            v = rng.randn(*shape) * 1e-2
        ins[name] = [v.astype(np.float32)]
    return ins


OPT_CASES = {
    "lars_momentum": (_opt(60, Velocity="any"),
                      {"mu": 0.9, "lars_coeff": 0.001,
                       "lars_weight_decay": 0.0005}),
    "lars_momentum_eps": (_opt(61, Velocity="any"),
                          {"mu": 0.8, "lars_coeff": 0.01,
                           "lars_weight_decay": 0.01, "epsilon": 1e-4}),
    "adamax": (_opt(62, Moment="any", InfNorm="pos", Beta1Pow="pow1"),
               {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "decayed_adagrad": (_opt(63, Moment="pos"), {"decay": 0.9, "epsilon": 1e-6}),
    "adadelta": (_opt(64, AvgSquaredGrad="pos", AvgSquaredUpdate="pos"),
                 {"rho": 0.9, "epsilon": 1e-6}),
    "rmsprop": (_opt(65, MeanSquare="pos", Moment="any"),
                {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5}),
    "rmsprop_centered": (_opt(66, MeanSquare="pos", Moment="any",
                              MeanGrad="any"),
                         {"decay": 0.9, "epsilon": 1e-4, "momentum": 0.1,
                          "centered": True}),
    "ftrl": (_opt(67, SquaredAccumulator="pos", LinearAccumulator="any"),
             {"l1": 0.01, "l2": 0.02, "lr_power": -0.5}),
    "ftrl_power": (_opt(68, SquaredAccumulator="pos", LinearAccumulator="any"),
                   {"l1": 0.0, "l2": 0.0, "lr_power": -0.75}),
    "lamb": (_opt(69, Moment1="any", Moment2="pos", Beta1Pow="pow1",
                  Beta2Pow="pow2"),
             {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
              "weight_decay": 0.01}),
    "dpsgd_sigma0": (_opt(70), {"clip": 0.5, "batch_size": 8.0, "sigma": 0.0}),
    "dpsgd_sigma0_unclipped": (_opt(71), {"clip": 100.0, "batch_size": 8.0,
                                          "sigma": 0.0}),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_rules_match_jax(case):
    """Every output to 1e-6; the gradient of ParamOut into Param and Grad
    to 1e-5."""
    op = case.replace("_eps", "").replace("_centered", "").replace(
        "_power", "").replace("_sigma0_unclipped", "").replace("_sigma0", "")
    ins, attrs = OPT_CASES[case]
    _run(op, ins, attrs, ["Param", "Grad"], "ParamOut")


def test_dpsgd_noise_has_its_mean_and_std():
    """sigma > 0: (p - p_new) / lr - clipped g is the noise over batch_size,
    of mean 0 and std clip * sigma / batch_size, held to 3% at n = 1e5."""
    n, clip, sigma, bs, lr = 100000, 1.0, 2.0, 4.0, 0.1
    p = np.zeros(n, np.float32)
    g = np.full(n, 1e-4, np.float32)            # norm 0.0316 < clip
    ctx = PortContext(None, torch.Generator().manual_seed(1))
    pout = port_rule("dpsgd")({"Param": [torch.from_numpy(p)],
                               "Grad": [torch.from_numpy(g)],
                               "LearningRate": [torch.tensor([lr])]},
                              {"clip": clip, "batch_size": bs, "sigma": sigma,
                               "seed": 5}, ctx)["ParamOut"][0].numpy()
    jout = np.asarray(jax_rule("dpsgd")(
        {"Param": [jnp.asarray(p)], "Grad": [jnp.asarray(g)],
         "LearningRate": [jnp.asarray([lr], jnp.float32)]},
        {"clip": clip, "batch_size": bs, "sigma": sigma, "seed": 5},
        JaxContext(None, None, seed_root=0))["ParamOut"][0])
    want_std = clip * sigma / bs
    for out in (pout, jout):
        noise = (p - out) / lr - g
        assert abs(noise.mean()) <= 0.03 * want_std
        assert abs(noise.std() / want_std - 1.0) <= 0.03


@pytest.mark.parametrize("step", [0.0, 3.0, 7.0, 20.0])
@pytest.mark.parametrize("nesterov", [False, True])
def test_dgc_momentum_before_and_after_rampup(step, nesterov):
    """rampup_begin_step 5 over 8 steps of a three-entry schedule: plain
    momentum at steps 0 and 3, then the top-k of |v| at the ramped
    sparsity."""
    ins = _opt(72, Velocity="any", ErrorAccum="any")
    ins["Step"] = [np.array([step], np.float32)]
    attrs = {"mu": 0.9, "use_nesterov": nesterov, "rampup_begin_step": 5,
             "rampup_step": 8, "sparsity": [0.5, 0.75, 0.9]}
    _run("dgc_momentum", ins, attrs, ["Param", "Grad"], "ParamOut")


def test_dgc_momentum_with_a_sparse_gradient():
    ins = _opt(73, Velocity="any", ErrorAccum="any")
    ins["Step"] = [np.array([9.0], np.float32)]
    rows, vals = np.array([3, 0, 3], np.int64), _randn(74, 3, 4)
    attrs = {"mu": 0.9, "rampup_begin_step": 0, "rampup_step": 1,
             "sparsity": [0.8]}
    dense = {k: v for k, v in ins.items() if k != "Grad"}
    jouts = jax_rule("dgc_momentum")(
        dict({k: [jnp.asarray(a) for a in v] for k, v in dense.items()},
             Grad=[JaxRows(jnp.asarray(rows), jnp.asarray(vals), 5)]),
        attrs, JaxContext(None, None, seed_root=0))
    pouts = port_rule("dgc_momentum")(
        dict({k: [torch.from_numpy(a) for a in v] for k, v in dense.items()},
             Grad=[SelectedRows(torch.from_numpy(rows), torch.from_numpy(vals), 5)]),
        attrs, None)
    assert set(pouts) == set(jouts)
    for slot in jouts:
        _close(pouts[slot][0].numpy(), np.asarray(jouts[slot][0]), FWD_TOL, slot)


# -- the card's cases, on the CPU --------------------------------------------------

def _chip_smoke_cases():
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("case", _chip_smoke_cases().OP_RULE_CASES,
                         ids=lambda c: c[0].replace(" ", "_"))
def test_chip_smoke_op_rule_cases_hold_on_the_cpu(case):
    """Every input ``chip_smoke.py``'s op-rule phase runs on the card: the
    port's rule on the CPU equals the JAX rule (value and kind), and both
    equal the JAX values the script records."""
    smoke = _chip_smoke_cases()
    label, op, ins, attrs, want = case
    np_ins = {k: [np.array(v, dtype=dt) for v, dt in vals]
              for k, vals in ins.items()}
    _, pouts = _rule_matches(op, np_ins, attrs)
    for slot, ref in want.items():
        if ref is None:
            continue
        got = pouts[slot][0].detach()
        tol = 1e-6 if got.is_floating_point() else 0.0
        assert smoke._same_values(got, torch.tensor(ref, dtype=torch.float64),
                                  tol), (label, slot)
