"""Item 3-B's tranche 5, the probes (``tests/test_torch_op_rules_5.py``
holds the rows themselves), with that file's harness and tolerances:

- every row of ``RULE_CASES_5`` with its float slots cast to int32 and to
  bool (``CONVERSE_5`` lists where the port computes and the JAX rule
  raises);
- +0 / -0 (forward and gradients), +-inf and NaN, and subnormals (XLA's
  CPU flushes them in its arithmetic; ``_FLUSHED`` rows hold the port on
  the flushed input, as ``tests/test_torch_op_rules_4.py`` does);
  ``conv3d_transpose`` of a non-finite value spreads NaN through XLA's
  dilated convolution (0 inf), where torch's transposed convolution does
  not: there the port is held to its own float64 run;
- ``REFUSALS_5`` raise in both packages (the JAX rule traced, as its
  Executor runs it), and what JAX's eager ``lax.slice`` does instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401  (registers the JAX rules)
from paddle_tpu.registry import OpLoweringContext as JaxContext
from paddle_tpu.registry import get_lowering as jax_rule
from paddle_tpu_torch.registry import OpLoweringContext as PortContext
from paddle_tpu_torch.registry import get_lowering as port_rule
from paddle_tpu_torch.tools.rule_cases import cast_rows
from paddle_tpu_torch.tools.rule_cases_5 import REFUSALS_5, RULE_CASES_5
from test_torch_fluid_ops import FWD_TOL, _close, _rule_matches, _run


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the probes ------------------------------------------------------------------

_CAST_ROWS = cast_rows(RULE_CASES_5)

# the port computes where the JAX rule raises (not queued): lax.logistic
# refuses integers and bool (the port's sigmoid promotes them), jnp's
# scatter-add refuses bool (the port's index_add takes it), and so does
# neg (teacher_student_sigmoid_loss's -|x|)
CONVERSE_5 = {"sigmoid_focal_loss_int32", "sigmoid_focal_loss_gamma_1_5_fg_0_int32",
              "lstm_unit_int32", "lstm_unit_bool",
              "scatter_nd_add_bool", "scatter_nd_add_out_of_range_bool",
              "scatter_nd_bool", "scatter_nd_out_of_range_bool",
              "teacher_student_sigmoid_loss_bool"}


def _port(op, ins, attrs):
    return port_rule(op)({k: [torch.from_numpy(np.array(a)) for a in v]
                          for k, v in ins.items()}, dict(attrs),
                         PortContext(None, torch.Generator().manual_seed(0)))


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
            assert cid not in CONVERSE_5
            return
        assert cid in CONVERSE_5, "the JAX rule raises on %s" % cid
        return
    assert cid not in CONVERSE_5
    _rule_matches(op, ins, attrs)


def _plant(ins, vals):
    """Every float slot with its first elements set to ``vals``."""
    out = {}
    for k, v in ins.items():
        out[k] = []
        for a in v:
            if np.issubdtype(a.dtype, np.floating):
                a = a.copy()
                flat = a.reshape(-1)
                flat[:len(vals)] = vals[:flat.size]
            out[k].append(a)
    return out


_FLOAT_ROWS = [c for c in RULE_CASES_5
               if any(np.issubdtype(a.dtype, np.floating)
                      for v in c[2].values() for a in v)]
_SIGNED_ZEROS = np.array([0.0, -0.0, 0.0, -0.0], np.float32)
_NON_FINITE = np.array([np.inf, -np.inf, np.nan], np.float32)
_SUBNORMAL = np.array([1e-40, -1e-40, 3e-39], np.float32)


@pytest.mark.parametrize("case", _FLOAT_ROWS, ids=[c[0] for c in _FLOAT_ROWS])
def test_signed_zeros_and_their_gradients_match_jax(case):
    _, op, ins, attrs, grad_slots, grad_out = case
    _run(op, _plant(ins, _SIGNED_ZEROS), dict(attrs), grad_slots, grad_out)


def _jax_outs(op, ins, attrs):
    return jax_rule(op)({k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
                        dict(attrs), JaxContext(None, None, seed_root=0))


@pytest.mark.parametrize("case", _FLOAT_ROWS, ids=[c[0] for c in _FLOAT_ROWS])
def test_infinities_and_nan_match_jax(case):
    """The forward; ``conv3d_transpose``: XLA's transposed convolution is a
    convolution of the input dilated by zeros, so an inf meets a 0 and
    NaN spreads past the true sum's; the port's NaN and inf are its own
    float64 run's, and JAX's NaN a strict superset of them."""
    _, op, ins, attrs, _, _ = case
    planted = _plant(ins, _NON_FINITE)
    if op != "conv3d_transpose":
        _run(op, planted, dict(attrs))
        return
    got = _port(op, planted, attrs)["Output"][0]
    f64 = port_rule(op)({k: [torch.from_numpy(a).double() for a in v]
                         for k, v in planted.items()}, dict(attrs),
                        PortContext(None, torch.Generator()))["Output"][0]
    assert torch.equal(torch.isnan(got), torch.isnan(f64))
    assert torch.equal(torch.isinf(got), torch.isinf(f64))
    jv = np.asarray(_jax_outs(op, planted, attrs)["Output"][0])
    assert (np.isnan(jv) >= torch.isnan(got).numpy()).all()
    assert np.isnan(jv).sum() > torch.isnan(got).sum()


def _flushed(ins):
    return {k: [np.where(np.abs(a) < np.finfo(np.float32).tiny, np.float32(0), a)
                .astype(a.dtype) if np.issubdtype(a.dtype, np.floating) else a
                for a in v] for k, v in ins.items()}


# rows whose forward reads a subnormal through XLA's flushing arithmetic: a
# divide by one (data_norm's BatchSize), comparisons (unique's groups,
# teacher_student_sigmoid_loss's label bands, positive_negative_pair's
# ties and orders)
_FLUSHED = {"data_norm", "data_norm_update_stats", "unique",
            "unique_signed_zeros_nan", "teacher_student_sigmoid_loss",
            "positive_negative_pair",
            "positive_negative_pair_weighted_accumulated"}


@pytest.mark.parametrize("case", _FLOAT_ROWS, ids=[c[0] for c in _FLOAT_ROWS])
def test_subnormals_match_jax(case):
    """The forward on subnormals; for ``_FLUSHED`` rows the port reads the
    input with its subnormals flushed to 0, as XLA's CPU reads them (and
    differs from JAX without the flush)."""
    cid, op, ins, attrs, _, _ = case
    planted = _plant(ins, _SUBNORMAL)
    if cid not in _FLUSHED:
        _run(op, planted, dict(attrs))
        return
    with pytest.raises(AssertionError):
        _run(op, planted, dict(attrs))
    jouts = _jax_outs(op, planted, attrs)
    pouts = _port(op, _flushed(planted), attrs)
    for slot in jouts:
        for j, p in zip(jouts[slot], pouts[slot]):
            j, p = np.asarray(j), p.detach().numpy()
            if np.issubdtype(j.dtype, np.floating):
                _close(p, j, FWD_TOL, "%s %s" % (op, slot))
            else:
                np.testing.assert_array_equal(p, j)


@pytest.mark.parametrize("case", REFUSALS_5, ids=[c[0] for c in REFUSALS_5])
def test_refusals_raise_in_both_packages(case):
    """The JAX rule traced, as its Executor runs it: ``lax.slice`` past the
    axis raises there (called eagerly it clamps the start instead, see
    below); the port raises as the traced rule does."""
    _, op, ins, attrs = case
    with pytest.raises(Exception):
        jax.jit(lambda: _jax_outs(op, ins, attrs))()
    with pytest.raises(ValueError):
        _port(op, ins, attrs)


def test_eager_lax_slice_past_the_axis_clamps_where_traced_it_raises():
    """Not queued (XLA's implementation): JAX's eager ``lax.slice`` moves a
    start that would pass the axis back inside it, as ``dynamic_slice``
    does; traced, the same call raises.  The port keeps the Executor's
    (traced) meaning, and its Offsets input the clamp."""
    _, op, ins, attrs = REFUSALS_5[0]
    eager = np.asarray(_jax_outs(op, ins, attrs)["Out"][0])
    np.testing.assert_array_equal(eager, ins["X"][0][1:3, 1:4, 0:2])
    got = _port(op, dict(ins, Offsets=[np.array(attrs["offsets"], np.int32)]),
                {"shape": attrs["shape"]})["Out"][0]
    np.testing.assert_array_equal(got.numpy(), eager)
