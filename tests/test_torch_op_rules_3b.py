"""Op rules of ROADMAP Queue 1 item 3-B that the port has, each against the
JAX package's rule through ``registry.get_lowering`` on the CPU, with
``tests/test_torch_fluid_ops.py``'s harness: the forward to 1e-6 and the
gradients of a seeded cotangent to 1e-5 of the largest magnitude (f32).

``sigmoid_cross_entropy_with_logits`` came with the data path: the CTR
program's loss (``tools/ctr_program.py``).  Its labels hold soft targets
in [0, 1] and, where ``ignore_index`` is exercised, that index, whose
elements give 0 (and no gradient); ``normalize`` divides by the count of
the other labels.

Tranches 1-3 (the 101 rules of ``math_ops``, ``nn_ops`` and
``tensor_ops``): every row of ``tools/rule_cases.py`` (one a rule and
setting, then the traps, each its own row: bilinear ``interpolate``
shrinking, which JAX antialiases, and growing; nearest at half-pixel
centres; ``p_norm`` of a 2-D input with no axis, the largest singular
value; ``isfinite``'s one bool; ``strided_slice`` with negative steps;
``gather_nd`` and ``scatter`` with ids out of range; ``group_norm`` at
N = 1; both ``gelu`` forms; ``kldiv_loss``'s four reductions), the values
those traps must give, ``randint`` by its range and seed, ``scatter``'s
repeated ids under overwrite, and the four refusals, which raise in both
packages with the same message.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.registry import OpLoweringContext as JaxContext
from paddle_tpu.registry import get_lowering as jax_rule
from paddle_tpu_torch.registry import OpLoweringContext as PortContext
from paddle_tpu_torch.registry import get_lowering as port_rule
from paddle_tpu_torch.registry import registered_ops
from paddle_tpu_torch.tools.rule_cases import REFUSALS, RULE_CASES
from test_torch_fluid_ops import _randn, _run


@pytest.mark.parametrize("ignore_index", [-100, -1])
@pytest.mark.parametrize("normalize", [False, True])
def test_sigmoid_cross_entropy_with_logits(normalize, ignore_index):
    x = _randn(70, 6, 5) * 4
    x[0, :2] = [60.0, -60.0]          # saturated logits stay finite
    label = np.random.RandomState(71).rand(6, 5).astype(np.float32)
    label[1, ::2] = ignore_index
    attrs = {"normalize": normalize}
    if ignore_index != -100:
        attrs["ignore_index"] = ignore_index
    jouts, _ = _run("sigmoid_cross_entropy_with_logits",
                    {"X": [x], "Label": [label]}, attrs, ["X"], "Out")
    out = np.asarray(jouts["Out"][0])
    if ignore_index == -1:
        assert (out[1, ::2] == 0).all()


RULES_3B_TRANCHES_1_3 = """
elementwise_floordiv elementwise_min logical_xor abs acos asin atan ceil cos
cosh erf exp log log10 log1p log2 reciprocal round rsqrt sin sinh square tan
matmul bmm pow arg_max arg_min argsort cumsum isfinite isnan isinf kron dot
p_norm maximum_entry_count
relu6 logsigmoid gelu leaky_relu elu selu softplus softsign softshrink
hard_shrink hard_sigmoid hard_swish swish mish thresholded_relu stanh brelu
prelu log_softmax depthwise_conv2d conv2d_transpose conv3d layer_norm
group_norm instance_norm l2_normalize huber_loss smooth_l1_loss label_smooth
kldiv_loss margin_rank_loss interpolate bilinear_interp nearest_interp
grid_sampler pixel_shuffle lrn temporal_shift multihead_matmul
trilinear_interp
fill_zeros_like randint assign_value share_data flatten2 slice strided_slice
expand_as unstack gather_nd scatter range shape pad2d pad tile where_index
linspace diag eye flip roll unique_with_counts shard_index""".split()


def test_the_101_rules_are_registered():
    assert len(RULES_3B_TRANCHES_1_3) == len(set(RULES_3B_TRANCHES_1_3)) == 101
    assert set(RULES_3B_TRANCHES_1_3) <= set(registered_ops())
    assert len(registered_ops()) >= 201


@pytest.mark.parametrize("case", RULE_CASES, ids=[c[0] for c in RULE_CASES])
def test_rule_matches_jax(case):
    """Every row of ``tools/rule_cases.py``, the traps included: the same
    inputs ``chip_smoke.py`` runs on the card."""
    _, op, ins, attrs, grad_slots, grad_out = case
    _run(op, ins, attrs, grad_slots, grad_out)


# -- the traps, each its own case --------------------------------------------

def test_bilinear_downsampling_antialiases():
    """4x4 -> 2x2: JAX's resize averages the whole 4x4 with a widened
    triangle; the plain bilinear would read four pixels."""
    v = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    _, pouts = _run("interpolate", {"X": [v]},
                    {"out_h": 2, "out_w": 2, "interp_method": "bilinear"},
                    ["X"], "Out")
    plain = torch.nn.functional.interpolate(torch.from_numpy(v), size=(2, 2),
                                            mode="bilinear", align_corners=False)
    assert (pouts["Out"][0] - plain).abs().max() > 0.1


def test_nearest_samples_half_pixel_centres():
    """4 -> 7 samples floor((i + 0.5) 4 / 7), not floor(i 4 / 7)."""
    v = np.arange(4, dtype=np.float32).reshape(1, 1, 1, 4)
    jouts, _ = _run("interpolate", {"X": [v]},
                    {"out_h": 1, "out_w": 7, "interp_method": "nearest"})
    np.testing.assert_array_equal(np.asarray(jouts["Out"][0]).ravel(),
                                  [0, 0, 1, 2, 2, 3, 3])


def test_p_norm_of_a_matrix_is_its_largest_singular_value():
    jouts, _ = _run("p_norm", {"X": [np.ones((2, 3), np.float32)]}, {})
    np.testing.assert_allclose(float(np.asarray(jouts["Out"][0])), 6 ** 0.5,
                               rtol=1e-6)


@pytest.mark.parametrize("bad", [None, np.nan, np.inf])
def test_isfinite_is_one_bool(bad):
    v = _randn(164, 3, 4)
    if bad is not None:
        v[1, 2] = bad
    jouts, pouts = _run("isfinite", {"X": [v]}, {})
    assert tuple(pouts["Out"][0].shape) == (1,)
    assert bool(pouts["Out"][0][0]) == (bad is None)


def test_scatter_overwrite_repeated_ids_keeps_one_candidate():
    """XLA fixes no winner among repeated ids under overwrite: each such row
    holds one of its updates, the other rows equal JAX's."""
    x, upd = _randn(169, 5, 2), _randn(170, 4, 2)
    ids = np.array([1, 3, 1, 1], np.int64)
    got = port_rule("scatter")({"X": [torch.from_numpy(x)],
                                "Ids": [torch.from_numpy(ids)],
                                "Updates": [torch.from_numpy(upd)]},
                               {"overwrite": True}, None)["Out"][0].numpy()
    want = np.asarray(jax_rule("scatter")({"X": [jnp.asarray(x)],
                                           "Ids": [jnp.asarray(ids)],
                                           "Updates": [jnp.asarray(upd)]},
                                          {"overwrite": True},
                                          JaxContext(None, None, seed_root=0))["Out"][0])
    np.testing.assert_array_equal(got[[0, 2, 3, 4]], want[[0, 2, 3, 4]])
    assert any(np.array_equal(got[1], upd[i]) for i in (0, 2, 3))
    assert any(np.array_equal(want[1], upd[i]) for i in (0, 2, 3))


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_group_norm_at_batch_one_squeezes_every_unit_dim(groups):
    jouts, pouts = _run("group_norm", {"X": [_randn(171, 1, 4, 2, 3)]},
                        {"groups": groups}, ["X"], "Y")
    for slot in ("Mean", "Variance"):
        assert tuple(pouts[slot][0].shape) == np.shape(jouts[slot][0])
    assert tuple(pouts["Mean"][0].shape) == ((groups,) if groups > 1 else ())


def test_randint_shape_range_and_seed():
    """Another stream than jax.random: held by shape, dtype, range, and a
    seeded generator repeating itself."""
    attrs = {"shape": [50, 4], "low": -3, "high": 5, "seed": 7}
    draw = [port_rule("randint")({}, attrs, PortContext(
        None, torch.Generator().manual_seed(s))) ["Out"][0] for s in (0, 0, 1)]
    jv = np.asarray(jax_rule("randint")({}, attrs, JaxContext(
        None, None, seed_root=0))["Out"][0])
    assert tuple(draw[0].shape) == jv.shape == (50, 4)
    assert draw[0].dtype == torch.int64
    assert int(draw[0].min()) >= -3 and int(draw[0].max()) < 5
    assert set(draw[0].unique().tolist()) == set(range(-3, 5))
    assert torch.equal(draw[0], draw[1]) and not torch.equal(draw[0], draw[2])


@pytest.mark.parametrize("case", REFUSALS, ids=[c[0] for c in REFUSALS])
def test_refusals_raise_in_both_packages(case):
    _, op, ins, attrs = case
    with pytest.raises(NotImplementedError) as jerr:
        jax_rule(op)({k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
                     dict(attrs),
                     JaxContext(None, None, seed_root=0))
    with pytest.raises(NotImplementedError) as perr:
        port_rule(op)({k: [torch.from_numpy(a) for a in v] for k, v in ins.items()},
                      dict(attrs), PortContext(None, torch.Generator()))
    assert str(perr.value) == str(jerr.value)
