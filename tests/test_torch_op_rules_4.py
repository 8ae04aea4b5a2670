"""Item 3-B's tranche 4 with ``ctc_align`` and ``edit_distance``: the 27
rules of ``ops/sequence_ops.py`` (12), ``ops/ctc_ops.py`` (warpctc),
``ops/misc_ops4.py`` (ctc_align), ``ops/misc_ops3.py`` (edit_distance),
``ops/rnn_ops.py`` (3), ``ops/pooling_ops.py`` (5), ``ops/metric_ops.py``
(2) and ``ops/sampling_ops.py`` (2).

Every row of ``tools/rule_cases.py``'s ``RULE_CASES_4`` is held to the JAX
rule forward and backward by ``tests/test_torch_op_rules_3b.py`` (and its
int32 / bool casts by ``tests/test_torch_queue3_faults.py``).  Here:

- the registry: tranche 4's rules stay registered, and the port's op
  types are a subset of the JAX registry's (228 of 357 at this tranche;
  ``tests/test_torch_op_rules_5.py`` counts the later ones);
- the special-value probe on every row with a float input: a few of its
  elements set to +0 and -0 (forward and gradients, so the kinks of the
  max rules and the clips meet ties), to +-inf and NaN (forward), and to
  subnormals (forward).  XLA's CPU flushes subnormals to zero in its
  arithmetic (ROADMAP Queue 3, "Not queued"), so where a row's forward
  meets that, the port is held to JAX on the flushed input;
  and ``im2sequence`` of a non-finite value spreads NaN through the
  JAX rule's patch convolution (a one-hot filter: 0 inf is NaN), where
  the port gathers, so there the port is held to a plain gather;
- ``max_pool2d_with_index``'s Mask against torch's own
  ``max_pool2d(return_indices=True)`` convention at a padded, ceil-mode
  shape;
- ``warpctc``'s ``norm_by_times``: the loss as it is, the gradient over T;
- the draws of ``sample_logits`` and ``sampling_id``, which the port does
  not take from ``jax.random``: by range, by a seed, by distribution;
- each layer that builds one of these ops, as a Fluid program through
  both Executors (``auc`` over two runs, its histograms carried by the
  persistable write-back).

Tolerances are ``tests/test_torch_fluid_ops.py``'s: forward 1e-6 and
gradients 1e-5 of the largest magnitude (f32); integers exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu.ops  # noqa: F401  (registers the JAX rules)
from paddle_tpu.registry import OpLoweringContext as JaxContext
from paddle_tpu.registry import get_lowering as jax_rule
from paddle_tpu.registry import registered_ops as jax_registered
from paddle_tpu_torch.registry import OpLoweringContext as PortContext
from paddle_tpu_torch.registry import get_lowering as port_rule
from paddle_tpu_torch.registry import registered_ops
from paddle_tpu_torch.tools.rule_cases import RULE_CASES_4
from test_torch_fluid_ops import (_close, _data, _programs_match, _randn, _run,
                                  FWD_TOL)

TRANCHE_4 = """
im2sequence sequence_softmax sequence_expand_as sequence_concat sequence_pad
sequence_unpad sequence_slice sequence_erase sequence_enumerate
sequence_expand sequence_scatter sequence_topk_avg_pooling
warpctc ctc_align edit_distance gru lstm lstmp
pool3d max_pool2d_with_index maxout unpool spp auc precision_recall
sample_logits sampling_id""".split()


def test_the_27_rules_are_registered_and_129_types_are_left():
    """Named for the count at tranche 4; later tranches port more (the
    counts are ``test_torch_op_rules_5.py``'s), so this holds what stays
    true: tranche 4's rules registered, and no type the reference lacks."""
    assert len(TRANCHE_4) == len(set(TRANCHE_4)) == 27
    port, ref = set(registered_ops()), set(jax_registered())
    assert set(TRANCHE_4) <= port and port <= ref
    assert len(port) >= 228 and len(ref) == 357
    left = ref - port
    assert len(left) <= 129 and not left & set(TRANCHE_4)
    assert {op for _, op, *_ in RULE_CASES_4} == set(TRANCHE_4) - {"sampling_id"}


# -- the special-value probe -------------------------------------------------

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


_FLOAT_ROWS = [c for c in RULE_CASES_4
               if any(np.issubdtype(a.dtype, np.floating)
                      for v in c[2].values() for a in v)]
_SIGNED_ZEROS = np.array([0.0, -0.0, 0.0, -0.0], np.float32)
_NON_FINITE = np.array([np.inf, -np.inf, np.nan], np.float32)
_SUBNORMAL = np.array([1e-40, -1e-40, 3e-39], np.float32)


@pytest.mark.parametrize("case", _FLOAT_ROWS, ids=[c[0] for c in _FLOAT_ROWS])
def test_signed_zeros_and_their_gradients_match_jax(case):
    _, op, ins, attrs, grad_slots, grad_out = case
    _run(op, _plant(ins, _SIGNED_ZEROS), attrs, grad_slots, grad_out)


@pytest.mark.parametrize("case", _FLOAT_ROWS, ids=[c[0] for c in _FLOAT_ROWS])
def test_infinities_and_nan_match_jax(case):
    _, op, ins, attrs, _, _ = case
    planted = _plant(ins, _NON_FINITE)
    if op != "im2sequence":
        _run(op, planted, attrs)
        return
    x = planted["X"][0]
    got = port_rule(op)({"X": [torch.from_numpy(x)]}, dict(attrs),
                        PortContext(None, torch.Generator()))["Out"][0]
    want = F.unfold(torch.from_numpy(x), tuple(attrs["kernels"]),
                    stride=tuple(attrs.get("strides", [1, 1]))).transpose(1, 2)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    jv = np.asarray(jax_rule(op)({"X": [jnp.asarray(x)]}, dict(attrs),
                                 JaxContext(None, None, seed_root=0))["Out"][0])
    assert np.isnan(jv).sum() > torch.isnan(got).sum()     # NaN spreads in JAX


def _flushed(ins):
    return {k: [np.where(np.abs(a) < np.finfo(np.float32).tiny, np.float32(0), a)
                .astype(a.dtype) if np.issubdtype(a.dtype, np.floating) else a
                for a in v] for k, v in ins.items()}


# rows whose forward reads a subnormal through XLA's flushing arithmetic
# (a log, a max); the others compare by XLA's total order or not at all
_FLUSHED = {"sample_logits_custom", "sample_logits_custom_keep_hits",
            "max_pool2d_with_index_pad_past_window"}


@pytest.mark.parametrize("case", _FLOAT_ROWS, ids=[c[0] for c in _FLOAT_ROWS])
def test_subnormals_match_jax(case):
    """The forward on subnormals; for ``_FLUSHED`` rows the port reads the
    input with its subnormals flushed to 0, as XLA's CPU reads them (and
    differs from JAX without the flush)."""
    cid, op, ins, attrs, _, _ = case
    planted = _plant(ins, _SUBNORMAL)
    if cid not in _FLUSHED:
        _run(op, planted, attrs)
        return
    with pytest.raises(AssertionError):
        _run(op, planted, attrs)
    jctx = JaxContext(None, None, seed_root=0)
    jouts = jax_rule(op)({k: [jnp.asarray(a) for a in v]
                          for k, v in planted.items()}, dict(attrs), jctx)
    pouts = port_rule(op)({k: [torch.from_numpy(np.array(a)) for a in v]
                           for k, v in _flushed(planted).items()}, dict(attrs),
                          PortContext(None, torch.Generator().manual_seed(0)))
    for slot in jouts:
        for j, p in zip(jouts[slot], pouts[slot]):
            j, p = np.asarray(j), p.detach().numpy()
            if np.issubdtype(j.dtype, np.floating):
                _close(p, j, FWD_TOL, "%s %s" % (op, slot))
            else:
                np.testing.assert_array_equal(p, j)


# -- max_pool2d_with_index and torch's convention -----------------------------

def test_max_pool2d_with_index_mask_and_torchs_convention():
    """The JAX rule's floor output size ignores ``ceil_mode``; its Mask is
    h W + w within each plane.  At a padded shape torch's return_indices
    agree where the sizes agree (ceil_mode off), and ceil_mode gives torch
    another size, which the port does not follow."""
    x = _randn(280, 2, 3, 7, 6)
    attrs = {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1],
             "ceil_mode": True}
    jouts, pouts = _run("max_pool2d_with_index", {"X": [x]}, attrs, ["X"], "Out")
    o, idx = F.max_pool2d(torch.from_numpy(x), 3, 2, padding=1,
                          return_indices=True)
    assert torch.equal(pouts["Out"][0], o)
    assert torch.equal(pouts["Mask"][0].long(), idx)
    o_ceil, _ = F.max_pool2d(torch.from_numpy(x), 3, 2, padding=1,
                             ceil_mode=True, return_indices=True)
    assert tuple(o_ceil.shape) != tuple(pouts["Out"][0].shape)
    assert tuple(pouts["Out"][0].shape) == np.shape(jouts["Out"][0])


# -- warpctc's norm_by_times ---------------------------------------------------

def test_norm_by_times_keeps_the_loss_and_scales_the_gradient():
    case = next(c for c in RULE_CASES_4 if c[0] == "warpctc_norm_by_times")
    ins, attrs = case[2], case[3]
    t = {k: [torch.from_numpy(np.array(a)) for a in v] for k, v in ins.items()}
    leaf = t["Logits"][0].requires_grad_(True)
    ctx = PortContext(None, torch.Generator())
    scaled = port_rule("warpctc")(t, dict(attrs), ctx)["Loss"][0]
    raw = port_rule("warpctc")(t, dict(attrs, norm_by_times=False), ctx)["Loss"][0]
    assert torch.equal(scaled.detach(), raw.detach()) or torch.allclose(
        scaled, raw, rtol=2 ** -23, atol=0)
    (gs,) = torch.autograd.grad(scaled.sum(), [leaf])
    (gr,) = torch.autograd.grad(raw.sum(), [leaf])
    steps = t["LogitsLength"][0].clamp(min=1).float().reshape(-1, 1, 1)
    torch.testing.assert_close(gs, gr / steps, rtol=1e-6, atol=1e-7)


# -- the draws -------------------------------------------------------------------

def _draw_logits(seed, attrs, B=4, C=50, T=2):
    ins = {"Logits": [torch.from_numpy(_randn(281, B, C))],
           "Labels": [torch.from_numpy(np.array([[1, 7]] * B, np.int64)[:, :T])]}
    outs = port_rule("sample_logits")(ins, dict(attrs), PortContext(
        None, torch.Generator().manual_seed(seed)))
    return {k: v[0] for k, v in outs.items()}


def test_sample_logits_draws_distinct_log_uniform_negatives_from_a_seed():
    attrs = {"num_samples": 10, "seed": 3}
    a, b, c = (_draw_logits(s, attrs) for s in (0, 0, 1))
    neg = a["Samples"][:, 2:]
    assert torch.equal(a["Samples"], b["Samples"])
    assert not torch.equal(a["Samples"], c["Samples"])
    assert (neg == neg[:1]).all()                  # shared over the batch
    assert len(set(neg[0].tolist())) == 10 and int(neg.min()) >= 0
    assert int(neg.max()) < 50
    assert a["Samples"][:, :2].tolist() == [[1, 7]] * 4
    # P(k) ~ log((k + 2) / (k + 1)): over many seeds, class 0 drawn more
    # often than class 40
    counts = np.zeros(50)
    for s in range(200):
        for k in _draw_logits(s, attrs, B=1)["Samples"][0, 2:].tolist():
            counts[k] += 1
    assert counts[:5].sum() > 3 * counts[-5:].sum()
    # probabilities are the JAX rule's: P(k) S
    k = neg[0].double()
    p = torch.log((k + 2) / (k + 1)) / np.log(51.0) * 10
    torch.testing.assert_close(a["Probabilities"][0, 2:].double(), p,
                               rtol=1e-6, atol=0)
    # a hit of a true label among the negatives is pushed down by 1e20
    hits = (neg[0][None, :] == torch.tensor([[1], [7]])).any(dim=0)
    assert (a["SampledLogits"][0, 2:][hits] <= -1e9).all()


def test_sampling_id_draws_by_the_running_sum_from_a_seed():
    probs = np.array([[0.1, 0.0, 0.6, 0.3]] * 4000, np.float32)
    ins = {"X": [torch.from_numpy(probs)]}

    def draw(seed, **attrs):
        return port_rule("sampling_id")(ins, dict(seed=1, **attrs), PortContext(
            None, torch.Generator().manual_seed(seed)))["Out"][0]

    a, b, c = draw(0), draw(0), draw(1)
    assert a.dtype == torch.float32 and tuple(a.shape) == (4000,)
    assert torch.equal(a, b) and not torch.equal(a, c)
    freq = np.bincount(a.long().numpy(), minlength=4) / 4000.0
    assert freq[1] == 0
    # each frequency within 5 standard deviations of its probability
    sd = np.sqrt(probs[0] * (1 - probs[0]) / 4000)
    assert (np.abs(freq - probs[0]) <= 5 * sd + 1e-12).all(), freq
    # r ~ U[min, max): min = max = 0.95 always lands in the last class
    assert (draw(2, min=0.95, max=0.95) == 3).all()


# -- the layers as Fluid programs -----------------------------------------------

def test_executor_sequence_layers_match_jax():
    def build(fluid):
        L = fluid.layers
        x = _data(fluid, "x", "float32", (3, 4, 2))
        y = _data(fluid, "y", "float32", (3, 2, 2))
        ids = _data(fluid, "ids", "int64", (3, 5))
        n = _data(fluid, "n", "int64", (3,))
        off = _data(fluid, "off", "int64", (3, 1))
        ln = _data(fluid, "ln", "int64", (3, 1))
        padded, length = L.sequence_pad(x, 0.0, seq_len=n)
        return [L.sequence_softmax(x, seq_len=n), L.sequence_concat([x, y]),
                L.sequence_expand_as(L.reduce_sum(x, dim=1), y),
                padded, length, L.sequence_unpad(x, n),
                L.sequence_expand(L.reduce_sum(x, dim=1), ids),
                L.sequence_enumerate(ids, 3, pad_value=-1, seq_len=n),
                L.sequence_slice(x, off, ln),
                L.sequence_scatter(L.reduce_sum(x, dim=2), off, ln)]
    _programs_match(build, {
        "x": _randn(282, 3, 4, 2), "y": _randn(283, 3, 2, 2),
        "ids": np.random.RandomState(284).randint(0, 9, (3, 5)).astype(np.int64),
        "n": np.array([4, 1, 0], np.int64),
        "off": np.array([[1], [3], [0]], np.int64),
        "ln": np.array([[2], [1], [4]], np.int64)})


def test_executor_pooling_and_recurrent_layers_match_jax():
    def build(fluid):
        L = fluid.layers
        img = _data(fluid, "img", "float32", (2, 6, 4, 5))
        vol = _data(fluid, "vol", "float32", (1, 2, 4, 5, 3))
        seq = _data(fluid, "seq", "float32", (2, 3, 8))
        n = _data(fluid, "n", "int64", (2,))
        proj, cell = L.dynamic_lstmp(seq, 8, 3, seq_len=n)
        hs, last_h, last_c = L.lstm(seq, None, None, 3, 2, 1, is_bidirec=True)
        return [L.maxout(img, groups=3), L.maxout(img, groups=5, axis=-1),
                L.pool3d(vol, pool_size=2, pool_type="max", pool_stride=2,
                         pool_padding=1, ceil_mode=True),
                L.pool3d(vol, pool_size=[2, 3, 2], pool_type="avg",
                         pool_padding=[1, 0, 1]),
                L.im2sequence(img, filter_size=[2, 3], stride=[2, 1]),
                proj, cell, hs, last_h, last_c]
    _programs_match(build, {"img": _randn(285, 2, 6, 4, 5),
                            "vol": _randn(286, 1, 2, 4, 5, 3),
                            "seq": _randn(287, 2, 3, 8),
                            "n": np.array([3, 2], np.int64)})


def test_executor_ctc_layers_match_jax():
    """warpctc (both length inputs), ctc_greedy_decoder and edit_distance,
    and sampled_softmax_with_cross_entropy with given samples."""
    def build(fluid):
        L = fluid.layers
        logits = _data(fluid, "logits", "float32", (3, 6, 5))
        lab = _data(fluid, "lab", "int32", (3, 3))
        ll = _data(fluid, "ll", "int64", (3,))
        tl = _data(fluid, "tl", "int64", (3,))
        cls = _data(fluid, "cls", "float32", (3, 7))
        tru = _data(fluid, "tru", "int64", (3, 1))
        smp = _data(fluid, "smp", "int64", (3, 4))
        prb = _data(fluid, "prb", "float32", (3, 4))
        loss = L.warpctc(logits, lab, blank=4, norm_by_times=True,
                         input_length=tl, label_length=ll)
        dec, dec_len = L.ctc_greedy_decoder(logits, blank=4)
        dist, num = L.edit_distance(dec, lab, normalized=False,
                                    input_length=dec_len, label_length=ll)
        ssce = L.sampled_softmax_with_cross_entropy(
            cls, tru, 3, use_customized_samples=True, customized_samples=smp,
            customized_probabilities=prb)
        return [loss, dec, dec_len, dist, num, ssce]
    _programs_match(build, {
        "logits": _randn(288, 3, 6, 5) * 2,
        "lab": np.array([[1, 2, 2], [3, 0, 0], [0, 1, 0]], np.int32),
        "ll": np.array([3, 1, 2], np.int64), "tl": np.array([6, 4, 5], np.int64),
        "cls": _randn(289, 3, 7),
        "tru": np.array([[1], [6], [0]], np.int64),
        "smp": np.array([[1, 3, 5, 1], [6, 0, 2, 4], [0, 0, 3, 5]], np.int64),
        "prb": np.random.RandomState(290).uniform(0.1, 0.9, (3, 4))
        .astype(np.float32)})


def test_executor_auc_carries_its_histograms_over_runs():
    """Two runs of one program: the second AUC counts both batches, as the
    StatPos / StatNeg persistables come back from the first."""
    import paddle_tpu as jfluid
    import paddle_tpu_torch as pfluid
    from paddle_tpu_torch import convert

    runs = []
    for fluid in (jfluid, pfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            p = _data(fluid, "p", "float32", (8, 2))
            lab = _data(fluid, "lab", "int64", (8, 1))
            auc, states = fluid.layers.auc(p, lab, num_thresholds=31)
        runs.append((fluid, main, startup, [auc] + states))
    rng = np.random.RandomState(291)
    feeds = []
    for _ in range(2):
        s = rng.rand(8).astype(np.float32)
        s[:2] = [0.0, 1.0]
        feeds.append({"p": np.stack([1 - s, s], 1),
                      "lab": rng.randint(0, 2, (8, 1)).astype(np.int64)})
    (jf, jmain, jstart, fetch), (pf, pmain, _, _) = runs
    jexe, jscope = jf.Executor(jf.CPUPlace()), jf.Scope()
    jexe.run(jstart, scope=jscope)
    names = [v.name for v in jstart.list_vars() if v.persistable]
    pscope = convert.scope_from_numpy(convert.scope_to_numpy(jscope, names),
                                      pf.Scope(), "cpu")
    pexe = pf.Executor(pf.CPUPlace())
    fetch_names = [v.name for v in fetch]
    for feed in feeds:
        jout = jexe.run(jmain, feed=feed, fetch_list=fetch_names, scope=jscope)
        pout = pexe.run(pmain, feed=feed, fetch_list=fetch_names, scope=pscope)
        _close(pout[0], jout[0], FWD_TOL, "auc")
        np.testing.assert_array_equal(pout[1], jout[1])
        np.testing.assert_array_equal(pout[2], jout[2])
    assert int(np.asarray(pout[1]).sum() + np.asarray(pout[2]).sum()) == 16
    assert int(np.asarray(pout[1])[-1]) >= 1             # the score of 1.0 counted


def test_sequence_concat_gradients_into_every_input_match_jax():
    """The rows' harness differentiates the first input of a slot; here
    both of ``sequence_concat``'s inputs."""
    import jax

    xs = [_randn(292, 2, 3, 2), _randn(293, 2, 1, 2)]
    ct = np.random.RandomState(294).standard_normal((2, 4, 2)).astype(np.float32)
    jctx = JaxContext(None, None, seed_root=0)
    _, vjp = jax.vjp(lambda a, b: jax_rule("sequence_concat")(
        {"X": [a, b]}, {}, jctx)["Out"][0], *[jnp.asarray(v) for v in xs])
    leaves = [torch.from_numpy(v).requires_grad_(True) for v in xs]
    y = port_rule("sequence_concat")({"X": leaves}, {}, PortContext(
        None, torch.Generator()))["Out"][0]
    got = torch.autograd.grad(y, leaves, torch.from_numpy(ct))
    for g, j in zip(got, vjp(jnp.asarray(ct))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
