"""The derived per-element bounds of ``tools/fp_bounds.py`` on the CPU.

They gate the data path's card checks where the order of additions is not
fixed (``chip_smoke.py``'s ``ctr_dataset`` and phase 27): each route's
merge of duplicate ids against the exact float64 sum within
gamma(n - 1) sum |x| (runs of one or two terms exactly), and Adam's and
SGD's sparse updates against a float64 recomputation with the bound
propagated through each f32 operation, 2^-149 of underflow per operation
included.  Here: the bounds hold on both merge routes of the port's CPU
path and on a step of the CTR program; they are reached (so no margin
below 1 can be promised); the underflow term is needed; a merged value
four units off is caught; Adam's moments equal their f32 replay.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.sparse import merge_rows
from paddle_tpu_torch.tools import ctr_program as cp
from paddle_tpu_torch.tools import fp_bounds as fb


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


U = 2.0 ** -24


def _merge(rows, values, via):
    r, v = merge_rows(torch.from_numpy(rows), torch.from_numpy(values),
                      1000, via=via)
    return r.numpy(), v.numpy()


def _zipf_contributions(seed, n=4000, d=5):
    rng = np.random.RandomState(seed)
    rows = (rng.zipf(1.3, n) % 1000).astype(np.int64)
    values = (rng.randn(n, d) * np.exp(rng.randn(n, d) * 3)).astype(np.float32)
    return rows, values


@pytest.mark.parametrize("via", ["xla", "kernel"])
def test_both_merge_routes_lie_within_their_bounds(via):
    rows, values = _zipf_contributions(0)
    out_rows, out = _merge(rows, values, via)
    rec = fb.merge_check(rows, values, out_rows, out, 1000)
    assert rec["rows_equal"] and rec["short_runs_exact"], rec
    assert rec["within_bound"] and rec["longest_run"] > 100, rec


def test_the_sum_bound_is_reached():
    """1 + 2^-24 + 2^-24 in f32 is 1 in any order (each addition rounds
    the tie to even): the error 2^-23 is the whole of gamma(2) (1 + 2^-23),
    so the largest ratio over many elements can come near 1."""
    rows = np.zeros(3, np.int64)
    values = np.array([[1.0], [U], [U]], np.float32)
    out_rows, out = _merge(rows, values, "xla")
    assert out[0, 0] == 1.0
    rec = fb.merge_check(rows, values, out_rows, out, 1000)
    assert 0.999 < rec["max_err_over_bound"] <= 1.0


def test_a_merge_four_units_off_is_caught():
    """Three equal terms: the bound is gamma(2) 3.3, under two units of
    the sum; four units off is outside it, and so is a term left out."""
    rows = np.array([5, 5, 5], np.int64)
    values = np.full((3, 1), 1.1, np.float32)
    out_rows, out = _merge(rows, values, "xla")
    assert fb.merge_check(rows, values, out_rows, out, 1000)["within_bound"]
    off = out.copy()
    for _ in range(4):
        off = np.nextafter(off, np.float32(10))
    assert not fb.merge_check(rows, values, out_rows, off, 1000)[
        "within_bound"]
    short = out - np.float32(1.1)
    assert not fb.merge_check(rows, values, out_rows, short, 1000)[
        "within_bound"]


def test_short_runs_are_held_exactly():
    rows = np.array([3, 5, 3, 7], np.int64)
    values = np.array([[0.1], [0.2], [0.7], [-0.0]], np.float32)
    out_rows, out = _merge(rows, values, "kernel")
    assert fb.merge_check(rows, values, out_rows, out, 1000)[
        "short_runs_exact"]
    out[out_rows == 3] = np.nextafter(out[out_rows == 3], np.float32(1))
    assert not fb.merge_check(rows, values, out_rows, out, 1000)[
        "short_runs_exact"]


def test_the_underflow_term_is_needed():
    """(1 - beta2) g^2 underflows to 0 in f32 for |g| ~ 1e-22: a bound
    relative to the exact value alone would be exceeded infinitely often;
    with 2^-149 per operation the 0 is covered."""
    g = np.array([[1e-22, -3e-23]], np.float32)
    inputs = dict(param=np.ones((4, 2), np.float32),
                  m1=np.zeros((4, 2), np.float32),
                  m2=np.zeros((4, 2), np.float32),
                  beta1_pow=np.array([0.9], np.float32),
                  beta2_pow=np.array([0.999], np.float32),
                  lr=np.array([1e-3], np.float32), rows=np.array([1]),
                  grad=g)
    out = fb.sparse_adam_f32(**inputs)
    ref = fb.sparse_adam_reference(**inputs)["Moment2Out"]
    assert (out["Moment2Out"][1] == 0).all() and (ref.r[1] > 0).all()
    relative_only = fb.UNIT * 4 * ref.r[1]
    assert (ref.r[1] > relative_only).all()
    assert fb.sparse_adam_check(out, **inputs)["Moment2Out"]["within_bound"]


@pytest.mark.parametrize("via", ["xla", "kernel"])
def test_a_ctr_step_lies_within_its_bounds(tmp_path, via, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SEGMENT_KERNEL",
                       "1" if via == "kernel" else "0")
    files = cp.write_ctr_files(str(tmp_path), n_files=1, rows_per_file=256,
                               n_fields=8, vocab=300, zipf=0.99)
    prog = cp.build_ctr_program(fluid, n_fields=8, vocab=300, embed=4,
                                mlp=(16,), lr=1e-3)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(prog.startup, scope=scope)
    ds = cp.make_dataset(fluid, "QueueDataset", files, prog, 256)
    feed = next(ds._iter_batches())
    with fb.capture_sparse_updates() as recs:
        step = fluid.Executor(fluid.CPUPlace())
        step.run(prog.main, feed=feed, fetch_list=[prog.loss], scope=scope)
    assert len(recs) == 2
    for rec in recs:
        res = fb.check_sparse_update(rec)
        assert res["ok"], res
        assert res["merge"]["longest_run"] > 2
        # the moments' arithmetic is IEEE here too: the same bits
        assert res["Moment1Out"]["f32_replay_equal"]
        assert res["Moment2Out"]["f32_replay_equal"]
    # the plan keeps the wrapped rules, which record nothing afterwards
    step.run(prog.main, feed=feed, fetch_list=[prog.loss], scope=scope)
    assert len(recs) == 2


def test_an_sgd_sparse_update_lies_within_its_bound():
    rows, values = _zipf_contributions(2, n=600, d=3)
    param = np.random.RandomState(3).randn(1000, 3).astype(np.float32)
    lr = np.array([0.37], np.float32)
    from paddle_tpu_torch.kernels.segment_update import scatter_rows_drop

    out = scatter_rows_drop(torch.from_numpy(param.copy()),
                            torch.from_numpy(rows),
                            -torch.from_numpy(lr)[0] * torch.from_numpy(values))
    rec = fb.sparse_sgd_check(out.numpy(), param, lr, rows, values)
    assert rec["ParamOut"]["within_bound"], rec
    assert rec["ParamOut"]["max_err_over_bound"] > 0


# -- op rules, operation by operation (BoundMode) --------------------------------

from paddle_tpu_torch.registry import OpLoweringContext, get_lowering  # noqa: E402
from paddle_tpu_torch.tools.rule_cases import RULE_CASES  # noqa: E402

# the CPU's own gelu evaluates erf by a polynomial of absolute error 1.5e-7
# (not the 2 ulps of CUDA's erff that the bound assumes)
_CPU_OFF_THE_CUDA_TABLE = {("gelu_erf", "Out")}


def _f32_rule(case):
    """The rule in f32 on the CPU: outputs, cotangent, gradients."""
    _, op, ins, attrs, grad_slots, grad_out = case
    ctx = OpLoweringContext(None, torch.Generator().manual_seed(0))
    t = {k: [torch.from_numpy(np.array(a)) for a in v] for k, v in ins.items()}
    leaves = [t[s][0].requires_grad_(True) for s in grad_slots]
    outs = get_lowering(op)(t, dict(attrs), ctx)
    ct, grads = None, {}
    if grad_slots:
        y = outs[grad_out][0]
        ct = torch.from_numpy(np.random.RandomState(1).standard_normal(
            tuple(y.shape)).astype(np.float32))
        got = torch.autograd.grad(y, leaves, ct, allow_unused=True)
        grads = dict(zip(grad_slots, got))
    return outs, ct, grads


@pytest.mark.parametrize("case", RULE_CASES, ids=[c[0] for c in RULE_CASES])
def test_rule_bounds_hold_on_the_cpu(case):
    """Every row of ``tools/rule_cases.py``: the bound engine knows every
    ATen op the rule and its gradient dispatch, and the CPU's f32 results
    lie within the bounds (where the bound is 0, bit for bit), the CPU's
    IEEE arithmetic and its library functions being within the CUDA
    table's ulps (but for ``_CPU_OFF_THE_CUDA_TABLE``)."""
    cid, op, ins, attrs, grad_slots, grad_out = case
    outs, ct, grads = _f32_rule(case)
    t_ins = {k: [torch.from_numpy(np.array(a)) for a in v] for k, v in ins.items()}
    res, gres, _ = fb.rule_bounds(get_lowering(op), t_ins, attrs, grad_slots,
                                  grad_out, ct)
    checks = [(slot, got, rb) for slot, vals in res.items()
              for got, rb in zip(outs[slot], vals)]
    checks += [("d" + s, grads[s], gres[s]) for s in grad_slots
               if gres[s] is not None]
    for slot, got, (ref, bound) in checks:
        if (cid, slot) in _CPU_OFF_THE_CUDA_TABLE:
            continue
        rec = fb.hold_to_bound(got, ref, bound)
        assert rec["ok"], (cid, slot, rec)


def test_a_rule_result_two_bounds_off_is_caught():
    case = next(c for c in RULE_CASES if c[0] == "matmul")
    outs, _, _ = _f32_rule(case)
    t_ins = {k: [torch.from_numpy(np.array(a)) for a in v]
             for k, v in case[2].items()}
    (ref, bound), = fb.rule_bounds(get_lowering("matmul"), t_ins, {})[0]["Out"]
    got = outs["Out"][0].detach().double()
    assert fb.hold_to_bound(got, ref, bound)["ok"]
    i = int(torch.argmax(bound))
    bad = got.clone().view(-1)
    bad[i] = ref.view(-1)[i] + 2 * bound.view(-1)[i]
    rec = fb.hold_to_bound(bad.view(got.shape), ref, bound)
    assert not rec["ok"] and rec["ratio"] >= 1.9


def test_a_copy_one_ulp_off_is_caught():
    """Data movement has a bound of 0: one ulp off anywhere fails."""
    x = np.random.RandomState(3).randn(4, 5).astype(np.float32)
    res, _, _ = fb.rule_bounds(get_lowering("flip"), {"X": [torch.from_numpy(x)]},
                               {"axis": [1]})
    (ref, bound), = res["Out"]
    assert float(bound.abs().max()) == 0.0
    got = torch.from_numpy(np.flip(x, 1).copy())
    assert fb.hold_to_bound(got, ref, bound)["ok"]
    got[2, 3] = float(np.nextafter(got[2, 3].numpy(), np.float32(9)))
    assert fb.hold_to_bound(got, ref, bound)["exact_mismatches"] == 1


def test_an_exp_three_ulps_off_is_caught():
    """exp's own bound is the CUDA table's 2 ulps."""
    x = np.linspace(-3, 3, 50).astype(np.float32)
    res, _, _ = fb.rule_bounds(get_lowering("exp"), {"X": [torch.from_numpy(x)]}, {})
    (ref, bound), = res["Out"]
    exact = ref.float()
    assert fb.hold_to_bound(exact, ref, bound)["ok"]
    off = exact.double() * (1 + 3 * 2.0 ** -23)
    assert not fb.hold_to_bound(off, ref, bound)["ok"]


def test_a_division_by_a_host_scalar_is_bounded_as_cuda_computes_it():
    """CUDA divides a tensor by a host scalar as a product with the f32
    reciprocal (two roundings, up to about 1.5 ulps); the bound covers that
    result, which a correctly rounded division's half ulp would not."""
    x = np.random.RandomState(7).uniform(1, 2, 4096).astype(np.float32)
    t = torch.from_numpy(x).double()
    mode = fb.BoundMode()
    with mode:
        mode.set_exact(t)
        y = t / 3.0
        bound = mode.bound(y)
    cuda_like = torch.from_numpy(x * (np.float32(1) / np.float32(3))).double()
    assert fb.hold_to_bound(cuda_like, y, bound)["ok"]
    half_ulp = y.abs() * 2.0 ** -24
    assert bool(((cuda_like - y).abs() > half_ulp).any())


def test_an_integer_divided_by_a_host_scalar_is_bounded_as_its_f32_division():
    """An integer tensor over a Python number gives an f32 result: the
    bound engine takes the integers in float64 and bounds the division as
    CUDA computes it (a product with the f32 reciprocal), so the card's
    x * (1 / 20) passes where the CPU's correctly rounded x / 20 differs
    from it by an ulp (``fsp``'s int32 probe: an integer product over
    H W)."""
    x = torch.tensor([3, 7, 13, 2 ** 20 + 1, -9], dtype=torch.int32)
    with fb.BoundMode() as mode:
        out = x / 20
        bound = mode.bound(out)
    assert out.dtype == torch.float64 and bool((bound > 0).all())
    ref = x.double() / 20
    card = x.float() * (np.float32(1) / np.float32(20))
    cpu = x.float() / 20
    assert fb.hold_to_bound(card, ref, bound)["ok"]
    assert fb.hold_to_bound(cpu, ref, bound)["ok"]
