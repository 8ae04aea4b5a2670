"""The port's named-axis collectives and collective op rules held to the
JAX package.

A gloo world of 2 ranks and one of 4 (``tests/torch_dp_worker.py``, a
``FileStore`` under ``tmp_path``) run every wrapper of
``parallel/collectives.py`` over the dp axis: its forward on each rank's x,
and the gradient of sum(out * w) for a seeded cotangent w through
``torch.autograd.grad``.  The JAX package runs the same wrappers on the
same x and w inside ``local_shard_map`` over a dp mesh of the 8-device CPU
mesh, with ``jax.grad`` in the body: the transposes (psum's is psum,
all_gather's is reduce_scatter, ppermute's the inverse shift, all_to_all's
the swapped dims) are the reference's.

Tolerances: at world 2 bit for bit (a sum of two operands has one rounding,
whatever the order; a gather or a permutation has none).  At world 4 the
ranks' values may be summed in another order than XLA's: each side is
within gamma(3) * sum |x_i| of the exact sum (``tools/fp_bounds.py``), so
the two within twice that.  The 15 collective op rules
(``tools/rule_cases.py`` ``COLLECTIVE_CASES``) run at world 2 with ring 0
on the dp axis, bit for bit (``c_allreduce_prod``, exp of the psum of
logs, to rtol 1e-6: exp and log come from two math libraries), and as
identities with no axis for the ring.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as JP

import paddle_tpu.ops  # noqa: F401  (registers the JAX rules)
from paddle_tpu.parallel import collectives as jcol
from paddle_tpu.parallel.mesh import local_shard_map, make_mesh as jmake_mesh
from paddle_tpu.registry import OpLoweringContext as JCtx
from paddle_tpu.registry import get_lowering as jget_lowering
from paddle_tpu_torch import ops as _pops  # noqa: F401
from paddle_tpu_torch.registry import OpLoweringContext, get_lowering
from paddle_tpu_torch.tools import fp_bounds
from paddle_tpu_torch.tools.rule_cases import COLLECTIVE_CASES

import torch_dp_worker as W

WORLDS = (2, 4)
# the reference's wrappers, with lax.pmin beside them (its c_allreduce_min
# rule calls lax.pmin directly; the port has a pmin wrapper for that rule)
JCOL = types.SimpleNamespace(**{k: getattr(jcol, k) for k in dir(jcol)},
                             pmin=lambda x, axis: lax.pmin(x, axis))
CASE_IDS = [c[0] for c in W.WRAPPER_CASES]
DIFF = {c[0]: c[2] for c in W.WRAPPER_CASES}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("col")
    scen = {n: ["collectives"] + (["collective_rules"] if n == 2 else [])
            for n in WORLDS}
    runs = {n: W.spawn_world(tmp, n, {}, scen[n]) for n in WORLDS}
    return {n: W.join_world(out, procs, scen[n])
            for n, (out, procs) in runs.items()}


def _jax_case(cid, n, xs, ws):
    """Forward and (where differentiable) gradient of a wrapper over a dp
    mesh of n devices, on the ranks' stacked x and w."""
    fn = W.wrapper_fn(JCOL, cid)

    def body(x, w):
        x, w = x[0], w[0]
        y = fn(x)
        g = (jax.grad(lambda x: jnp.sum(fn(x) * w))(x) if DIFF[cid]
             else jnp.zeros_like(x))
        return y[None], g[None]

    f = local_shard_map(body, jmake_mesh(dp=n), in_specs=(JP("dp"), JP("dp")),
                        out_specs=(JP("dp"), JP("dp")))
    y, g = f(np.stack(xs), np.stack(ws))
    return np.asarray(y), np.asarray(g)


@pytest.fixture(scope="module")
def jax_cases(worlds):
    out = {}
    for n in WORLDS:
        ranks = [r["cases"] for r in worlds[n]["collectives"]]
        for cid in CASE_IDS:
            out[(n, cid)] = _jax_case(cid, n, [r[cid]["x"] for r in ranks],
                                      [r[cid]["w"] for r in ranks])
    return out


def _terms(cid, n, r, ranks, grad):
    """The terms rank r's value sums over the ranks (None where it sums
    nothing: a gather or a permutation moves values; psum's transpose is a
    sum of the ranks' cotangents, all_gather's a sum of their chunks)."""
    xs = [q["w" if grad else "x"] for q in ranks]
    if not grad:
        if cid in ("psum", "pmean"):
            return [x / (n if cid == "pmean" else 1) for x in xs]
        if cid.startswith("reduce_scatter"):
            return [np.split(x, n, axis=int(cid[-1]))[r] for x in xs]
        if cid == "global_mean_loss":     # (psum(l) - l) + l
            ls = [np.sum(x * x) / 40.0 for x in xs]
            return ls + [-ls[r], ls[r]]
        return None
    if cid in ("psum", "pmean"):
        return [w / (n if cid == "pmean" else 1) for w in xs]
    if cid.startswith("all_gather"):
        return [np.split(w, n, axis=int(cid[-1]))[r] for w in xs]
    return None


def _hold(got, want, terms):
    """Bit for bit where nothing is summed or two terms are (one rounding,
    in any order); else within twice gamma(k - 1) * sum |terms| (each
    side's order of k terms is its own)."""
    if terms is None or len(terms) <= 2:
        np.testing.assert_array_equal(got, want)
        return
    bound = 2 * fp_bounds.gamma(len(terms) - 1) * sum(np.abs(t) for t in terms)
    assert np.all(np.abs(got - want) <= bound), np.max(np.abs(got - want))


@pytest.mark.parametrize("cid", CASE_IDS)
@pytest.mark.parametrize("n", WORLDS)
def test_wrapper_forward_matches_jax(worlds, jax_cases, n, cid):
    ranks = [r["cases"][cid] for r in worlds[n]["collectives"]]
    want_y, _ = jax_cases[(n, cid)]
    for r, rec in enumerate(ranks):
        assert rec["y"].shape == want_y[r].shape
        _hold(rec["y"], want_y[r], _terms(cid, n, r, ranks, grad=False))


@pytest.mark.parametrize("cid", [c for c in CASE_IDS if DIFF[c]])
@pytest.mark.parametrize("n", WORLDS)
def test_wrapper_gradient_matches_jax(worlds, jax_cases, n, cid):
    ranks = [r["cases"][cid] for r in worlds[n]["collectives"]]
    _, want_g = jax_cases[(n, cid)]
    for r, rec in enumerate(ranks):
        _hold(rec["g"], want_g[r], _terms(cid, n, r, ranks, grad=True))


@pytest.mark.parametrize("n", WORLDS)
def test_axis_index_and_size(worlds, n):
    got = [(r["axis_index"], r["axis_size"]) for r in worlds[n]["collectives"]]
    f = local_shard_map(lambda x: jcol.axis_index("dp")[None] + 0 * x[:1],
                        jmake_mesh(dp=n), in_specs=(JP("dp"),),
                        out_specs=JP("dp"))
    idx = np.asarray(f(np.zeros(n, np.int32)))
    assert got == [(int(i), n) for i in idx]


def test_pmax_has_no_gradient_as_in_the_reference():
    """Outside a mesh the wrapper is the identity; its gradient at a real
    axis raises (lax.pmax has no AD rule) — checked in the world run by
    the forward only, and here on the autograd function itself."""
    from paddle_tpu_torch.parallel import collectives as pcol

    x = torch.ones(3, requires_grad=True)
    assert pcol.pmax(x, "dp") is x
    with pytest.raises(NotImplementedError, match="no gradient"):
        pcol._Extremum.backward(None, torch.ones(3))


# -- the 15 collective op rules ------------------------------------------------

def _jax_rule(row, n=2):
    cid, op, ins, attrs, gslots, gout = row
    rule = jget_lowering(op)
    ctx = JCtx(None, None, None, axis_env={0: "dp"})
    slots = sorted(ins)

    def run(arrs):
        return rule({k: [a] for k, a in zip(slots, arrs)}, attrs, ctx)

    def body(*arrs_and_cot):
        arrs = [a[0] for a in arrs_and_cot[:-1]]
        cot = arrs_and_cot[-1][0]
        outs = run(arrs)
        flat = {k: v[0][None] for k, v in outs.items()}
        grads = {}
        if gslots:
            def loss(*ga):
                sub = dict(zip(slots, arrs))
                sub.update(dict(zip(gslots, ga)))
                return jnp.sum(run([sub[k] for k in slots])[gout][0] * cot)
            gs = jax.grad(loss, argnums=tuple(range(len(gslots))))(
                *[dict(zip(slots, arrs))[k] for k in gslots])
            grads = {k: g[None] for k, g in zip(gslots, gs)}
        return flat, grads

    return run, body, slots


@pytest.fixture(scope="module")
def jax_rules(worlds):
    res = {}
    ranks = worlds[2]["collective_rules"]
    for row in COLLECTIVE_CASES:
        cid, op, ins, attrs, gslots, gout = row
        if not ins:
            res[cid] = None
            continue
        _, body, slots = _jax_rule(row)
        cot = (np.stack([r[cid]["cot"] for r in ranks]) if gslots
               else np.zeros((2, 1), np.float32))
        f = local_shard_map(body, jmake_mesh(dp=2),
                            in_specs=tuple(JP("dp") for _ in range(len(slots) + 1)),
                            out_specs=JP("dp"))
        outs, grads = f(*[ins[k][0] for k in slots], cot)
        res[cid] = (jax.tree.map(np.asarray, outs), jax.tree.map(np.asarray, grads))
    return res


@pytest.mark.parametrize("row", COLLECTIVE_CASES, ids=[c[0] for c in COLLECTIVE_CASES])
def test_collective_rule_over_the_dp_axis_matches_jax(worlds, jax_rules, row):
    cid, op, ins, attrs, gslots, gout = row
    ranks = [r[cid] for r in worlds[2]["collective_rules"]]
    want = jax_rules[cid]
    for r, rec in enumerate(ranks):
        if want is None:            # the bootstrap markers: no outputs
            assert rec["outs"] == {}
            continue
        outs, grads = want
        assert sorted(rec["outs"]) == sorted(outs)
        # exp and log of the prod rule come from two math libraries, each
        # within an ulp or two; every other row moves or sums two values
        tol = dict(rtol=1e-6, atol=0) if cid == "c_allreduce_prod" else \
            dict(rtol=0, atol=0)
        for k, v in rec["outs"].items():
            np.testing.assert_allclose(v[0], outs[k][r], err_msg=k, **tol)
        for k, g in rec["grads"].items():
            np.testing.assert_allclose(g, grads[k][r], err_msg=k, **tol)


@pytest.mark.parametrize("row", COLLECTIVE_CASES, ids=[c[0] for c in COLLECTIVE_CASES])
def test_collective_rule_without_an_axis_is_the_identity(row):
    """With no axis for the ring (every JAX path: its executor never fills
    axis_env), each rule is an identity, as the JAX rule."""
    cid, op, ins, attrs, _, _ = row
    p_outs = get_lowering(op)({k: [torch.from_numpy(a[0]) for a in v]
                               for k, v in ins.items()}, attrs,
                              OpLoweringContext(None, torch.Generator()))
    j_outs = jget_lowering(op)({k: [a[0] for a in v] for k, v in ins.items()},
                               attrs, JCtx(None, None, None))
    assert sorted(p_outs) == sorted(j_outs)
    for k in p_outs:
        np.testing.assert_array_equal(p_outs[k][0].numpy(),
                                      np.asarray(j_outs[k][0]))
        np.testing.assert_array_equal(p_outs[k][0].numpy(), ins["X"][0][0])


def test_registry_gap_is_55_types():
    """Item 3-B's count: the port registers every JAX type but 55."""
    from paddle_tpu.registry import registered_ops as jreg
    from paddle_tpu_torch.registry import registered_ops as preg

    missing = set(jreg()) - set(preg())
    assert len(missing) == 55
    assert not {c[1] for c in COLLECTIVE_CASES} & missing
