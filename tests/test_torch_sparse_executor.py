"""The executor's SelectedRows path for ``lookup_table(is_sparse=True)``
against the JAX package's on the CPU.

An eligible table (every use an ``is_sparse`` lookup whose ids come from
the feed, every consumer of its gradient an optimizer with a sparse
branch) is not differentiated: each lookup's gathered rows are, and its
``@GRAD`` is a ``SelectedRows`` of (ids, row gradients), a ``padding_idx``
id pointed at the out-of-range sentinel.  The optimizer rules then take
their sparse branches: ``sgd`` adds every slot's update, ``momentum``,
``adam`` (``lazy_mode`` both ways) and ``adagrad`` merge duplicate rows
(``sparse.merge_rows``) and set the touched rows, after the g = 0 update
of every row for momentum and non-lazy Adam.  An ineligible table warns
once, naming it, and takes the dense gradient.

Tolerances, f32: the rules' outputs to 1e-6 of the largest magnitude of
the JAX value; the executor's losses and every persistable after the steps
to 1e-5 (the two frameworks sum in other orders); the merge routes
(``via="xla"`` and the segment kernel's plain version) to 1e-6.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu.registry import OpLoweringContext as JaxContext
from paddle_tpu.registry import get_lowering as jax_rule
from paddle_tpu.sparse import SelectedRows as JaxRows
from paddle_tpu_torch import convert
from paddle_tpu_torch import executor as pexecutor
from paddle_tpu_torch.registry import get_lowering as port_rule
from paddle_tpu_torch.sparse import SelectedRows

RULE_TOL, RUN_TOL, ROUTE_TOL = 1e-6, 1e-5, 1e-6
V, D = 12, 4


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max(initial=0.0)
    scale = max(np.abs(want).max(initial=0.0), 1e-30)
    assert err <= tol * scale, "%s: %.3g of %.3g" % (what, err, scale)


# -- the optimizer rules' SelectedRows branches ------------------------------------

# duplicates (3 three times), -1 (row V - 1, as JAX indexing counts it), the
# merge's sentinel V (a padding id), and ids past the table, which drop
ROWS = np.array([3, 0, 3, 7, -1, V, 3, V + 5, -V - 2, 7], np.int64)


def _state(seed):
    rng = np.random.RandomState(seed)
    return {"Param": [rng.randn(V, D).astype(np.float32)],
            "LearningRate": [np.array([0.05], np.float32)],
            "Velocity": [rng.randn(V, D).astype(np.float32) * 0.1],
            "Moment": [np.abs(rng.randn(V, D)).astype(np.float32)],
            "Moment1": [rng.randn(V, D).astype(np.float32) * 1e-2],
            "Moment2": [np.abs(rng.randn(V, D)).astype(np.float32) * 1e-3],
            "Beta1Pow": [np.array([0.9 ** 2], np.float32)],
            "Beta2Pow": [np.array([0.999 ** 2], np.float32)]}


@pytest.mark.parametrize("op,attrs", [
    ("sgd", {}),
    ("momentum", {"mu": 0.9}),
    ("momentum", {"mu": 0.9, "use_nesterov": True}),
    ("adam", {"lazy_mode": False}),
    ("adam", {"lazy_mode": True}),
    ("adagrad", {"epsilon": 1e-6}),
], ids=["sgd", "momentum", "nesterov", "adam", "adam_lazy", "adagrad"])
def test_sparse_branch_matches_jax(op, attrs):
    vals = np.random.RandomState(1).randn(len(ROWS), D).astype(np.float32)
    ins = _state(2)
    jins = {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}
    jins["Grad"] = [JaxRows(jnp.asarray(ROWS), jnp.asarray(vals), V)]
    pins = {k: [torch.from_numpy(a) for a in v] for k, v in ins.items()}
    pins["Grad"] = [SelectedRows(torch.from_numpy(ROWS), torch.from_numpy(vals), V)]
    jouts = jax_rule(op)(jins, attrs, JaxContext(None, None, seed_root=0))
    pouts = port_rule(op)(pins, attrs, None)
    assert set(pouts) == set(jouts)
    for slot in jouts:
        close(pouts[slot][0].numpy(), np.asarray(jouts[slot][0]), RULE_TOL,
              "%s %s" % (op, slot))
    p0, p1 = ins["Param"][0], pouts["ParamOut"][0].numpy()
    untouched = np.ones(V, bool)
    untouched[[0, 3, 7, V - 1]] = False
    if op in ("sgd", "adagrad") or attrs.get("lazy_mode"):
        # only the gradient's rows move
        np.testing.assert_array_equal(p1[untouched], p0[untouched])
    else:
        # every row takes the g = 0 update: a different optimizer from one
        # that touches only the gradient's rows
        assert (p1[untouched] != p0[untouched]).any()


# -- through the executor -------------------------------------------------------------

OPTIMIZERS = {
    "sgd": lambda f: f.optimizer.SGD(0.1),
    "momentum": lambda f: f.optimizer.Momentum(0.05, 0.9),
    "adam": lambda f: f.optimizer.Adam(1e-2),
    "adam_lazy": lambda f: f.optimizer.Adam(1e-2, lazy_mode=True),
    "adagrad": lambda f: f.optimizer.Adagrad(0.1),
}


def embed_program(fluid, opt, is_sparse=True, padding_idx=None, case=None):
    """Two lookups of one table (one through a reshape of the feed) and a
    second table, summed into a small regression; ``case`` plants an
    ineligible use."""
    main, startup = fluid.Program(), fluid.Program()
    L = fluid.layers
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = L.data("ids", shape=[3], dtype="int64")
        more = L.data("more", shape=[1], dtype="int64")
        y = L.data("y", shape=[1], dtype="float32")
        flat = L.reshape(ids, [-1, 3, 1])
        if case == "derived_ids":
            flat = L.elementwise_add(flat, L.fill_constant([1], "int64", 0))
        attr = fluid.ParamAttr(name="table")
        e1 = L.embedding(flat, size=[V, D], is_sparse=is_sparse,
                         padding_idx=padding_idx, param_attr=attr)
        e2 = L.embedding(more, size=[V, D], is_sparse=is_sparse,
                         padding_idx=padding_idx, param_attr=attr)
        e3 = L.embedding(more, size=[5, D], is_sparse=is_sparse,
                         param_attr=fluid.ParamAttr(name="small"))
        h = L.concat([L.reduce_sum(e1, dim=[1]), e2, e3], axis=1)
        if case == "dense_use":
            table = fluid.default_main_program().global_block().var("table")
            h = L.elementwise_add(h, L.reduce_mean(table))
        pred = L.fc(h, 1)
        loss = L.mean(L.square_error_cost(pred, y))
        OPTIMIZERS[opt](fluid).minimize(loss)
    return main, startup, loss


def embed_feed(seed, B=8, padding_idx=None):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, V, (B, 3)).astype("int64")
    ids[0] = [2, 2, 2]                         # duplicate rows in one lookup
    if padding_idx is not None:
        ids[1, 0] = padding_idx
    more = rng.randint(0, 5, (B, 1)).astype("int64")
    return {"ids": ids, "more": more,
            "y": rng.randn(B, 1).astype("float32")}


def run_both(opt, steps=3, padding_idx=None, case=None, is_sparse=True):
    jmain, jstart, jloss = embed_program(jfluid, opt, is_sparse, padding_idx,
                                         case)
    pmain, pstart, ploss = embed_program(pfluid, opt, is_sparse, padding_idx,
                                         case)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    names = [v.name for v in jstart.list_vars() if v.persistable]
    pscope = convert.scope_from_numpy(convert.scope_to_numpy(jscope, names),
                                      pfluid.Scope(), "cpu")
    pexe = pfluid.Executor(pfluid.CPUPlace())
    init = convert.scope_to_numpy(pscope, names)
    for step in range(steps):
        feed = embed_feed(step, padding_idx=padding_idx)
        (jl,) = jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)
        (pl,) = pexe.run(pmain, feed=feed, fetch_list=[ploss], scope=pscope)
        close(pl, jl, RUN_TOL, "step %d loss" % step)
    state = sorted(v.name for v in pmain.list_vars() if v.persistable)
    for n in state:
        close(pscope.find_tensor_as_numpy(n), jscope.find_tensor_as_numpy(n),
              RUN_TOL, n)
    plan = next(iter(pexe._cache.values()))
    return plan, pscope, init


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_sparse_tables_train_as_in_jax(opt):
    plan, _, _ = run_both(opt)
    assert sorted(plan.sparse) == ["small", "table"]
    assert len(plan.sparse["table"]) == 2       # one rows leaf per lookup


def test_padding_rows_do_not_train():
    plan, scope, init = run_both("sgd", padding_idx=5)
    np.testing.assert_array_equal(scope.find_tensor_as_numpy("table")[5],
                                  init["table"][5])


def test_sparse_and_dense_gradients_give_the_same_step():
    """``is_sparse=False`` on the same program and data: SGD's update is
    the same either way."""
    _, sparse_scope, _ = run_both("sgd")
    _, dense_scope, _ = run_both("sgd", is_sparse=False)
    for n in ("table", "small"):
        close(sparse_scope.find_tensor_as_numpy(n),
              dense_scope.find_tensor_as_numpy(n), RUN_TOL, n)


@pytest.mark.parametrize("case,reason", [
    ("dense_use", "non-sparse-lookup use"),
    ("derived_ids", "not derivable from feeds"),
])
def test_an_ineligible_table_warns_once_and_takes_the_dense_gradient(case,
                                                                     reason):
    """The warning names the table and the reason, as the JAX executor's;
    the step still matches JAX's (both fall back)."""
    from paddle_tpu import executor as jexecutor

    pexecutor._SPARSE_FALLBACK_WARNED.clear()
    jexecutor._SPARSE_FALLBACK_WARNED.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        plan, _, _ = run_both("adam", case=case)
    msgs = [str(w.message) for w in caught
            if "falls back to the DENSE" in str(w.message)]
    assert len(msgs) == 2 and msgs[0] == msgs[1], msgs   # JAX's, the port's
    assert "'table'" in msgs[0] and reason in msgs[0]
    assert sorted(plan.sparse) == ["small"]
    # one warning per (program, table): a second run does not warn again
    with warnings.catch_warnings(record=True) as again:
        warnings.simplefilter("always")
        pmain, pstart, ploss = embed_program(pfluid, "adam", case=case)
        exe, scope = pfluid.Executor(pfluid.CPUPlace()), pfluid.Scope()
        exe.run(pstart, scope=scope)
        exe.run(pmain, feed=embed_feed(0), fetch_list=[ploss], scope=scope)
        exe.run(pmain, feed=embed_feed(1), fetch_list=[ploss], scope=scope)
    assert len([w for w in again if "'table'" in str(w.message)]) == 1


def test_fetching_a_sparse_gradient_raises():
    pmain, pstart, ploss = embed_program(pfluid, "sgd")
    exe, scope = pfluid.Executor(pfluid.CPUPlace()), pfluid.Scope()
    exe.run(pstart, scope=scope)
    with pytest.raises(TypeError, match="SelectedRows"):
        exe.run(pmain, feed=embed_feed(0), fetch_list=[ploss, "table@GRAD"],
                scope=scope)


@pytest.mark.parametrize("opt", ["adam", "momentum"])
def test_both_merge_routes_give_the_same_step(opt, monkeypatch):
    """``PADDLE_TPU_SEGMENT_KERNEL=1`` routes ``merged()`` through the
    segment-sum kernel's wrapper (its plain version on the CPU): the tables
    and moments agree with the default route."""
    results = {}
    for route in ("0", "1"):
        monkeypatch.setenv("PADDLE_TPU_SEGMENT_KERNEL", route)
        pmain, pstart, ploss = embed_program(pfluid, opt)
        exe, scope = pfluid.Executor(pfluid.CPUPlace()), pfluid.Scope()
        exe.run(pstart, scope=scope)
        for step in range(3):
            exe.run(pmain, feed=embed_feed(step), fetch_list=[ploss],
                    scope=scope)
        names = [v.name for v in pmain.list_vars() if v.persistable]
        results[route] = convert.scope_to_numpy(scope, names)
    for n, want in results["0"].items():
        close(results["1"][n], want, ROUTE_TOL, n)


def test_the_recommenders_sparse_step_matches_jax():
    """The book's recommender (seven ``is_sparse`` tables, Adam) for one
    step from the same parameters: the loss, and each sparse table with its
    moments and beta powers (the dense parameters, where Adam meets
    gradients near epsilon, are held in tests/test_torch_book.py)."""
    import test_torch_book as book_tests

    jrun = book_tests.build(jfluid, "recommender")
    prun = book_tests.build(pfluid, "recommender")
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jrun.startup, scope=jscope)
    names = sorted(v.name for v in jrun.startup.list_vars() if v.persistable)
    pscope = convert.scope_from_numpy(convert.scope_to_numpy(jscope, names),
                                      pfluid.Scope(), "cpu")
    pexe = pfluid.Executor(pfluid.CPUPlace())
    (jl,) = jexe.run(jrun.main, feed=jrun.feed, fetch_list=[jrun.cost],
                     scope=jscope)
    (pl,) = pexe.run(prun.main, feed=prun.feed, fetch_list=[prun.cost],
                     scope=pscope)
    close(pl, jl, RUN_TOL, "loss")
    plan = next(iter(pexe._cache.values()))
    assert len(plan.sparse) == 7
    held = [n for n in names if any(n.startswith(w) for w in plan.sparse)]
    assert len(held) == 7 * 5        # table, 2 moments, 2 beta powers
    for n in held:
        close(pscope.find_tensor_as_numpy(n), jscope.find_tensor_as_numpy(n),
              RUN_TOL, n)
