"""Program-mode tensor parallelism (ROADMAP item 5-C′) held to the JAX
package.

One gloo world of 2 ranks (tp = 2) and one of 4 (dp = 2 x tp = 2)
(``tests/torch_program_tp_worker.py``, one process a rank, started once for
the module) run every Fluid program through the port's ``Executor`` with
``tensor_parallel_degree = 2``, each rank fed the global batch; while they
run, the JAX package runs the same programs with ``with_data_parallel`` at
``tensor_parallel_degree = 2`` on the 8 simulated CPU devices of
``tests/conftest.py`` (GSPMD over a (4, 2) mesh: the one-device function),
from the same JAX startup parameters and the same seeded feeds:

- ``tests/test_tensor_parallel.py``'s model (embedding "col", fc "col" /
  "row" / "col", Adam, six steps, B = 16): the losses at that test's 2e-4;
  the scope saved by every rank and loaded at one rank equal to the
  gathered blocks;
- one SGD step: the gathered gradients and parameters; the update equal to
  the port's one-rank step (ratio 1.0: the gradients are the one-device
  ones, not tp times them);
- the fleet form (``DistributedStrategy.tensor_parallel_degree = 2``, SGD,
  ``test_tp_via_fleet_strategy``'s model), LAMB (its norms summed over the
  model group), the tiny Fluid-layers encoder with the Megatron marks (two
  layers, hidden 64, four heads, dropout 0, SGD), which runs with no
  all-gather of an activation;
- kReduce with tp: the reference dryrun's program and its shapes;
- an explicit world-4 mesh with a pp axis (dp 2 x pp 2, and pp 2 x tp 2):
  one SGD step's gradients the port's one-rank ones, not pp times them;
- a dim that does not divide stays whole;
- a "row" embedding (repeated and padding ids) gives the one-rank run;
- in this process: a world that tp does not divide raises, and an explicit
  mesh without a tp axis warns and runs the plain program.

Tolerances: losses at 2e-4 (the reference test's), SGD's gradients and
parameters f32 at rtol 1e-5 and atol 1e-6, as
``tests/test_torch_program_dp.py``.  Adam's and LAMB's parameters are held
at the losses' 2e-4: their update of an element whose steps' gradients
nearly cancel is as sensitive as those gradients' rounding (one element in
2048 moved by ~1e-4 relative); a norm not summed over the model group
would move every element of a split weight by O(1) of its update.  The
replicas of every rank hold the same whole values bit for bit.
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu_torch import convert
from paddle_tpu_torch.tools.programs import (bert_encoder_program,
                                             encoder_feed)

import torch_dp_worker as W
import torch_program_tp_worker as TW


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WORLD2 = ["tp_adam", "tp_sgd_one_step", "tp_lamb", "fleet_tp", "encoder_tp",
          "kreduce_tp", "indivisible", "row_table"]
WORLD4 = ["tp_adam", "tp_sgd_one_step", "pp_mesh_sgd", "encoder_tp",
          "kreduce_tp", "row_table"]
TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)


def _start(build):
    """A program built on the JAX package, its startup run: (main, vars,
    scope, executor, the startup's persistables as numpy)."""
    main, startup, v = build(jfluid)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe.run(startup, scope=scope)
    names = sorted(x.name for x in startup.list_vars() if x.persistable)
    return main, v, scope, exe, convert.scope_to_numpy(scope, names)


def _tp(main, v, reduce=False):
    bs = jfluid.BuildStrategy()
    bs.tensor_parallel_degree = TW.TP
    if reduce:
        bs.reduce_strategy = jfluid.BuildStrategy.ReduceStrategy.Reduce
    return jfluid.CompiledProgram(main).with_data_parallel(
        loss_name=v["loss"].name, build_strategy=bs)


def _np(scope, names):
    return {n: np.asarray(scope.find_var(n)) for n in names}


def _run(start, feeds, fetch=None, program=None, reduce=False):
    main, v, scope, exe, _ = start
    prog = program or _tp(main, v, reduce)
    out = [exe.run(prog, feed=f, fetch_list=[v["loss"]] + (fetch or []),
                   scope=scope) for f in feeds]
    return out, _np(scope, TW.params_of(main))


def _jax_references(starts):
    ref = {}
    out, params = _run(starts["tp_adam"], TW.tp_feeds())
    ref["tp_adam"] = {"losses": [float(o[0]) for o in out], "params": params}
    grads = TW.grad_names(starts["tp_sgd"][0])
    out, params = _run(starts["tp_sgd"], TW.tp_feeds(1), grads)
    ref["tp_sgd"] = {"loss": float(out[0][0]), "params": params,
                     "grads": dict(zip(grads, out[0][1:]))}
    out, params = _run(starts["tp_lamb"], TW.tp_feeds(3))
    ref["tp_lamb"] = {"losses": [float(o[0]) for o in out], "params": params}
    main = starts["fleet_tp"][0]
    out, params = _run(starts["fleet_tp"], TW.fleet_feeds(), program=main)
    ref["fleet_tp"] = {"losses": [float(o[0]) for o in out],
                       "params": params}
    cfg = TW.encoder_cfg()
    out, params = _run(starts["encoder"],
                       [encoder_feed(cfg, s) for s in range(2)])
    ref["encoder"] = {"losses": [float(o[0]) for o in out], "params": params}
    out, params = _run(starts["kreduce"], TW.dryrun_feeds(8), reduce=True)
    ref["kreduce"] = {"losses": [float(o[0]) for o in out], "params": params}
    return ref


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' results by scenario and rank, and the JAX package's
    references, computed while the ranks run."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        starts = {
            "tp_adam": _start(lambda f: TW.tp_program(
                f, lambda g: g.optimizer.Adam(1e-2))),
            "tp_sgd": _start(lambda f: TW.tp_program(
                f, lambda g: g.optimizer.SGD(0.5))),
            "tp_lamb": _start(lambda f: TW.tp_program(
                f, lambda g: g.optimizer.Lamb(0.01))),
            "fleet_tp": _start(lambda f: TW.fleet_program(f, jfleet)),
            "encoder": _start(lambda f: bert_encoder_program(
                f, TW.encoder_cfg(), tp_split=True)),
            "kreduce": _start(TW.dryrun_program),
            "odd": _start(TW.indivisible_program),
            "row_table": _start(TW.row_table_program),
        }
    inputs = {k: s[4] for k, s in starts.items()}
    tmp = tmp_path_factory.mktemp("program_tp")
    runs = [(W.spawn_world(tmp, world, inputs, names, script=TW.__file__),
             names) for world, names in ((2, WORLD2), (4, WORLD4))]
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = _jax_references(starts)
    finally:
        got = {world: W.join_world(out, procs, names) for world, (
            (out, procs), names) in zip((2, 4), runs)}
    return got, ref


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), err_msg=what,
                               **tol)


def _replicas_alike(per_rank, key):
    for r, res in enumerate(per_rank[1:], 1):
        a, b = res[key], per_rank[0][key]
        assert sorted(a) == sorted(b)
        for n in a:
            assert a[n].tobytes() == b[n].tobytes(), (r, n)


@pytest.mark.parametrize("world", [2, 4])
def test_tp_model_matches_jax_tensor_parallel(worlds, world):
    """Six Adam steps at tp = 2 against JAX's tp = 2 (GSPMD: the one-device
    function), at ``test_tensor_parallel.py``'s 2e-4; the model learns."""
    got, ref = worlds
    res = got[world]["tp_adam"]
    _replicas_alike(res, "params")
    losses = res[0]["losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    _close(losses, ref["tp_adam"]["losses"], "losses", LOSS_TOL)
    # the split weights are held as this rank's block of their dim
    assert res[0]["local"]["tp_fc1"] == (32, 32)
    assert res[0]["local"]["tp_fc2"] == (32, 32)
    assert res[0]["local"]["tp_emb"] == (64, 16)
    assert res[0]["split"]["tp_fc1"] == (1, 2)
    assert res[0]["split"]["tp_fc2"] == (0, 2)
    moments = [n for n in res[0]["split"] if n.startswith("tp_fc1_moment")]
    assert moments and all(res[0]["split"][n] == (1, 2) for n in moments)
    # no activation moves but the embedding's (a col-split lookup feeding a
    # col-split fc gathers its rows, as GSPMD does)
    assert res[0]["counts"]["activation_gathers"] == TW.TP_STEPS


@pytest.mark.parametrize("world", [2, 4])
def test_saved_tp_scope_loads_whole_at_one_rank(worlds, world):
    """Every rank saves; the files hold the whole values, which a one-rank
    load reads back equal to the gathered blocks."""
    got, _ = worlds
    res = got[world]["tp_adam"][0]
    assert sorted(res["loaded"]) == sorted(res["whole"])
    for n, a in res["whole"].items():
        assert res["loaded"][n].tobytes() == a.tobytes(), n


@pytest.mark.parametrize("world", [2, 4])
def test_one_sgd_step_gradients_match_jax(worlds, world):
    """The gathered gradients and parameters after one SGD step against
    JAX's tp = 2 step."""
    got, ref = worlds
    res = got[world]["tp_sgd_one_step"]
    _replicas_alike(res, "params")
    res, want = res[0], ref["tp_sgd"]
    _close(res["loss"], want["loss"], "loss")
    for n, g in want["grads"].items():
        _close(res["grads"][n], g, n)
    for n, p in want["params"].items():
        _close(res["params"][n], p, n)


@pytest.mark.parametrize("world", [2, 4])
def test_tp_gradient_scale_is_the_one_device_one(worlds, world):
    """The update of a tp run over the port's one-rank update: 1.0 for
    every parameter (seeding 1/dp, or summing a split gradient over the
    model group, would give tp times it)."""
    got, _ = worlds
    res = got[world]["tp_sgd_one_step"][0]
    one = res["one_rank"]
    _close(res["loss"], one["loss"], "loss")
    for n, g in one["grads"].items():
        ratio = (np.linalg.norm(res["grads"][n].astype(np.float64))
                 / np.linalg.norm(g.astype(np.float64)))
        assert abs(ratio - 1.0) < 1e-5, (n, ratio)
        _close(res["grads"][n], g, n)


@pytest.mark.parametrize("mesh", ["dp2_pp2", "pp2_tp2"])
def test_a_pp_axis_keeps_the_one_device_gradient_scale(worlds, mesh):
    """An explicit world-4 mesh with a pp axis: each pp coordinate is a
    replica, so a whole gradient sums over the data and model groups only
    (summing it over the world would give pp times it)."""
    got, _ = worlds
    res = got[4]["pp_mesh_sgd"][0][mesh]
    one = res["one_rank"]
    _close(res["loss"], one["loss"], "loss")
    for n, g in one["grads"].items():
        ratio = (np.linalg.norm(res["grads"][n].astype(np.float64))
                 / np.linalg.norm(g.astype(np.float64)))
        assert abs(ratio - 1.0) < 1e-5, (n, ratio)
        _close(res["grads"][n], g, n)


def test_fleet_strategy_tensor_parallel_matches_jax(worlds):
    got, ref = worlds
    res = got[2]["fleet_tp"]
    _replicas_alike(res, "params")
    res = res[0]
    assert res["losses"][-1] < res["losses"][0]
    _close(res["losses"], ref["fleet_tp"]["losses"], "losses", LOSS_TOL)
    for n, p in ref["fleet_tp"]["params"].items():
        _close(res["params"][n], p, n)
    # fc(16 -> 32) "col" and fc(32 -> 8) "row", with the col fc's bias
    assert sorted(res["local"].values()) == [(8,), (16,), (16, 8), (16, 16)]


def test_lamb_norms_sum_over_the_model_group(worlds):
    got, ref = worlds
    res = got[2]["tp_lamb"][0]
    _close(res["losses"], ref["tp_lamb"]["losses"], "losses", LOSS_TOL)
    for n, p in ref["tp_lamb"]["params"].items():
        _close(res["params"][n], p, n, LOSS_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_tiny_encoder_runs_without_activation_gathers(worlds, world):
    """The Fluid-layers encoder with q/k/v and FFN-in "col", the attention
    output and FFN-out "row" and the vocabulary fc "col": the heads stay
    split from the q/k/v fcs to the output fc, the vocab-parallel loss
    reads the split logits, and no activation is all-gathered."""
    got, ref = worlds
    res = got[world]["encoder_tp"]
    _replicas_alike(res, "params")
    res, want = res[0], ref["encoder"]
    assert res["counts"]["activation_gathers"] == 0
    assert res["counts"]["fallback_gathers"] == 0
    # two row-parallel fcs a layer, two layers, two steps
    assert res["counts"]["partial_reductions"] == 2 * 2 * 2
    assert res["local"]["encoder_layer_0_multi_head_att_query_fc.w_0"] == \
        (64, 32)
    assert res["local"]["mask_lm_out_fc.w_0"] == (64, 32)
    _close(res["losses"], want["losses"], "losses")
    for n, p in want["params"].items():
        _close(res["params"][n], p, n)


@pytest.mark.parametrize("world", [2, 4])
def test_kreduce_with_tensor_parallel_matches_the_dryrun(worlds, world):
    """The dryrun's assertions: ``pp_fc1`` held as [in, out / tp];
    ``pp_head_moment1_0`` as 1/dp of its rows (dp = world / tp); a split
    accumulator ignores kReduce.  Losses and parameters against JAX."""
    got, ref = worlds
    res = got[world]["kreduce_tp"]
    _replicas_alike(res, "params")
    res = res[0]
    dp = world // TW.TP
    assert res["local"]["pp_fc1"] == (32, 64 // TW.TP)
    assert res["local"]["pp_fc1_moment1_0"] == (32, 64 // TW.TP)
    assert res["row_shards"]["pp_fc1_moment1_0"] == 1
    assert res["local"]["pp_head_moment1_0"] == (32 // dp, 64)
    assert res["row_shards"]["pp_head_moment1_0"] == dp
    assert res["local"]["pp_head"] == (32, 64)
    _close(res["losses"], ref["kreduce"]["losses"], "losses", LOSS_TOL)
    for n, p in ref["kreduce"]["params"].items():
        _close(res["params"][n], p, n, LOSS_TOL)


def test_indivisible_dim_stays_whole(worlds):
    got, _ = worlds
    res = got[2]["indivisible"][0]
    assert res["local"] == {"odd_b": (7,), "odd_w": (6, 7)}
    assert res["split"] == {"odd_b": None, "odd_w": None}
    _close(res["losses"], res["one_rank"], "losses")
    for n, p in res["one_rank_params"].items():
        _close(res["params"][n], p, n)


@pytest.mark.parametrize("world", [2, 4])
def test_row_split_table_is_the_one_rank_lookup(worlds, world):
    """A "row" embedding with repeated and padding ids: each rank gathers
    the rows it owns (a partial sum over the model group), and the losses,
    the gathered table gradients and the parameters are the plain
    program's at one rank."""
    got, _ = worlds
    res = got[world]["row_table"]
    _replicas_alike(res, "params")
    res = res[0]
    assert res["split"]["row_emb"] == (0, 2)
    assert res["local"]["row_emb"] == (32, 16)
    _close(res["losses"], res["one_rank"], "losses")
    for k, (g, want) in enumerate(zip(res["grads"], res["one_rank_grads"])):
        _close(g, want, "row_emb@GRAD step %d" % k)
    assert not res["one_rank_grads"][0][0].any()     # padding row: no grad
    for n, p in res["one_rank_params"].items():
        _close(res["params"][n], p, n)


def test_a_world_tp_does_not_divide_raises():
    """Outside a world the port has one rank, which tp = 2 does not divide
    (the reference's device-count check)."""
    main, startup, v = TW.tp_program(pfluid, lambda f: f.optimizer.SGD(0.1))
    exe, scope = pfluid.Executor(pfluid.CPUPlace()), pfluid.Scope()
    exe.run(startup, scope=scope)
    prog = TW._compiled(pfluid, main, v)
    with pytest.raises(ValueError, match="does not divide the 1 ranks"):
        exe.run(prog, feed=TW.tp_feeds(1)[0], fetch_list=[v["loss"]],
                scope=scope)


def test_explicit_mesh_without_a_tp_axis_warns():
    """An explicit one-rank mesh: the splits are dropped with a warning and
    the run is the plain program's, bit for bit."""
    from paddle_tpu_torch.parallel.mesh import make_mesh

    main, startup, v = TW.tp_program(pfluid, lambda f: f.optimizer.SGD(0.1))
    exe = pfluid.Executor(pfluid.CPUPlace())
    init = pfluid.Scope()
    exe.run(startup, scope=init)
    names = sorted(x.name for x in startup.list_vars() if x.persistable)
    values = convert.scope_to_numpy(init, names)
    bs = pfluid.BuildStrategy()
    bs.tensor_parallel_degree = 2
    prog = pfluid.CompiledProgram(main).with_data_parallel(
        loss_name=v["loss"].name, build_strategy=bs,
        mesh=make_mesh(device="cpu"))
    runs = []
    for p in (prog, main):
        scope = convert.scope_from_numpy(values, pfluid.Scope(), "cpu")
        with warnings.catch_warnings(record=True) as said:
            warnings.simplefilter("always")
            out = exe.run(p, feed=TW.tp_feeds(1)[0], fetch_list=[v["loss"]],
                          scope=scope)
        runs.append((out[0].tobytes(), [str(w.message) for w in said],
                     convert.scope_to_numpy(scope, names)))
    assert any("no tp axis" in t for t in runs[0][1]), runs[0][1]
    assert runs[0][0] == runs[1][0]
    for n in names:
        assert runs[0][2][n].tobytes() == runs[1][2][n].tobytes(), n
