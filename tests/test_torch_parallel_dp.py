"""The port's data-parallel engine (ROADMAP item 5-A) held to the JAX package.

One gloo world of 2 ranks and one of 4 (``tests/torch_dp_worker.py``, one
process a rank, a ``FileStore`` under ``tmp_path``) run every scenario once
for the module; the JAX package runs the same configurations on the
8-device CPU mesh of ``tests/conftest.py``, from the same parameters (the
JAX init, carried across as numpy) and the same global batches:

- BERT tiny at dp = 2 with Adam (3 steps) and with SGD (1 step, where the
  gradient scale shows: the reference's loss psums the NLL sum, and psum's
  transpose is psum, so its dp gradient is dp times the one-device one);
- BERT tiny at dp = 4 with ``zero=True`` and LAMB (the reference's
  ``tests/test_zero.py:42`` case): losses, parameters, gathered moments;
- ResNet tiny at dp = 2 with ``sync_bn``, fused and unfused (2 momentum
  steps): losses, parameters, velocities, BN state;
- the ``batch_norm`` rule with ``_sync_axis``: outputs and gradients;
- ``dygraph.DataParallel`` at 2 ranks: gradients and the SGD step.

Tolerances: losses rtol 1e-5 (f32, the same operations in another
summation order); BERT parameters atol 1e-5 (1% of lr 1e-3: Adam's and
LAMB's first updates move each element by about lr whatever its gradient,
so an element whose gradient is rounding noise may move either way by lr,
as ``tests/test_torch_bert.py`` holds them), the SGD update rtol 1e-4 /
atol 1e-7 of its size; ResNet as ``tests/test_torch_resnet.py``: params
1e-5, velocities and BN state 1e-4; the rule 1e-5 / gradients 1e-4.  All
within the reference's own 2e-3 (``tests/test_parallel.py:70``); every
rank's replica equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import dygraph as jdy
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import resnet as jres
from paddle_tpu.parallel import MeshSpec as JMeshSpec
from paddle_tpu.parallel import optim as joptim
from paddle_tpu.parallel import rules as jrules
from paddle_tpu.parallel import transformer as jtransformer
from paddle_tpu.parallel import zero as jzero
from paddle_tpu.parallel.mesh import local_shard_map, make_mesh as jmake_mesh
from paddle_tpu.registry import get_lowering as jget_lowering
from jax.sharding import PartitionSpec as JP
from paddle_tpu_torch._tree import tree_leaves
from paddle_tpu_torch.parallel import mesh as pmesh
from paddle_tpu_torch.parallel import optim as poptim
from paddle_tpu_torch.parallel import rules as prules
from paddle_tpu_torch.parallel import transformer as ptransformer
from paddle_tpu_torch.parallel import zero as pzero

import torch_dp_worker as W

WORLD2 = ["bert_dp2_adam", "bert_dp2_sgd", "resnet_dp2_sync_fused",
          "resnet_dp2_sync_unfused", "batch_norm_rule_sync", "dygraph_dp"]
WORLD4 = ["bert_dp4_zero_lamb"]
RESNET_TINY = dict(depth=18, image_size=16)
RESNET_LR = 1e-2
LOSS_TOL = dict(rtol=1e-5, atol=0)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if np.asarray(a).dtype.kind == "V" else np.asarray(a),
                        tree)


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k], prefix + "/" + k)]
    return [prefix]


def _bert_batch(rng, B, S, V):
    """tests/test_parallel.py's batch: 30% of the positions counted."""
    ids = rng.randint(0, V, size=(B, S)).astype(np.int32)
    labels = rng.randint(0, V, size=(B, S)).astype(np.int32)
    mask = (rng.rand(B, S) < 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    return {"ids": ids, "labels": labels, "mask": mask}


def _jax_bert(mesh_spec, optimizer, batch, steps, lr):
    tr = jbert.build_bert_trainer(jbert.bert_tiny_config(), mesh_spec,
                                  optimizer=optimizer)
    params0 = _np(tr.state["params"])
    losses = [float(tr.step(batch, lr)) for _ in range(steps)]
    return params0, {"losses": losses, "params": _np(tr.state["params"]),
                     "opt": _np(tr.state["opt"])}


def _jax_resnet(fuse_bn, batches):
    cfg = jres.resnet_tiny_config(fuse_bn=fuse_bn, sync_bn=True, **RESNET_TINY)
    tr = jres.build_resnet_trainer(cfg, JMeshSpec(dp=2),
                                   optimizer=joptim.momentum(0.9))
    params0, bn0 = _np(tr.state["params"]), _np(tr.bn_state)
    losses = [float(tr.step(b, RESNET_LR)) for b in batches]
    return (params0, bn0), {"losses": losses, "params": _np(tr.state["params"]),
                            "velocity": _np(tr.state["opt"]["velocity"]),
                            "bn": _np(tr.bn_state)}


BN_ATTRS = {"epsilon": 1e-5, "momentum": 0.9, "data_layout": "NCHW",
            "_sync_axis": "dp"}


def _bn_case():
    rng = np.random.RandomState(11)
    C = 3
    return {"ins": {"X": rng.randn(2, 4, C, 3, 3).astype("f4") * 2 + 0.5,
                    "Scale": rng.rand(C).astype("f4") + 0.5,
                    "Bias": rng.randn(C).astype("f4"),
                    "Mean": rng.randn(C).astype("f4"),
                    "Variance": rng.rand(C).astype("f4") + 0.5},
            "attrs": dict(BN_ATTRS), "cot": rng.randn(2, 4, C, 3, 3).astype("f4")}


def _jax_bn_rule(case):
    rule = jget_lowering("batch_norm")
    mesh = jmake_mesh(dp=2)
    ins = case["ins"]

    def body(x, s, b, m, v, cot):
        def run(x, s, b):
            return rule({"X": [x], "Scale": [s], "Bias": [b], "Mean": [m],
                         "Variance": [v]}, case["attrs"], None)

        def loss(x, s, b):
            return jnp.sum(run(x, s, b)["Y"][0] * cot)

        outs = run(x, s, b)
        gx, gs, gb = jax.grad(loss, argnums=(0, 1, 2))(x, s, b)
        return ({k: v[0][None] for k, v in outs.items()}, gx, gs[None], gb[None])

    f = local_shard_map(body, mesh,
                        in_specs=(JP("dp"), JP(), JP(), JP(), JP(), JP("dp")),
                        out_specs=(JP("dp"), JP("dp"), JP("dp"), JP("dp")))
    x = ins["X"].reshape((-1,) + ins["X"].shape[2:])
    cot = case["cot"].reshape(x.shape)
    outs, gx, gs, gb = f(x, ins["Scale"], ins["Bias"], ins["Mean"],
                         ins["Variance"], cot)
    n = 2
    return [{"outs": {k: np.asarray(v)[r] for k, v in outs.items()},
             "grads": [np.asarray(gx).reshape(ins["X"].shape)[r],
                       np.asarray(gs)[r], np.asarray(gb)[r]]}
            for r in range(n)]


def _dygraph_case():
    rng = np.random.RandomState(5)
    return {"state": {"weight": rng.randn(6, 3).astype("f4"),
                      "bias": rng.randn(3).astype("f4")},
            "x": rng.randn(2, 4, 6).astype("f4"), "lr": 0.1}


def _jax_dygraph(case, nranks=2):
    """The JAX package's DataParallel arithmetic at nranks: each rank's
    loss scaled by 1/nranks, its gradients, the mean over the ranks (its
    process_allgather + jnp.mean), one SGD step."""
    grads = []
    for r in range(nranks):
        with jdy.guard(jfluid.CPUPlace()):
            net = jdy.Linear(6, 3)
            net.set_dict(case["state"])
            out = net(jdy.to_variable(case["x"][r]))
            loss = jdy.nn._lowering_apply("mean", ("X",), {}, "Out", out * out)
            loss = loss * (1.0 / nranks)
            loss.backward()
            grads.append([np.asarray(p.gradient) for p in net.parameters()])
    mean = [np.asarray(jnp.mean(jnp.stack([g[i] for g in grads]), axis=0))
            for i in range(len(grads[0]))]
    return {"grads": mean}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.RandomState(42)
    V = jbert.bert_tiny_config().vocab_size
    bert_batch = _bert_batch(rng, 8, 32, V)
    adam_params0, jadam = _jax_bert(JMeshSpec(dp=2), joptim.adam(), bert_batch,
                                    3, 1e-3)
    rn_rng = np.random.RandomState(3)
    rn_batches = [{"image": rn_rng.rand(16, 16, 16, 3).astype("f4"),
                   "label": rn_rng.randint(0, 10, (16,)).astype(np.int32)}
                  for _ in range(2)]
    (rn_p0, rn_bn0), jfused = _jax_resnet(True, rn_batches)
    inputs = {"bert_params": adam_params0, "bert_batch": bert_batch,
              "resnet_tiny": RESNET_TINY, "resnet_params": rn_p0,
              "resnet_bn": rn_bn0, "resnet_batches": rn_batches,
              "resnet_lr": RESNET_LR, "bn_rule": _bn_case(),
              "dygraph": _dygraph_case()}
    out2, procs2 = W.spawn_world(tmp, 2, inputs, WORLD2)
    out4, procs4 = W.spawn_world(tmp, 4, inputs, WORLD4)
    try:
        # the JAX side while the ranks run
        jax_res = {"bert_dp2_adam": jadam, "resnet_dp2_sync_fused": jfused}
        _, jax_res["bert_dp2_sgd"] = _jax_bert(JMeshSpec(dp=2), joptim.sgd(),
                                               bert_batch, 1, 0.1)
        _, jax_res["bert_dp1_sgd"] = _jax_bert(JMeshSpec(dp=1), joptim.sgd(),
                                               bert_batch, 1, 0.1)
        _, jax_res["bert_dp4_zero_lamb"] = _jax_bert(
            JMeshSpec(dp=4, zero=True), joptim.lamb(), bert_batch, 3, 1e-3)
        _, jax_res["resnet_dp2_sync_unfused"] = _jax_resnet(False, rn_batches)
        jax_res["batch_norm_rule_sync"] = _jax_bn_rule(inputs["bn_rule"])
        jax_res["dygraph_dp"] = _jax_dygraph(inputs["dygraph"])
    finally:
        port = W.join_world(out2, procs2, WORLD2)
        port.update(W.join_world(out4, procs4, WORLD4))
    return {"port": port, "jax": jax_res, "params0": adam_params0,
            "inputs": inputs}


BERT_LEAVES = _names(jax.tree.map(lambda _: 0, jbert.init_transformer_params(
    jax.random.PRNGKey(0), jbert.bert_tiny_config())))
RESNET_LEAVES = _names(jax.tree.map(lambda _: 0, jres.init_resnet_params(
    jax.random.PRNGKey(0), jres.resnet_tiny_config(**RESNET_TINY))[0]))


def _leaf(tree, name):
    for k in name.strip("/").split("/"):
        tree = tree[k]
    return np.asarray(tree)


def _replicas_agree(results, key):
    first = results[0][key]
    for other in results[1:]:
        for a, b in zip(jax.tree.leaves(first), jax.tree.leaves(other[key])):
            np.testing.assert_array_equal(a, b)


# -- BERT ----------------------------------------------------------------------

@pytest.mark.parametrize("scenario", ["bert_dp2_adam", "bert_dp2_sgd",
                                      "bert_dp4_zero_lamb"])
def test_bert_losses_match_jax(runs, scenario):
    for rank in runs["port"][scenario]:
        np.testing.assert_allclose(rank["losses"],
                                   runs["jax"][scenario]["losses"], **LOSS_TOL)


@pytest.mark.parametrize("scenario", ["bert_dp2_adam", "bert_dp2_sgd",
                                      "bert_dp4_zero_lamb"])
def test_bert_replicas_agree_bit_for_bit(runs, scenario):
    _replicas_agree(runs["port"][scenario], "params")
    if scenario == "bert_dp4_zero_lamb":
        _replicas_agree(runs["port"][scenario], "m")


@pytest.mark.parametrize("leaf", BERT_LEAVES)
@pytest.mark.parametrize("scenario", ["bert_dp2_adam", "bert_dp4_zero_lamb"])
def test_bert_params_match_jax(runs, scenario, leaf):
    got = _leaf(runs["port"][scenario][0]["params"], leaf)
    want = _leaf(runs["jax"][scenario]["params"], leaf)
    if leaf == "/params_layers/bqkv":
        # the key bias's gradient is exactly 0 in exact arithmetic (a per-row
        # shift of the scores); both sides hand the optimizer rounding noise
        # there, which m/(sqrt(v)+eps) magnifies to about lr a step: hold
        # that slice to its three updates' own scale, as test_torch_bert.py
        np.testing.assert_allclose(got[:, 1], want[:, 1], atol=3e-3, rtol=0)
        got, want = got[:, 0::2], want[:, 0::2]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=leaf)


@pytest.mark.parametrize("leaf", BERT_LEAVES)
def test_bert_sgd_update_matches_jax(runs, leaf):
    """SGD shows the gradient itself: the port's dp = 2 update is the
    reference's, to rtol 1e-4 of the update."""
    p0 = _leaf(runs["params0"], leaf)
    got = p0 - _leaf(runs["port"]["bert_dp2_sgd"][0]["params"], leaf)
    want = p0 - _leaf(runs["jax"]["bert_dp2_sgd"]["params"], leaf)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-7 + 1e-4 * np.abs(want).max(), err_msg=leaf)


def test_bert_gradient_scale_is_dp_times_the_one_device_one(runs):
    """The reference's dp = 2 gradient is twice its one-device gradient
    (the psum'd loss; ROADMAP Queue 3), and the port's is the reference's:
    the SGD updates of w1 at dp = 2 over those at dp = 1."""
    p0 = _leaf(runs["params0"], "/params_layers/w1")
    one = p0 - _leaf(runs["jax"]["bert_dp1_sgd"]["params"], "/params_layers/w1")
    two = p0 - _leaf(runs["jax"]["bert_dp2_sgd"]["params"], "/params_layers/w1")
    port = p0 - _leaf(runs["port"]["bert_dp2_sgd"][0]["params"],
                      "/params_layers/w1")
    # elements whose update is well above the rounding of p0 - p1
    big = np.abs(one) > 0.1 * np.abs(one).max()
    np.testing.assert_allclose(two[big] / one[big], 2.0, rtol=1e-3)
    np.testing.assert_allclose(port[big] / one[big], 2.0, rtol=1e-3)


@pytest.mark.parametrize("leaf", BERT_LEAVES)
def test_zero_moments_match_jax(runs, leaf):
    got = _leaf(runs["port"]["bert_dp4_zero_lamb"][0]["m"], leaf)
    want = _leaf(runs["jax"]["bert_dp4_zero_lamb"]["opt"]["m"], leaf)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-4, err_msg=leaf)


def test_zero_shards_the_leaves_the_reference_shards(runs):
    """dp = 4 divides dim 0 of every leaf of BERT tiny (the [L = 4, ...]
    stacked layers, the vocab and position rows, the final LN's 32): every
    moment is sharded, as by the reference's zero_shardable_mask."""
    from paddle_tpu.parallel.mesh import make_mesh as jmm
    from paddle_tpu.parallel.transformer import (grad_sync_axes,
                                                 transformer_param_specs)
    from paddle_tpu.parallel.zero import zero_shardable_mask

    cfg = jbert.bert_tiny_config()
    template = jbert.init_transformer_params(jax.random.PRNGKey(0), cfg)
    want = jax.tree.leaves(zero_shardable_mask(
        template, transformer_param_specs(cfg), grad_sync_axes(cfg),
        jmm(dp=4)))
    got = runs["port"]["bert_dp4_zero_lamb"][0]["sharded"]
    assert got == want and all(want)


# -- ResNet with sync-BN -------------------------------------------------------

RESNET = ["resnet_dp2_sync_fused", "resnet_dp2_sync_unfused"]


@pytest.mark.parametrize("scenario", RESNET)
def test_resnet_sync_bn_losses_match_jax(runs, scenario):
    for rank in runs["port"][scenario]:
        np.testing.assert_allclose(rank["losses"],
                                   runs["jax"][scenario]["losses"], **LOSS_TOL)


@pytest.mark.parametrize("scenario", RESNET)
def test_resnet_sync_bn_replicas_agree_bit_for_bit(runs, scenario):
    for key in ("params", "velocity", "bn"):
        _replicas_agree(runs["port"][scenario], key)


@pytest.mark.parametrize("leaf", RESNET_LEAVES)
@pytest.mark.parametrize("scenario", RESNET)
def test_resnet_sync_bn_params_match_jax(runs, scenario, leaf):
    got, want = runs["port"][scenario][0], runs["jax"][scenario]
    np.testing.assert_allclose(_leaf(got["params"], leaf),
                               _leaf(want["params"], leaf),
                               atol=1e-5, rtol=1e-5, err_msg=leaf)
    np.testing.assert_allclose(_leaf(got["velocity"], leaf),
                               _leaf(want["velocity"], leaf),
                               atol=1e-4, rtol=1e-4, err_msg=leaf)


@pytest.mark.parametrize("scenario", RESNET)
def test_resnet_sync_bn_state_matches_jax(runs, scenario):
    got, want = runs["port"][scenario][0]["bn"], runs["jax"][scenario]["bn"]
    names = _names(want)
    assert len(names) == 40
    for name in names:
        np.testing.assert_allclose(_leaf(got, name), _leaf(want, name),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def test_fused_sync_bn_ran_on_both_paths(runs):
    """The fused and unfused sync-BN steps agree with each other as they
    do with the reference (the same statistics, reduced across ranks)."""
    a = runs["port"]["resnet_dp2_sync_fused"][0]["losses"]
    b = runs["port"]["resnet_dp2_sync_unfused"][0]["losses"]
    np.testing.assert_allclose(a, b, rtol=1e-5)


# -- the batch_norm rule's _sync_axis ----------------------------------------

@pytest.mark.parametrize("slot", ["Y", "MeanOut", "VarianceOut", "SavedMean",
                                  "SavedVariance"])
@pytest.mark.parametrize("rank", [0, 1])
def test_batch_norm_rule_sync_axis_outputs(runs, rank, slot):
    got = runs["port"]["batch_norm_rule_sync"][rank]["outs"][slot]
    want = runs["jax"]["batch_norm_rule_sync"][rank]["outs"][slot]
    np.testing.assert_allclose(got, want.reshape(got.shape), rtol=1e-5,
                               atol=1e-6, err_msg=slot)


@pytest.mark.parametrize("which", [0, 1, 2], ids=["X", "Scale", "Bias"])
@pytest.mark.parametrize("rank", [0, 1])
def test_batch_norm_rule_sync_axis_grads(runs, rank, which):
    got = runs["port"]["batch_norm_rule_sync"][rank]["grads"][which]
    want = runs["jax"]["batch_norm_rule_sync"][rank]["grads"][which]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_batch_norm_rule_statistics_are_global(runs):
    """Both ranks' batch mean is the mean over the two ranks' rows."""
    x = runs["inputs"]["bn_rule"]["ins"]["X"]
    want = x.transpose(2, 0, 1, 3, 4).reshape(x.shape[2], -1).mean(axis=1)
    for r in range(2):
        np.testing.assert_allclose(
            runs["port"]["batch_norm_rule_sync"][r]["outs"]["SavedMean"], want,
            rtol=1e-5)


# -- dygraph DataParallel ------------------------------------------------------

def test_dygraph_data_parallel_grads_match_jax(runs):
    want = runs["jax"]["dygraph_dp"]["grads"]
    for rank in runs["port"]["dygraph_dp"]:
        assert rank["nranks"] == 2
        for g, w in zip(rank["grads"], want):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_dygraph_data_parallel_step_matches_jax(runs):
    """One SGD step from the mean of the scaled gradients, (1/n^2) times
    their sum, as the reference's arithmetic (ROADMAP Queue 3)."""
    case = runs["inputs"]["dygraph"]
    grads = runs["jax"]["dygraph_dp"]["grads"]
    start = [case["state"]["weight"], case["state"]["bias"]]
    for rank in runs["port"]["dygraph_dp"]:
        for got, p, g in zip(rank["params"], start, grads):
            np.testing.assert_allclose(got, p - case["lr"] * g, rtol=1e-6,
                                       atol=1e-7)
    _replicas_agree(runs["port"]["dygraph_dp"], "params")


# -- the sharding rules, mesh and fleet (no world needed) --------------------


def _spec_tuples(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, (JP, prules.PartitionSpec)))]


@pytest.mark.parametrize("attn_mode,pp", [("heads", 1), ("ring", 1),
                                          ("heads", 2)])
def test_transformer_param_specs_match_jax(attn_mode, pp):
    jcfg = jbert.bert_tiny_config(attn_mode=attn_mode, pp=pp)
    pcfg = ptransformer.TransformerConfig(
        **{f: getattr(jcfg, f) for f in ("vocab_size", "hidden", "n_layers",
                                         "n_heads", "ffn_hidden", "max_seq",
                                         "dtype", "causal", "attn_mode", "pp")})
    assert _spec_tuples(ptransformer.transformer_param_specs(pcfg)) == \
        _spec_tuples(jtransformer.transformer_param_specs(jcfg))
    assert tree_leaves(ptransformer.grad_sync_axes(pcfg)) == \
        jax.tree.leaves(jtransformer.grad_sync_axes(jcfg),
                        is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("world", [1, 2, 3, 7])
def test_hostps_row_ranges_match_jax(world):
    for vocab in (0, 5, 100, 1001):
        assert prules.hostps_row_ranges(world, vocab) == \
            jrules.hostps_row_ranges(world, vocab)
    with pytest.raises(ValueError, match="outside world"):
        prules.hostps_row_range(world, world, 10)


def test_rule_lists_and_tp_split_specs_match_jax():
    marks = {"fc_w": ("col", 2), "emb": ("row", 2), "b": ("col", 1)}
    assert {k: tuple(v) for k, v in prules.tp_split_specs(marks).items()} == \
        {k: tuple(v) for k, v in jrules.tp_split_specs(marks).items()}
    for name in ("deepfm_rules", "moe_rules"):
        got, want = getattr(prules, name)(), getattr(jrules, name)()
        assert [(r, tuple(s)) for r, s in got] == [(r, tuple(s)) for r, s in want]
    assert tuple(prules.batch_spec()) == tuple(jrules.batch_spec())


def test_match_partition_rules_scalars_strict_and_default():
    tree = {"w": np.zeros((4, 2)), "s": np.zeros(()), "one": np.zeros((1,)),
            "other": np.zeros((3,))}
    rules = [(r"^w$", prules.P("dp", None))]
    with pytest.raises(ValueError, match="no partition rule"):
        prules.match_partition_rules(rules, tree)
    got = prules.match_partition_rules(rules, tree, strict=False)
    want = jrules.match_partition_rules([(r"^w$", JP("dp", None))], tree,
                                        strict=False)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(want[k]) for k in want}
    auth = prules.ShardingAuthority(rules, strict=False)
    assert tuple(auth.spec("w", tree["w"])) == ("dp", None)
    with pytest.raises(ValueError, match="no mesh"):
        auth.shard(tree)


@pytest.mark.parametrize("dp", [2, 4, 8])
def test_zero_specs_match_jax(dp):
    """The moment specs ZeRO places by, on a mesh of dp ranks (eligibility
    reads the mesh's shape only)."""
    jcfg = jbert.bert_tiny_config()
    template = jbert.init_transformer_params(jax.random.PRNGKey(0), jcfg)
    jstate = {"params": template, "opt": joptim.lamb()[0](template)}
    jmask = jzero.zero_shardable_mask(
        template, jtransformer.transformer_param_specs(jcfg),
        jtransformer.grad_sync_axes(jcfg), jmake_mesh(dp=dp))
    want = jzero.zero_state_specs(jtransformer.transformer_param_specs(jcfg),
                                  jstate, jmask)
    pcfg = ptransformer.TransformerConfig(**{
        f: getattr(jcfg, f) for f in ("vocab_size", "hidden", "n_layers",
                                      "n_heads", "ffn_hidden", "max_seq",
                                      "dtype")})
    pparams = ptransformer.init_transformer_params(
        torch.Generator().manual_seed(0), pcfg, device="cpu")
    mesh = pmesh.Mesh({"dp": dp, "pp": 1, "tp": 1},
                      {"dp": 0, "pp": 0, "tp": 0}, {}, torch.device("cpu"))
    pspecs = ptransformer.transformer_param_specs(pcfg)
    pmask = pzero.zero_shardable_mask(pparams, pspecs,
                                      ptransformer.grad_sync_axes(pcfg), mesh)
    pstate = {"params": pparams, "opt": poptim.lamb()[0](pparams)}
    got = pzero.zero_state_specs(pspecs, pstate, pmask)
    for k in ("m", "v"):
        assert _spec_tuples(got["opt"][k]) == _spec_tuples(want["opt"][k]), k
    assert tree_leaves(pmask) == jax.tree.leaves(jmask)


def test_make_mesh_refuses_tp_pp_and_a_missing_world(monkeypatch):
    """tp and pp above one run over a world of ranks since item 5-C
    (tests/test_torch_model_parallel.py); outside one, any mesh above one
    rank is refused."""
    for kw in ({"tp": 2}, {"pp": 2}, {"dp": 2}, {"dp": 2, "pp": 2, "tp": 2}):
        with pytest.raises(ValueError, match="no process group"):
            pmesh.make_mesh(device="cpu", **kw)
    one = pmesh.make_mesh(device="cpu")
    assert one.size == 1 and one.groups == {} and pmesh.active_mesh() is None
    with one:
        assert pmesh.active_mesh() is one
    assert pmesh.active_mesh() is None


def test_collectives_are_identities_outside_a_mesh():
    from paddle_tpu_torch.parallel import collectives as pcol

    x = torch.randn(4, 2, requires_grad=True)
    for fn in (lambda t: pcol.psum(t, "dp"), lambda t: pcol.pmean(t, "dp"),
               lambda t: pcol.all_gather(t, "dp", 1),
               lambda t: pcol.reduce_scatter(t, "dp"),
               lambda t: pcol.ppermute_shift(t, "dp"),
               lambda t: pcol.all_to_all(t, "dp", 0, 1)):
        assert fn(x) is x
    with pmesh.make_mesh(device="cpu"):      # one rank: size 1
        assert pcol.psum(x, "dp") is x and pcol.axis_size_in("dp") == 1
        assert pcol.axis_index("dp") == 0 and pcol.axis_present("dp")
    assert not pcol.axis_present("dp") and pcol.axis_size_in("dp") == 1


def test_backend_follows_the_device_unless_named(monkeypatch):
    monkeypatch.delenv("PADDLE_DISTRI_BACKEND", raising=False)
    assert pmesh.backend_for("cpu") == "gloo"
    assert pmesh.backend_for(torch.device("cuda", 0)) == "nccl"
    monkeypatch.setenv("PADDLE_DISTRI_BACKEND", "gloo")
    assert pmesh.backend_for(torch.device("cuda", 0)) == "gloo"
    monkeypatch.setenv("PADDLE_DISTRI_BACKEND", "mpi")
    with pytest.raises(ValueError, match="nccl or gloo"):
        pmesh.backend_for("cpu")


def test_fleet_tagged_programs_wait_for_item_5b():
    """Since item 5-B a fleet-tagged program runs data-parallel: outside a
    world, on this process alone, equal to the untagged program bit for
    bit (``tests/test_torch_program_dp.py`` runs it over worlds of 2 and
    4).  The host sparse table knob sets the table router's flag (its host
    route waits for item 7)."""
    import paddle_tpu_torch as pfluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet as pfleet

    runs = []
    for tagged in (False, True):
        main, startup = pfluid.Program(), pfluid.Program()
        with pfluid.unique_name.guard(), pfluid.program_guard(main, startup):
            x = pfluid.layers.data("x", shape=[4], dtype="float32")
            loss = pfluid.layers.mean(pfluid.layers.fc(x, size=1))
            opt = pfluid.optimizer.SGD(0.1)
            if tagged:
                opt = pfleet._Fleet().distributed_optimizer(opt)
            opt.minimize(loss)
        assert (getattr(main, "_fleet_strategy", None) is not None) == tagged
        exe = pfluid.Executor(pfluid.CPUPlace())
        if not runs:
            init = pfluid.Scope()
            exe.run(startup, scope=init)
            names = [v.name for v in startup.list_vars() if v.persistable]
            values = convert.scope_to_numpy(init, names)
        scope = convert.scope_from_numpy(values, pfluid.Scope(), "cpu")
        feed = {"x": np.arange(8, dtype="f4").reshape(2, 4)}
        runs.append([exe.run(main, feed=feed, fetch_list=[loss],
                             scope=scope)[0].tobytes() for _ in range(2)]
                    + [scope.find_tensor_as_numpy(n).tobytes() for n in names])
    assert runs[0] == runs[1]
    # the host sparse table knob sets the table router's flag (item 5-C′);
    # the host route itself waits for item 7 (tests/
    # test_torch_sharded_embedding.py)
    from paddle_tpu_torch.parallel import embedding

    strategy = pfleet.DistributedStrategy()
    strategy.use_host_sparse_table = True
    try:
        pfleet._Fleet().distributed_optimizer(pfluid.optimizer.SGD(0.1),
                                              strategy)
        assert embedding.host_sparse_table_enabled()
    finally:
        embedding.enable_host_sparse_table(False)
