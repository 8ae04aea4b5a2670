"""The port's tensor, sequence, ring and pipeline parallelism and its
expert-parallel MoE (ROADMAP item 5-C, part 1) held to the JAX package.

One gloo world of 2 ranks and one of 4
(``tests/torch_model_parallel_worker.py``, one process a rank, a ``FileStore`` under ``tmp_path``) run every scenario
once for the module; meanwhile the JAX package runs the same computations on
the 8 simulated CPU devices of ``tests/conftest.py`` from the same numpy
parameters (its ``init_transformer_params``) and batches:

- BERT tiny (f32) at the meshes (dp, pp, tp) (1, 1, 2) heads, (1, 1, 2) and
  (1, 1, 4) ring, (1, 2, 1) and (1, 2, 2) with 2 microbatches, (2, 1, 2),
  and (2, 1, 2) with ``zero=True``: the loss, the gradients after their
  sync, gathered to the global tree (``gather_pytree``), and the parameters
  after one Adam and one LAMB step.  The JAX side runs its train step's
  math (``make_loss_fn``, the psum over ``grad_sync_axes``, ``optim``'s
  updates) under ``local_shard_map``, one jitted function a mesh, and its
  ``build_bert_trainer`` for the ZeRO mesh.  The reference's gradients are
  dp * pp * tp times the one-device ones (psum's transpose is psum), and
  so are the port's; its LAMB takes each tp shard's own norms;
- ``ring_attention`` at tp = 2 and 4, causal and not, with a key mask (a
  fully masked row included), forward and backward, against JAX's under
  ``local_shard_map`` and against plain attention;
- ``gpipe`` at pp = 2 and 4 against the stages run in sequence;
- ``moe_ffn`` at ep = 2 and 4 (capacity factor 1: tokens dropped), forward
  and backward against JAX's;
- ``make_mesh``'s coordinates and groups at (2, 1, 2) and (1, 2, 2);
- ResNet tiny at ``MeshSpec(tp=2)`` and ``MeshSpec(pp=2)``: the JAX
  trainer trains there (replicated, as at one device), and so does the
  port's.

Tolerances (f32, each side sums in its own order): losses rtol 1e-5 /
atol 2e-6; gradients and parameters rtol 1e-4 / atol 5e-5 (lr 1e-3: an
Adam or LAMB update moves an element by about lr whatever its gradient);
attention, the pipeline and MoE rtol 1e-5 / atol 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from paddle_tpu.models import bert as jbert
from paddle_tpu.models import resnet as jres
from paddle_tpu.parallel import MeshSpec as JMeshSpec
from paddle_tpu.parallel import collectives as jcol
from paddle_tpu.parallel import optim as joptim
from paddle_tpu.parallel import transformer as jT
from paddle_tpu.parallel.mesh import local_shard_map, make_mesh as jmake_mesh
from paddle_tpu.parallel.moe import moe_ffn as jmoe_ffn
from paddle_tpu.parallel.ring_attention import (local_attention as jlocal,
                                                ring_attention as jring)

import torch_dp_worker as W
import torch_model_parallel_worker as MW


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WORLD2 = ["bert_tp2_heads", "bert_tp2_ring", "bert_pp2", "ring_attention",
          "gpipe", "moe", "resnet_tp", "resnet_pp"]
WORLD4 = ["bert_tp4_ring", "bert_pp2_tp2", "bert_dp2_tp2", "bert_dp2_tp2_zero",
          "ring_attention", "gpipe", "moe", "mesh_layout"]
BERT_KEYS = list(MW.MESHES)
LOSS_TOL = dict(rtol=1e-5, atol=2e-6)
TREE_TOL = dict(rtol=1e-4, atol=5e-5)
OP_TOL = dict(rtol=1e-5, atol=1e-6)
RESNET_TINY = dict(depth=18, image_size=16)
RESNET_LR = 1e-2


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _bert_batch():
    """tests/test_parallel.py's batch: 30% of the positions counted."""
    rng = np.random.RandomState(42)
    B, S, V = 8, 32, jbert.bert_tiny_config().vocab_size
    ids = rng.randint(0, V, size=(B, S)).astype(np.int32)
    labels = rng.randint(0, V, size=(B, S)).astype(np.int32)
    mask = (rng.rand(B, S) < 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    return {"ids": ids, "labels": labels, "mask": mask}


@functools.lru_cache(maxsize=None)
def _bert_params_pp1():
    # eager, as the reference's trainers make it (a jitted init may round
    # its draws otherwise)
    return _np(jT.init_transformer_params(jax.random.PRNGKey(0),
                                          jbert.bert_tiny_config()))


def _bert_params(pp):
    """The reference's init at ``bert_tiny_config(pp=pp)``: the pp = 1 tree
    with each layer leaf reshaped to [pp, L/pp, ...], as its
    ``init_transformer_params`` does."""
    p = _bert_params_pp1()
    if pp == 1:
        return p
    layers = {k: v.reshape((pp, v.shape[0] // pp) + v.shape[1:])
              for k, v in p["params_layers"].items()}
    return {**p, "params_layers": layers}


def _jax_step_math(cfg, spec, mb, params, batch):
    """The reference's train step, once: loss, the synced gradients and the
    parameters after Adam and after LAMB, global trees."""
    mesh = spec.build()
    pspecs = jT.transformer_param_specs(cfg)
    syncs = jT.grad_sync_axes(cfg)
    loss_fn = jbert.make_loss_fn(cfg, n_microbatches=mb)
    adam, lamb = joptim.adam(), joptim.lamb()

    def body(p, b):
        loss, g = jax.value_and_grad(loss_fn)(p, b)
        flat, td = jax.tree.flatten(g)
        synced = []
        for x, axes in zip(flat, td.flatten_up_to(syncs)):
            for a in axes:
                x = jcol.psum(x, a)
            synced.append(x)
        g = jax.tree.unflatten(td, synced)
        pa, _ = adam[1](g, adam[0](p), p, MW.LR)
        pl, _ = lamb[1](g, lamb[0](p), p, MW.LR)
        return loss, g, pa, pl

    f = jax.jit(local_shard_map(body, mesh,
                                in_specs=(pspecs, jbert.batch_specs()),
                                out_specs=(JP(), pspecs, pspecs, pspecs)))
    loss, g, pa, pl = f(params, batch)
    return {"loss": float(loss), "grads": _np(g), "params_adam": _np(pa),
            "params_lamb": _np(pl)}


def _jax_zero(cfg, spec, batch):
    out = {}
    for name, opt in (("adam", joptim.adam()), ("lamb", joptim.lamb())):
        tr = jbert.build_bert_trainer(cfg, spec, optimizer=opt)
        out["step_loss_" + name] = float(tr.step(batch, MW.LR))
        out["params_" + name] = _np(tr.state["params"])
        out["m_" + name] = _np(tr.state["opt"]["m"])
    return out


def _jax_bert(batch):
    ref = {"one": _jax_step_math(jbert.bert_tiny_config(), JMeshSpec(), 1,
                                 _bert_params(1), batch)}
    for key, (dp, pp, tp, mode, mb, zero) in MW.MESHES.items():
        cfg = jbert.bert_tiny_config(tp=tp, pp=pp, attn_mode=mode)
        if zero:
            ref[key] = _jax_zero(cfg, JMeshSpec(dp, pp, tp, zero=True), batch)
        else:
            ref[key] = _jax_step_math(cfg, JMeshSpec(dp, pp, tp), mb,
                                      _bert_params(pp), batch)
    return ref


def _ring_case(world):
    rng = np.random.RandomState(100 + world)
    B, S, H, D = 2, 16, 2, 8
    case = {n: rng.randn(B, S, H, D).astype("f4")
            for n in ("q", "k", "v", "cot")}
    mask = rng.rand(B, S) < 0.7
    mask[:, 0] = False          # causal query 0 then sees no key at all
    case["mask"] = mask
    return case


def _jax_ring(case, world):
    mesh = jmake_mesh(1, 1, world)
    out = {}
    for causal in (False, True):
        def body(q, k, v, m, cot, causal=causal):
            def f(q, k, v):
                return jnp.sum(jring(q, k, v, axis="tp", causal=causal,
                                     kv_mask=m) * cot)
            o = jring(q, k, v, axis="tp", causal=causal, kv_mask=m)
            return (o,) + jax.grad(f, argnums=(0, 1, 2))(q, k, v)

        seq = JP(None, "tp")
        f = jax.jit(local_shard_map(body, mesh, in_specs=(seq,) * 5,
                                    out_specs=(seq,) * 4))
        o, gq, gk, gv = f(case["q"], case["k"], case["v"], case["mask"],
                          case["cot"])
        o_l, _, l = jlocal(jnp.asarray(case["q"]), jnp.asarray(case["k"]),
                           jnp.asarray(case["v"]), causal=causal,
                           kv_mask=jnp.asarray(case["mask"]))
        plain = np.asarray(o_l) / np.maximum(np.asarray(l), 1e-30).transpose(
            0, 2, 1)[..., None]
        out[causal] = {"o": np.asarray(o), "grads": [np.asarray(g) for g in
                                                     (gq, gk, gv)],
                       "plain": plain}
    return out


def _moe_case(world):
    rng = np.random.RandomState(200 + world)
    T, E, F, nE = 16, 8, 12, 2 * world
    return {"x": rng.randn(world, T, E).astype("f4"),
            "router": (rng.randn(E, nE) * 0.5).astype("f4"),
            "w1": (rng.randn(nE, E, F) / np.sqrt(E)).astype("f4"),
            "w2": (rng.randn(nE, F, E) / np.sqrt(F)).astype("f4"),
            "cot": rng.randn(world, T, E).astype("f4"), "cf": 1.0}


def _jax_moe(case, world):
    mesh = jmake_mesh(dp=world)
    d = JP("dp")

    def body(x, router, w1, w2, cot):
        params = {"router": router, "w1": w1, "w2": w2}

        def f(x, params):
            y = jmoe_ffn(params, x, capacity_factor=case["cf"])
            return jnp.sum(y * cot)

        y = jmoe_ffn(params, x, capacity_factor=case["cf"])
        gx, gp = jax.grad(f, argnums=(0, 1))(x, params)
        return y, gx, gp["router"][None], gp["w1"], gp["w2"]

    f = jax.jit(local_shard_map(body, mesh, in_specs=(d, JP(), d, d, d),
                                out_specs=(d,) * 5))
    T = case["x"].shape[1]
    y, gx, gr, g1, g2 = f(case["x"].reshape(world * T, -1), case["router"],
                          case["w1"], case["w2"],
                          case["cot"].reshape(world * T, -1))
    return {"y": np.asarray(y).reshape(world, T, -1),
            "gx": np.asarray(gx).reshape(world, T, -1),
            "grouter": np.asarray(gr),
            "gw1": np.asarray(g1), "gw2": np.asarray(g2)}


def _gpipe_case():
    rng = np.random.RandomState(300)
    F, M, mb = 5, 4, 3
    return {"w": (rng.randn(4, F, F) * 0.5).astype("f4"),
            "b": rng.randn(4, F).astype("f4") * 0.1,
            "x": rng.randn(M, mb, F).astype("f4"),
            "cot": rng.randn(M, mb, F).astype("f4")}


def _resnet_inputs():
    cfg = jres.resnet_tiny_config(sync_bn=True, **RESNET_TINY)
    params, bn = jres.init_resnet_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.RandomState(5)
    batches = [{"image": rng.rand(8, 16, 16, 3).astype("f4"),
                "label": rng.randint(0, 10, (8,)).astype(np.int32)}
               for _ in range(2)]
    return _np(params), _np(bn), batches


def _jax_resnet(batches):
    cfg = jres.resnet_tiny_config(sync_bn=True, **RESNET_TINY)
    out = {}
    for axis in ("tp", "pp"):
        tr = jres.build_resnet_trainer(cfg, JMeshSpec(**{axis: 2}),
                                       optimizer=joptim.momentum(0.9))
        losses = [float(tr.step(b, RESNET_LR)) for b in batches]
        out[axis] = {"losses": losses, "params": _np(tr.state["params"]),
                     "bn": _np(tr.bn_state)}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' results by scenario and rank, and the JAX package's,
    computed while the ranks run."""
    batch = _bert_batch()
    rn_params, rn_bn, rn_batches = _resnet_inputs()
    inputs = {"bert_params": {"pp1": _bert_params(1), "pp2": _bert_params(2)},
              "bert_batch": batch,
              "ring": {w: _ring_case(w) for w in (2, 4)},
              "moe": {w: _moe_case(w) for w in (2, 4)},
              "gpipe": _gpipe_case(),
              "resnet_tiny": RESNET_TINY, "resnet_params": rn_params,
              "resnet_bn": rn_bn, "resnet_batches": rn_batches,
              "resnet_lr": RESNET_LR}
    tmp = tmp_path_factory.mktemp("model_parallel")
    spawned = [(W.spawn_world(tmp, world, inputs, names, script=MW.__file__),
                names) for world, names in ((2, WORLD2), (4, WORLD4))]
    try:
        ref = {"bert": _jax_bert(batch),
               "ring": {w: _jax_ring(inputs["ring"][w], w) for w in (2, 4)},
               "moe": {w: _jax_moe(inputs["moe"][w], w) for w in (2, 4)},
               "resnet": _jax_resnet(rn_batches)}
    finally:
        got = {world: W.join_world(out, procs, names) for world, (
            (out, procs), names) in zip((2, 4), spawned)}
    return got, ref, inputs


def _world_of(key):
    return 2 if "bert_" + key in WORLD2 else 4


def _leaves(tree):
    return jax.tree.leaves(tree)


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _names(tree[k], prefix + "/" + k)]
    return [prefix]


def _close_trees(got, want, what, tol):
    for name, a, b in zip(_names(want), _leaves(got), _leaves(want)):
        if name == "/params_layers/bqkv" and what in ("adam", "lamb"):
            # the key bias's gradient is exactly 0 in exact arithmetic (a
            # per-row shift of the scores); both sides hand the optimizer
            # rounding noise there, which m / (sqrt(v) + eps) magnifies to
            # about lr: hold that slice to its update's own scale, as
            # tests/test_torch_bert.py does
            np.testing.assert_allclose(a[..., 1, :], b[..., 1, :], atol=MW.LR,
                                       rtol=0, err_msg=what + " bk")
            a, b = a[..., 0::2, :], b[..., 0::2, :]
        np.testing.assert_allclose(a, b, err_msg="%s %s" % (what, name), **tol)


# -- BERT at each mesh --------------------------------------------------------

@pytest.mark.parametrize("key", BERT_KEYS)
def test_bert_loss_matches_jax(runs, key):
    got, ref, _ = runs
    for r, res in enumerate(got[_world_of(key)]["bert_" + key]):
        want = ref["bert"][key]
        if "loss" in want:
            np.testing.assert_allclose(res["loss"], want["loss"], **LOSS_TOL)
        else:
            np.testing.assert_allclose(res["step_loss_adam"],
                                       want["step_loss_adam"], **LOSS_TOL)
        # every mesh computes the one-device loss
        np.testing.assert_allclose(res["step_loss_adam"],
                                   ref["bert"]["one"]["loss"], **LOSS_TOL)


@pytest.mark.parametrize("key", [k for k in BERT_KEYS if not MW.MESHES[k][5]])
def test_bert_gradients_match_jax_and_scale_with_the_mesh(runs, key):
    """The gathered gradients equal the reference's, which are dp * pp * tp
    times the one-device ones, leaf by leaf, by their norms (the one-device
    loss streams its vocab in chunks and rounds the softmax gradient to
    bf16, the vocab-parallel one at tp > 1 does not: elements part by a few
    bf16 roundings)."""
    got, ref, _ = runs
    dp, pp, tp = MW.MESHES[key][:3]
    want = ref["bert"][key]["grads"]
    one = ref["bert"]["one"]["grads"]
    for res in got[_world_of(key)]["bert_" + key]:
        _close_trees(res["grads"], want, "grads", TREE_TOL)
    for name, g, g1 in zip(_names(one), _leaves(want), _leaves(one)):
        n1 = np.linalg.norm(g1)
        if n1 > 0:
            np.testing.assert_allclose(np.linalg.norm(g) / n1, dp * pp * tp,
                                       rtol=2e-3, err_msg=name)


@pytest.mark.parametrize("key", [k for k in BERT_KEYS if not MW.MESHES[k][5]])
def test_bert_run_steps_is_step_on_every_mesh(runs, key):
    """``build.multi`` (``BertTrainer.run_steps`` over staged batches) runs
    on every mesh and gives ``step``'s losses and parameters bit for bit."""
    got, _, _ = runs
    for res in got[_world_of(key)]["bert_" + key]:
        assert res["multi_bit_for_bit"]


@pytest.mark.parametrize("opt", ["adam", "lamb"])
@pytest.mark.parametrize("key", BERT_KEYS)
def test_bert_step_matches_jax(runs, key, opt):
    got, ref, _ = runs
    for res in got[_world_of(key)]["bert_" + key]:
        _close_trees(res["params_" + opt], ref["bert"][key]["params_" + opt],
                     opt, TREE_TOL)
        assert res["replicas_differ_" + opt] == 0


def test_lamb_trust_ratio_is_the_shards_own(runs):
    """At tp = 2 (heads) LAMB's trust ratio of a column-split leaf (the
    stacked wq, [L, E, E]) is each shard's ||p|| / ||r||, not the whole
    leaf's, as in the reference (its norms are not reduced outside ZeRO).
    The port's update, replayed in float64 from its own gradient both
    ways: the per-shard replay within a tenth of the distance between the
    two replays (the f32 update's rounding is ~1e-8, that distance ~1e-6)."""
    got, _, inputs = runs
    res = got[2]["bert_tp2_heads"][0]
    p = inputs["bert_params"]["pp1"]["params_layers"]["wq"].astype(np.float64)
    g = res["grads"]["params_layers"]["wq"].astype(np.float64)
    r = g / (np.abs(g) + 1e-6) + 0.01 * p       # LAMB's first-step direction
    E = p.shape[-1]

    def update(cols):
        trust = np.linalg.norm(p[cols]) / np.linalg.norm(r[cols])
        return MW.LR * trust * r[cols]

    shards = np.concatenate([update((Ellipsis, slice(s * E // 2,
                                                      (s + 1) * E // 2)))
                             for s in range(2)], axis=-1)
    whole = update(Ellipsis)
    port = p - res["params_lamb"]["params_layers"]["wq"]
    assert np.linalg.norm(port - shards) < 0.1 * np.linalg.norm(whole - shards)


def test_zero_moments_and_shards_match_jax(runs):
    got, ref, _ = runs
    want = ref["bert"]["dp2_tp2_zero"]
    for res in got[4]["bert_dp2_tp2_zero"]:
        for opt in ("adam", "lamb"):
            _close_trees(res["m_" + opt], want["m_" + opt], "m", TREE_TOL)
        # every leaf of BERT tiny divides over dp = 2 after its tp split
        assert all(res["sharded_adam"])


# -- ring attention, gpipe, MoE -----------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("world", [2, 4])
def test_ring_attention_matches_jax(runs, world, causal):
    got, ref, inputs = runs
    want = ref["ring"][world][causal]
    S = inputs["ring"][world]["q"].shape[1]
    o = np.concatenate([r[causal]["o"]
                        for r in got[world]["ring_attention"]], 1)
    np.testing.assert_allclose(o, want["o"], **OP_TOL)
    np.testing.assert_allclose(o, want["plain"], **OP_TOL)
    if causal:          # query 0 of every row sees only key 0, masked
        assert not np.any(o[:, 0])
    for i, n in enumerate("qkv"):
        g = np.concatenate([r[causal]["grads"][i]
                            for r in got[world]["ring_attention"]], 1)
        assert g.shape[1] == S
        np.testing.assert_allclose(g, want["grads"][i], err_msg=n, **OP_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_ring_attention_shifts_point_to_point_on_gloo_cpu(runs, world):
    """gloo takes point-to-point calls on CPU tensors: the P2P route, one
    batch_isend_irecv a shift: K, V and the mask forward and K and V
    backward, for n - 1 steps, causal and not."""
    got, _, _ = runs
    for r in got[world]["ring_attention"]:
        assert r["route"] == "p2p"
        assert r["p2p_calls"] == 2 * (3 + 2) * (world - 1)


@pytest.mark.parametrize("world", [2, 4])
def test_gpipe_matches_sequential_stages(runs, world):
    """The outputs are the stages run in sequence; the gradients are world
    times theirs: the loss is psum'd over pp (the last stage's, masked), and
    psum's transpose is psum, as in the reference."""
    got, _, inputs = runs
    case = inputs["gpipe"]
    w = torch.tensor(case["w"][:world], requires_grad=True)
    b = torch.tensor(case["b"][:world], requires_grad=True)
    x = torch.tensor(case["x"], requires_grad=True)
    h = x
    for s in range(world):
        h = torch.tanh(h @ w[s] + b[s])
    gw, gb, gx = torch.autograd.grad((h * torch.tensor(case["cot"])).sum(),
                                     (w, b, x))
    res = got[world]["gpipe"]
    np.testing.assert_allclose(res[-1]["ys"], h.detach().numpy(), **OP_TOL)
    for r in range(world):
        np.testing.assert_allclose(res[r]["gw"], world * gw[r].numpy(),
                                   **OP_TOL)
        np.testing.assert_allclose(res[r]["gb"], world * gb[r].numpy(),
                                   **OP_TOL)
        np.testing.assert_allclose(res[r]["gx"], world * gx.numpy() if r == 0
                                   else np.zeros_like(case["x"]), **OP_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_moe_matches_jax(runs, world):
    got, ref, inputs = runs
    want = ref["moe"][world]
    res = got[world]["moe"]
    y = np.stack([r["y"] for r in res])
    np.testing.assert_allclose(y, want["y"], **OP_TOL)
    # capacity factor 1 drops tokens: their outputs are zero
    assert np.sum(~np.any(want["y"], axis=-1)) > 0
    np.testing.assert_allclose(np.stack([r["grads"][0] for r in res]),
                               want["gx"], **OP_TOL)
    for r in range(world):
        np.testing.assert_allclose(res[r]["grads"][1], want["grouter"][r],
                                   **OP_TOL)
    n_local = inputs["moe"][world]["w1"].shape[0] // world
    for i, key in ((2, "gw1"), (3, "gw2")):
        np.testing.assert_allclose(
            np.concatenate([r["grads"][i] for r in res]), want[key], **OP_TOL)
        assert res[0]["grads"][i].shape[0] == n_local


# -- the mesh -----------------------------------------------------------------

def test_make_mesh_coordinates_and_groups(runs):
    got, _, _ = runs
    want_groups = {(2, 1, 2): {"dp": [[0, 2], [1, 3]], "pp": [],
                               "tp": [[0, 1], [2, 3]]},
                   (1, 2, 2): {"dp": [], "pp": [[0, 2], [1, 3]],
                               "tp": [[0, 1], [2, 3]]}}
    for rank, res in enumerate(got[4]["mesh_layout"]):
        for shape, rec in res.items():
            _, pp, tp = shape
            c = rec["coords"]
            assert (c["dp"] * pp + c["pp"]) * tp + c["tp"] == rank
            assert rec["axis_groups"] == want_groups[shape]
            assert rec["world_key"] and rec["groups"]["world"] == [0, 1, 2, 3]
            for a, groups in want_groups[shape].items():
                mine = [g for g in groups if rank in g]
                if mine:
                    assert rec["groups"][a] == mine[0]
                    assert rec["psum"][a] == float(sum(mine[0]))
                else:
                    assert a not in rec["groups"]
                    assert rec["psum"][a] == float(rank)


# -- ResNet on a tp or pp mesh ------------------------------------------------

@pytest.mark.parametrize("axis", ["tp", "pp"])
def test_resnet_trains_replicated_on_a_tp_or_pp_mesh(runs, axis):
    """The reference's ResNet trainer replicates everything over tp and pp
    (it trains there as at one device); the port's does the same."""
    got, ref, _ = runs
    want = ref["resnet"][axis]
    for res in got[2]["resnet_" + axis]:
        np.testing.assert_allclose(res["losses"], want["losses"], **LOSS_TOL)
        _close_trees(res["params"], want["params"], "params",
                     dict(rtol=1e-5, atol=1e-5))
        _close_trees(res["bn"], want["bn"], "bn", dict(rtol=1e-4, atol=1e-4))
