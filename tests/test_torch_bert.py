"""The port's BERT pretraining slice against the JAX package on the CPU:
loss and every gradient leaf of ``bert_tiny_config`` (f32) with and without
MLM ``positions``, a 3-step LAMB trajectory through the whole train step,
and the reference behaviours the port must keep (tanh GELU, the parameter
tree and layout, 4 vocab chunks, the bf16 rounding of the vocab-loss
gradient, no key-padding mask).  Both sides start from the JAX package's
initial parameters, carried over with ``convert.params_from_numpy``.

Tolerances: the loss to rtol 1e-5 (f32, the same operations in another
summation order).  Gradients to atol 2e-5 / rtol 1e-3: both sides round the
vocab-loss gradient to bf16 (transformer.py:398), and where ``p - onehot``
sits on a bf16 rounding edge the two frameworks' f32 values of it can round
to neighbouring bf16 values, a relative change of 2^-8 in that element.
LAMB parameters to atol 1e-5 (1% of lr = 1e-3) after each step: an update
is lr * trust * r with |r| <= ~1, and r = m / (sqrt(v) + eps) is sensitive
to the last digits of a gradient element whose size is near eps = 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import bert as jbert
from paddle_tpu.parallel import optim as joptim
from paddle_tpu.parallel import transformer as jtf
from paddle_tpu_torch import convert
from paddle_tpu_torch._tree import tree_leaves
from paddle_tpu_torch.models import bert as pbert
from paddle_tpu_torch.parallel import optim as poptim
from paddle_tpu_torch.parallel import transformer as ptf
from paddle_tpu_torch.parallel.mesh import MeshSpec
from paddle_tpu_torch.parallel.train import stack_batches

LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(atol=2e-5, rtol=1e-3)


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray,
                        jtf.init_transformer_params(jax.random.PRNGKey(seed), cfg))


def _batch(seed, cfg, B=2, S=32, P=None):
    rng = np.random.RandomState(seed)
    b = {"ids": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    n = S if P is None else P
    b["labels"] = rng.randint(0, cfg.vocab_size, (B, n)).astype(np.int32)
    b["mask"] = (rng.rand(B, n) < 0.6).astype(np.float32)
    if P is not None:
        b["positions"] = np.stack([np.sort(rng.choice(S, P, replace=False))
                                   for _ in range(B)]).astype(np.int32)
    return b


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], prefix + "/" + k)]
    return [prefix]


def _jax_loss_grads(cfg, params, batch):
    loss, grads = jax.value_and_grad(jbert.make_loss_fn(cfg))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch))
    return float(loss), tree_leaves(jax.tree.map(np.asarray, grads))


def _torch_loss_grads(cfg, params, batch):
    tp = convert.params_from_numpy(params, "cpu")
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = pbert.make_loss_fn(cfg)(tp, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("positions,use_flash", [
    pytest.param(None, True, id="None"),
    pytest.param(8, True, id="8"),
    # the reference's XLA softmax path: ring_attention(axis=None) on eager
    # ops (on the card too)
    pytest.param(None, False, id="no_flash"),
])
def test_loss_and_grads_match_jax(positions, use_flash):
    cfg = jbert.bert_tiny_config(use_flash=use_flash)
    params = _jax_params(cfg)
    batch = _batch(1, cfg, P=positions)
    want_loss, want = _jax_loss_grads(cfg, params, batch)
    got_loss, got = _torch_loss_grads(pbert.bert_tiny_config(use_flash=use_flash),
                                      params, batch)
    np.testing.assert_allclose(got_loss, want_loss, **LOSS_TOL)
    for name, g, w in zip(_leaf_names(params), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL)


def test_remat_gives_the_same_grads():
    cfg = jbert.bert_tiny_config()
    params = _jax_params(cfg)
    batch = _batch(2, cfg)
    l0, g0 = _torch_loss_grads(pbert.bert_tiny_config(), params, batch)
    l1, g1 = _torch_loss_grads(pbert.bert_tiny_config(remat=True), params, batch)
    assert l0 == l1
    for a, b in zip(g0, g1):
        np.testing.assert_array_equal(a, b)


def test_lamb_trajectory_matches_jax():
    """Three train steps (forward, backward, LAMB) from the same weights and
    batches: parameters after every step, and the loss of every step."""
    cfg = jbert.bert_tiny_config()
    params = _jax_params(cfg)
    batches = [_batch(10 + i, cfg) for i in range(3)]
    lr = 1e-3

    loss_fn = jbert.make_loss_fn(cfg)
    j_init, j_update = joptim.lamb()

    @jax.jit
    def jstep(p, opt, b):
        loss, g = jax.value_and_grad(loss_fn)(p, b)
        p, opt = j_update(g, opt, p, lr)
        return p, opt, loss

    jp = jax.tree.map(jnp.asarray, params)
    jopt = j_init(jp)
    trainer = pbert.build_bert_trainer(pbert.bert_tiny_config(),
                                       optimizer=poptim.lamb(), device="cpu",
                                       params=params)
    names = _leaf_names(params)
    for b in batches:
        jp, jopt, jloss = jstep(jp, jopt, jax.tree.map(jnp.asarray, b))
        loss = trainer.step({k: torch.from_numpy(v) for k, v in b.items()}, lr)
        np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
        got = tree_leaves(convert.params_to_numpy(trainer.state["params"]))
        want = tree_leaves(jax.tree.map(np.asarray, jp))
        for name, g, w in zip(names, got, want):
            if name == "/params_layers/bqkv":
                # the key bias's gradient is exactly 0 in exact arithmetic
                # (a per-row shift of the scores); both sides hand LAMB
                # rounding noise of ~1e-9 there, which r = m/(sqrt(v)+eps)
                # magnifies: hold that slice to its update's own scale, lr
                np.testing.assert_allclose(g[:, 1], w[:, 1], atol=lr, rtol=0)
                g, w = g[:, 0::2], w[:, 0::2]
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)
    assert int(trainer.state["opt"]["step"]) == 3


def test_lamb_bf16_moments_and_zero_norm_trust():
    """Moments are zeros_like(params): bf16 for bf16 leaves, updating in
    bf16; the update is cast to the param dtype; a zero leaf (trust ratio 1)
    moves by lr * weight-decay-free r.  Held against the reference's update
    on the same tree, to bf16 resolution."""
    rng = np.random.RandomState(3)
    p32 = {"w": rng.randn(16, 8).astype("f4"), "z": np.zeros(8, "f4")}
    grads = [{k: rng.randn(*v.shape).astype("f4") for k, v in p32.items()}
             for _ in range(3)]
    j_init, j_update = joptim.lamb()
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), p32)
    jopt = j_init(jp)
    p_init, p_update = poptim.lamb()
    tp = {k: torch.from_numpy(v).bfloat16() for k, v in p32.items()}
    topt = p_init(tp)
    assert topt["m"]["w"].dtype == torch.bfloat16
    for g in grads:
        jp, jopt = j_update(jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), g),
                            jopt, jp, 1e-2)
        tp, topt = p_update({k: torch.from_numpy(v).bfloat16() for k, v in g.items()},
                            topt, tp, 1e-2)
        for k in p32:
            assert tp[k].dtype == torch.bfloat16
            np.testing.assert_allclose(tp[k].float().numpy(),
                                       np.asarray(jp[k], dtype="f4"),
                                       atol=1e-2, rtol=1e-2, err_msg=k)
            np.testing.assert_allclose(topt["m"][k].float().numpy(),
                                       np.asarray(jopt["m"][k], dtype="f4"),
                                       atol=1e-2, rtol=1e-2, err_msg=k)
    assert float(tp["z"].abs().max()) > 0      # zero leaf moved: trust = 1


def test_sgd_matches_jax():
    rng = np.random.RandomState(4)
    p = {"a": rng.randn(5, 3).astype("f4")}
    g = {"a": rng.randn(5, 3).astype("f4")}
    want, _ = joptim.sgd()[1](jax.tree.map(jnp.asarray, g), {},
                              jax.tree.map(jnp.asarray, p), 0.1)
    got, _ = poptim.sgd()[1]({"a": torch.from_numpy(g["a"])}, {},
                             {"a": torch.from_numpy(p["a"].copy())}, 0.1)
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                               rtol=1e-6)


def test_run_steps_matches_single_steps():
    cfg = pbert.bert_tiny_config()
    params = _jax_params(jbert.bert_tiny_config())
    batches = [_batch(20 + i, cfg) for i in range(3)]
    a = pbert.build_bert_trainer(cfg, device="cpu", params=params)
    b = pbert.build_bert_trainer(cfg, device="cpu", params=params)
    single = [float(a.step({k: torch.from_numpy(v) for k, v in bt.items()}, 1e-3))
              for bt in batches]
    multi = b.run_steps(stack_batches(b.mesh, pbert.batch_specs(), batches,
                                      pbert.batch_dtypes()), 1e-3)
    np.testing.assert_array_equal(multi.numpy(), np.array(single, "f4"))


def test_embed_out_of_range_ids_match_jax():
    """Ids -1, V and V+3: a zero token row and no gradient into
    ``tok_emb``, as the reference's vocab mask gives at tp = 1.  Exact in
    f32: the same gathers, products by 0 or 1, and one add."""
    cfg = jbert.bert_tiny_config()
    V = cfg.vocab_size
    params = _jax_params(cfg)
    ids = np.array([[-1, 2, V, 5], [V + 3, 0, V - 1, -1]], dtype=np.int32)
    w = np.random.RandomState(12).randn(2, 4, cfg.hidden).astype(np.float32)
    sub = {k: params[k] for k in ("tok_emb", "pos_emb")}

    def jloss(p):
        return (jtf.embed(p, jnp.asarray(ids), cfg) * w).sum()

    jout = jtf.embed(jax.tree.map(jnp.asarray, sub), jnp.asarray(ids), cfg)
    jgrad = jax.grad(jloss)(jax.tree.map(jnp.asarray, sub))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in sub.items()}
    out = ptf.embed(tp, torch.from_numpy(ids), cfg)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                [tp["tok_emb"], tp["pos_emb"]])
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_array_equal(grads[0].numpy(), np.asarray(jgrad["tok_emb"]))
    np.testing.assert_array_equal(grads[1].numpy(), np.asarray(jgrad["pos_emb"]))
    # out-of-range positions carry the position row alone
    np.testing.assert_array_equal(out[0, 0].detach().numpy(), sub["pos_emb"][0])
    np.testing.assert_array_equal(out[0, 2].detach().numpy(), sub["pos_emb"][2])


def test_gelu_is_tanh_form():
    x = np.linspace(-6, 6, 101).astype("f4")
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = ptf.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_tree_matches_jax(dtype):
    """Same leaves, shapes and dtypes: bqkv is [L, 3, E], LN params f32, no
    separate LM head (tied to tok_emb)."""
    jcfg = jbert.bert_tiny_config(dtype=dtype)
    want = _jax_params(jcfg)
    got = ptf.init_transformer_params(torch.Generator().manual_seed(0),
                                      pbert.bert_tiny_config(dtype=dtype),
                                      device="cpu")
    assert _leaf_names(got) == _leaf_names(want)
    for name, g, w in zip(_leaf_names(want), tree_leaves(got), tree_leaves(want)):
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype).replace("torch.", "") == w.dtype.name, name
    assert tuple(got["params_layers"]["bqkv"].shape) == (4, 3, 32)


def test_vocab_chunks_match_jax():
    emb = np.zeros((30528, 1), "f4")
    assert ptf._vocab_chunks(30528, 4) == jtf._vocab_chunks(emb, 4)


def test_vocab_grad_is_rounded_to_bf16_in_f32_configs():
    """The tied-embedding gradient carries the reference's bf16 rounding:
    it differs from exact f32 softmax cross-entropy, and matches JAX."""
    rng = np.random.RandomState(5)
    x = rng.randn(6, 16).astype("f4")
    emb = rng.randn(40, 16).astype("f4")
    labels = rng.randint(0, 40, 6).astype(np.int32)
    xt, et = (torch.from_numpy(a).requires_grad_() for a in (x, emb))
    ptf._ChunkedVocabNLL.apply(xt, et, torch.from_numpy(labels), 4).sum().backward()
    want = jax.grad(lambda e: jnp.sum(jtf._chunked_vocab_nll(
        jnp.asarray(x), e, jnp.asarray(labels), 4)))(jnp.asarray(emb))
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(want), **GRAD_TOL)
    e2 = torch.from_numpy(emb).requires_grad_()
    torch.nn.functional.cross_entropy(torch.from_numpy(x) @ e2.t(),
                                      torch.from_numpy(labels).long(),
                                      reduction="sum").backward()
    assert np.abs(e2.grad.numpy() - et.grad.numpy()).max() > 1e-5


def test_attention_has_no_key_padding_mask():
    """batch['mask'] only weights the loss: changing a token whose loss is
    masked out still changes the loss, in both frameworks alike."""
    cfg = jbert.bert_tiny_config()
    params = _jax_params(cfg)
    b0 = _batch(6, cfg)
    b0["mask"][:, -1] = 0.0
    b1 = {k: v.copy() for k, v in b0.items()}
    b1["ids"][:, -1] = (b1["ids"][:, -1] + 1) % cfg.vocab_size
    l0, _ = _torch_loss_grads(pbert.bert_tiny_config(), params, b0)
    l1, _ = _torch_loss_grads(pbert.bert_tiny_config(), params, b1)
    j0, _ = _jax_loss_grads(cfg, params, b0)
    j1, _ = _jax_loss_grads(cfg, params, b1)
    assert abs(l1 - l0) > 1e-6
    np.testing.assert_allclose(l1 - l0, j1 - j0, rtol=1e-3, atol=1e-6)


def test_convert_roundtrip_keeps_bf16_bits():
    params = _jax_params(jbert.bert_tiny_config(dtype="bfloat16"))
    back = convert.params_to_numpy(convert.params_from_numpy(params, "cpu"))
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        np.testing.assert_array_equal(a, b.astype("f4"))


def test_parallel_degrees_raise():
    """dp, tp and pp above one need a world of that many ranks
    (tests/test_torch_parallel_dp.py and tests/test_torch_model_parallel.py
    run them); a mesh's pp and tp must be the config's."""
    for cfg_kw, spec in (({"tp": 2}, MeshSpec(tp=2)),
                         ({"pp": 2}, MeshSpec(pp=2)), ({}, MeshSpec(dp=2))):
        with pytest.raises(ValueError, match="needs 2 ranks"):
            pbert.build_bert_trainer(pbert.bert_tiny_config(**cfg_kw), spec,
                                     device="cpu")
    with pytest.raises(ValueError, match="against cfg"):
        pbert.build_bert_trainer(pbert.bert_tiny_config(), MeshSpec(tp=2),
                                 device="cpu")


def test_ring_mode_at_one_rank_matches_jax():
    """attn_mode="ring" at one rank (no tp axis) runs plain attention
    through ring_attention, as the reference does: the loss and gradients
    match JAX's."""
    params = _jax_params(jbert.bert_tiny_config())
    rng = np.random.RandomState(3)
    batch = {"ids": rng.randint(0, 128, (4, 32)).astype(np.int32),
             "labels": rng.randint(0, 128, (4, 32)).astype(np.int32),
             "mask": (rng.rand(4, 32) < 0.5).astype(np.float32)}
    lt, gt = _torch_loss_grads(pbert.bert_tiny_config(attn_mode="ring"),
                               params, batch)
    lj, gj = _jax_loss_grads(jbert.bert_tiny_config(attn_mode="ring"),
                             params, batch)
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=1e-6)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)