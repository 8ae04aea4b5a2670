"""The port's DeepFM slice against the JAX package and ``bench.py``'s step
variants on the same weights (JAX's init, carried over as numpy) and the
same numpy batch, at ``deepfm_tiny_config()`` and B = 32.  Tolerance 1e-5
absolute, as the reference's own variant test (tests/test_segment_update.py)
holds the variants to each other; the Pallas segment-sum kernel runs in
interpret mode.  The steps run SGD at lr 1: at the bench's lr 1e-3 a table
row moves by about 1e-6 here, below that tolerance, so a variant that lost
or mis-merged its table update would still pass."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from paddle_tpu.kernels.segment_update import dedup_segment_sum as jdedup
from paddle_tpu.models import deepfm as jdeepfm
from paddle_tpu.models.parity import deepfm_synthetic_auc as jax_auc
from paddle_tpu.parallel import optim as joptim
from paddle_tpu_torch import convert
from paddle_tpu_torch._tree import tree_leaves
from paddle_tpu_torch.kernels import _common
from paddle_tpu_torch.kernels.segment_update import (dedup_segment_sum as
                                                     pdedup, scatter_rows_drop)
from paddle_tpu_torch.models import deepfm as pdeepfm
from paddle_tpu_torch.models.parity import deepfm_synthetic_auc
from paddle_tpu_torch.parallel import optim as poptim
from paddle_tpu_torch.parallel.train import grads_of


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = jdeepfm.deepfm_tiny_config()
PCFG = pdeepfm.deepfm_tiny_config()
LR = 1.0
TOL = dict(atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def jparams():
    return jdeepfm.init_deepfm_params(jax.random.PRNGKey(0), CFG)


@pytest.fixture(scope="module")
def np_params(jparams):
    return jax.tree.map(np.asarray, jparams)


def _batch(seed=4, B=32):
    rng = np.random.RandomState(seed)
    return {"feat_ids": rng.randint(0, CFG.num_features,
                                    (B, CFG.num_fields)).astype(np.int32),
            "label": rng.randint(0, 2, (B,)).astype(np.float32)}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_trees(port_tree, jax_tree, **tol):
    pl, jl = tree_leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(pl) == len(jl)
    for p, j in zip(pl, jl):
        assert tuple(p.shape) == j.shape
        np.testing.assert_allclose(p.detach().float().numpy(), np.asarray(j),
                                   **(tol or TOL))


def test_param_tree_matches_jax(jparams):
    mine = pdeepfm.init_deepfm_params(torch.Generator().manual_seed(0), PCFG,
                                      "cpu")
    pl, jl = tree_leaves(mine), jax.tree.leaves(jparams)
    assert [tuple(t.shape) for t in pl] == [a.shape for a in jl]
    assert all(t.dtype == torch.float32 for t in pl)
    assert isinstance(mine["mlp"], list) and len(mine["mlp"]) == 3


def test_loss_and_every_gradient_match_jax(jparams, np_params):
    batch = _batch()
    jb = jax.tree.map(jnp.asarray, batch)
    loss_ref, g_ref = jax.value_and_grad(
        lambda p: jdeepfm.deepfm_loss(p, jb, CFG))(jparams)
    params = convert.params_from_numpy(np_params, "cpu")
    loss, g = grads_of(lambda p: pdeepfm.deepfm_loss(p, _tb(batch), PCFG),
                       params)
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref), rtol=1e-6)
    _assert_trees(g, g_ref)


def test_fused_and_row_losses_match_jax(jparams, np_params):
    batch = _batch(5)
    jb = jax.tree.map(jnp.asarray, batch)
    params = convert.params_from_numpy(np_params, "cpu")
    f = pdeepfm.fuse_tables(params)
    jf = jdeepfm.fuse_tables(jparams)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_allclose(
        float(pdeepfm.deepfm_loss_fused(params, f, _tb(batch), PCFG)),
        float(jdeepfm.deepfm_loss_fused(jparams, jf, jb, CFG)), rtol=1e-6)
    back = pdeepfm.split_tables(params, f)
    for k in ("embed", "w_linear"):
        assert torch.equal(back[k], params[k])


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("variant", ["dense", "fused", "rows", "segment"])
def test_step_variants_match_bench(jparams, np_params, variant, steps):
    """Each variant through the port's trainer against the same variant of
    bench.py, step by step."""
    batch = _batch(6)
    jb = jax.tree.map(jnp.asarray, batch)
    jstep = jax.jit(bench._deepfm_step_variants(CFG, LR)[variant])
    trainer = pdeepfm.build_deepfm_trainer(PCFG, variant=variant,
                                           device="cpu", params=np_params)
    before = dict(_common.launches)
    p = jparams
    for _ in range(steps):
        p, loss_ref = jstep(p, jb)
        loss = trainer.step(_tb(batch), LR)
        np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-6)
    assert _common.launches == before          # CPU tensors: no kernel
    _assert_trees(trainer.state["params"], p)


def test_variants_agree_with_dense_after_one_step(np_params):
    batch = _tb(_batch(7))
    params = convert.params_from_numpy(np_params, "cpu")
    variants = pdeepfm.make_step_variants(PCFG, LR)
    ref, loss_ref = variants["dense"](params, batch)
    # the table update is far above the tolerance, so a lost one shows
    for k in ("embed", "w_linear"):
        assert float((ref[k] - params[k]).abs().max()) > 100 * TOL["atol"]
    for name in ("fused", "rows", "segment"):
        out, loss = variants[name](params, batch)
        assert abs(float(loss) - float(loss_ref)) < 1e-5
        for a, b in zip(tree_leaves(out), tree_leaves(ref)):
            torch.testing.assert_close(a, b, **TOL)
    # functional: the input tree is untouched
    for a, b in zip(tree_leaves(params), jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_out_of_range_ids_drop_as_in_jax(jparams, np_params):
    """Ids at or past num_features: the gathers clamp in JAX (and would
    raise in PyTorch), so feed them only to the row update."""
    rng = np.random.RandomState(8)
    ids = rng.randint(0, 40, 300).astype(np.int32)
    ids[:7] = CFG.num_features + np.arange(7)
    g = rng.randn(300, CFG.embed_dim + 1).astype(np.float32)
    f = np.asarray(jdeepfm.fuse_tables(jparams))
    mr, mv = jdedup(jnp.asarray(ids), jnp.asarray(g), f.shape[0],
                    interpret=True)
    ref = jnp.asarray(f).at[mr].add(-LR * mv, mode="drop",
                                    unique_indices=True)
    pr, pv = pdedup(torch.from_numpy(ids), torch.from_numpy(g), f.shape[0])
    got = scatter_rows_drop(torch.from_numpy(f.copy()), pr, -LR * pv)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("variant", ["dense", "fused", "rows", "segment"])
def test_out_of_range_ids_in_the_batch_match_bench(jparams, np_params,
                                                   variant):
    """Ids -1, -V-1, V and V+5 in the batch, through each step variant of
    the port's trainer against the same variant of bench.py under jit: the
    gathers read row V-1 for -1, row 0 for -V-1 and row V-1 for V and V+5
    (JAX's gather: negatives count from the end, then clamp), and only -1
    sends a gradient, into row V-1; the row variants' drop-mode update
    likewise keeps -1 (as V-1) and drops the rest."""
    V = CFG.num_features
    batch = _batch(11)
    # V-1 itself stays out of the batch, so -1's update is the only one to
    # row V-1 and the row variants' scatter keeps its unique-rows promise
    batch["feat_ids"][batch["feat_ids"] == V - 1] = 0
    batch["feat_ids"][0, :4] = [-1, -V - 1, V, V + 5]
    batch["feat_ids"][3, 2:4] = [V + 5, -1]
    jb = jax.tree.map(jnp.asarray, batch)
    p, loss_ref = jax.jit(bench._deepfm_step_variants(CFG, LR)[variant])(
        jparams, jb)
    trainer = pdeepfm.build_deepfm_trainer(PCFG, variant=variant,
                                           device="cpu", params=np_params)
    loss = trainer.step(_tb(batch), LR)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-6)
    _assert_trees(trainer.state["params"], p)
    # the update reached row V-1 (from -1) and left the clamp targets of
    # the dropped ids alone where nothing else touched them
    moved = np.abs(np.asarray(p["embed"]) - np_params["embed"]).max(axis=1)
    assert moved[V - 1] > 100 * TOL["atol"]


def test_take_rows_matches_jax_gather():
    """The gather helper against ``table[ids]`` under jit, forward and the
    gradient into the table, on a 4-row table."""
    ids = np.array([-5, -1, 0, 3, 4, 9], dtype=np.int32)
    t = np.arange(8, dtype=np.float32).reshape(4, 2)
    w = np.arange(1, 7, dtype=np.float32)[:, None]
    jt = jnp.asarray(t)
    fwd_ref = jax.jit(lambda a: a[jnp.asarray(ids)])(jt)
    grad_ref = jax.grad(lambda a: (jax.jit(lambda b: b[jnp.asarray(ids)])(a)
                                   * w).sum())(jt)
    tt = torch.from_numpy(t).requires_grad_()
    out = pdeepfm.take_rows(tt, torch.from_numpy(ids))
    (grad,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), tt)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(fwd_ref))
    np.testing.assert_array_equal(grad.numpy(), np.asarray(grad_ref))


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_adam_trajectory_matches_jax(jparams, np_params, name):
    batch = _batch(9)
    jb = jax.tree.map(jnp.asarray, batch)
    j_init, j_update = getattr(joptim, name)()
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jdeepfm.deepfm_loss(p, b, CFG)))
    p, opt = jparams, j_init(jparams)
    trainer = pdeepfm.build_deepfm_trainer(
        PCFG, variant="dense", optimizer=getattr(poptim, name)(),
        device="cpu", params=np_params)
    for _ in range(3):
        loss_ref, g = grad_fn(p, jb)
        p, opt = j_update(g, opt, p, 1e-2)
        loss = trainer.step(_tb(batch), 1e-2)
        np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-6)
    _assert_trees(trainer.state["params"], p)
    _assert_trees(trainer.state["opt"]["m"], opt["m"])
    _assert_trees(trainer.state["opt"]["v"], opt["v"], atol=1e-8, rtol=1e-5)
    assert int(trainer.state["opt"]["step"]) == int(opt["step"]) == 3


def test_synthetic_auc_matches_jax(np_params):
    """BASELINE's criterion: both above 0.95, within 0.01 of each other,
    from JAX's init weights."""
    ref = jax_auc()
    got = deepfm_synthetic_auc(params=np_params, device="cpu")
    assert ref > 0.95 and got > 0.95
    assert abs(got - ref) <= 0.01


def test_autotune_times_every_variant(np_params):
    params = convert.params_from_numpy(np_params, "cpu")
    variants = pdeepfm.make_step_variants(PCFG, LR)
    name, fn, timings = pdeepfm.autotune_step(variants, params, _tb(_batch()), 2)
    assert list(timings) == list(variants) and fn is variants[name]
    assert all(t > 0 for t in timings.values())
    assert timings[name] == min(timings.values())
    # functional: every variant was timed from the same, untouched params
    for a, b in zip(tree_leaves(params), jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_unsupported_settings_raise():
    """The sharded functions run since item 5-C′
    (``tests/test_torch_sharded_embedding.py``); a sharded trainer takes
    the segment variant's SGD step only."""
    from paddle_tpu_torch.parallel.rules import P

    specs = pdeepfm.deepfm_param_specs(PCFG)
    assert specs["embed"] == P("dp", None) and specs["bias"] == P()
    with pytest.raises(ValueError, match="variant"):
        pdeepfm.build_deepfm_trainer(PCFG, variant="nope", device="cpu")
    with pytest.raises(ValueError, match="dense"):
        pdeepfm.build_deepfm_trainer(PCFG, optimizer=poptim.adam(),
                                     device="cpu")


def test_synthetic_batch_and_flops_are_the_bench():
    b = pdeepfm.synthetic_batch(pdeepfm.DeepFMConfig(), 8192)
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(b["feat_ids"],
                                  rng.randint(0, 1000000, (8192, 39)))
    np.testing.assert_array_equal(b["label"], rng.randint(0, 2, (8192,)))
    assert b["feat_ids"].dtype == np.int32 and b["label"].dtype == np.float32
    assert pdeepfm.mlp_train_flops(pdeepfm.DeepFMConfig(), 8192) == (
        3 * 2 * 8192 * (390 * 400 + 400 * 400 + 400 * 400 + 400))
