"""The port's Transformer NMT slice against the JAX package on the CPU:
``nmt_tiny_config`` (vocab 64, 2 + 2 layers, hidden 32, 4 heads), both sides
from the JAX package's ``init_nmt_params(PRNGKey(0), cfg)`` carried over
with ``convert.params_from_numpy``.

- The teacher-forced loss and every gradient leaf (f32) on padded batches
  whose masks hold zeros, one of them with a source row masked entirely.
- ``decode_logits`` projecting every position and one position t.
- One bf16 loss.
- Two SGD steps through ``build_nmt_trainer``.
- ``beam_search`` over a model trained a few SGD steps on WMT16-shaped
  data, so beams finish on EOS and freeze.
- ``wmt16_batch`` against ``bench.py``'s NMT batch, from the synthetic
  corpus and from a small archive in the reference's layout.
- The copy-task decode parity, and the FLOP count behind the card's MFU.

Tolerances: the loss to rtol 1e-5 and every gradient leaf to atol 2e-5 /
rtol 1e-3 in f32 (the tolerances of ``tests/test_torch_bert.py``; the two
frameworks sum in other orders).  Logits to atol 1e-5.  The bf16 loss to
rtol 3e-3: each bf16 product and sum rounds to 2^-9 relative, and where the
two frameworks round an intermediate to neighbouring bf16 values the
difference propagates through four layers (over four batch seeds the gap
was at most 6.5e-4); a wrong formula moves the loss by O(1).
Beam search: sequences exactly equal, scores to 1e-5.  SGD parameters to
atol 1e-6 after two steps at lr 0.1 (the update is lr x the gradient
above).
"""

import io
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from paddle_tpu.datasets import common as jcommon
from paddle_tpu.datasets import wmt16 as jwmt16
from paddle_tpu.models import transformer_nmt as jnmt
from paddle_tpu_torch import convert
from paddle_tpu_torch._tree import tree_leaves
from paddle_tpu_torch.datasets import common as pcommon
from paddle_tpu_torch.datasets import wmt16 as pwmt16
from paddle_tpu_torch.models import transformer_nmt as pnmt
from paddle_tpu_torch.models.parity import nmt_copy_decode_parity

LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(atol=2e-5, rtol=1e-3)
LOGIT_TOL = dict(atol=1e-5, rtol=0)
BF16_LOSS_TOL = dict(rtol=3e-3, atol=0)
SCORE_TOL = dict(atol=1e-5, rtol=0)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The port's side runs thousands of tiny ops.  With a team of intra-op
    threads per process, test processes running side by side wait on each
    other's spinning threads: four processes of the copy-task recipe took
    150 s each with 8 threads and 1 s with one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return jnmt.nmt_tiny_config(**kw), pnmt.nmt_tiny_config(**kw)


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray, jnmt.init_nmt_params(
        jax.random.PRNGKey(seed), cfg))


def _padded_batch(seed, cfg, src_lens, tgt_lens, Ss=10, St=9):
    """Random ids, zero-padded past each row's length, masks 1 over it."""
    rng = np.random.RandomState(seed)
    B = len(src_lens)
    smask = (np.arange(Ss)[None] < np.array(src_lens)[:, None]).astype(np.float32)
    tmask = (np.arange(St)[None] < np.array(tgt_lens)[:, None]).astype(np.float32)
    src = rng.randint(2, cfg.src_vocab, (B, Ss)).astype(np.int32)
    tgt = rng.randint(2, cfg.tgt_vocab, (B, St + 1)).astype(np.int32)
    tgt[:, 0] = cfg.bos_id
    return {"src_ids": src * smask.astype(np.int32), "src_mask": smask,
            "tgt_in": tgt[:, :-1] * tmask.astype(np.int32),
            "tgt_out": tgt[:, 1:] * tmask.astype(np.int32),
            "tgt_mask": tmask}


BATCHES = {
    "padded": ([10, 6, 3], [9, 4, 7]),
    "src_row_all_masked": ([10, 0, 5], [9, 5, 1]),
}


def _jax_grad_fn(cfg):
    return jax.jit(jax.value_and_grad(lambda p, b: jnmt.nmt_loss(p, b, cfg)))


def _jax_loss_grads(cfg, params, batch):
    loss, grads = _jax_grad_fn(cfg)(jax.tree.map(jnp.asarray, params),
                                    jax.tree.map(jnp.asarray, batch))
    return float(loss), tree_leaves(jax.tree.map(np.asarray, grads))


def _torch_loss_grads(cfg, params, batch):
    tp = convert.params_from_numpy(params, "cpu")
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = pnmt.nmt_loss(tp, pnmt.batch_to(batch, "cpu"), cfg)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.float().numpy() for g in grads]


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_loss_and_grads_match_jax(case):
    jcfg, pcfg = _cfgs()
    params = _jax_params(jcfg)
    batch = _padded_batch(1, jcfg, *BATCHES[case])
    jl, jg = _jax_loss_grads(jcfg, params, batch)
    pl, pg = _torch_loss_grads(pcfg, params, batch)
    assert np.isfinite(pl)
    np.testing.assert_allclose(pl, jl, **LOSS_TOL)
    assert len(jg) == len(pg) == len(tree_leaves(params))
    for a, b in zip(pg, jg):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


@pytest.mark.parametrize("position", [None, 0, 4, 8])
def test_decode_logits_match_jax(position):
    jcfg, pcfg = _cfgs()
    params = _jax_params(jcfg)
    b = _padded_batch(2, jcfg, *BATCHES["src_row_all_masked"])
    jp = jax.tree.map(jnp.asarray, params)
    jmem = jnmt.encode(jp, b["src_ids"], b["src_mask"], jcfg)
    want = np.asarray(jnmt.decode_logits(jp, jmem, b["src_mask"], b["tgt_in"],
                                         jcfg, position=position))
    tp = convert.params_from_numpy(params, "cpu")
    tb = pnmt.batch_to(b, "cpu")
    with torch.no_grad():
        mem = pnmt.encode(tp, tb["src_ids"], tb["src_mask"], pcfg)
        np.testing.assert_allclose(mem.numpy(), np.asarray(jmem), **LOGIT_TOL)
        got = pnmt.decode_logits(tp, mem, tb["src_mask"], tb["tgt_in"], pcfg,
                                 position=position)
        full = pnmt.decode_logits(tp, mem, tb["src_mask"], tb["tgt_in"], pcfg)
    assert got.dtype == torch.float32
    assert got.shape == ((3, 9, 64) if position is None else (3, 1, 64))
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    if position is not None:   # one position projected = that row of all
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, position].numpy(),
                                   **LOGIT_TOL)


def test_bf16_loss_matches_jax():
    jcfg, pcfg = _cfgs(dtype="bfloat16")
    params = _jax_params(jcfg)
    batch = _padded_batch(3, jcfg, *BATCHES["padded"])
    jl = float(jnmt.nmt_loss(jax.tree.map(jnp.asarray, params),
                             jax.tree.map(jnp.asarray, batch), jcfg))
    tp = convert.params_from_numpy(params, "cpu")
    assert tp["enc"]["w1"].dtype == torch.bfloat16
    assert tp["enc"]["ln1"]["scale"].dtype == torch.float32
    with torch.no_grad():
        pl = float(pnmt.nmt_loss(tp, pnmt.batch_to(batch, "cpu"), pcfg))
    np.testing.assert_allclose(pl, jl, **BF16_LOSS_TOL)


def test_sgd_steps_match_jax():
    jcfg, pcfg = _cfgs()
    params = _jax_params(jcfg)
    batch = _padded_batch(4, jcfg, *BATCHES["src_row_all_masked"])
    lr = 0.1
    trainer = pnmt.build_nmt_trainer(pcfg, device="cpu", params=params)
    jp = jax.tree.map(jnp.asarray, params)
    jb = jax.tree.map(jnp.asarray, batch)
    grad_fn = _jax_grad_fn(jcfg)
    tb = pnmt.batch_to(batch, "cpu")
    for _ in range(2):
        jl, g = grad_fn(jp, jb)
        jp = jax.tree.map(lambda p, gr: p - lr * gr.astype(p.dtype), jp, g)
        pl = trainer.step(tb, lr)
        np.testing.assert_allclose(float(pl), float(jl), **LOSS_TOL)
    for a, b in zip(tree_leaves(trainer.state["params"]),
                    tree_leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def trained_tiny():
    """The tiny model after 40 SGD steps at lr 0.5 on a WMT16-shaped batch
    (targets end in EOS), trained in JAX; and a padded source batch."""
    jcfg, _ = _cfgs()
    batch = jwmt16_batch(jcfg, 16, 16, 16)
    jb = jax.tree.map(jnp.asarray, batch)
    jp = jax.tree.map(jnp.asarray, _jax_params(jcfg))
    grad_fn = _jax_grad_fn(jcfg)
    for _ in range(40):
        _, g = grad_fn(jp, jb)
        jp = jax.tree.map(lambda p, gr: p - 0.5 * gr, jp, g)
    return jax.tree.map(np.asarray, jp), batch


@pytest.mark.parametrize("beam_size,max_len", [(4, 12), (2, 16)])
def test_beam_search_matches_jax(trained_tiny, beam_size, max_len):
    jcfg, pcfg = _cfgs()
    params, batch = trained_tiny
    src = batch["src_ids"][:5]
    mask = batch["src_mask"][:5] > 0
    mask[4] = False                       # one source with no valid key
    jseq, jsc = jnmt.beam_search(jax.tree.map(jnp.asarray, params), src, mask,
                                 jcfg, beam_size=beam_size, max_len=max_len)
    tp = convert.params_from_numpy(params, "cpu")
    seq, sc = pnmt.beam_search(tp, torch.from_numpy(src), torch.from_numpy(mask),
                               pcfg, beam_size=beam_size, max_len=max_len)
    assert seq.shape == (5, beam_size, max_len) and seq.dtype == torch.int32
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), **SCORE_TOL)
    # the case the test is for: some beam finished on EOS and froze early
    assert (seq[:, :, :-1].numpy() == pcfg.eos_id).any()


def jwmt16_batch(cfg, B, Ss, St):
    """``bench.py``'s NMT batch (bench.py:623-648) built the same way, from
    the JAX package's reader, as numpy arrays."""
    src = np.zeros((B, Ss), np.int32)
    tin = np.zeros((B, St), np.int32)
    tout = np.zeros((B, St), np.int32)
    smask = np.zeros((B, Ss), np.float32)
    tmask = np.zeros((B, St), np.float32)
    it = iter(jwmt16.train(cfg.src_vocab, cfg.tgt_vocab)())
    samples = []
    while len(samples) < B:
        try:
            samples.append(next(it))
        except StopIteration:
            it = iter(jwmt16.train(cfg.src_vocab, cfg.tgt_vocab)())
    for i, (s, t, tn) in enumerate(samples):
        s, t, tn = s[:Ss], t[:St], tn[:St]
        src[i, :len(s)] = s
        tin[i, :len(t)] = t
        tout[i, :len(tn)] = tn
        smask[i, :len(s)] = 1.0
        tmask[i, :len(tn)] = 1.0
    return {"src_ids": src, "src_mask": smask, "tgt_in": tin,
            "tgt_out": tout, "tgt_mask": tmask}


def _archive(root):
    """A small wmt16.tar.gz in the reference's layout: members
    wmt16/{train,val,test}, lines 'en \\t de'."""
    rng = np.random.RandomState(7)
    d = root / "wmt16"
    d.mkdir()
    with tarfile.open(d / "wmt16.tar.gz", "w:gz") as tf:
        for member, n in (("train", 30), ("val", 5), ("test", 12)):
            lines = []
            for _ in range(n):
                en = ["w%d" % i for i in rng.randint(0, 40, rng.randint(1, 20))]
                de = ["v%d" % i for i in rng.randint(0, 50, rng.randint(1, 20))]
                lines.append(" ".join(en) + "\t" + " ".join(de))
            data = ("\n".join(lines) + "\n").encode()
            info = tarfile.TarInfo("wmt16/%s" % member)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


@pytest.mark.parametrize("corpus", ["synthetic", "archive"])
@pytest.mark.parametrize("shape", [(128, 128, 128), (40, 8, 6)])
def test_wmt16_batch_matches_bench(monkeypatch, tmp_path, corpus, shape):
    """Full width (B = Ss = St = 128, every sentence shorter than 128) and
    one that cuts sentences and wraps the reader (40 pairs from 30)."""
    if corpus == "archive":
        _archive(tmp_path)
    for common, reader in ((jcommon, jwmt16), (pcommon, pwmt16)):
        monkeypatch.setattr(common, "DATA_HOME", str(tmp_path))
        monkeypatch.setattr(reader, "_dict_cache", {})
    jcfg, pcfg = _cfgs(src_vocab=32000, tgt_vocab=32000)
    got = pwmt16.wmt16_batch(pcfg, *shape)
    want = jwmt16_batch(jcfg, *shape)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    assert got["tgt_mask"].sum() > 0 and (got["tgt_out"] == 1).any()


@pytest.mark.parametrize("init", ["seeded", "jax"])
def test_copy_decode_parity_on_cpu(init):
    """The reference's criterion (tests/test_models.py:60): above 0.9, from
    the port's seeded init and from the JAX package's."""
    params = _jax_params(jnmt.nmt_tiny_config()) if init == "jax" else None
    assert nmt_copy_decode_parity(device="cpu", params=params) > 0.9


def test_train_flops_count_every_product():
    """``nmt_train_flops`` equals the matrix products' FLOPs that
    torch.utils.flop_counter counts over one forward and backward."""
    cfg = pnmt.nmt_tiny_config()
    B, Ss, St = 3, 10, 9
    params = pnmt.init_nmt_params(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = pnmt.batch_to(_padded_batch(5, cfg, *BATCHES["padded"], Ss=Ss,
                                        St=St), "cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with FlopCounterMode(display=False) as counter:
        torch.autograd.grad(pnmt.nmt_loss(params, batch, cfg), leaves)
    assert counter.get_total_flops() == pnmt.nmt_train_flops(cfg, B, Ss, St)


def test_profile_groups_find_every_part_of_the_step():
    """``profile_step --model nmt`` charges each kernel to the op that
    launched it; on the CPU, each of a tiny step's leaf ops goes through
    the same walk up its callers, and every group is found: the products
    of forward and backward, the vocab loss and the update."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from paddle_tpu_torch.datasets.wmt16 import wmt16_batch
    from paddle_tpu_torch.parallel import optim
    from paddle_tpu_torch.tools import profile_step as ps

    cfg = pnmt.nmt_tiny_config(src_vocab=96, tgt_vocab=96)   # V unlike F
    init, update = optim.sgd()

    def traced_update(*args):
        with record_function(ps.NMT_UPDATE_RANGE):
            return update(*args)

    trainer = pnmt.build_nmt_trainer(cfg, optimizer=(init, traced_update),
                                     device="cpu")
    batch = pnmt.batch_to(wmt16_batch(cfg, 4, 16, 16), "cpu")
    trainer.step(batch, 0.1)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        trainer.step(batch, 0.1)
    by_op = {}
    for e in prof.events():
        if not e.cpu_children:
            by_op.setdefault(ps.nmt_op_group(ps.op_chain(e), cfg.tgt_vocab),
                             set()).add(e.name)
    assert set(by_op) == {
        "SGD update", "attention products (f32 from bf16, cuBLAS)",
        "vocab head product (tied tgt_emb, cuBLAS)",
        "FFN and projection products (cuBLAS)",
        "vocab log-softmax, NLL and casts ([B, T, V] f32)", "other PyTorch ops"}
    assert "aten::sub_" in by_op["SGD update"]
    assert "aten::_log_softmax" in by_op["vocab log-softmax, NLL and casts ([B, T, V] f32)"]
    assert "aten::_log_softmax_backward_data" in by_op[
        "vocab log-softmax, NLL and casts ([B, T, V] f32)"]
