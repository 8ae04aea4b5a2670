"""The LAC lexical-analysis tagger (``tools/programs.py`` ``lac_program``:
PaddlePaddle models' ``PaddleNLP/lexical_analysis`` ``lex_net``: an
``is_sparse`` embedding at learning rate 5, two bidirectional
``dynamic_gru`` layers with L2Decay, an fc to the tag emissions,
``linear_chain_crf`` with the shared transition ``crfw`` at learning rate
0.2, Adam; ``crf_decoding`` and ``chunk_eval`` (IOB) in the program and
its test clone) built on the JAX package and on the port, run through
each package's ``Executor(CPUPlace())`` from the JAX startup's parameters
at a narrow width: vocabulary 50, embedding and GRUs of 8, 2 layers, 7
tags (3 chunk types), B = 3, T = 6.  Before this slice the port's
Executor refused the program (no rule for ``gru_unit``'s layers'
neighbour ``chunk_eval``).

Tolerances, f32, relative to the largest magnitude of the JAX value: the
loss at each of 2 steps to 1e-5 (``tests/test_torch_crnn_ctc.py``'s), and
the state after them as vectors, as ``chip_smoke.py`` holds the CRNN's:
the parameters, the first and the second Adam moments, each group to 1e-5
of its largest magnitude.  Not each parameter on its own: where a step's
gradient of an element is rounding noise (a cancellation, ~1e-9 here)
Adam's first update of it is lr g / (|g| + eps), as sensitive as the
noise (one fc bias element parts by 1.5e-4 lr).  The decoded tags and
``chunk_eval``'s three counts exactly, precision, recall and F1 to 1e-6.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.tools.programs import (LAC, LACConfig, lac_feed,
                                             lac_program, lac_train_flops)

TOL, STEPS = 1e-5, 2
CFG = LACConfig(batch=3, seq_len=6, vocab=50, emb=8, hidden=8, tags=7,
                len_min=2, len_max=6, lr=1e-3)
EVAL = ["decoded", "num_infer", "num_label", "num_correct", "precision",
        "recall", "f1"]


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max(initial=0.0)
    scale = max(np.abs(want).max(initial=0.0), 1e-30)
    assert err <= tol * scale, "%s: %.3g of %.3g" % (what, err, scale)


def _both(cfg):
    """Both packages' programs, the port's scope from the JAX startup."""
    jmain, jstart, jtest, jvars = lac_program(jfluid, cfg)
    pmain, _, ptest, pvars = lac_program(pfluid, cfg)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    names = sorted(v.name for v in jstart.list_vars() if v.persistable)
    pscope = convert.scope_from_numpy(convert.scope_to_numpy(jscope, names),
                                      pfluid.Scope(), "cpu")
    return ((jexe, jscope, jmain, jtest, jvars),
            (pfluid.Executor(pfluid.CPUPlace()), pscope, pmain, ptest, pvars),
            names)


def test_the_programs_match_op_for_op():
    jmain, _, jtest, _ = lac_program(jfluid, CFG)
    pmain, _, ptest, _ = lac_program(pfluid, CFG)
    for jp, pp in ((jmain, pmain), (jtest, ptest)):
        jb, pb = jp.global_block(), pp.global_block()
        assert [op.type for op in pb.ops] == [op.type for op in jb.ops]
        for jo, po in zip(jb.ops, pb.ops):
            assert (po.inputs, po.outputs, po.attrs.get("chunk_scheme")) == (
                jo.inputs, jo.outputs, jo.attrs.get("chunk_scheme"))
    types = {op.type for op in pmain.global_block().ops}
    assert {"lookup_table", "scan", "linear_chain_crf", "crf_decoding",
            "chunk_eval", "adam", "concat"} <= types
    params = pmain.global_block().all_parameters()
    by_name = {p.name: p for p in params}
    assert by_name["word_emb"].optimize_attr["learning_rate"] == 5.0
    assert by_name["crfw"].optimize_attr["learning_rate"] == 0.2
    # an fc (w, b) and a gru_unit layer (gates and candidate, w and b)
    # per direction
    assert len(params) == 1 + 2 * 2 * (2 + 4) + 2 + 1


def test_losses_parameters_and_chunk_counts_match_the_jax_package():
    (jexe, jscope, jmain, jtest, jv), (pexe, pscope, pmain, ptest, pv), names = \
        _both(CFG)
    for step in range(STEPS):
        feed = lac_feed(CFG, seed=step)
        jout = jexe.run(jmain, feed=feed, fetch_list=[jv[k] for k in
                                                      ["loss"] + EVAL],
                        scope=jscope)
        pout = pexe.run(pmain, feed=feed, fetch_list=[pv[k] for k in
                                                      ["loss"] + EVAL],
                        scope=pscope)
        _close(pout[0], jout[0], "loss at step %d" % step)
        for k, j, p in zip(EVAL, jout[1:], pout[1:]):
            if k in ("precision", "recall", "f1"):
                _close(p, j, "%s at step %d" % (k, step), tol=1e-6)
            else:
                np.testing.assert_array_equal(p, j, err_msg=k)
    params = sorted(p.name for p in pmain.global_block().all_parameters())
    groups = {"parameters": params,
              "moment1": [n for n in names if "_moment1" in n],
              "moment2": [n for n in names if "_moment2" in n]}
    assert len(groups["moment1"]) == len(groups["moment2"]) == len(params)
    for group, ns in groups.items():
        jvals = convert.scope_to_numpy(jscope, ns)
        pvals = convert.scope_to_numpy(pscope, ns)
        _close(np.concatenate([pvals[n].reshape(-1) for n in ns]),
               np.concatenate([jvals[n].reshape(-1) for n in ns]), group)
    feed = lac_feed(CFG, seed=STEPS)
    jout = jexe.run(jtest, feed=feed, fetch_list=[jv[k] for k in EVAL],
                    scope=jscope)
    pout = pexe.run(ptest, feed=feed, fetch_list=[pv[k] for k in EVAL],
                    scope=pscope)
    for k, j, p in zip(EVAL, jout, pout):
        if k in ("precision", "recall", "f1"):
            _close(p, j, k, tol=1e-6)
        else:
            np.testing.assert_array_equal(p, j, err_msg=k)
    assert int(pout[2]) > 0 and pout[0].shape == (CFG.batch, CFG.seq_len)


def test_the_loss_falls_on_one_batch():
    """Ten Adam steps on one batch through the port's Executor."""
    (_, _, _, _, _), (pexe, pscope, pmain, _, pv), _ = _both(
        CFG._replace(lr=0.05))
    feed = lac_feed(CFG, seed=0)
    losses = [float(pexe.run(pmain, feed=feed, fetch_list=[pv["loss"]],
                             scope=pscope)[0]) for _ in range(10)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_the_feed_holds_valid_iob_sequences():
    feed = lac_feed(LAC._replace(batch=40), seed=3)
    tags, n = feed["target"], feed["length"]
    o_tag = LAC.tags - 1
    assert tags.shape == (40, 64) and n.min() >= 8 and n.max() <= 64
    prev = np.full(40, o_tag)
    for t in range(64):
        inside = (tags[:, t] % 2 == 1) & (tags[:, t] != o_tag)
        # an I-k follows a B-k or an I-k of the same type
        ok = (prev != o_tag) & (prev // 2 == tags[:, t] // 2)
        assert (~inside | ok).all()
        prev = tags[:, t]
    past = np.arange(64)[None, :] >= n[:, None]
    assert (tags[past] == o_tag).all()
    assert (tags < o_tag).mean() > 0.3
    # the tags follow from the words: word w is of kind w mod 29, the
    # last kind O
    kind = np.where(tags == o_tag, 28, tags // 2)
    assert (kind[~past] == feed["word"][~past] % 29).all()


def test_the_tagger_learns_the_words_tags_on_one_batch():
    """Twenty Adam steps on one batch through the port's Executor: the
    test program's chunk F1 on that batch rises, with chunks inferred
    and matched."""
    cfg = CFG._replace(batch=8, seq_len=12, len_max=12, lr=0.05)
    (_, _, _, _, _), (pexe, pscope, pmain, ptest, pv), _ = _both(cfg)
    feed = lac_feed(cfg, seed=0)
    fetch = [pv[k] for k in ("f1", "num_infer", "num_correct")]
    f1_0 = float(pexe.run(ptest, feed=feed, fetch_list=fetch,
                          scope=pscope)[0])
    for _ in range(20):
        pexe.run(pmain, feed=feed, fetch_list=[pv["loss"]], scope=pscope)
    f1, n_infer, n_correct = pexe.run(ptest, feed=feed, fetch_list=fetch,
                                      scope=pscope)
    assert int(n_infer) > 0 and int(n_correct) > 0
    assert float(f1) > f1_0, (f1_0, float(f1))


def test_the_published_configuration():
    """Full width: the program builds in both packages with the same ops
    and shapes (not run here: that is the card's phase 46)."""
    shapes = {}
    for fluid in (jfluid, pfluid):
        main, _, _, v = lac_program(fluid, LAC)
        shapes[fluid.__name__] = (tuple(v["emission"].shape),
                                  tuple(main.global_block().var("word_emb").shape))
    assert shapes["paddle_tpu"] == shapes["paddle_tpu_torch"] == (
        (300, 64, 57), (20940, 128))
    assert 5.5e10 < lac_train_flops(LAC) < 6e10
