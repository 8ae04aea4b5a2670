"""The CRNN-CTC text recognizer (``tools/programs.py``
``crnn_ctc_program``: conv + batch_norm + relu groups with ceil-mode max
pools, ``im2sequence``, fcs into a forward and a reverse ``dynamic_gru``,
an fc to the classes and the blank, ``warpctc`` with ``norm_by_times``,
Momentum with L2Decay; its evaluation program: ``ctc_greedy_decoder``,
i.e. ``arg_max`` + ``ctc_align``, and ``edit_distance``) built on the JAX
package and on the port, run through each package's
``Executor(CPUPlace())`` from the JAX startup's parameters at a narrow
width: 16 x 64 images (T = 8 steps), channels 4 / 4 / 8 / 8, GRUs of 8,
9 classes, B = 3, labels of 1-3.  Before this slice the port's Executor
refused the program (no rule for ``im2sequence``, ``warpctc``,
``ctc_align`` or ``edit_distance``).

Tolerances, f32, relative to the largest magnitude of the JAX value:
the loss at each of 2 steps and every parameter and BN statistic after
them to 1e-5 (``tests/test_torch_fluid_encoder.py``'s); the evaluation's
decoded ids and lengths exactly, its distances to 1e-6.  Two kinds of
state are compared otherwise:
- a convolution's bias feeds a batch norm, which takes its mean out, so
  its gradient is exactly 0 and both sides keep it at rounding noise
  (under 1e-11 here): held, as the encoder's key bias, to 1e-5 lr a step;
- a deep BN's running mean is a cancellation: the published BN scales
  start at N(0, 0.01), so past the first groups the activations are the
  BN offsets' and a convolution of them averages to ~1e-9 from products
  ~1e-6 (a relative difference of 3e-7 in an offset shows as 1e-4 in
  the mean).  The running means are held together, to 1e-5 of the
  largest of them.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.tools.programs import (CRNN_CTC, CRNNConfig,
                                             crnn_ctc_program, crnn_feed,
                                             crnn_train_flops)

TOL, STEPS = 1e-5, 2
CFG = CRNNConfig(batch=3, height=16, width=64, classes=9, channels=(4, 4, 8, 8),
                 hidden=8, label_min=1, label_max=3, lr=0.05, momentum=0.9,
                 l2=4e-4)


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
    jmain, jstart, jtest, jvars = crnn_ctc_program(jfluid, cfg)
    pmain, _, ptest, pvars = crnn_ctc_program(pfluid, cfg)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    names = sorted(v.name for v in jstart.list_vars() if v.persistable)
    pscope = convert.scope_from_numpy(convert.scope_to_numpy(jscope, names),
                                      pfluid.Scope(), "cpu")
    return ((jexe, jscope, jmain, jtest, jvars),
            (pfluid.Executor(pfluid.CPUPlace()), pscope, pmain, ptest, pvars),
            names)


def test_the_programs_match_op_for_op():
    jmain, _, jtest, _ = crnn_ctc_program(jfluid, CFG)
    pmain, _, ptest, _ = crnn_ctc_program(pfluid, CFG)
    for jp, pp in ((jmain, pmain), (jtest, ptest)):
        jb, pb = jp.global_block(), pp.global_block()
        assert [op.type for op in pb.ops] == [op.type for op in jb.ops]
        for jo, po in zip(jb.ops, pb.ops):
            assert (po.inputs, po.outputs) == (jo.inputs, jo.outputs)
    types = {op.type for op in pmain.global_block().ops}
    assert {"im2sequence", "warpctc", "ctc_align", "edit_distance", "scan",
            "batch_norm", "pool2d", "momentum"} <= types


def test_losses_parameters_and_edit_distances_match_the_jax_package():
    (jexe, jscope, jmain, jtest, jv), (pexe, pscope, pmain, ptest, pv), names = \
        _both(CFG)
    for step in range(STEPS):
        feed = crnn_feed(CFG, seed=step)
        (jl,) = jexe.run(jmain, feed=feed, fetch_list=[jv["loss"]], scope=jscope)
        (pl,) = pexe.run(pmain, feed=feed, fetch_list=[pv["loss"]], scope=pscope)
        _close(pl, jl, "loss at step %d" % step)
    state = [n for n in names if "velocity" not in n and "learning_rate" not in n]
    assert len(state) == 8 * 6 + 3 * 2 + 1 + 2 * 4
    jvals = convert.scope_to_numpy(jscope, state)
    pvals = convert.scope_to_numpy(pscope, state)
    means = [n for n in state if n.endswith(".mean_0")]
    assert len(means) == 8
    mean_scale = max(np.abs(jvals[n]).max() for n in means)
    for n in state:
        if n.startswith("conv2d_") and ".b_" in n:
            assert max(np.abs(pvals[n]).max(), np.abs(jvals[n]).max()) <= (
                1e-5 * CFG.lr * STEPS), n
        elif n in means:
            err = np.abs(pvals[n].astype(np.float64) - jvals[n]).max()
            assert err <= TOL * mean_scale, n
        else:
            _close(pvals[n], jvals[n], n)
    feed = crnn_feed(CFG, seed=STEPS)
    fetch = ["decoded", "decoded_length", "distance"]
    jout = jexe.run(jtest, feed=feed, fetch_list=[jv[k] for k in fetch],
                    scope=jscope)
    pout = pexe.run(ptest, feed=feed, fetch_list=[pv[k] for k in fetch],
                    scope=pscope)
    np.testing.assert_array_equal(pout[0], jout[0])
    np.testing.assert_array_equal(pout[1], jout[1])
    _close(pout[2], jout[2], "edit distances", tol=1e-6)
    assert pout[2].shape == (CFG.batch, 1) and (pout[2] >= 0).all()


def test_the_loss_falls_on_one_batch():
    """Ten Momentum steps on one batch through the port's Executor."""
    (_, _, _, _, _), (pexe, pscope, pmain, _, pv), _ = _both(
        CFG._replace(lr=0.1))
    feed = crnn_feed(CFG, seed=0)
    losses = [float(pexe.run(pmain, feed=feed, fetch_list=[pv["loss"]],
                             scope=pscope)[0]) for _ in range(10)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_the_published_configuration():
    """Full width: 48 x 512 gray images give T = 64 steps of 128 x 6 = 768
    values, 96 logits a step; the program builds in both packages with the
    same ops (not run here: that is the card's phase 42)."""
    shapes = {}
    for fluid in (jfluid, pfluid):
        main, _, _, v = crnn_ctc_program(fluid, CRNN_CTC)
        blk = main.global_block()
        seq = [op for op in blk.ops if op.type == "reshape2"][0]
        shapes[fluid.__name__] = (tuple(blk.var(seq.outputs["Out"][0]).shape),
                                  tuple(v["logits"].shape))
    assert shapes["paddle_tpu"] == shapes["paddle_tpu_torch"] == (
        (32, 64, 768), (32, 64, 96))
    assert 5e10 < crnn_train_flops(CRNN_CTC) < 1e11
