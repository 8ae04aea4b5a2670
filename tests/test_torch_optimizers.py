"""The port's optimizer, clip, decay, initializer and weight-norm classes
(the ones that run the op rules of ROADMAP Queue 1 item 3-A) against the
JAX package's, each training three executor steps of a small MLP on the
CPU.  Both packages build the same program under a fresh
``unique_name.guard()``; the parameters are initialised by the JAX startup
program and passed to the port as numpy; after each step the loss and
every persistable (parameters, moments, accumulators, LR state) are held to
JAX's at 1e-5 of the largest magnitude (f32; the frameworks sum in other
orders).  RMSProp and Adadelta at 1e-4 and 2e-4 (centered): they divide
each element's step by its own running gradient magnitude, so a bias
gradient that nearly cancels over the batch (its f32 sum differing by
~1e-7 between the two) moves its element by a relative 2e-5 to 9e-5.

``Dpsgd`` runs at sigma = 0: its noise is another stream than JAX's by
design (``tests/test_torch_op_rules_3a.py`` holds its distribution).
``TruncatedNormal`` is also run through the port's own startup, held by
its support.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu_torch import convert


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5
STEPS = 3


def _mlp(fluid, optimizer, param_attr=None):
    x = fluid.layers.data("x", shape=[6], dtype="float32")
    y = fluid.layers.data("y", shape=[1], dtype="float32")
    h = fluid.layers.fc(x, 8, act="tanh", param_attr=param_attr)
    pred = fluid.layers.fc(h, 1)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    optimizer.minimize(loss)
    return loss


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(initial=0.0), 1e-30)
    err = np.abs(got - want).max(initial=0.0)
    assert err <= tol * scale, "%s: %.3g of %.3g" % (what, err, scale)


def train_both(make_optimizer, param_attr=None, steps=STEPS, tol=TOL):
    """``make_optimizer(fluid)`` on both packages; returns the port's
    startup program (for tests that run it) after holding every step."""
    built = []
    for fluid in (jfluid, pfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            loss = _mlp(fluid, make_optimizer(fluid),
                        None if param_attr is None else param_attr(fluid))
        built.append((fluid, main, startup, loss.name))
    (jf, jmain, jstart, loss_name), (pf, pmain, pstart, _) = built
    jexe, jscope = jf.Executor(jf.CPUPlace()), jf.Scope()
    jexe.run(jstart, scope=jscope)
    persist = sorted({v.name for prog in (jstart, jmain)
                      for v in prog.list_vars() if v.persistable})
    persist = [n for n in persist if jscope.find_var(n) is not None]
    pscope = convert.scope_from_numpy(convert.scope_to_numpy(jscope, persist),
                                      pf.Scope(), "cpu")
    pexe = pf.Executor(pf.CPUPlace())
    rng = np.random.RandomState(0)
    for step in range(steps):
        xs = rng.randn(16, 6).astype(np.float32)
        ys = (xs[:, :1] * 0.7 - xs[:, 1:2] * 0.3).astype(np.float32)
        feed = {"x": xs, "y": ys}
        (jl,) = jexe.run(jmain, feed=feed, fetch_list=[loss_name], scope=jscope)
        (pl,) = pexe.run(pmain, feed=feed, fetch_list=[loss_name], scope=pscope)
        _close(pl, jl, "loss at step %d" % step, tol)
        want = convert.scope_to_numpy(jscope, persist)
        got = convert.scope_to_numpy(pscope, persist)
        for n in persist:
            _close(got[n], want[n], "%s after step %d" % (n, step), tol)
    return pstart


OPTIMIZERS = {
    "DGCMomentum": lambda f: f.optimizer.DGCMomentumOptimizer(
        0.1, 0.9, rampup_begin_step=1, rampup_step=2, sparsity=[0.5, 0.75]),
    "LarsMomentum": lambda f: f.optimizer.LarsMomentum(0.5, 0.9),
    "Adamax": lambda f: f.optimizer.Adamax(0.05),
    "Dpsgd": lambda f: f.optimizer.Dpsgd(0.1, clip=0.5, batch_size=16.0,
                                         sigma=0.0),
    "DecayedAdagrad": lambda f: f.optimizer.DecayedAdagrad(0.05),
    "Adadelta": lambda f: f.optimizer.Adadelta(1.0),
    "RMSProp": lambda f: f.optimizer.RMSProp(0.01, momentum=0.5),
    "RMSPropCentered": lambda f: f.optimizer.RMSProp(0.01, centered=True),
    "Ftrl": lambda f: f.optimizer.Ftrl(0.1, l1=0.01, l2=0.01),
    "Lamb": lambda f: f.optimizer.Lamb(0.05),
    "ClipByValue": lambda f: f.optimizer.SGD(
        0.5, grad_clip=f.clip.GradientClipByValue(0.05)),
    "ClipByNorm": lambda f: f.optimizer.SGD(
        0.5, grad_clip=f.clip.GradientClipByNorm(0.1)),
    "ClipByGlobalNorm": lambda f: f.optimizer.Momentum(
        0.5, 0.9, grad_clip=f.clip.GradientClipByGlobalNorm(0.1)),
    "L1Decay": lambda f: f.optimizer.Adam(
        0.05, regularization=f.regularizer.L1Decay(1e-2)),
    "Lookahead": lambda f: f.optimizer.LookaheadOptimizer(
        f.optimizer.Adam(0.05), alpha=0.5, k=2),
}


PER_ELEMENT_TOL = {"Adadelta": 1e-4, "RMSProp": 1e-4, "RMSPropCentered": 2e-4}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_three_executor_steps_match_jax(name):
    train_both(OPTIMIZERS[name], tol=PER_ELEMENT_TOL.get(name, TOL))


@pytest.mark.parametrize("dim", [None, 1])
def test_weight_norm_param_attr_trains_as_jax(dim):
    train_both(lambda f: f.optimizer.SGD(0.2),
               param_attr=lambda f: f.param_attr.WeightNormParamAttr(dim=dim))


def test_truncated_normal_initializer():
    """Three steps from JAX's startup values, then the port's own startup:
    the hidden layer's weights lie in [mean - 2 std, mean + 2 std]."""
    def attr(f):
        return f.ParamAttr(initializer=f.initializer.TruncatedNormal(0.2, 0.5))

    pstart = train_both(lambda f: f.optimizer.SGD(0.2), param_attr=attr)
    scope = pfluid.Scope()
    pfluid.Executor(pfluid.CPUPlace()).run(pstart, scope=scope)
    (op,) = [op for op in pstart.global_block().ops
             if op.type == "truncated_gaussian_random"]
    w = scope.find_tensor_as_numpy(op.output_arg_names[0])
    assert w.shape == (6, 8) and w.dtype == np.float32
    assert w.min() >= 0.2 - 1.0 - 1e-6 and w.max() <= 0.2 + 1.0 + 1e-6
    assert np.unique(w).size == w.size
