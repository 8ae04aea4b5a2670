"""The dygraph ResNet of PaddlePaddle models v1.6 ``dygraph/resnet/train.py``
(``tools/programs.py`` ``dygraph_resnet``: ``ConvBNLayer``s, bottleneck
blocks with their shortcuts, ``cross_entropy`` and ``mean`` through
``nn._lowering_apply``, Momentum over ``PiecewiseDecay``) built on the JAX
package's dygraph and on the port's, at a narrow width: the [1, 1, 1, 1]
layout, widths 8-64, 32 x 32 images, B = 4, the JAX net's parameters
carried across with ``state_dict`` / ``set_dict``.

Tolerances.  Three training steps in float64 in both packages (JAX under
``enable_x64``): the losses, and the parameters, the velocities and the
batch-norm statistics each as one vector, to 1e-9 of its largest
magnitude.  In f32 the first forward (the softmax output and the loss) to
1e-5.  The f32 trajectory after a step is not held to the JAX one: a ReLU
input that cancels to ~1e-6 takes opposite signs in the two packages'
f32 roundings, its gradient element flips, and every gradient below it
parts by ~1e-2 (a flip at the last stage's 4 x 4 map at 64 x 64, B = 8);
in float64 no input lies that close to zero.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu_torch.tools.programs import (
    DYGRAPH_RESNET50, DygraphResNetConfig, dygraph_resnet,
    dygraph_resnet_feed, dygraph_resnet_loss, dygraph_resnet_optimizer,
    dygraph_resnet_step, dygraph_resnet_train_flops)

CFG = DygraphResNetConfig(depth=(1, 1, 1, 1), base_width=8, classes=102,
                          batch=4, image=32)
STEPS = 3
TOL64, TOL32 = 1e-9, 1e-5


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vec_rel(got, want, names):
    g = np.concatenate([np.asarray(got[n], np.float64).ravel() for n in names])
    w = np.concatenate([np.asarray(want[n], np.float64).ravel() for n in names])
    return np.abs(g - w).max() / np.abs(w).max()


def _jax_run(feeds, dtype):
    """STEPS steps of the JAX net: (initial state, losses, state,
    velocities by parameter name)."""
    dy = jfluid.dygraph
    with dy.guard():
        net = dygraph_resnet(jfluid, CFG)
        first = net.state_dict()
        net.set_dict({k: v.astype(dtype) for k, v in first.items()})
        opt = dygraph_resnet_optimizer(jfluid)
        losses = []
        for img, lab in feeds:
            loss, _ = dygraph_resnet_step(jfluid, net, opt,
                                          dy.to_variable(img.astype(dtype)),
                                          dy.to_variable(lab))
            losses.append(float(loss.numpy()))
        vel = {n: np.asarray(opt._dy_acc[("velocity", id(p))])
               for n, p in net.named_parameters() if p.trainable}
        return first, losses, net.state_dict(), vel


def _port_run(state, feeds, dtype):
    dy = pfluid.dygraph
    with dy.guard(pfluid.CPUPlace()):
        net = dygraph_resnet(pfluid, CFG)
        net.set_dict(state)
        for p in net.parameters():
            p._value = p._value.to(dtype)
        opt = dygraph_resnet_optimizer(pfluid)
        losses = []
        for img, lab in feeds:
            loss, _ = dygraph_resnet_step(
                pfluid, net, opt, dy.to_variable(torch.from_numpy(img).to(dtype)),
                dy.to_variable(lab))
            losses.append(float(loss.numpy()))
        vel = {n: opt._dy_acc[("velocity", id(p))].numpy()
               for n, p in net.named_parameters() if p.trainable}
        return losses, net.state_dict(), vel


def test_narrow_resnet_three_steps_match_jax_in_float64():
    feeds = [dygraph_resnet_feed(CFG, k) for k in range(STEPS)]
    with jax.enable_x64(True):
        first, jl, jstate, jvel = _jax_run(feeds, np.float64)
    pl, pstate, pvel = _port_run(first, feeds, torch.float64)
    assert list(pstate) == list(jstate)
    np.testing.assert_allclose(pl, jl, rtol=TOL64)
    trainable = list(jvel)
    stats = [n for n in jstate if n not in jvel]
    assert len(trainable) == 3 * 17 + 2 and len(stats) == 2 * 17
    assert _vec_rel(pstate, jstate, trainable) <= TOL64
    assert _vec_rel(pvel, jvel, trainable) <= TOL64
    assert _vec_rel(pstate, jstate, stats) <= TOL64


def test_narrow_resnet_first_forward_matches_jax_in_float32():
    img, lab = dygraph_resnet_feed(CFG, 0)
    out = {}
    for fl in (jfluid, pfluid):
        dy = fl.dygraph
        guard = dy.guard() if fl is jfluid else dy.guard(pfluid.CPUPlace())
        with guard:
            net = dygraph_resnet(fl, CFG)
            if fl is jfluid:
                state = net.state_dict()
            else:
                net.set_dict(state)
            loss, prob = dygraph_resnet_loss(fl, net, dy.to_variable(img),
                                             dy.to_variable(lab))
            out[fl] = (float(loss.numpy()), prob.numpy())
    assert abs(out[pfluid][0] - out[jfluid][0]) <= TOL32 * abs(out[jfluid][0])
    err = np.abs(out[pfluid][1] - out[jfluid][1]).max()
    assert err <= TOL32 * np.abs(out[jfluid][1]).max()
    np.testing.assert_allclose(out[pfluid][1].sum(1), 1.0, rtol=1e-6)


def test_feed_labels_follow_from_the_images():
    cfg = CFG._replace(batch=64, image=64)
    img, lab = dygraph_resnet_feed(cfg, 3)
    assert img.shape == (64, 3, 64, 64) and img.dtype == np.float32
    assert lab.shape == (64, 1) and lab.dtype == np.int64
    cell = 64 // 8
    for b in range(64):
        blocks = img[b].reshape(3, 8, cell, 8, cell).mean(axis=(2, 4))
        ch, r, c = np.unravel_index(blocks.argmax(), blocks.shape)
        k = int(lab[b, 0])
        assert (ch, r * 8 + c) == (k % 3, k % 64)
    assert len({(k % 3, k % 64) for k in range(cfg.classes)}) == cfg.classes


def test_resnet50_layout_and_flops():
    """ResNet-50's layout (at a narrow base width): 53 convolutions, 53
    batch norms and the fc, 161 trainable parameters and 106 statistics,
    named alike in both packages; 4.09 GMAC an image at 224 x 224."""
    cfg = DYGRAPH_RESNET50._replace(base_width=4, classes=10)
    names = {}
    for fl in (jfluid, pfluid):
        dy = fl.dygraph
        with (dy.guard() if fl is jfluid else dy.guard(pfluid.CPUPlace())):
            net = dygraph_resnet(fl, cfg)
            names[fl] = [(n, p.trainable) for n, p in net.named_parameters()]
    assert names[pfluid] == names[jfluid]
    assert sum(t for _, t in names[pfluid]) == 161
    assert sum(not t for _, t in names[pfluid]) == 106
    macs = dygraph_resnet_train_flops(DYGRAPH_RESNET50) / (3 * 2 * 32)
    assert 4.05e9 < macs < 4.15e9


def test_traced_narrow_resnet_serves_the_eval_forward(tmp_path):
    """Three steps on one batch lower the loss; the traced eval forward
    equals the eager one within 1e-6, writes nothing to the layer, and its
    saved program gives its values bit for bit."""
    img, _ = dygraph_resnet_feed(CFG, 5)
    dy = pfluid.dygraph
    with dy.guard(pfluid.CPUPlace()):
        net = dygraph_resnet(pfluid, CFG)
        opt = dygraph_resnet_optimizer(pfluid)
        one = [dy.to_variable(a) for a in dygraph_resnet_feed(CFG, 0)]
        losses = [float(dygraph_resnet_step(pfluid, net, opt, *one)[0].numpy())
                  for _ in range(3)]
        assert losses[2] < losses[1] < losses[0]
        net.eval()
        x = dy.to_variable(img)
        eager = net(x).numpy()
        state = net.state_dict()
        _, traced = dy.TracedLayer.trace(net, [x])
        got = traced(x).numpy()
        traced.save_inference_model(str(tmp_path / "resnet"))
        for n, v in net.state_dict().items():
            np.testing.assert_array_equal(v, state[n])
    loaded = dy.TracedLayer.load(str(tmp_path / "resnet"), device="cpu")
    np.testing.assert_array_equal(loaded(img).numpy(), got)
    np.testing.assert_allclose(got, eager, rtol=0, atol=1e-6)
