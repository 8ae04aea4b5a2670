"""ResNet training (counterpart of ``paddle_tpu/models/resnet.py``, BASELINE
config 2: ResNet-50 / ImageNet image classification), on a mesh of
data-parallel ranks (``MeshSpec(dp=...)``; params replicated, the batch
split, gradients psum'd, ``sync_bn`` batch statistics reduced across ranks)
or one device.

The public layout is the JAX package's: images ``[B, H, W, 3]``, conv
weights HWIO in the parameter tree, BN parameters and running statistics
f32.  Inside, activations are NCHW tensors in ``torch.channels_last``
memory, which is NHWC in memory: the batch-norm kernels' ``[M, C]`` view of
an activation is then a view and not a copy.  Convolutions pad as XLA's
"SAME" does (asymmetric on a stride-2 conv over an even size) through an
explicit ``F.pad`` where the two sides differ.

With ``fuse_bn`` (the bench's setting) every training-mode BN runs the four
``kernels/fused_bn`` kernels (with ``sync_bn``, the statistics and the
backward sums reduced over dp between them); ``fuse_bn=False`` runs the
folded BN math in eager PyTorch, the JAX package's own XLA path, as the
A/B.  Convolutions,
max pool, ReLU, the residual add, the global mean and the ``fc`` product
are PyTorch calls, as the JAX package leaves them to XLA.

batch dict: ``image`` float [B, H, W, 3], ``label`` int32 [B].
"""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .._tree import tree_map
from ..convert import params_from_numpy
from ..kernels import fused_bn as fbn
from ..kernels._common import same_pads
from ..parallel import collectives as col
from ..parallel import optim
from ..parallel.mesh import DP, MeshSpec
from ..parallel.rules import PartitionSpec as P
from ..parallel.train import (TrainState, grads_of, shard_batch, shard_pytree,
                              state_specs)

__all__ = ["ResNetConfig", "resnet50_config", "resnet_tiny_config",
           "init_resnet_params", "resnet_forward", "make_loss_fn",
           "synthetic_batches", "ResNetTrainer", "build_resnet_trainer"]

_BN_EPS = 1e-5


@dataclasses.dataclass
class ResNetConfig:
    depth: int = 50
    num_classes: int = 1000
    width: int = 64
    dtype: str = "bfloat16"
    sync_bn: bool = False
    bn_momentum: float = 0.9
    image_size: int = 224
    # route training-mode batch norm through the fused_bn kernels
    fuse_bn: bool = False

    @property
    def blocks(self):
        return {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}[self.depth]

    @property
    def bottleneck(self):
        return self.depth >= 50

    @property
    def torch_dtype(self):
        return getattr(torch, self.dtype)


def resnet50_config(**kw):
    return ResNetConfig(**dict(dict(depth=50), **kw))


def resnet_tiny_config(**kw):
    d = dict(depth=18, num_classes=10, width=8, dtype="float32", image_size=32)
    d.update(kw)
    return ResNetConfig(**d)


# -- init ----------------------------------------------------------------------

def _conv_init(gen, kh, kw, cin, cout, dtype):
    std = (2.0 / (kh * kw * cin)) ** 0.5     # MSRA (initializer.py)
    return (torch.randn(kh, kw, cin, cout, generator=gen) * std).to(dtype)


def _bn_init(c):
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def _bn_state_init(c):
    return {"mean": torch.zeros(c), "var": torch.ones(c)}


def init_resnet_params(gen, cfg, device):
    """Returns (params, bn_state) trees on ``device``, with the JAX package's
    leaves, shapes and dtypes; ``gen`` is a CPU ``torch.Generator``."""
    dt = cfg.torch_dtype
    params, state = {}, {}
    params["conv0"] = _conv_init(gen, 7, 7, 3, cfg.width, dt)
    params["bn0"] = _bn_init(cfg.width)
    state["bn0"] = _bn_state_init(cfg.width)

    cin = cfg.width
    for si, nblocks in enumerate(cfg.blocks):
        cmid = cfg.width * (2 ** si)
        cout = cmid * (4 if cfg.bottleneck else 1)
        for bi in range(nblocks):
            name = "s%d_b%d" % (si, bi)
            stride = 2 if (bi == 0 and si > 0) else 1
            blk, sblk = {}, {}
            if cfg.bottleneck:
                blk["conv1"] = _conv_init(gen, 1, 1, cin, cmid, dt)
                blk["conv2"] = _conv_init(gen, 3, 3, cmid, cmid, dt)
                blk["conv3"] = _conv_init(gen, 1, 1, cmid, cout, dt)
                widths = (cmid, cmid, cout)
            else:
                blk["conv1"] = _conv_init(gen, 3, 3, cin, cmid, dt)
                blk["conv2"] = _conv_init(gen, 3, 3, cmid, cout, dt)
                widths = (cmid, cout)
            for j, c in enumerate(widths, 1):
                blk["bn%d" % j] = _bn_init(c)
                sblk["bn%d" % j] = _bn_state_init(c)
            if bi == 0 and (cin != cout or stride != 1):
                blk["proj"] = _conv_init(gen, 1, 1, cin, cout, dt)
                blk["bnp"] = _bn_init(cout)
                sblk["bnp"] = _bn_state_init(cout)
            params[name], state[name] = blk, sblk
            cin = cout

    params["fc_w"] = (torch.randn(cin, cfg.num_classes, generator=gen)
                      * (1.0 / cin ** 0.5)).to(dt)
    params["fc_b"] = torch.zeros(cfg.num_classes, dtype=dt)
    to = lambda t: t.to(device)
    return tree_map(to, params), tree_map(to, state)


# -- forward -------------------------------------------------------------------

def _pad_same(x, k, stride, value=0.0):
    """"SAME" padding of x for a k x k window: ``(x, (ph, pw))`` for the op
    to pad itself where each axis pads both sides alike, else ``(x padded
    with value, (0, 0))``."""
    ph = same_pads(x.shape[2], k, stride)
    pw = same_pads(x.shape[3], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


def _conv(x, w, stride=1):
    """x NCHW (channels-last memory), w HWIO; XLA "SAME" padding."""
    x, pad = _pad_same(x, w.shape[0], stride)
    # HWIO -> OIHW in channels-last memory (I innermost), so that the conv
    # keeps its output channels-last
    wt = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return F.conv2d(x, wt, stride=stride, padding=pad)


def _max_pool_3x3_s2(x):
    """reduce_window(-inf, max, 3x3, stride 2, "SAME")."""
    x, pad = _pad_same(x, 3, 2, value=float("-inf"))
    return F.max_pool2d(x, 3, 2, padding=pad)


def _bn_fused(x, p, s, cfg, train, updates, path):
    """cfg.fuse_bn: the same math as _bn through the fused_bn kernels, on
    the NHWC view of the channels-last activation."""
    xh = x.permute(0, 2, 3, 1)
    if train:
        y, m, v = fbn.fused_bn_train(xh, p["scale"], p["bias"], _BN_EPS,
                                     DP if cfg.sync_bn else None)
        mom = cfg.bn_momentum
        updates[path] = {"mean": mom * s["mean"] + (1 - mom) * m,
                         "var": mom * s["var"] + (1 - mom) * v}
    else:
        y = fbn.fused_bn_eval(xh, p["scale"], p["bias"], s["mean"], s["var"],
                              _BN_EPS)
    return y.permute(0, 3, 1, 2)


def _bn(x, p, s, cfg, train, updates, path):
    """Folded batch norm: y = x*a + b with per-channel a, b in x.dtype, f32
    statistics (one-pass variance; with ``sync_bn`` each pmean'd over dp);
    gradients flow through the batch statistics, the running-statistics
    update takes them stop-gradient."""
    if cfg.fuse_bn:
        return _bn_fused(x, p, s, cfg, train, updates, path)
    if train:
        m = x.mean(dim=(0, 2, 3), dtype=torch.float32)
        m2 = x.float().square().mean(dim=(0, 2, 3))
        if cfg.sync_bn:
            m = col.pmean(m, DP)
            m2 = col.pmean(m2, DP)
        v = m2 - m.square()
        mom = cfg.bn_momentum
        updates[path] = {"mean": mom * s["mean"] + (1 - mom) * m.detach(),
                         "var": mom * s["var"] + (1 - mom) * v.detach()}
    else:
        m, v = s["mean"], s["var"]
    a = p["scale"] * torch.rsqrt(v + _BN_EPS)
    b = p["bias"] - m * a
    return x * a.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]


def resnet_forward(params, bn_state, images, cfg, train=True):
    """images: [B, H, W, 3].  Returns (logits [B, classes] f32,
    new_bn_state); the new state replaces the old for the BNs that ran."""
    updates = {}
    # NHWC memory seen as NCHW: a channels-last tensor, no copy
    x = images.to(cfg.torch_dtype).permute(0, 3, 1, 2)
    x = _conv(x, params["conv0"], stride=2)
    x = _bn(x, params["bn0"], bn_state["bn0"], cfg, train, updates, "bn0")
    x = _max_pool_3x3_s2(F.relu(x))

    for si, nblocks in enumerate(cfg.blocks):
        for bi in range(nblocks):
            name = "s%d_b%d" % (si, bi)
            blk, sblk = params[name], bn_state[name]
            stride = 2 if (bi == 0 and si > 0) else 1
            bupd = {}
            shortcut = x
            if cfg.bottleneck:
                y = _conv(x, blk["conv1"], 1)
                y = F.relu(_bn(y, blk["bn1"], sblk["bn1"], cfg, train, bupd, "bn1"))
                y = _conv(y, blk["conv2"], stride)
                y = F.relu(_bn(y, blk["bn2"], sblk["bn2"], cfg, train, bupd, "bn2"))
                y = _conv(y, blk["conv3"], 1)
                y = _bn(y, blk["bn3"], sblk["bn3"], cfg, train, bupd, "bn3")
            else:
                y = _conv(x, blk["conv1"], stride)
                y = F.relu(_bn(y, blk["bn1"], sblk["bn1"], cfg, train, bupd, "bn1"))
                y = _conv(y, blk["conv2"], 1)
                y = _bn(y, blk["bn2"], sblk["bn2"], cfg, train, bupd, "bn2")
            if "proj" in blk:
                shortcut = _conv(x, blk["proj"], stride)
                shortcut = _bn(shortcut, blk["bnp"], sblk["bnp"], cfg, train,
                               bupd, "bnp")
            x = F.relu(y + shortcut)
            if bupd:
                updates[name] = {**{k: sblk[k] for k in sblk if k not in bupd},
                                 **bupd}

    x = x.float().mean(dim=(2, 3))                      # global average pool
    logits = x.to(cfg.torch_dtype) @ params["fc_w"] + params["fc_b"]
    new_state = {k: updates.get(k, bn_state[k]) for k in bn_state}
    return logits.float(), new_state


def make_loss_fn(cfg):
    """Per-rank loss_fn({'params': tree, '_bn': bn_state}, batch_local) ->
    (mean NLL over the dp-split global batch, new_bn_state), as the JAX
    package's: the NLL sum psum'd over dp, over the global count (a host
    number, as the reference's psum of the static count folds)."""

    def loss_fn(bundle, batch):
        logits, new_state = resnet_forward(bundle["params"], bundle["_bn"],
                                           batch["image"], cfg, train=True)
        logp = F.log_softmax(logits, dim=-1)
        labels = batch["label"].long()
        nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
        count = nll.shape[0] * col.axis_size_in(DP)
        return col.psum(nll.sum(), DP) / count, new_state

    return loss_fn


def synthetic_batches(cfg, n, batch, seed=0):
    """``n`` host batches as ``bench.py`` makes them: uniform [0, 1) f32
    images and uniform int32 labels, from one numpy stream."""
    rng = np.random.RandomState(seed)
    size = cfg.image_size
    out = []
    for _ in range(n):
        image = rng.rand(batch, size, size, 3).astype(np.float32)
        label = rng.randint(0, cfg.num_classes, (batch,)).astype(np.int32)
        out.append({"image": image, "label": label})
    return out


@dataclasses.dataclass
class ResNetTrainer:
    cfg: ResNetConfig
    mesh: object
    device: torch.device
    state: dict
    bn_state: dict
    step_fn: object

    def step(self, batch, lr):
        """One step over a global batch; each rank trains on its slice."""
        self.state, self.bn_state, loss = self.step_fn(self.state,
                                                       self.bn_state, batch, lr)
        return loss

    def run_steps(self, batches, lr):
        """N steps over batches with a leading [N] step axis (staged with
        parallel.train.stack_batches, already this rank's).  Returns losses
        [N]."""
        n = next(iter(batches.values())).shape[0]
        losses = []
        for i in range(n):
            self.state, self.bn_state, loss = self.step_fn.local(
                self.state, self.bn_state,
                {k: v[i] for k, v in batches.items()}, lr)
            losses.append(loss)
        return torch.stack(losses)


def _make_step(loss_fn, optimizer, mesh):
    """step(state, bn_state, batch, lr) -> (state, new_bn_state, loss) over
    a global batch (``step.local`` over this rank's slice): the forward,
    ``autograd.grad`` with the BN state as an auxiliary output, each
    gradient psum'd and each new BN statistic pmean'd over dp, and the
    optimizer's in-place update."""
    _, opt_update = optimizer
    bspecs = {"image": P(DP), "label": P(DP)}

    def local(state, bn_state, batch, lr):
        with mesh:
            (loss, new_bn), grads = grads_of(
                lambda p, b: loss_fn({"params": p, "_bn": bn_state}, b),
                state["params"], batch)
            with torch.no_grad():
                grads = tree_map(lambda g: col.psum(g, DP), grads)
                new_bn = tree_map(lambda a: col.pmean(a, DP), new_bn)
            new_params, new_opt = opt_update(grads, state["opt"],
                                             state["params"], lr)
        return {"params": new_params, "opt": new_opt}, new_bn, loss.detach()

    def step(state, bn_state, batch, lr):
        return local(state, bn_state, shard_batch(mesh, bspecs, batch), lr)

    step.local = local
    return step


def build_resnet_trainer(cfg, mesh_spec: MeshSpec = None, optimizer=None,
                         seed=0, device=None, params=None, bn_state=None):
    """DP trainer: the mesh of this rank's world (``mesh_spec``, one rank by
    default), params and BN state on ``device`` (``cuda`` unless named),
    replicated (rank 0's values on every rank), momentum (0.9) unless
    another optimizer is given, and the train step: the batch split over
    dp, gradients psum'd — the ParallelExecutor AllReduce mode
    (parallel_executor.cc:393).  ``params``/``bn_state``: trees to start
    from instead of a seeded init — torch tensors, or numpy arrays as
    ``jax.tree.map(np.asarray, tree)`` gives them from the JAX package."""
    mesh = (mesh_spec or MeshSpec(1, 1, 1)).build(device=device)
    device = mesh.device
    optimizer = optimizer or optim.momentum(0.9)
    if params is None or bn_state is None:
        fresh = init_resnet_params(torch.Generator().manual_seed(seed), cfg,
                                   device)
    params = fresh[0] if params is None else params_from_numpy(params, device)
    bn_state = (fresh[1] if bn_state is None
                else params_from_numpy(bn_state, device))
    state = TrainState.create(params, optimizer)
    pspecs = tree_map(lambda _: P(), params)
    state = shard_pytree(state, state_specs(pspecs, state), mesh)
    bn_state = shard_pytree(bn_state, tree_map(lambda _: P(), bn_state), mesh)
    return ResNetTrainer(cfg=cfg, mesh=mesh, device=device, state=state,
                         bn_state=bn_state,
                         step_fn=_make_step(make_loss_fn(cfg), optimizer, mesh))
