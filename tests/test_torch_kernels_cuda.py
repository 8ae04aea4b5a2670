"""The port's CUDA kernels on the card, against their plain PyTorch versions
(which tests/test_torch_layer_norm.py and test_torch_flash_attention.py
hold to the JAX package on the CPU).  Every test needs a card and skips
without one; this file imports neither JAX nor the JAX package, so it runs
where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances: f32 kernels against f32 plain versions at the reference tests'
own (LayerNorm forward 1e-5, gradients 2e-4; attention forward 2e-6/1e-5,
gradients 5e-5/1e-4; batch norm 1e-5 forward, 1e-4 gradients; segment sums
and the conv filter gradient 1e-5 / 1e-4 of the largest value, row ids
exactly); bf16 kernels against the plain versions on the same bf16 inputs
to 2e-2 (a few bf16 roundings of 2^-9).  The bf16 attention forward and
backward and the bf16 filter gradient at widths that are multiples of 8 run
on the tensor cores; their f32 sums (lse, dw) are held to the same 1e-5 as the
FMA kernels': bf16 products are exact in f32, so only the order of the f32
additions differs from the plain version's."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch._tree import tree_leaves
from paddle_tpu_torch.kernels import _common
from paddle_tpu_torch.kernels import conv as pconv
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import fused_bn as fbn
from paddle_tpu_torch.kernels import layer_norm as ln
from paddle_tpu_torch.kernels import segment_update as seg
from paddle_tpu_torch.tools.profile_step import cuda_kernels_per_call

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip.  Decided here, when the test runs, never
    while a module is imported: pytest-xdist workers must all collect the
    same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels have no "
                    "interpret mode)")
    return torch.device("cuda")

LN_TOL = {torch.float32: (1e-5, 2e-4), torch.bfloat16: (2e-2, 2e-2)}
FA_TOL = {torch.float32: (dict(atol=2e-6, rtol=1e-5), dict(atol=5e-5, rtol=1e-4)),
          torch.bfloat16: (dict(atol=2e-2, rtol=2e-2), dict(atol=2e-2, rtol=2e-2))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,E", [(1000, 768), (1, 96), (4097, 40)])
def test_layer_norm_kernels_match_plain(cuda_device, dtype, N, E):
    g = torch.Generator(device=cuda_device).manual_seed(N + E)
    x = (torch.randn(N, E, generator=g, device=cuda_device) * 2 + 1).to(dtype)
    s = torch.rand(E, generator=g, device=cuda_device) + 0.5
    b = torch.randn(E, generator=g, device=cuda_device)
    dy = torch.randn(N, E, generator=g, device=cuda_device).to(dtype)
    ftol, gtol = LN_TOL[dtype]
    y, mu, rstd = ln.layer_norm_fwd(x, s, b, 1e-6)
    ref = ln.layer_norm_fwd_plain(x, s, b, 1e-6)
    grads = ln.layer_norm_bwd(x, s, dy, mu, rstd)
    gref = ln.layer_norm_bwd_plain(x, s, dy, mu, rstd)
    torch.cuda.synchronize()
    for got, want, tol in zip((y, mu, rstd) + grads, ref + gref,
                              (ftol,) * 3 + (gtol,) * 3):
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _ln_case(dev, N, E, dtype, offset=0, seed=0):
    """x and dy [N, E] (``offset`` elements into their storage, which moves
    them off 16-byte alignment), scale, and the forward's mu and rstd."""
    g = torch.Generator(device=dev).manual_seed(seed + N + E)
    mk = lambda m, c: (torch.randn(N * E + offset, generator=g, device=dev)
                       * m + c).to(dtype)[offset:].view(N, E)
    x, dy = mk(2, 1), mk(1, 0)
    s = torch.rand(E, generator=g, device=dev) + 0.5
    _, mu, rstd = ln.layer_norm_fwd_plain(x, s, torch.zeros_like(s), 1e-6)
    return x, s, dy, mu, rstd


@pytest.mark.parametrize("N,E,dtype,offset,route", [
    (32768, 768, torch.bfloat16, 0, "vec16"),    # BERT-base's backward
    (5000, 1024, torch.bfloat16, 0, "vec16"),
    (3001, 768, torch.float32, 0, "vec16"),
    (3001, 100, torch.bfloat16, 0, "scalar"),    # E off the vector width
    (3001, 768, torch.bfloat16, 1, "scalar"),    # rows 2 bytes off 16
    (1, 768, torch.bfloat16, 0, "vec16"),
])
def test_layer_norm_bwd_routes_match_plain(cuda_device, N, E, dtype, offset,
                                           route):
    x, s, dy, mu, rstd = _ln_case(cuda_device, N, E, dtype, offset)
    assert ln._bwd_route(x, s, dy) == route
    got = ln.layer_norm_bwd(x, s, dy, mu, rstd)
    want = ln.layer_norm_bwd_plain(x.float(), s, dy.float(), mu, rstd)
    torch.cuda.synchronize()
    assert _rel(got[0], want[0]) <= (2e-2 if dtype == torch.bfloat16 else 1e-5)
    assert _rel(got[1], want[1]) <= 1e-4 and _rel(got[2], want[2]) <= 1e-4


@pytest.mark.parametrize("N,E,offset", [(32768, 768, 0), (3001, 100, 0),
                                        (3001, 768, 1)])
def test_layer_norm_bwd_is_deterministic(cuda_device, N, E, offset):
    """Two calls, the same bits: the blocks' sums fold in a fixed order."""
    x, s, dy, mu, rstd = _ln_case(cuda_device, N, E, torch.bfloat16, offset)
    a = ln.layer_norm_bwd(x, s, dy, mu, rstd)
    b = ln.layer_norm_bwd(x, s, dy, mu, rstd)
    torch.cuda.synchronize()
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def _cuda_kernels_per_call(fn):
    return sum(n for n, _ in cuda_kernels_per_call(fn, calls=3).values())


def test_redesigned_wrappers_run_one_cuda_kernel_a_call(cuda_device):
    x, s, dy, mu, rstd = _ln_case(cuda_device, 32768, 768, torch.bfloat16)
    assert _cuda_kernels_per_call(
        lambda: ln.layer_norm_bwd(x, s, dy, mu, rstd)) == 1
    g = torch.Generator(device=cuda_device).manual_seed(3)
    ids = torch.randint(0, 1000000, (319488,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    keys, order = torch.sort(ids, stable=True)
    vals = torch.randn(319488, 11, generator=g, device=cuda_device)
    assert _cuda_kernels_per_call(
        lambda: seg._segsum_sorted(keys, order, vals, 1000000)) == 1
    # the batch-norm reductions at ResNet-50's largest and widest views
    for M, C in ((401408, 256), (6272, 2048)):
        x = torch.randn(M, C, generator=g, device=cuda_device).bfloat16()
        assert _cuda_kernels_per_call(lambda: fbn.stats2(x)) == 1
        assert _cuda_kernels_per_call(lambda: fbn.bwd_reduce2(x, x)) == 1


def test_fused_layer_norm_autograd_on_card(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(2, 128, 64, generator=g, device=cuda_device)
    s = torch.rand(64, generator=g, device=cuda_device) + 0.5
    b = torch.randn(64, generator=g, device=cuda_device)
    w = torch.randn(2, 128, 64, generator=g, device=cuda_device)
    ins = [t.clone().requires_grad_() for t in (x, s, b)]
    ref = [t.clone().requires_grad_() for t in (x, s, b)]
    (ln.fused_layer_norm(*ins) * w).sum().backward()
    (ln.layer_norm_reference(*ref) * w).sum().backward()
    for a, r in zip(ins, ref):
        torch.testing.assert_close(a.grad, r.grad, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,D,causal", [
    (2, 512, 512, 12, 64, False),    # the BERT-base head shape
    (2, 320, 320, 4, 64, True),      # a ragged last tile
    (1, 130, 70, 2, 128, True),      # Sq != Sk, D = 128
    (1, 64, 64, 4, 8, False),        # bert_tiny's D = 8 (columns zero-filled)
    # tensor-core tile edges: ragged q and kv tiles, D not a multiple of 16
    (2, 200, 333, 3, 64, False),
    (2, 333, 200, 3, 64, True),
    (1, 129, 129, 2, 40, True),
    (1, 64, 96, 2, 128, False),
    # Sq < Sk causal (kv tiles past the last q row: dk, dv are 0 there);
    # both lengths off the 64-row tile
    (2, 200, 333, 3, 64, True),
    (1, 70, 150, 2, 128, True),
])
def test_flash_kernels_match_plain(cuda_device, dtype, B, Sq, Sk, H, D, causal):
    g = torch.Generator(device=cuda_device).manual_seed(Sq + Sk + D)
    mk = lambda S: (torch.randn(B, S, H * D, generator=g, device=cuda_device)
                    * 0.5).to(dtype)
    q, k, v, do = mk(Sq), mk(Sk), mk(Sk), mk(Sq)
    scale = D ** -0.5
    ftol, gtol = FA_TOL[dtype]
    o, lse = fa.flash_fwd(q, k, v, H, scale, causal)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, H, scale, causal)
    grads = fa.flash_bwd(q, k, v, o, lse, do, H, scale, causal)
    grads_ref = fa.flash_bwd_plain(q, k, v, o, lse, do, H, scale, causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), o_ref.float(), **ftol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=1e-5)
    for a, r in zip(grads, grads_ref):
        torch.testing.assert_close(a.float(), r.float(), **gtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [-0.3, 0.0, 2.0])
def test_flash_forward_takes_any_scale(cuda_device, dtype, scale):
    """The softmax's max is taken over scaled scores, so a negative, zero or
    large scale gives the plain version's o and lse on both routes."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    q, k, v = [(torch.randn(2, 100, 2 * 64, generator=g, device=cuda_device)
                * 0.5).to(dtype) for _ in range(3)]
    o, lse = fa.flash_fwd(q, k, v, 2, scale, True)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, 2, scale, True)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), o_ref.float(), **FA_TOL[dtype][0])
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [-0.3, 0.0, 2.0])
def test_flash_backward_takes_any_scale(cuda_device, dtype, scale):
    """p = exp(s scale - lse) on both routes: a negative, zero or large
    scale gives the plain version's dq, dk and dv."""
    g = torch.Generator(device=cuda_device).manual_seed(12)
    q, k, v, do = [(torch.randn(2, 100, 2 * 64, generator=g, device=cuda_device)
                    * 0.5).to(dtype) for _ in range(4)]
    o, lse = fa.flash_fwd(q, k, v, 2, scale, True)
    grads = fa.flash_bwd(q, k, v, o, lse, do, 2, scale, True)
    grads_ref = fa.flash_bwd_plain(q, k, v, o, lse, do, 2, scale, True)
    torch.cuda.synchronize()
    for a, r in zip(grads, grads_ref):
        torch.testing.assert_close(a.float(), r.float(), **FA_TOL[dtype][1])


def test_flash_backward_is_deterministic(cuda_device):
    """dq is summed inside one block, with no atomics: two bf16 backward
    calls give bit-identical dq, dk and dv."""
    g = torch.Generator(device=cuda_device).manual_seed(13)
    q, k, v, do = [(torch.randn(4, 333, 4 * 64, generator=g, device=cuda_device)
                    * 0.5).bfloat16() for _ in range(4)]
    o, lse = fa.flash_fwd(q, k, v, 4, 0.125, False)
    first = fa.flash_bwd(q, k, v, o, lse, do, 4, 0.125, False)
    second = fa.flash_bwd(q, k, v, o, lse, do, 4, 0.125, False)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("entry", ["bshd", "packed"])
def test_flash_autograd_on_card(cuda_device, entry):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    B, S, H, D = 2, 256, 4, 64
    ins = [torch.randn(B, S, H, D, generator=g, device=cuda_device) * 0.5
           for _ in range(3)]
    w = torch.randn(B, S, H * D, generator=g, device=cuda_device)
    a = [t.clone().requires_grad_() for t in ins]
    r = [t.clone().requires_grad_() for t in ins]
    if entry == "bshd":
        o = fa.flash_attention(*a, causal=True).reshape(B, S, H * D)
    else:
        o = fa.flash_attention_packed(*(t.reshape(B, S, H * D) for t in a), H,
                                      causal=True)
    (o * w).sum().backward()
    (fa.attention_reference(*(t.reshape(B, S, H * D) for t in r), H,
                            causal=True) * w).sum().backward()
    for x, y in zip(a, r):
        torch.testing.assert_close(x.grad, y.grad, atol=5e-5, rtol=1e-4)


def test_each_wrapper_counts_one_launch(cuda_device):
    x = torch.randn(16, 32, device=cuda_device)
    s, b = torch.ones(32, device=cuda_device), torch.zeros(32, device=cuda_device)
    q = torch.randn(1, 64, 64, device=cuda_device)
    before = dict(_common.launches)
    y, mu, rstd = ln.layer_norm_fwd(x, s, b, 1e-6)
    ln.layer_norm_bwd(x, s, torch.ones_like(x), mu, rstd)
    o, lse = fa.flash_fwd(q, q, q, 2, 0.125, False)
    fa.flash_bwd(q, q, q, o, lse, torch.ones_like(q), 2, 0.125, False)
    fbn.stats2(x)
    fbn.scale_shift2(x, s, b)
    fbn.bwd_reduce2(x, x)
    fbn.dx2(x, x, torch.ones(3, 32, device=cuda_device))
    seg.dedup_segment_sum(torch.arange(16, device=cuda_device) % 5, x, 5)
    pconv.conv_wgrad(x.view(1, 4, 4, 32), x.view(1, 4, 4, 32), 3, 1)
    torch.cuda.synchronize()
    assert {k: _common.launches[k] - before[k] for k in before} == {
        "layer_norm_fwd": 1, "layer_norm_bwd": 1,
        "flash_attention_fwd": 1, "flash_attention_bwd": 1,
        "bn_stats": 1, "bn_scale_shift": 1, "bn_bwd_reduce": 1, "bn_dx": 1,
        "segment_sum": 1, "conv_wgrad": 1}


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    s, b = torch.ones(32, device=cuda_device), torch.zeros(32, device=cuda_device)
    with pytest.raises(TypeError):
        ln.layer_norm_fwd(torch.randn(8, 32, device=cuda_device).half(), s, b, 1e-6)
    with pytest.raises(ValueError):
        ln.layer_norm_fwd(torch.randn(32, 8, device=cuda_device).t(), s, b, 1e-6)
    q = torch.randn(1, 16, 200, device=cuda_device)
    with pytest.raises(ValueError):
        fa.flash_fwd(q, q, q, 2, 0.1, False)          # head dim 100
    q = torch.randn(1, 16, 64, device=cuda_device)
    with pytest.raises(ValueError):
        fa.flash_fwd(q, q, q.cpu(), 2, 0.1, False)
    # the tensor-core backward reads 16-byte chunks: a view 2 bytes in raises
    qb = torch.randn(16 * 64 + 1, device=cuda_device).bfloat16()[1:].view(1, 16, 64)
    lse = torch.zeros(1, 2, 16, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_bwd(qb, qb, qb, qb, lse, qb, 2, 0.1, False)


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,C", [
    (401408, 256),     # ResNet-50's largest bottleneck BN at B = 128
    (6272, 2048),      # its fewest rows and widest channels
    (1001, 64),        # a ragged row count
    (777, 12),         # C no 16-byte vector divides: one channel a thread
])
def test_bn_kernels_match_plain(cuda_device, dtype, M, C):
    """Each BN kernel against its plain version on the same inputs: f32
    outputs (the sums, and every f32 kernel) to 1e-5 of the largest value,
    bf16 outputs to 2e-2."""
    g = torch.Generator(device=cuda_device).manual_seed(M + C)
    mk = lambda: (torch.randn(M, C, generator=g, device=cuda_device) + 0.5).to(dtype)
    x, dy = mk(), mk()
    a = (torch.rand(C, generator=g, device=cuda_device) + 0.5).to(dtype)
    b = torch.randn(C, generator=g, device=cuda_device).to(dtype)
    coefs = torch.randn(3, C, generator=g, device=cuda_device)
    pairs = [(fbn.stats2(x), fbn.bn_stats_plain(x)),
             ((fbn.scale_shift2(x, a, b),), (fbn.scale_shift_plain(x, a, b),)),
             (fbn.bwd_reduce2(dy, x), fbn.bwd_reduce_plain(dy, x)),
             ((fbn.dx2(dy, x, coefs),), (fbn.dx_plain(dy, x, coefs),))]
    torch.cuda.synchronize()
    for got, want in pairs:
        for gt, wt in zip(got, want):
            assert gt.dtype == wt.dtype and gt.shape == wt.shape
            assert _rel(gt, wt) <= (2e-2 if gt.dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("M,C,dtype", [
    (6272, 2048, torch.bfloat16), (25088, 256, torch.bfloat16),
    (100003, 512, torch.float32), (777, 12, torch.bfloat16)])
def test_bn_reductions_are_deterministic_and_reset_their_counters(
        cuda_device, M, C, dtype):
    """Two calls of each one-launch reduction give the same bits (the last
    block of a tile folds the blocks' rows in a fixed order) and leave the
    workspace's tile counters at 0."""
    g = torch.Generator(device=cuda_device).manual_seed(M + C)
    x = torch.randn(M, C, generator=g, device=cuda_device).to(dtype)
    dy = torch.randn(M, C, generator=g, device=cuda_device).to(dtype)
    for fn in (lambda: fbn.stats2(x), lambda: fbn.bwd_reduce2(dy, x)):
        a = [t.clone() for t in fn()]
        b = fn()
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(a, b))
        counters = fbn._WORK[(x.device.index,
                              _common.stream_ptr(x.device))][1]
        assert not counters.any()


def test_bn_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    x = torch.randn(8, 32, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        fbn.stats2(torch.randn(32, 8, device=cuda_device).t())
    with pytest.raises(TypeError):
        fbn.stats2(x.half())
    with pytest.raises(ValueError):
        fbn.scale_shift2(x, torch.ones(32, device=cuda_device).bfloat16(),
                         torch.zeros(32, device=cuda_device))
    with pytest.raises(ValueError):
        fbn.bwd_reduce2(x, x.cpu())
    with pytest.raises(ValueError, match="channels_last"):
        fbn.fused_bn_train(torch.randn(2, 32, 3, 3, device=cuda_device).permute(0, 2, 3, 1),
                           torch.ones(32, device=cuda_device),
                           torch.zeros(32, device=cuda_device))


def test_fused_bn_autograd_on_card_matches_cpu(cuda_device):
    """fused_bn_train and fused_scale_shift through autograd (f32): the
    kernels on the card against the plain versions on the CPU."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(4, 9, 9, 40).astype("f4") + 1.0)
    s = torch.from_numpy(rng.rand(40).astype("f4") + 0.5)
    b = torch.from_numpy(rng.randn(40).astype("f4"))
    w = torch.from_numpy(rng.randn(4, 9, 9, 40).astype("f4"))
    outs = {}
    for dev in ("cpu", cuda_device):
        leaves = [t.to(dev).detach().requires_grad_() for t in (x, s, b)]
        y, m, v = fbn.fused_bn_train(*leaves)
        z = fbn.fused_scale_shift(y, leaves[1], leaves[2])
        (z * w.to(dev)).sum().backward()
        outs[str(dev)] = [t.detach().cpu() for t in (y, m, v)] + [
            t.grad.cpu() for t in leaves]
    for name, got, want in zip(("y", "mean", "var", "dx", "dscale", "dbias"),
                               outs[str(cuda_device)], outs["cpu"]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4, msg=name)


def test_resnet_activations_stay_channels_last(cuda_device):
    """Every activation of a block is channels-last, so the BN kernels'
    [M, C] views are views; a fused train step on the card then runs (a
    gradient that arrived in another layout would raise)."""
    from paddle_tpu_torch.models import resnet

    cfg = resnet.resnet_tiny_config(depth=50, fuse_bn=True, image_size=32)
    params, state = resnet.init_resnet_params(torch.Generator().manual_seed(0),
                                              cfg, cuda_device)
    cl = lambda t: t.is_contiguous(memory_format=torch.channels_last)
    # stage 1's first bottleneck: 1x1, 3x3 stride 2 (padded (0, 1)), 1x1,
    # and the stride-2 projection
    blk, sblk, upd = params["s1_b0"], state["s1_b0"], {}
    x = torch.rand(2, 8, 8, blk["conv1"].shape[2],
                   device=cuda_device).permute(0, 3, 1, 2)
    assert cl(x)
    y = x
    for conv, bn, stride in (("conv1", "bn1", 1), ("conv2", "bn2", 2),
                             ("conv3", "bn3", 1)):
        y = resnet._conv(y, blk[conv], stride)
        assert cl(y), conv
        y = resnet._bn(y, blk[bn], sblk[bn], cfg, True, upd, bn)
        assert cl(y), bn
    sc = resnet._bn(resnet._conv(x, blk["proj"], 2), blk["bnp"], sblk["bnp"],
                    cfg, True, upd, "bnp")
    assert cl(sc) and sc.shape == y.shape
    trainer = resnet.build_resnet_trainer(cfg, device=cuda_device)
    batch = {"image": torch.rand(4, 32, 32, 3, device=cuda_device),
             "label": torch.zeros(4, dtype=torch.int32, device=cuda_device)}
    before = _common.launches["bn_dx"]
    assert torch.isfinite(trainer.step(batch, 1e-2))
    assert _common.launches["bn_dx"] - before == 53


def test_resnet_tiny_steps_on_card_match_cpu(cuda_device):
    """Two momentum steps of the tiny ResNet (f32, fused) through the
    kernels on the card and through the plain versions on the CPU, from the
    same weights; TF32 off so both sides convolve in f32."""
    from paddle_tpu_torch.convert import params_to_numpy
    from paddle_tpu_torch.models import resnet

    cfg = resnet.resnet_tiny_config(fuse_bn=True, image_size=16)
    params, state = (params_to_numpy(t) for t in resnet.init_resnet_params(
        torch.Generator().manual_seed(0), cfg, "cpu"))
    batches = resnet.synthetic_batches(cfg, 2, 16, seed=1)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        on_card = resnet.build_resnet_trainer(cfg, device=cuda_device,
                                              params=params, bn_state=state)
        on_cpu = resnet.build_resnet_trainer(cfg, device="cpu", params=params,
                                             bn_state=state)
        before = _common.launches["bn_stats"]
        for bt in batches:
            tb = {k: torch.from_numpy(v) for k, v in bt.items()}
            lc = on_card.step({k: v.to(cuda_device) for k, v in tb.items()}, 1e-2)
            lp = on_cpu.step(tb, 1e-2)
            np.testing.assert_allclose(float(lc), float(lp), rtol=1e-5)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert _common.launches["bn_stats"] - before == 2 * 20
    for a, b in zip(tree_leaves(on_card.state["params"]),
                    tree_leaves(on_cpu.state["params"])):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=1e-5)


def test_resnet_trainer_refuses_sync_bn_and_dp(cuda_device):
    """dp, tp and pp above one need a world of that many ranks
    (chip_smoke.py phases 51 and 54 run two)."""
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.parallel.mesh import MeshSpec

    with pytest.raises(ValueError, match="needs 2 ranks"):
        resnet.build_resnet_trainer(resnet.resnet_tiny_config(sync_bn=True),
                                    MeshSpec(tp=2), device=cuda_device)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        resnet.build_resnet_trainer(resnet.resnet_tiny_config(),
                                    MeshSpec(dp=2), device=cuda_device)


def test_non_flash_attention_raises_on_card(cuda_device):
    """use_flash=False has no kernel of its own: since item 5-C it runs the
    reference's eager attention (``ring_attention`` at ``axis=None``) on
    the card instead of raising, launches no flash kernel, and its step's
    loss is the CPU's (f32, TF32 off)."""
    from paddle_tpu_torch.convert import params_to_numpy
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel.transformer import init_transformer_params

    cfg = bert.bert_tiny_config(use_flash=False)
    params = params_to_numpy(init_transformer_params(
        torch.Generator().manual_seed(0), cfg, device="cpu"))
    rng = np.random.RandomState(1)
    batch = {"ids": rng.randint(0, 128, (2, 32)).astype(np.int32),
             "labels": rng.randint(0, 128, (2, 32)).astype(np.int32),
             "mask": np.ones((2, 32), np.float32)}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        losses = []
        for device in (cuda_device, "cpu"):
            trainer = bert.build_bert_trainer(cfg, device=device, params=params)
            before = dict(_common.launches)
            losses.append(float(trainer.step(
                {k: torch.from_numpy(v).to(device) for k, v in batch.items()},
                1e-3)))
            if device == cuda_device:
                assert _common.launches["flash_attention_fwd"] == \
                    before["flash_attention_fwd"]
                assert _common.launches["layer_norm_fwd"] - \
                    before["layer_norm_fwd"] == 2 * cfg.n_layers
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


def test_bert_tiny_steps_on_card_match_cpu(cuda_device):
    """Two LAMB steps of bert_tiny (f32) through the kernels on the card
    and through the plain versions on the CPU, from the same weights."""
    from paddle_tpu_torch.convert import params_to_numpy
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel.transformer import init_transformer_params

    cfg = bert.bert_tiny_config()
    params = params_to_numpy(init_transformer_params(
        torch.Generator().manual_seed(0), cfg, device="cpu"))
    rng = np.random.RandomState(0)
    batches = [{"ids": torch.from_numpy(rng.randint(0, 128, (2, 32)).astype(np.int32)),
                "labels": torch.from_numpy(rng.randint(0, 128, (2, 32)).astype(np.int32)),
                "mask": torch.ones(2, 32)} for _ in range(2)]
    on_card = bert.build_bert_trainer(cfg, device=cuda_device, params=params)
    on_cpu = bert.build_bert_trainer(cfg, device="cpu", params=params)
    before = _common.launches["flash_attention_bwd"]
    for bt in batches:
        lc = on_card.step({k: v.to(cuda_device) for k, v in bt.items()}, 1e-3)
        lp = on_cpu.step(bt, 1e-3)
        np.testing.assert_allclose(float(lc), float(lp), rtol=1e-5)
    assert _common.launches["flash_attention_bwd"] - before == 2 * cfg.n_layers


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    (319488, 1000000, 11),   # the DeepFM step: B = 8192 x 39 fields, D + 1
    (50000, 100, 11),        # heavy duplicates: runs across many tiles
    (70000, 1, 11),          # one id repeated N times: one run, 274 tiles
    (3001, 20000, 40),       # few duplicates, D above one register chunk
    (257, 3, 1),             # a ragged last tile, D = 1
    (1, 10, 2),              # a single element
])
def test_segment_kernel_matches_plain(cuda_device, dtype, case):
    """Row ids exactly equal (both sort stably), values to 1e-5 (f32) or
    2e-2 (bf16) of the largest; ids out of range keep their id."""
    N, vocab, D = case
    g = torch.Generator(device=cuda_device).manual_seed(N + D)
    ids = torch.randint(0, vocab, (N,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    if N > 20:
        ids[torch.randperm(N, generator=g, device=cuda_device)[:20]] = (
            vocab + torch.arange(20, device=cuda_device, dtype=torch.int32))
    vals = torch.randn(N, D, generator=g, device=cuda_device).to(dtype)
    rows, out = seg.dedup_segment_sum(ids, vals, vocab)
    rows_p, out_p = seg.segsum_plain(ids, vals, vocab)
    torch.cuda.synchronize()
    assert rows.dtype == ids.dtype and out.dtype == dtype
    assert torch.equal(rows, rows_p)
    assert _rel(out, out_p) <= (2e-2 if dtype == torch.bfloat16 else 1e-5)


def _spanning_ids(dev, n, tile):
    """Sorted-unique ids with a run of 3.5 tiles that starts mid-tile and a
    run that ends at a tile edge, shuffled."""
    ids = torch.arange(n, device=dev, dtype=torch.int32) * 10
    ids[100:100 + 3 * tile + 128] = ids[100].item()
    ids[4 * tile - 24:4 * tile] = ids[4 * tile - 24].item()
    g = torch.Generator(device=dev).manual_seed(n)
    return ids[torch.randperm(n, generator=g, device=dev)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,D", [(5 * 256 + 77, 11), (5 * 256 + 77, 8),
                                 (70001, 16)])
def test_segment_kernel_runs_across_tiles(cuda_device, dtype, n, D):
    """Runs crossing several tile edges from mid-tile, a ragged last tile."""
    ids = _spanning_ids(cuda_device, n, seg._TILE)
    g = torch.Generator(device=cuda_device).manual_seed(D)
    vals = torch.randn(n, D, generator=g, device=cuda_device).to(dtype)
    rows, out = seg.dedup_segment_sum(ids, vals, 10 * n)
    rows_p, out_p = seg.segsum_plain(ids, vals, 10 * n)
    torch.cuda.synchronize()
    assert torch.equal(rows, rows_p)
    assert _rel(out, out_p) <= (2e-2 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [33, 256, 768])
def test_segment_kernel_wide_rows(cuda_device, dtype, D):
    """Rows wider than the kernel's 32-column tile go through it a chunk of
    columns at a time, runs across tiles included."""
    n = 5 * 256 + 77
    ids = _spanning_ids(cuda_device, n, seg._TILE)
    g = torch.Generator(device=cuda_device).manual_seed(D)
    vals = torch.randn(n, D, generator=g, device=cuda_device).to(dtype)
    rows, out = seg.dedup_segment_sum(ids, vals, 10 * n)
    rows_p, out_p = seg.segsum_plain(ids, vals, 10 * n)
    torch.cuda.synchronize()
    assert torch.equal(rows, rows_p)
    assert _rel(out, out_p) <= (2e-2 if dtype == torch.bfloat16 else 1e-5)


def test_reductions_on_two_streams_at_once(cuda_device):
    """Calls on two streams, issued in turns so that they overlap: each
    stream has its own scratch and counters, every result equals the same
    call's on the default stream, and every counter is back at 0."""
    g = torch.Generator(device=cuda_device).manual_seed(12)
    seg_in, ln_in = [], []
    for vocab in (100, 1):
        ids = torch.randint(0, vocab, (319488,), generator=g, device=cuda_device,
                            dtype=torch.int32)
        seg_in.append((ids, torch.randn(319488, 11, generator=g,
                                        device=cuda_device), vocab))
    for seed in (1, 2):
        ln_in.append(_ln_case(cuda_device, 32768, 768, torch.bfloat16, seed=seed))
    want_seg = [seg.dedup_segment_sum(*a) for a in seg_in]
    want_ln = [ln.layer_norm_bwd(*a) for a in ln_in]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    got = [[], []]
    for _ in range(4):
        for k, st in enumerate(streams):
            with torch.cuda.stream(st):
                got[k].append((seg.dedup_segment_sum(*seg_in[k]),
                               ln.layer_norm_bwd(*ln_in[k])))
    torch.cuda.synchronize()
    for k in range(2):
        for s_out, l_out in got[k]:
            assert all(torch.equal(u, v) for u, v in zip(s_out, want_seg[k]))
            assert all(torch.equal(u, v) for u, v in zip(l_out, want_ln[k]))
    for st in streams:
        assert (cuda_device.index or 0, st.cuda_stream) in ln._WORK
        assert (cuda_device.index or 0, st.cuda_stream) in seg._WORK
    assert not any(w[1].any() for w in (*ln._WORK.values(), *seg._WORK.values()))


@pytest.mark.parametrize("vocab", [1, 7, 3000000])
def test_segment_kernel_many_tiles(cuda_device, vocab):
    """2.2M ids: runs of up to 8,594 tiles.  The totals are held to float64
    sums on the CPU: the plain version, like ``index_add_``, adds a run's
    2.2M f32 values one by one and drifts by about 1e-4 of the largest
    total, more than the kernel's tree and chunk sums."""
    g = torch.Generator(device=cuda_device).manual_seed(vocab)
    ids = torch.randint(0, vocab, (2200000,), generator=g, device=cuda_device)
    vals = torch.randn(2200000, 3, generator=g, device=cuda_device)
    rows, out = seg.dedup_segment_sum(ids, vals, vocab)
    rows_p, _ = seg.segsum_plain(ids, vals, vocab)
    torch.cuda.synchronize()
    assert torch.equal(rows, rows_p)
    rows, out = rows.cpu(), out.cpu().double()
    first = rows != vocab
    want = torch.zeros(vocab, 3, dtype=torch.float64).index_add_(
        0, ids.cpu(), vals.cpu().double())
    assert not out[~first].any()
    assert _rel(out[first], want[rows[first]]) <= 1e-5


@pytest.mark.parametrize("vocab", [1000000, 100, 1])
def test_segment_kernel_is_deterministic(cuda_device, vocab):
    """Two calls, the same bits, whatever the run lengths."""
    g = torch.Generator(device=cuda_device).manual_seed(vocab)
    ids = torch.randint(0, vocab, (319488,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    vals = torch.randn(319488, 11, generator=g, device=cuda_device)
    a = seg.dedup_segment_sum(ids, vals, vocab)
    b = seg.dedup_segment_sum(ids, vals, vocab)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_segment_kernel_int64_ids_and_apply(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(7)
    ids = torch.randint(0, 300, (9000,), generator=g, device=cuda_device)
    vals = torch.randn(9000, 2, 3, generator=g, device=cuda_device)
    rows, out = seg.dedup_segment_sum(ids, vals, 300)
    rows_p, out_p = seg.segsum_plain(ids, vals, 300)
    assert rows.dtype == torch.int64 and out.shape == (9000, 2, 3)
    assert torch.equal(rows, rows_p) and _rel(out, out_p) <= 1e-5
    table = torch.randn(300, 6, generator=g, device=cuda_device)
    got = seg.apply_rows_update(table.clone(), ids, vals.view(9000, 6), -0.5)
    want = table.index_add(0, ids, -0.5 * vals.view(9000, 6))
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


def test_segment_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    ids = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        seg.dedup_segment_sum(ids, torch.randn(4, 8, device=cuda_device).t(), 4)
    with pytest.raises(TypeError):
        seg.dedup_segment_sum(ids, torch.randn(8, 4, device=cuda_device).half(), 4)
    with pytest.raises(ValueError):
        seg.dedup_segment_sum(ids.cpu(), torch.randn(8, 4, device=cuda_device), 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 8, 8, 32, 48, 3, 1),
    (2, 5, 7, 32, 32, 3, 1),
    (1, 9, 9, 32, 32, 5, 2),
    (2, 8, 8, 32, 32, 4, 2),
    (2, 8, 8, 32, 32, 4, 1),
    (4, 14, 14, 96, 80, 3, 1),     # ragged channel tiles
    (8, 28, 28, 64, 64, 3, 1),     # a split contraction with a fold
    # tensor-core tile edges: C, K not multiples of 64; B*H*W = 198 and 189,
    # not multiples of the 64 positions a step stages; k = 5, pad 2
    (2, 9, 11, 72, 136, 3, 1),
    (3, 7, 9, 136, 72, 5, 2),
    (2, 8, 8, 36, 40, 3, 1),       # C % 8 != 0: bf16 takes the FMA route
])
def test_conv_wgrad_kernel_matches_plain(cuda_device, dtype, shape):
    B, H, W, C, K, k, pad = shape
    g = torch.Generator(device=cuda_device).manual_seed(B * H + C + k)
    x = torch.randn(B, H, W, C, generator=g, device=cuda_device).to(dtype)
    dy = torch.randn(B, H, W, K, generator=g, device=cuda_device).to(dtype)
    dw = pconv.conv_wgrad(x, dy, k, pad)
    want = pconv.wgrad_plain(x, dy, k, pad)
    torch.cuda.synchronize()
    assert dw.dtype == torch.float32 and dw.shape == (k, k, C, K)
    assert _rel(dw, want) <= 1e-5


def test_conv2d_autograd_on_card_matches_cpu(cuda_device):
    """conv2d's backward (kernel wgrad, library dgrad) on the card against
    the plain versions on the CPU, f32 with TF32 off; one wgrad launch per
    eligible backward and none for a stride-2 conv."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 8, 8, 32).astype("f4"))
    w = torch.from_numpy((rng.randn(4, 4, 32, 24) * 0.1).astype("f4"))
    pad = ((2, 1), (2, 1))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        outs = {}
        for dev in ("cpu", cuda_device):
            xs, ws = (t.to(dev).requires_grad_() for t in (x, w))
            y = pconv.conv2d(xs, ws, 1, pad)
            before = _common.launches["conv_wgrad"]
            dx, dw = torch.autograd.grad(y, (xs, ws), torch.ones_like(y))
            outs[str(dev)] = [t.detach().cpu() for t in (y, dx, dw)]
            assert _common.launches["conv_wgrad"] - before == (
                0 if dev == "cpu" else 1)
        for got, want in zip(outs[str(cuda_device)], outs["cpu"]):
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        xs = x.to(cuda_device).requires_grad_()
        before = _common.launches["conv_wgrad"]
        pconv.conv2d(xs, w[:3, :3].to(cuda_device), 2).sum().backward()
        assert _common.launches["conv_wgrad"] == before
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.parametrize("variant", ["segment", "rows"])
def test_deepfm_tiny_steps_on_card_match_cpu(cuda_device, variant):
    """Three SGD steps of the tiny DeepFM (f32) on the card and on the CPU
    from the same weights; the segment kernel launches once a step on the
    card's ``segment`` variant and never on ``rows``."""
    from paddle_tpu_torch.convert import params_to_numpy
    from paddle_tpu_torch.models import deepfm

    cfg = deepfm.deepfm_tiny_config()
    params = params_to_numpy(deepfm.init_deepfm_params(
        torch.Generator().manual_seed(0), cfg, "cpu"))
    batch = {k: torch.from_numpy(v)
             for k, v in deepfm.synthetic_batch(cfg, 64, seed=3).items()}
    on_card = deepfm.build_deepfm_trainer(cfg, variant=variant,
                                          device=cuda_device, params=params)
    on_cpu = deepfm.build_deepfm_trainer(cfg, variant=variant, device="cpu",
                                         params=params)
    before = _common.launches["segment_sum"]
    for _ in range(3):
        lc = on_card.step({k: v.to(cuda_device) for k, v in batch.items()}, 1e-2)
        lp = on_cpu.step(batch, 1e-2)
        np.testing.assert_allclose(float(lc), float(lp), rtol=1e-5)
    assert _common.launches["segment_sum"] - before == (
        3 if variant == "segment" else 0)
    for a, b in zip(tree_leaves(on_card.state["params"]),
                    tree_leaves(on_cpu.state["params"])):
        torch.testing.assert_close(a.cpu(), b, atol=1e-6, rtol=1e-5)
