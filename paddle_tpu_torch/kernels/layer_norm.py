"""Fused LayerNorm: CUDA forward and backward kernels under one autograd op.

Counterpart of ``paddle_tpu/kernels/layer_norm.py`` (Pallas
``_fwd_kernel`` / ``_bwd_kernel``).  Per row of ``x[N, E]``: f32 mean, the
centred variance, ``rstd = rsqrt(var + eps)``, ``y = (x - mu) * rstd *
scale + bias`` in ``x.dtype``; the backward returns ``dx`` in ``x.dtype``
and f32 ``dscale``/``dbias``.  The kernels are in ``csrc/layer_norm.cu``.

The backward is one launch that also folds dscale and dbias across its
blocks, in a fixed order (two calls give the same bits); it takes 16-byte
vectors where the row allows (``_bwd_route``).  On a CPU tensor the wrappers
run the plain PyTorch version below; on a CUDA tensor they launch the kernel
or raise.  Any row count is accepted (the
TPU's ``_pick_bn`` tiling rule has no counterpart here).
"""

import math

import torch

from . import _common

__all__ = ["fused_layer_norm", "layer_norm_reference", "layer_norm_fwd",
           "layer_norm_bwd", "layer_norm_fwd_plain", "layer_norm_bwd_plain"]

_WARPS = 8            # rows per forward block; warps per backward block
_GROUP = 16           # backward blocks a first-level fold takes (kGroup)
_COUNTERS = 128       # backward done-counters a device keeps
_MAX_SMEM = 232448    # bytes of shared memory a block can use on Hopper
_WORK = {}            # (device index, stream) -> backward scratch, counters
_GRID = {}            # (device, dtype, route, E) -> backward blocks an SM


# -- plain versions ----------------------------------------------------------

def layer_norm_fwd_plain(x, scale, bias, eps):
    """x [N, E]; returns y (x.dtype), mu [N] f32, rstd [N] f32."""
    xf = x.float()
    mu = xf.mean(dim=1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=1, keepdim=True) + eps)
    y = (xc * rstd * scale + bias).to(x.dtype)
    return y, mu[:, 0], rstd[:, 0]


def layer_norm_bwd_plain(x, scale, dy, mu, rstd):
    """Returns dx (x.dtype), dscale [E] f32, dbias [E] f32."""
    xf, dyf = x.float(), dy.float()
    rs = rstd[:, None]
    xhat = (xf - mu[:, None]) * rs
    g = dyf * scale
    c1 = g.mean(dim=1, keepdim=True)
    c2 = (g * xhat).mean(dim=1, keepdim=True)
    dx = (rs * (g - c1 - xhat * c2)).to(x.dtype)
    return dx, (dyf * xhat).sum(dim=0), dyf.sum(dim=0)


def layer_norm_reference(x, scale, bias, eps=1e-6):
    """The plain formulation of ``fused_layer_norm`` (torch autograd)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale.float()
            + bias.float()).to(x.dtype)


# -- kernel wrappers ---------------------------------------------------------

def _check_cuda(what, x, *params):
    """Raise on what the kernels do not take; returns x's dtype code."""
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("%s: x must be a contiguous [N, E] tensor" % what)
    E = x.shape[1]
    if 2 * _WARPS * E * 4 > _MAX_SMEM:
        raise ValueError("%s: E=%d exceeds the backward kernel's shared "
                         "memory" % (what, E))
    for t in params:
        if (t.device != x.device or t.dtype != torch.float32
                or t.shape != (E,) or not t.is_contiguous()):
            raise ValueError("%s: scale/bias must be contiguous f32 [E] on "
                             "x's device" % what)
    return _common.dtype_code(x.dtype, what)


def layer_norm_fwd(x, scale, bias, eps):
    """Forward kernel on ``x [N, E]``: returns y, mu [N], rstd [N]."""
    if x.device.type == "cpu":
        return layer_norm_fwd_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError("layer_norm_fwd: unsupported device %s" % x.device)
    code = _check_cuda("layer_norm_fwd", x, scale, bias)
    lib = _common.load_library()
    N, E = x.shape
    y = torch.empty_like(x)
    mu = torch.empty(N, device=x.device, dtype=torch.float32)
    rstd = torch.empty(N, device=x.device, dtype=torch.float32)
    _common.check_status("layer_norm_fwd", lib.ptt_layer_norm_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        mu.data_ptr(), rstd.data_ptr(), N, E, float(eps), code,
        _common.stream_ptr(x.device)))
    _common.count_launch("layer_norm_fwd")
    return y, mu, rstd


def _bwd_route(x, scale, dy):
    """The backward kernel a call takes: ``"vec16"`` (16-byte loads and
    stores, sums in registers) where a row is 32 lanes' whole 16-byte
    vectors, at most 1024 columns, and x, dy and scale are 16-byte aligned;
    else ``"scalar"``."""
    E = x.shape[1]
    per = 32 * (16 // x.element_size())
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, scale, dy))
    return "vec16" if E % per == 0 and E <= 1024 and aligned else "scalar"


def _bwd_blocks(lib, x, code, route):
    """Backward blocks of the persistent grid: CUDA's occupancy query times
    the SMs, no more than one block for every 8 rows, and no more than the
    done-counters cover."""
    N, E = x.shape
    key = (x.device.index, code, route, E)
    if key not in _GRID:
        per_sm = lib.ptt_layer_norm_bwd_blocks_per_sm(E, code, int(route == "vec16"))
        if per_sm <= 0:
            raise RuntimeError("layer_norm_bwd: occupancy query failed (%d)"
                               % per_sm)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        _GRID[key] = per_sm * sms
    return max(1, min(math.ceil(N / _WARPS), _GRID[key],
                      _GROUP * (_COUNTERS - 1)))


def layer_norm_bwd(x, scale, dy, mu, rstd):
    """Backward kernel: returns dx (x.dtype), dscale [E] f32, dbias [E] f32.
    One CUDA launch, on the current stream."""
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(x, scale, dy, mu, rstd)
    if x.device.type != "cuda":
        raise ValueError("layer_norm_bwd: unsupported device %s" % x.device)
    code = _check_cuda("layer_norm_bwd", x, scale)
    N, E = x.shape
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError("layer_norm_bwd: dy must match x")
    for t in (mu, rstd):
        if t.shape != (N,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("layer_norm_bwd: mu/rstd must be contiguous f32 [N]")
    dy = dy.contiguous()
    lib = _common.load_library()
    route = _bwd_route(x, scale, dy)
    nblk = _bwd_blocks(lib, x, code, route)
    # the blocks' partial rows, then the groups' rows, [., 2E] each (every
    # call rewrites what it reads), and the done-counters (zeroed when
    # allocated; every launch leaves them at 0): reused by the calls on one
    # stream, which run one after another; another stream gets its own
    need = (nblk + -(-nblk // _GROUP)) * 2 * E
    stream = _common.stream_ptr(x.device)
    work = _WORK.get((x.device.index, stream))
    if work is None or work[0].numel() < need:
        work = _WORK[x.device.index, stream] = (
            torch.empty(need, device=x.device, dtype=torch.float32),
            torch.zeros(_COUNTERS, device=x.device, dtype=torch.int32))
    scratch, done = work
    dx = torch.empty_like(x)
    out = torch.empty(2, E, device=x.device, dtype=torch.float32)
    _common.check_status("layer_norm_bwd", lib.ptt_layer_norm_bwd(
        x.data_ptr(), scale.data_ptr(), dy.data_ptr(), mu.data_ptr(),
        rstd.data_ptr(), dx.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        done.data_ptr(), N, E, nblk, code, int(route == "vec16"), stream))
    _common.count_launch("layer_norm_bwd")
    return dx, out[0], out[1]


class _FusedLayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mu, rstd = layer_norm_fwd(x, scale, bias, eps)
        ctx.save_for_backward(x, scale, mu, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, mu, rstd = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd(x, scale, dy, mu, rstd)
        return dx, dscale, dbias, None


def fused_layer_norm(x, scale, bias, eps=1e-6):
    """x: [..., E]; scale/bias: [E] (any float dtype — stats and params run
    in f32, output in x.dtype).  Returns layer-normalized x."""
    shape = x.shape
    E = shape[-1]
    x2 = x.reshape(-1, E).contiguous()
    y = _FusedLayerNorm.apply(x2, scale.float().contiguous(),
                              bias.float().contiguous(), float(eps))
    return y.reshape(shape)
