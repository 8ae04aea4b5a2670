"""Fused batch norm: CUDA statistics, apply, backward-reduce and dx kernels.

Counterpart of ``paddle_tpu/kernels/fused_bn.py`` (Pallas ``_stats_kernel``,
``_scale_shift_kernel``, ``_bwd_reduce_kernel`` and ``_dx_kernel``).  Inputs
of any rank with the channel axis last; statistics and normalisation run
over all leading axes, through the ``[M, C]`` view.  An NCHW activation in
``torch.channels_last`` memory, permuted to NHWC, has a contiguous view; a
tensor whose view is not contiguous raises, and is never copied.  The
kernels are in ``csrc/fused_bn.cu``.

The numerics are the reference's: f32 sums in one sweep, the one-pass
variance ``E[x^2] - m^2``, ``a`` and ``b`` rounded to ``x.dtype`` before the
apply in ``x.dtype``, ``dx`` in f32 from f32 coefficients then cast, and
``dgamma = (sum dy*x - m * sum dy) * r``.  The batch statistics that
``fused_bn_train`` returns are stop-gradient by contract: they are marked
non-differentiable.

The two reductions (statistics, backward reduce) are one CUDA launch a
call: the blocks' f32 partial sums are folded in the kernel in a fixed
order, so two calls give the same bits, through a workspace kept per device
and stream (``_WORK``).  On a CPU tensor the wrappers run the plain PyTorch
versions below; on a CUDA tensor they launch the kernel or raise.
"""

import functools
import math

import torch

from . import _common
from ..parallel import collectives as col
from ..parallel.mesh import AXES

__all__ = ["bn_stats", "fused_bn_train", "fused_scale_shift", "fused_bn_eval",
           "stats2", "scale_shift2", "bwd_reduce2", "dx2",
           "bn_stats_plain", "scale_shift_plain", "bwd_reduce_plain",
           "dx_plain"]

_THREADS = 256         # threads per block (csrc/fused_bn.cu kThreads)
_REDUCE_PER_SM = 4     # reduction blocks an SM (the kernels' launch bounds)
_APPLY_BLOCKS = 1056   # elementwise blocks at most: eight per SM, full occupancy
_MIN_ROWS = 8          # rows each reduction thread sweeps at least
_TILE_VECTORS = 8      # 16-byte vectors across a reduction's channel tile
_ONE_LEVEL = 64        # row blocks a tile folds in one level, at most
_WORK = {}             # (device index, stream) -> (scratch f32, counters int32)


# -- plain versions ([M, C] views) -------------------------------------------

def bn_stats_plain(x2):
    """Per-channel f32 sum and sum of squares."""
    xf = x2.float()
    return xf.sum(dim=0), (xf * xf).sum(dim=0)


def scale_shift_plain(x2, a, b):
    """``y = x*a + b`` in ``x.dtype`` (a, b [C] in ``x.dtype``)."""
    return x2 * a + b


def bwd_reduce_plain(dy2, x2):
    """Per-channel f32 sum of dy and of dy*x."""
    dyf = dy2.float()
    return dyf.sum(dim=0), (dyf * x2.float()).sum(dim=0)


def dx_plain(dy2, x2, coefs):
    """``dy*coefs[0] + x*coefs[1] + coefs[2]`` in f32, cast to ``x.dtype``."""
    return (dy2.float() * coefs[0] + x2.float() * coefs[1]
            + coefs[2]).to(x2.dtype)


# -- kernel wrappers ([M, C] views) ------------------------------------------

def _on_cpu(what, *ts):
    """True for CPU tensors; raises on a device the kernels do not run on."""
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError("%s: tensors on %s and %s" % (what, dev, t.device))
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError("%s: unsupported device %s" % (what, dev))
    return False


def _check(what, *views):
    """Raise on what the kernels do not take; returns the dtype code."""
    x2 = views[0]
    for t in views:
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(
                "%s: expects contiguous [M, C] views (a channels-last "
                "activation); got shape %s, strides %s"
                % (what, tuple(t.shape), t.stride()))
        if t.shape != x2.shape or t.dtype != x2.dtype:
            raise ValueError("%s: dy and x must match in shape and dtype"
                             % what)
    if x2.shape[0] == 0:
        raise ValueError("%s: no rows" % what)
    return _common.dtype_code(x2.dtype, what)


def _channel_param(what, t, C, dtype):
    if t.shape != (C,) or t.dtype != dtype or not t.is_contiguous():
        raise ValueError("%s: per-channel parameters must be contiguous [%d] "
                         "%s" % (what, C, dtype))


def _layout(x2, *others):
    """(tx, vec, tiles, ty) of a pass over ``x2 [M, C]``: a block is tx
    threads across the channels by ty down the rows, each thread owning one
    16-byte vector of channels where C and every address allow (vec = 1),
    else one channel; tiles is the number of channel tiles of tx vectors."""
    C = x2.shape[1]
    v = 16 // x2.element_size()
    vec = C % v == 0 and all(t.data_ptr() % 16 == 0 for t in (x2,) + others)
    nv = C // v if vec else C
    tx = min(nv, 32)
    return tx, int(vec), -(-nv // tx), _THREADS // tx


def _reduce_layout(x2, *others):
    """(tx, vec, tiles) of a reduction over ``x2 [M, C]``: tx threads across
    a channel tile (a power of two), each owning one 16-byte vector of
    channels where C and every address allow (vec = 1; tx at most
    _TILE_VECTORS), else one channel (tx at most 32); tiles is the number of
    channel tiles."""
    C = x2.shape[1]
    v = 16 // x2.element_size()
    vec = C % v == 0 and all(t.data_ptr() % 16 == 0 for t in (x2,) + others)
    nv = C // v if vec else C
    tx = min(_TILE_VECTORS if vec else 32, 1 << (nv - 1).bit_length())
    return tx, int(vec), -(-nv // tx)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _reduce_blocks(M, tiles, ty, sms):
    """(row blocks, rows per block) of a reduction: one wave of
    _REDUCE_PER_SM blocks an SM over row blocks and channel tiles together,
    each thread sweeping at least _MIN_ROWS rows."""
    nblk = max(1, min(_REDUCE_PER_SM * sms // tiles,
                      -(-M // (_MIN_ROWS * ty))))
    rows = -(-M // nblk)
    return -(-M // rows), rows


def _fold_group(nblk):
    """Row blocks a reduction folds together first: all of them (one level)
    up to _ONE_LEVEL, else about sqrt(nblk), so that the last block of a
    group and the last group each read about as many rows."""
    return nblk if nblk <= _ONE_LEVEL else math.isqrt(nblk - 1) + 1


def _workspace(device, stream, floats, counters):
    """The reductions' scratch (the f32 partial rows of the row blocks and
    of their groups, rewritten by every call) and counters (int32, zeroed
    when allocated; every launch leaves them at 0),
    for the calls on one stream of one device, which run one after another;
    a call on another stream gets its own.  Both grow, and never shrink."""
    key = (device.index, stream)
    work = _WORK.get(key)
    if work is None or work[0].numel() < floats or work[1].numel() < counters:
        floats = max(floats, work[0].numel() if work else 0)
        counters = max(counters, work[1].numel() if work else 0)
        work = _WORK[key] = (
            torch.empty(floats, device=device, dtype=torch.float32),
            torch.zeros(counters, device=device, dtype=torch.int32))
    return work


def _reduce(name, fn, a2, *rest):
    """One launch of a reduction kernel (``fn``, the C entry) over ``a2``
    (and ``rest``, the same shape): f32 [2, C] out, returned as two [C]
    views."""
    M, C = a2.shape
    code = _check(name, a2, *rest)
    tx, vec, tiles = _reduce_layout(a2, *rest)
    nblk, rows = _reduce_blocks(M, tiles, _THREADS // tx,
                                _sm_count(a2.device.index))
    stream = _common.stream_ptr(a2.device)
    group = _fold_group(nblk)
    ngroups = -(-nblk // group)
    scratch, counters = _workspace(a2.device, stream,
                                   2 * (nblk + ngroups) * C,
                                   tiles * (ngroups + 1))
    out = torch.empty(2, C, device=a2.device, dtype=torch.float32)
    _common.check_status(name, fn(
        *(t.data_ptr() for t in (a2,) + rest), scratch.data_ptr(),
        counters.data_ptr(), out.data_ptr(), M, C, tx, rows, nblk, group, vec,
        code, stream))
    _common.count_launch(name)
    return out[0], out[1]


def _apply_blocks(M, tiles, ty):
    return max(1, min(-(-M // ty), -(-_APPLY_BLOCKS // tiles)))


def stats2(x2):
    """Statistics kernel on ``x2 [M, C]``: f32 sum and sum of squares [C],
    one launch."""
    if _on_cpu("bn_stats", x2):
        return bn_stats_plain(x2)
    return _reduce("bn_stats", _common.load_library().ptt_bn_stats, x2)


def scale_shift2(x2, a, b):
    """Apply kernel: ``y = x*a + b`` in ``x.dtype``; a, b [C] in x.dtype."""
    if _on_cpu("bn_scale_shift", x2, a, b):
        return scale_shift_plain(x2, a, b)
    code = _check("bn_scale_shift", x2)
    M, C = x2.shape
    for t in (a, b):
        _channel_param("bn_scale_shift", t, C, x2.dtype)
    y = torch.empty_like(x2)
    tx, vec, tiles, ty = _layout(x2, a, b, y)
    lib = _common.load_library()
    _common.check_status("bn_scale_shift", lib.ptt_bn_scale_shift(
        x2.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(), M, C, tx,
        _apply_blocks(M, tiles, ty), vec, code, _common.stream_ptr(x2.device)))
    _common.count_launch("bn_scale_shift")
    return y


def bwd_reduce2(dy2, x2):
    """Backward-reduce kernel: f32 sum of dy and of dy*x [C], one sweep, one
    launch."""
    if _on_cpu("bn_bwd_reduce", dy2, x2):
        return bwd_reduce_plain(dy2, x2)
    return _reduce("bn_bwd_reduce", _common.load_library().ptt_bn_bwd_reduce,
                   dy2, x2)


def dx2(dy2, x2, coefs):
    """dx kernel: ``dy*coefs[0] + x*coefs[1] + coefs[2]`` (coefs f32 [3, C])
    in f32, cast to ``x.dtype``."""
    if _on_cpu("bn_dx", dy2, x2, coefs):
        return dx_plain(dy2, x2, coefs)
    code = _check("bn_dx", x2, dy2)
    M, C = x2.shape
    if (coefs.shape != (3, C) or coefs.dtype != torch.float32
            or not coefs.is_contiguous()):
        raise ValueError("bn_dx: coefs must be contiguous f32 [3, %d]" % C)
    out = torch.empty_like(x2)
    tx, vec, tiles, ty = _layout(x2, dy2, out)
    lib = _common.load_library()
    _common.check_status("bn_dx", lib.ptt_bn_dx(
        dy2.data_ptr(), x2.data_ptr(), coefs.data_ptr(), out.data_ptr(), M, C,
        tx, _apply_blocks(M, tiles, ty), vec, code,
        _common.stream_ptr(x2.device)))
    _common.count_launch("bn_dx")
    return out


# -- public functions (channel axis last, any rank) --------------------------

def _rows(x, what):
    """The ``[M, C]`` view of a channel-last tensor; raises rather than copy."""
    if not x.is_contiguous():
        raise ValueError(
            "%s: needs a contiguous channel-last tensor (an NCHW activation "
            "in torch.channels_last memory, permuted to NHWC); got shape %s, "
            "strides %s" % (what, tuple(x.shape), x.stride()))
    return x.view(-1, x.shape[-1])


def bn_stats(x):
    """Per-channel ``(sum, sum_of_squares)`` over all leading axes of ``x``
    (channel last), in f32, in one sweep."""
    return stats2(_rows(x, "bn_stats"))


class _FusedBNTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, eps, sync_axis):
        x2 = _rows(x, "fused_bn_train")
        s, q = stats2(x2)
        n = float(x2.shape[0])
        m = s / n
        m2 = q / n
        if sync_axis is not None:
            # cross-replica statistics between the two kernels (sync-BN)
            m = col.pmean(m, sync_axis)
            m2 = col.pmean(m2, sync_axis)
        v = m2 - m * m
        r = torch.rsqrt(v + eps)
        a = scale * r
        b = bias - m * a
        y2 = scale_shift2(x2, a.to(x.dtype), b.to(x.dtype))
        ctx.save_for_backward(x, scale, m, r)
        ctx.sync_axis = sync_axis
        ctx.mark_non_differentiable(m, v)
        return y2.view(x.shape), m, v

    @staticmethod
    def backward(ctx, dy, _dm, _dv):
        # the statistics' cotangents are ignored: stop-gradient by contract
        x, scale, m, r = ctx.saved_tensors
        x2 = x.view(-1, x.shape[-1])
        dy2 = _rows(dy, "fused_bn_train backward")
        s1, s2x = bwd_reduce2(dy2, x2)
        # dgamma/dbeta fold out of the same sweep: sum dy*xhat = (sum dy*x -
        # m * sum dy) * r; they stay this rank's partial sums, for the
        # step's gradient psum
        dgamma = (s2x - m * s1) * r
        S1, S2x, n = s1, s2x, float(x2.shape[0])
        if ctx.sync_axis is not None:
            S1 = col.psum(s1, ctx.sync_axis)
            S2x = col.psum(s2x, ctx.sync_axis)
            n = n * col.axis_size_in(ctx.sync_axis)
        S2 = (S2x - m * S1) * r                 # the global sum dy*xhat
        g = scale * r
        B = -(g * r * S2) / n
        Cc = -B * m - g * S1 / n
        dx = dx2(dy2, x2, torch.stack([g, B, Cc]))
        return (dx.view(x.shape), dgamma.to(scale.dtype), s1.to(scale.dtype),
                None, None)


def fused_bn_train(x, scale, bias, eps=1e-5, sync_axis=None):
    """Training-mode batch norm: ``(y, batch_mean, batch_var)``, one
    statistics sweep and a fused backward.  ``scale``/``bias`` are f32
    ``[C]``; the statistics come back in f32 and are stop-gradient.
    ``sync_axis`` names the mesh axis for cross-replica statistics
    (sync-BN): the ``pmean`` of the mean and mean square rides between the
    statistics and scale-shift kernels, and the ``psum`` of the backward
    sums between the reduce and dx kernels (a no-op outside a mesh or at
    size 1).  ``dgamma``/``dbeta`` come back as this rank's partial sums,
    so the step's gradient psum treats them as the autodiff path's."""
    if sync_axis is not None and sync_axis not in AXES:
        raise ValueError("sync_axis=%r is not a mesh axis (one of %s)"
                         % (sync_axis, ", ".join(AXES)))
    return _FusedBNTrain.apply(x, scale, bias, float(eps), sync_axis)


class _FusedScaleShift(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, a, b):
        y2 = scale_shift2(_rows(x, "fused_scale_shift"), a.to(x.dtype),
                          b.to(x.dtype))
        ctx.save_for_backward(x, a)
        ctx.b_dtype = b.dtype
        return y2.view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x, a = ctx.saved_tensors
        dy2 = _rows(dy, "fused_scale_shift backward")
        s1, s2x = bwd_reduce2(dy2, x.view(-1, x.shape[-1]))
        dx = scale_shift2(dy2, a.to(dy.dtype),
                          torch.zeros_like(a, dtype=dy.dtype))
        return dx.view(x.shape), s2x.to(a.dtype), s1.to(ctx.b_dtype)


def fused_scale_shift(x, a, b):
    """``y = x*a + b`` with per-channel ``a``/``b`` (the folded BN apply),
    elementwise in ``x.dtype``.  Differentiable: ``da = sum dy*x`` and
    ``db = sum dy`` come out of the backward-reduce kernel's one sweep."""
    return _FusedScaleShift.apply(x, a, b)


def fused_bn_eval(x, scale, bias, mean, var, eps=1e-5):
    """Inference-mode batch norm through the fused apply: the folded a/b come
    from the running statistics (small per-channel ops, so gradients with
    respect to scale and bias flow through them)."""
    a = scale * torch.rsqrt(var + eps)
    b = bias - mean * a
    return fused_scale_shift(x, a, b)
