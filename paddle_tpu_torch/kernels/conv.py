"""conv2d with a CUDA weight-gradient kernel (counterpart of
``paddle_tpu/kernels/conv.py``).

``conv2d(x, w, stride, padding)`` takes NHWC ``x`` and HWIO ``w``, as the
JAX package does, and computes the same convolution (``lax.conv`` there,
``F.conv2d`` here, with XLA's "SAME" pads written out through ``F.pad``
where the two sides differ).  Its backward mirrors the reference's custom
VJP: where ``_eligible_pads`` allows (square k >= 2, stride 1,
pl + pr = k - 1 on both axes, C >= 32), ``dy`` is cast to ``x.dtype``, the
data gradient is the stride-1 convolution of ``dy`` with the flipped,
IO-swapped kernel and reversed pads (a library convolution, as XLA's is in
the reference), and the filter gradient

    dw[i, j, ci, co] = sum_{b,h,w} xp[b, h+i, w+j, ci] * dy[b, h, w, co]

comes from the CUDA kernel ``csrc/conv_wgrad.cu`` in f32, returned in
``w.dtype``: bf16 with C and K multiples of 8 on the tensor cores, f32 and
other widths on f32 FMAs (``_wgrad_route``).  Other convolutions take
autograd of the plain convolution.  No model calls this entry (as in the
reference).

On a CPU tensor ``conv_wgrad`` runs ``wgrad_plain`` below; on a CUDA
tensor it launches the kernel or raises.
"""

import torch
import torch.nn.functional as F

from . import _common

__all__ = ["conv2d", "conv_wgrad", "wgrad_plain"]

_TM = 48        # positions a split is rounded to (csrc/conv_wgrad.cu kMT)
_TILE = 64      # channels per tile on both sides (kTC, kTK)


def _cdiv(a, b):
    return -(-a // b)


def _pads(x, w, stride, padding):
    """((top, bottom), (left, right)) for "SAME", "VALID" or explicit
    per-axis (lo, hi) pairs."""
    if padding == "SAME":
        return (_common.same_pads(x.shape[1], w.shape[0], stride),
                _common.same_pads(x.shape[2], w.shape[1], stride))
    if padding == "VALID":
        return (0, 0), (0, 0)
    return padding


def _plain(x, w, stride, padding):
    """NHWC x HWIO -> NHWC, lax.conv_general_dilated's math."""
    (pt, pb), (pl_, pr_) = _pads(x, w, stride, padding)
    xt = x.permute(0, 3, 1, 2)
    if pt == pb and pl_ == pr_:
        pad = (pt, pl_)
    else:
        xt, pad = F.pad(xt, (pl_, pr_, pt, pb)), (0, 0)
    y = F.conv2d(xt, w.permute(3, 2, 0, 1), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def _eligible_pads(w, stride, padding):
    """Return (pl, pr) if the wgrad kernel applies, else None: square
    kernel, stride 1, same pads on both spatial dims with pl+pr == k-1,
    C >= 32 (the reference's rule, conv.py ``_eligible_pads``)."""
    kh, kw = w.shape[0], w.shape[1]
    if kh != kw or stride != 1 or kh < 2 or w.shape[2] < 32:
        return None
    if padding == "SAME":
        return ((kh - 1) // 2,) * 2 if kh % 2 == 1 and kh >= 3 else None
    if (isinstance(padding, tuple) and len(padding) == 2
            and padding[0] == padding[1]):
        pl_, pr_ = padding[0]
        if pl_ + pr_ == kh - 1:
            return (pl_, pr_)
    return None


def wgrad_plain(x, dy, k, pad):
    """The plain version: x padded by ``pad`` at the top and left (and
    k - 1 - pad at the bottom and right), then one f32 einsum over each of
    the k*k shifted views.  -> f32 [k, k, C, K]."""
    B, H, W, C = x.shape
    pr_ = k - 1 - pad
    xp = F.pad(x.float(), (0, 0, pad, pr_, pad, pr_))
    d = dy.float()
    return torch.stack([
        torch.stack([torch.einsum("bhwc,bhwk->ck",
                                  xp[:, i:i + H, j:j + W, :], d)
                     for j in range(k)])
        for i in range(k)])


def _wgrad_route(dtype, C, K):
    """The kernel a CUDA call takes: "mma" (tensor cores) for bf16 with C
    and K multiples of 8, the 16-byte copies' width; else "fma" (f32 FMAs:
    f32 on the tensor cores would be TF32, another result)."""
    if dtype == torch.bfloat16 and C % 8 == 0 and K % 8 == 0:
        return "mma"
    return "fma"


def _splits(tiles, M, slots):
    """Splits of the B*H*W contraction: as many as fill the card's ``slots``
    resident blocks in one wave (a block more would start a second wave),
    with at least 8 staging steps a block; 1 when the tiles alone fill it."""
    return max(1, min(slots // tiles, M // (8 * _TM), 65535))


def _slots(lib, device, route):
    """Blocks of the route's kernel the whole card holds at once."""
    n = lib.ptt_conv_wgrad_blocks_per_sm(_common.ROUTE_CODES[route])
    if n <= 0:
        raise RuntimeError("conv_wgrad: occupancy query failed (%d)" % n)
    return n * torch.cuda.get_device_properties(device).multi_processor_count


def _check(x, dy, k, pad):
    if x.dim() != 4 or dy.dim() != 4 or dy.shape[:3] != x.shape[:3]:
        raise ValueError("conv_wgrad: x must be [B, H, W, C] and dy "
                         "[B, H, W, K]; got %s and %s"
                         % (tuple(x.shape), tuple(dy.shape)))
    if x.device != dy.device or x.dtype != dy.dtype:
        raise ValueError("conv_wgrad: x and dy must share a device and dtype")
    if not 0 <= pad <= k - 1:
        raise ValueError("conv_wgrad: pad %d outside [0, k - 1 = %d]"
                         % (pad, k - 1))


def conv_wgrad(x, dy, k, pad):
    """Filter gradient of a stride-1 k x k NHWC convolution padded by
    ``pad`` at the top and left (k - 1 - pad at the bottom and right):
    f32 [k, k, C, K]."""
    _check(x, dy, k, pad)
    if x.device.type == "cpu":
        return wgrad_plain(x, dy, k, pad)
    if x.device.type != "cuda":
        raise ValueError("conv_wgrad: unsupported device %s" % x.device)
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("conv_wgrad: x and dy must be contiguous NHWC")
    code = _common.dtype_code(x.dtype, "conv_wgrad")
    B, H, W, C = x.shape
    K = dy.shape[3]
    route = _wgrad_route(x.dtype, C, K)
    if route == "mma" and (x.data_ptr() % 16 or dy.data_ptr() % 16):
        raise ValueError("conv_wgrad: the tensor-core kernel needs x and dy "
                         "on 16-byte boundaries")
    dw = torch.empty(k, k, C, K, device=x.device, dtype=torch.float32)
    M = B * H * W
    if M == 0 or C == 0 or K == 0:
        return dw.zero_()
    lib = _common.load_library()
    tiles = _cdiv(C, _TILE) * _cdiv(K, _TILE) * k * k
    splits = _splits(tiles, M, _slots(lib, x.device, route))
    per_split = _cdiv(_cdiv(M, splits), _TM) * _TM
    splits = _cdiv(M, per_split)
    partial = (torch.empty(splits, k, k, C, K, device=x.device,
                           dtype=torch.float32) if splits > 1 else dw)
    _common.check_status("conv_wgrad", lib.ptt_conv_wgrad(
        x.data_ptr(), dy.data_ptr(), partial.data_ptr(), dw.data_ptr(),
        B, H, W, C, K, k, pad, splits, per_split, code,
        _common.ROUTE_CODES[route],
        _common.stream_ptr(x.device)))
    _common.count_launch("conv_wgrad")
    return dw


class _Conv2d(torch.autograd.Function):
    """The reference's custom VJP: library forward and dgrad, kernel
    wgrad where eligible, autograd of the plain convolution elsewhere."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.cfg = (stride, padding)
        return _plain(x, w, stride, padding)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        stride, padding = ctx.cfg
        pads = _eligible_pads(w, stride, padding)
        if pads is None:
            with torch.enable_grad():
                xd, wd = x.detach().requires_grad_(), w.detach().requires_grad_()
                dx, dw = torch.autograd.grad(_plain(xd, wd, stride, padding),
                                             (xd, wd), dy)
            return dx, dw, None, None
        pl_, pr_ = pads
        dy = dy.to(x.dtype).contiguous()
        wr = torch.flip(w, (0, 1)).transpose(2, 3)
        dx = _plain(dy, wr, 1, ((pr_, pl_), (pr_, pl_)))
        dw = conv_wgrad(x.contiguous(), dy, w.shape[0], pl_)
        return dx, dw.to(w.dtype), None, None


def conv2d(x, w, stride=1, padding="SAME"):
    """NHWC x HWIO -> NHWC convolution (padding: "SAME"/"VALID" or a pair
    of per-axis (lo, hi) pairs); eligible stride-1 convolutions take the
    CUDA wgrad kernel in the backward."""
    if not isinstance(padding, str):
        padding = tuple(tuple(int(v) for v in p) for p in padding)
    return _Conv2d.apply(x, w, int(stride), padding)
