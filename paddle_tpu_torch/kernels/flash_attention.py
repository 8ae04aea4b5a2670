"""Flash attention: CUDA forward and backward kernels under autograd ops.

Counterpart of ``paddle_tpu/kernels/flash_attention.py``.  Streaming-softmax
attention with scale ``1/sqrt(D)`` by default and optional causal masking:
``o = softmax(q k^T * scale) v`` per head, and the row log-sum-exp ``lse``
that the backward uses to recompute the probabilities.  The kernels are in
``csrc/flash_attention.cu``; they read each head's columns of the packed
``[B, S, H*D]`` tensors in place.

Numerics follow the reference kernel: f32 accumulation, ``p`` rounded to
``v.dtype`` before ``p.v``, ``ds`` rounded to ``q.dtype`` before ``ds.k`` and
``ds^T.q``, ``l`` clamped at 1e-30, causal masking with -1e30.  bf16 runs
on the tensor cores both ways, f32 on f32 FMAs (``_fwd_route``,
``_bwd_route``).  The backward sums dq inside the block that owns its rows,
with no atomics, so two calls give the same bits.

On a CPU tensor the wrappers run the plain PyTorch version below; on a CUDA
tensor they launch the kernel or raise.
"""

import torch

from . import _common

__all__ = ["flash_attention", "flash_attention_packed", "flash_fwd",
           "flash_bwd", "flash_fwd_plain", "flash_bwd_plain",
           "attention_reference", "NEG_INF"]

NEG_INF = -1e30


# -- plain versions ----------------------------------------------------------

def _heads(t, H):
    """[B, S, H*D] -> [B, H, S, D] as f32 (a view until the cast)."""
    B, S, E = t.shape
    return t.reshape(B, S, H, E // H).transpose(1, 2).float()


def _unheads(t, dtype):
    B, H, S, D = t.shape
    return t.transpose(1, 2).reshape(B, S, H * D).to(dtype)


def _scores(qh, kh, scale, causal):
    s = (qh @ kh.transpose(-1, -2)) * scale
    if causal:
        Sq, Sk = s.shape[-2:]
        future = (torch.arange(Sk, device=s.device)[None, :]
                  > torch.arange(Sq, device=s.device)[:, None])
        s = s.masked_fill(future, NEG_INF)
    return s


def flash_fwd_plain(q, k, v, n_heads, scale, causal):
    """Packed q [B, Sq, H*D], k/v [B, Sk, H*D]; returns o (q.dtype) and
    lse [B, H, Sq] f32."""
    qh, kh, vh = (_heads(t, n_heads) for t in (q, k, v))
    s = _scores(qh, kh, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = (p.to(v.dtype).float() @ vh) / l
    return _unheads(o, q.dtype), (m + torch.log(l))[..., 0]


def flash_bwd_plain(q, k, v, o, lse, do, n_heads, scale, causal):
    """Returns dq, dk, dv in the input dtype."""
    qh, kh, vh, oh, doh = (_heads(t, n_heads) for t in (q, k, v, o, do))
    p = torch.exp(_scores(qh, kh, scale, causal) - lse[..., None])
    delta = (doh * oh).sum(dim=-1, keepdim=True)
    dv = p.to(do.dtype).float().transpose(-1, -2) @ doh
    ds = (p * (doh @ vh.transpose(-1, -2) - delta) * scale).to(q.dtype).float()
    dq = ds @ kh
    dk = ds.transpose(-1, -2) @ qh
    return _unheads(dq, q.dtype), _unheads(dk, k.dtype), _unheads(dv, v.dtype)


def attention_reference(q, k, v, n_heads, causal=False, scale=None):
    """The plain formulation of ``flash_attention_packed`` (torch autograd)."""
    D = q.shape[-1] // n_heads
    scale = 1.0 / (D ** 0.5) if scale is None else scale
    qh, kh, vh = (_heads(t, n_heads) for t in (q, k, v))
    p = torch.softmax(_scores(qh, kh, scale, causal), dim=-1)
    return _unheads(p @ vh, q.dtype)


# -- kernel wrappers ---------------------------------------------------------

def _check_cuda(q, k, v, n_heads, what):
    for t in (q, k, v):
        if t.device != q.device or t.dtype != q.dtype or t.dim() != 3:
            raise ValueError("%s: q, k, v must be [B, S, H*D] tensors of one "
                             "dtype on one device" % what)
        if not t.is_contiguous():
            raise ValueError("%s: q, k, v must be contiguous" % what)
    B, Sq, E = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2] != E:
        raise ValueError("%s: k and v must be [B, Sk, H*D] like q" % what)
    if E % n_heads:
        raise ValueError("%s: width %d not divisible by %d heads"
                         % (what, E, n_heads))
    D = E // n_heads
    if D % 8 or D > 128:
        raise ValueError("%s: head dim %d unsupported (a multiple of 8, at "
                         "most 128)" % (what, D))
    return _common.dtype_code(q.dtype, what), B, Sq, k.shape[1], D


def _fwd_route(dtype):
    """The forward kernel a CUDA call takes: "mma" (tensor cores) for bf16,
    "fma" (f32 FMAs) for f32, where the tensor cores would compute in TF32."""
    return "mma" if dtype == torch.bfloat16 else "fma"


def _bwd_route(dtype):
    """The backward kernels a CUDA call takes, as ``_fwd_route``."""
    return "mma" if dtype == torch.bfloat16 else "fma"


def _check_mma(route, tensors, S, width, what):
    if route == "mma" and (any(t.data_ptr() % 16 for t in tensors)
                           or S * width >= 2 ** 31):
        raise ValueError("%s: the tensor-core kernels need their inputs on "
                         "16-byte boundaries and S * H * D < 2^31" % what)


def flash_fwd(q, k, v, n_heads, scale, causal):
    """Forward kernel on packed tensors: returns o and lse [B, H, Sq]."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, n_heads, scale, causal)
    if q.device.type != "cuda":
        raise ValueError("flash_fwd: unsupported device %s" % q.device)
    _, B, Sq, Sk, D = _check_cuda(q, k, v, n_heads, "flash_fwd")
    route = _fwd_route(q.dtype)
    _check_mma(route, (q, k, v), max(Sq, Sk), q.shape[2], "flash_fwd")
    lib = _common.load_library()
    o = torch.empty_like(q)
    lse = torch.empty(B, n_heads, Sq, device=q.device, dtype=torch.float32)
    _common.check_status("flash_fwd", lib.ptt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, n_heads, Sq, Sk, D, float(scale), int(causal),
        _common.ROUTE_CODES[route], _common.stream_ptr(q.device)))
    _common.count_launch("flash_attention_fwd")
    return o, lse


def flash_bwd(q, k, v, o, lse, do, n_heads, scale, causal):
    """Backward kernels (delta, dk/dv, dq): returns dq, dk, dv."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, n_heads, scale, causal)
    if q.device.type != "cuda":
        raise ValueError("flash_bwd: unsupported device %s" % q.device)
    code, B, Sq, Sk, D = _check_cuda(q, k, v, n_heads, "flash_bwd")
    do = do.contiguous()
    if o.shape != q.shape or do.shape != q.shape or do.dtype != q.dtype \
            or not o.is_contiguous():
        raise ValueError("flash_bwd: o and do must match q")
    if lse.shape != (B, n_heads, Sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError("flash_bwd: lse must be a contiguous f32 [B, H, Sq]")
    route = _bwd_route(q.dtype)
    _check_mma(route, (q, k, v, o, do), max(Sq, Sk), q.shape[2], "flash_bwd")
    lib = _common.load_library()
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _common.check_status("flash_bwd", lib.ptt_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, n_heads, Sq, Sk, D, float(scale),
        int(causal), code, _common.ROUTE_CODES[route],
        _common.stream_ptr(q.device)))
    _common.count_launch("flash_attention_bwd")
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Packed [B, S, H*D] attention: one forward, one backward."""

    @staticmethod
    def forward(ctx, q, k, v, n_heads, scale, causal):
        o, lse = flash_fwd(q, k, v, n_heads, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (n_heads, scale, causal)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, *ctx.cfg)
        return dq, dk, dv, None, None, None


def flash_attention_packed(q, k, v, n_heads, causal=False, scale=None):
    """q [B, Sq, H*D], k/v [B, Sk, H*D], exactly as the projections produce
    them; returns [B, Sq, H*D] ready for the output projection."""
    D = q.shape[-1] // n_heads
    scale = 1.0 / (D ** 0.5) if scale is None else scale
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), n_heads, float(scale),
                                 bool(causal))


def flash_attention(q, k, v, causal=False, scale=None):
    """q, k, v: [B, S, H, D] (model layout).  Returns [B, S, H, D].

    A contiguous [B, S, H, D] tensor has the packed layout's memory order, so
    this goes through the same kernels with no transpose."""
    B, S, H, D = q.shape
    Sk = k.shape[1]
    o = flash_attention_packed(q.reshape(B, S, H * D),
                               k.reshape(B, Sk, H * D),
                               v.reshape(B, Sk, H * D), H, causal, scale)
    return o.reshape(B, S, H, D)
