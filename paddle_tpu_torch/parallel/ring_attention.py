"""Ring attention: exact attention over a sequence-sharded axis (counterpart
of ``paddle_tpu/parallel/ring_attention.py``).

Each rank keeps its chunk of Q and passes its K/V chunk (and the key mask)
one step around the ring of the axis's ranks, n steps in all, merging each
chunk's streaming-softmax partials (running max and denominator) into its
accumulator as flash attention does; memory a rank is O(S/n) and the
result is full attention.  The reference runs the n steps as a ``lax.scan``
with one ``ppermute`` of each array a step; here they are a Python loop
over ``collectives.ppermute_shift``, whose backward is the inverse shift,
so autograd runs the ring backwards.  The n-th shift of the reference's
scan hands each rank back its own chunk, which no step reads: the loop
leaves it out.  Without an axis (or at size one) it is plain attention on
eager ops, which is what ``use_flash=False`` runs.

The products take the model's dtype in and give f32 out (the reference's
``preferred_element_type=f32``): bf16 pairs on the card go to cuBLAS with an
f32 output, anything else runs in f32.  Masked scores are -1e30, a fully
masked row contributes nothing, and the denominator is floored at 1e-30,
as in the reference.
"""

import torch

from . import collectives as col

__all__ = ["ring_attention", "local_attention"]

_NEG = -1e30


def _bmm_raw(a, b):
    if a.is_cuda and a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class _BmmF32(torch.autograd.Function):
    """a @ b (batched) with f32 products and output; the gradients are f32
    products of the f32 cotangent with the other operand, rounded to the
    operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _bmm_raw(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
        gb = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return ga, gb


def local_attention(q, k, v, causal=False, q_offset=0, kv_offset=0,
                    kv_mask=None, scale=None):
    """Plain attention of local chunks, returning the unnormalised
    accumulators (o [B, Sq, H, D] f32, running max m [B, H, Sq], denominator
    l [B, H, Sq]) for streaming combination.  q, k, v: [B, S, H, D];
    the offsets give global positions for the causal mask when the chunks
    come from a rotated ring; ``kv_mask`` [B, Sk] marks the valid keys."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qs = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    s = _BmmF32.apply(qs.permute(0, 2, 1, 3).reshape(B * H, Sq, D),
                      k.permute(0, 2, 3, 1).reshape(B * H, D, Sk))
    s = s.reshape(B, H, Sq, Sk)
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
        kpos = kv_offset + torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, _NEG)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :].bool(), s, _NEG)
    m = s.amax(dim=-1)                                       # [B, H, Sq]
    p = torch.exp(s - m[..., None])
    # rows that are fully masked (m == -1e30) must contribute nothing
    p = torch.where((m == _NEG)[..., None], 0.0, p)
    l = p.sum(dim=-1)                                        # [B, H, Sq]
    # the probabilities cast down to the value dtype for the second product
    o = _BmmF32.apply(p.to(v.dtype).reshape(B * H, Sq, Sk),
                      v.permute(0, 2, 1, 3).reshape(B * H, Sk, D))
    return o.reshape(B, H, Sq, D).permute(0, 2, 1, 3), m, l


def _normalize(o, l, dtype):
    """Divide the unnormalised accumulator by the softmax denominator."""
    return (o / l.clamp_min(1e-30).transpose(1, 2)[..., None]).to(dtype)


def _combine(o1, m1, l1, o2, m2, l2):
    """Merge two streaming-softmax partials (flash-attention rescale)."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    l = l1 * a1 + l2 * a2
    o = o1 * a1.transpose(1, 2)[..., None] + o2 * a2.transpose(1, 2)[..., None]
    return o, m, l


def ring_attention(q, k, v, axis=None, causal=False, kv_mask=None, scale=None):
    """Exact attention with K/V sharded over ``axis`` (the sequence dim).

    q, k, v: [B, S_local, H, D] chunks of this rank (sequence sharded);
    kv_mask: optional [B, S_local] validity mask travelling with K/V.
    Returns [B, S_local, H, D], the attention output of the local Q chunk.
    """
    n = col.axis_size_in(axis)
    if n == 1:
        o, _, l = local_attention(q, k, v, causal=causal, kv_mask=kv_mask,
                                  scale=scale)
        return _normalize(o, l, q.dtype)
    idx = col.axis_index(axis)
    S_local = q.shape[1]
    # the reference starts from (0, -inf, 0); merging the first chunk into
    # that gives the chunk's own partials, bit for bit
    kc, vc, maskc = k, v, kv_mask
    acc = None
    for t in range(n):
        # after t forward shifts this rank holds the chunk born on rank
        # (idx - t) mod n
        part = local_attention(q, kc, vc, causal=causal,
                               q_offset=idx * S_local,
                               kv_offset=((idx - t) % n) * S_local,
                               kv_mask=maskc, scale=scale)
        acc = part if acc is None else _combine(*acc, *part)
        if t < n - 1:
            kc = col.ppermute_shift(kc, axis, 1)
            vc = col.ppermute_shift(vc, axis, 1)
            if maskc is not None:
                maskc = col.ppermute_shift(maskc.to(torch.uint8), axis, 1)
    o, _, l = acc
    return _normalize(o, l, q.dtype)
