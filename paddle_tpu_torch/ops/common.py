"""Shared helpers for op rules (counterpart of ``paddle_tpu/ops/common.py``)."""

import torch

from ..dtypes import convert_dtype


def x(ins, slot, i=0):
    """Fetch the i-th input of a slot; None if absent (optional inputs)."""
    vals = ins.get(slot)
    if not vals or i >= len(vals):
        return None
    return vals[i]


def out(**slots):
    return {k: v if isinstance(v, list) else [v] for k, v in slots.items()}


def op_generator(ctx, attrs):
    """A generator for one random op: the run's seed folded with the op's
    static seed attr (the reference ops' `seed` attribute), as the JAX
    package folds the op's seed into its per-run key.  Each random op draws
    from its own stream, whatever the other ops draw."""
    seed = (ctx.generator.initial_seed() * 1000003
            + int(attrs.get("seed", 0))) % (2 ** 63)
    return torch.Generator(ctx.device).manual_seed(seed)


def dtype_of(attrs, default="float32"):
    return convert_dtype(attrs.get("dtype", default))


def promote_float(v):
    """``v`` as a float: integer and bool tensors go to f32, as ``jnp.mean``,
    ``jax.nn.softmax`` and the other float-only JAX functions promote them
    with x64 off; a float tensor is returned as it is."""
    return v if v.is_floating_point() else v.float()


def saturating_cast(v, dtype):
    """``v.to(dtype)`` with XLA's conversion, as the JAX rules' ``astype``:
    a float going to an integer type maps NaN to 0 and saturates at the
    type's range (``Tensor.to`` wraps, or gives the least value, as C++'s
    conversion does); every other conversion is ``Tensor.to``'s."""
    if (not v.is_floating_point() or dtype.is_floating_point
            or dtype == torch.bool):
        return v.to(dtype)
    info = torch.iinfo(dtype)
    # max + 1 and min are powers of two: exact in every float type
    hi, lo = v >= info.max + 1.0, v < info.min
    r = torch.where(torch.isnan(v) | hi | lo, 0, v).to(dtype)
    return torch.where(hi, info.max, torch.where(lo, info.min, r))


def take_fill(v, idx):
    """Rows ``idx`` of ``v`` along axis 0 with ``jnp.take``'s default
    ("fill") semantics: a negative index counts from the end, and an index
    still outside [0, n) reads NaN (floats), the type's least value (signed
    integers), its largest (unsigned) or True (bool), and takes no
    gradient."""
    n = v.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    hit = (idx >= 0) & (idx < n)
    rows = v[idx.clamp(0, max(n - 1, 0))]
    if v.is_floating_point():
        fill = float("nan")
    elif v.dtype == torch.bool:
        fill = True
    elif v.dtype == torch.uint8:
        fill = torch.iinfo(v.dtype).max
    else:
        fill = torch.iinfo(v.dtype).min
    return torch.where(hit.reshape((-1,) + (1,) * (v.ndim - 1)), rows,
                       torch.full((), fill, dtype=v.dtype, device=v.device))


def take_steps(data, idx):
    """``data[n, idx[n, k]]`` for an [N, K] index, with
    ``jnp.take_along_axis``'s fill: a negative step counts from the end,
    and a step still outside [0, T) reads ``take_fill``'s fill (NaN for
    floats) and takes no gradient."""
    N, T = data.shape[:2]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + T, idx)
    flat = torch.arange(N, device=data.device)[:, None] * T + idx
    flat = torch.where((idx >= 0) & (idx < T), flat, N * T)   # past the end
    rows = take_fill(data.reshape((N * T,) + data.shape[2:]), flat.reshape(-1))
    return rows.reshape(tuple(idx.shape) + data.shape[2:])


def take_clamp(v, *idx):
    """``v[idx0, idx1, ...]`` as JAX gathers an integer-array index: a
    negative index counts from the end once, and one still outside its
    axis reads the nearest element but takes no gradient (XLA's gather
    clamps, and its transpose, a scatter-add, drops an update out of
    range).  On the card, an index out of range so never reaches a gather,
    and no device assert fires."""
    hit, clamped = None, []
    for axis, i in enumerate(idx):
        n = v.shape[axis]
        i = i.long()
        i = torch.where(i < 0, i + n, i)
        ok = (i >= 0) & (i < n)
        hit = ok if hit is None else hit & ok
        clamped.append(i.clamp(0, max(n - 1, 0)))
    r = v[tuple(clamped)]
    if not r.requires_grad:
        return r
    hit = hit.reshape(tuple(hit.shape) + (1,) * (r.ndim - hit.ndim))
    return torch.where(hit, r, r.detach())


def exact_matmul(a, b):
    """``torch.matmul`` for floats; for integer and bool operands the
    product as XLA computes it (torch's CUDA products refuse integers):
    int64 products summed, back to a's integer dtype (wrapping, as an int32
    accumulator does) or, for bool, whether any product is nonzero.  A 1-D
    side is a vector and leading dims broadcast, as in ``jnp.matmul``."""
    if a.is_floating_point() or b.is_floating_point():
        return torch.matmul(a, b)
    dt = a.dtype
    a, b = a.to(torch.int64), b.to(torch.int64)
    if b.ndim == 1:
        r = (a * b).sum(dim=-1)
    elif a.ndim == 1:
        r = (a.unsqueeze(-1) * b).sum(dim=-2)
    else:
        r = (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(dim=-2)
    return r != 0 if dt == torch.bool else r.to(dt)


def promoting_matmul(a, b):
    """``jnp.matmul``'s promotion: where one side is a float and the other
    an integer or bool, the other in the float's dtype; otherwise
    ``exact_matmul`` (two integer or two bool sides keep their kind)."""
    if a.is_floating_point() != b.is_floating_point():
        if a.is_floating_point():
            b = b.to(a.dtype)
        else:
            a = a.to(b.dtype)
    return exact_matmul(a, b)


def exact_conv(fn, v, w, **kw):
    """``fn(v, w, **kw)`` (a torch convolution) for floats; integer and
    bool inputs convolve in float64, exact while the sums stay below 2^53,
    and come back to v's dtype (bool: whether the sum is nonzero), as the
    JAX rules' integer convolutions give (torch's CUDA convolutions refuse
    integers)."""
    if v.is_floating_point():
        return fn(v, w, **kw)
    r = fn(v.double(), w.double(), **kw)
    return r != 0 if v.dtype == torch.bool else r.to(torch.int64).to(v.dtype)


_SIGNED = {torch.float64: torch.int64, torch.float32: torch.int32,
           torch.float16: torch.int16, torch.bfloat16: torch.int16}


def lax_top_k(v, k):
    """``lax.top_k`` along the last axis: the k largest in XLA's total
    order of floats (+0 above -0, NaN above +inf, -NaN below -inf), ties
    to the lower index; ``torch.topk`` promises no order among equals and
    a sort takes -0 and +0 as equal.  Returns (values, indices)."""
    key = v
    if v.is_floating_point():
        bits = v.view(_SIGNED[v.dtype])
        mask = torch.iinfo(bits.dtype).max
        key = torch.where(bits < 0, bits ^ mask, bits)
    elif v.dtype == torch.bool:
        key = v.to(torch.uint8)
    idx = torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(v, -1, idx), idx
