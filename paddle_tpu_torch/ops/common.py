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
