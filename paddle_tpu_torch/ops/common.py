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
