"""Tensor creation op rules: fill_constant, gaussian_random and
uniform_random, the startup program's initializers (counterparts of the
rules in ``paddle_tpu/ops/tensor_ops.py``; the others wait).

Parity: operators/fill_constant_op.cc, gaussian_random_op.cc,
uniform_random_op.cc.  Random ops draw from ``torch`` generators seeded per
run and op (``common.op_generator``); they do not reproduce ``jax.random``
streams, only their distributions.
"""

import torch

from ..registry import register_op
from .common import out, op_generator, dtype_of


@register_op("fill_constant")
def _fill_constant(ins, attrs, ctx):
    shape = [int(s) for s in attrs["shape"]]
    return out(Out=torch.full(shape, attrs.get("value", 0.0),
                              dtype=dtype_of(attrs), device=ctx.device))


@register_op("gaussian_random")
def _gaussian_random(ins, attrs, ctx):
    shape = [int(s) for s in attrs["shape"]]
    v = torch.randn(shape, generator=op_generator(ctx, attrs),
                    dtype=dtype_of(attrs), device=ctx.device)
    return out(Out=attrs.get("mean", 0.0) + attrs.get("std", 1.0) * v)


@register_op("uniform_random")
def _uniform_random(ins, attrs, ctx):
    shape = [int(s) for s in attrs["shape"]]
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    u = torch.rand(shape, generator=op_generator(ctx, attrs),
                   dtype=dtype_of(attrs), device=ctx.device)
    return out(Out=lo + (hi - lo) * u)
