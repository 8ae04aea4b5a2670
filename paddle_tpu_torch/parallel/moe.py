"""Mixture-of-Experts FFN with expert parallelism (counterpart of
``paddle_tpu/parallel/moe.py``).

Experts are split over a mesh axis (dp by default: expert parallelism
rides the data-parallel ranks); each token is routed top-1 (switch style)
under a capacity limit, exchanged with ``all_to_all`` over the axis,
processed by this rank's experts, sent back and weighted by its gate.  As
in the reference: the capacity is ``int(max(1, round(T * cf / nE)))`` with
Python's ``round``, a token's place in its expert's queue comes from a
cumulative sum of one-hots, tokens past the capacity are dropped (their
output is zero), ties in the routing go to the first expert, and the
experts' GELU is the tanh form.
"""

import math

import torch
import torch.nn.functional as F

from . import collectives as col
from .mesh import DP
from ..kernels._common import resolve_device

__all__ = ["init_moe_params", "moe_param_specs", "moe_ffn"]


def init_moe_params(generator, n_experts, hidden, ffn_hidden,
                    dtype=torch.float32, device=None):
    """The reference's tree: the f32 router [hidden, nE], the experts' w1
    [nE, hidden, ffn] and w2 [nE, ffn, hidden] in ``dtype`` (values from a
    torch.Generator: the streams differ from jax.random)."""
    s1, s2 = 1.0 / math.sqrt(hidden), 1.0 / math.sqrt(ffn_hidden)

    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    params = {"router": normal((hidden, n_experts), s1),
              "w1": normal((n_experts, hidden, ffn_hidden), s1).to(dtype),
              "w2": normal((n_experts, ffn_hidden, hidden), s2).to(dtype)}
    device = resolve_device(device)
    return {k: v.to(device) for k, v in params.items()}


def moe_param_specs(ep_axis=DP):
    """Derived from the rule tree (``rules.moe_rules``): the experts split
    over ``ep_axis``, the router replicated."""
    from . import rules as shard_rules

    leaf = shard_rules.SkeletonLeaf
    return shard_rules.match_partition_rules(
        shard_rules.moe_rules(ep_axis),
        {"router": leaf(), "w1": leaf(), "w2": leaf()})


def moe_ffn(params, x, ep_axis=DP, capacity_factor=1.25):
    """Switch-routed expert FFN.  x: [tokens_local, E] (the batch and
    sequence flattened).  This rank holds ``params["w1"].shape[0]`` experts
    of ``ep_axis``; the router is replicated (its gradient must be psum'd
    over ``ep_axis``: spec it so)."""
    T, E = x.shape
    n_local = params["w1"].shape[0]
    ep = col.axis_size_in(ep_axis)
    n_experts = n_local * ep

    probs = torch.softmax(x.float() @ params["router"], dim=-1)     # [T, nE]
    gate = probs.amax(dim=-1)                                       # [T]
    expert = probs.argmax(dim=-1)                                   # [T]

    cap = int(max(1, round(T * capacity_factor / n_experts)))
    # each token's place in its expert's queue
    onehot = F.one_hot(expert, n_experts)                           # [T, nE]
    pos_in_expert = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1) - 1
    keep = (pos_in_expert >= 0) & (pos_in_expert < cap)

    # tokens into the [nE, cap, E] send buffer (a dropped token adds zeros)
    tok_idx = torch.where(keep, expert * cap + pos_in_expert.clamp(0, cap - 1),
                          0)
    buf = torch.zeros(n_experts * cap, E, dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, tok_idx, torch.where(keep[:, None], x, 0))
    buf = buf.reshape(n_experts, cap, E)

    # [nE, cap, E] -> [n_local, ep * cap, E]: every rank's tokens
    if ep > 1:
        buf = col.all_to_all(buf, ep_axis, split_dim=0, concat_dim=1)
    h = F.gelu(torch.bmm(buf.to(params["w1"].dtype), params["w1"]),
               approximate="tanh")
    out = torch.bmm(h, params["w2"])
    if ep > 1:
        out = col.all_to_all(out, ep_axis, split_dim=1, concat_dim=0)
    out = out.reshape(n_experts * cap, E)

    # each token's result, weighted by its gate
    y = out[tok_idx] * keep[:, None].to(out.dtype)
    return (y.float() * gate[:, None]).to(x.dtype)
