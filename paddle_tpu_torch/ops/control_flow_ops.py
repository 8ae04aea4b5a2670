"""Control-flow op rules on tensors: while, conditional_block, cond, scan,
select_input, print and backward_meta's refusal (counterparts of
``paddle_tpu/ops/control_flow_ops.py``; parity: operators/controlflow/
while_op.cc:43, conditional_block_op.cc, recurrent_op.cc).

The JAX rules lower a sub-block into ``lax.while_loop`` / ``lax.cond`` /
``lax.scan``.  Here they run eagerly: ``while`` is a Python loop that reads
its condition on the host before each iteration, ``conditional_block`` and
``cond`` run the taken branch only, ``scan`` loops over the leading axis
and stacks the per-step outputs.  Each iteration, as in the reference, the
body sees the outer env (closure reads) with the carried vars bound, and
only the carried vars pass from one iteration to the next.

Reading a condition is one host synchronisation on the card, inherent to an
eager loop; ``host_syncs`` counts them by op type, as the kernels' launch
counters count launches (``reset_host_syncs`` sets them to 0).

``lax.while_loop`` has no reverse-mode derivative, so in the JAX package a
differentiated value carried through ``while`` fails ``jax.grad``.  The
eager loop would differentiate it quietly; the ``while`` rule raises
``NotDifferentiable`` (a ``ValueError``) in the same case instead.  ``cond``
and ``scan`` are differentiable in both packages.
"""

import collections

import torch

from ..enforce import NotDifferentiable
from ..registry import register_op
from .common import x, out

__all__ = ["host_syncs", "reset_host_syncs"]

host_syncs = collections.Counter()


def reset_host_syncs():
    host_syncs.clear()


def _read_bool(t, op_type):
    """A scalar predicate on the host: one sync on the card."""
    host_syncs[op_type] += 1
    return bool(t.reshape(()))


def _refuse_differentiated(names, values):
    if not torch.is_grad_enabled():
        return
    bad = [n for n, v in zip(names, values)
           if isinstance(v, torch.Tensor) and v.requires_grad]
    if bad:
        raise NotDifferentiable(
            "Reverse-mode differentiation does not work for the while op "
            "(lax.while_loop in the reference): the differentiated value(s) "
            "%s are carried through the loop; compute the gradient outside "
            "the loop, or use scan" % bad)


@register_op("while")
def _while(ins, attrs, ctx):
    """attrs: sub_block_index, cond_name, loop_var_names.  The carried state
    is the loop vars' values; whatever else the body reads from the outer
    env is loop-invariant."""
    names = list(attrs["loop_var_names"])
    cond_name = attrs["cond_name"]
    sub_idx = int(attrs["sub_block_index"])
    outer_env = dict(ctx.env)
    carry = [outer_env[n] for n in names]
    _refuse_differentiated(names, carry)
    while True:
        env = dict(outer_env)
        env.update(zip(names, carry))
        if not _read_bool(env[cond_name], "while"):
            break
        env = ctx.interpret_block(sub_idx, env)
        carry = [env[n] for n in names]
        _refuse_differentiated(names, carry)
    return out(Out=carry)


@register_op("conditional_block")
def _conditional_block(ins, attrs, ctx):
    """Single-branch conditional (ref conditional_block_op.cc): if Cond, run
    the sub-block, else pass the carried vars through unchanged."""
    names = list(attrs["carried_var_names"])
    sub_idx = int(attrs["sub_block_index"])
    env = dict(ctx.env)
    if _read_bool(x(ins, "Cond"), "conditional_block"):
        env = ctx.interpret_block(sub_idx, env)
    return out(Out=[env[n] for n in names])


@register_op("cond")
def _cond(ins, attrs, ctx):
    """Two-branch cond (ref layers/control_flow.py cond): the taken branch
    runs; its outputs are the op's."""
    if _read_bool(x(ins, "Cond"), "cond"):
        idx, names = attrs["true_block_index"], attrs["true_out_names"]
    else:
        idx, names = attrs["false_block_index"], attrs["false_out_names"]
    env = ctx.interpret_block(int(idx), dict(ctx.env))
    return out(Out=[env[n] for n in names])


@register_op("scan")
def _scan(ins, attrs, ctx):
    """Loop over the leading axis of the scanned inputs (the reference's
    ``lax.scan``).  attrs: sub_block_index, carry_names, xs_names (the
    sub-block's names of one step's slices), ys_names (stacked outputs).
    The initial carries and the scanned inputs are the op's input values."""
    carry_names = list(attrs["carry_names"])
    xs_names = list(attrs["xs_names"])
    ys_names = list(attrs["ys_names"])
    sub_idx = int(attrs["sub_block_index"])
    outer_env = dict(ctx.env)
    carry = list(ins.get("Carry", []))
    xs = list(ins.get("Xs", []))
    ys = [[] for _ in ys_names]
    for t in range(xs[0].shape[0]):
        env = dict(outer_env)
        env.update(zip(carry_names, carry))
        env.update(zip(xs_names, [v[t] for v in xs]))
        env = ctx.interpret_block(sub_idx, env)
        carry = [env[n] for n in carry_names]
        for acc, n in zip(ys, ys_names):
            acc.append(env[n])
    return out(CarryOut=carry, Ys=[torch.stack(acc) for acc in ys])


@register_op("select_input")
def _select_input(ins, attrs, ctx):
    mask = x(ins, "Mask")
    branches = ins["X"]
    r = branches[0]
    for i, b in enumerate(branches[1:], start=1):
        r = torch.where(mask.reshape(()) == i, b, r)
    return out(Out=r)


@register_op("print")
def _print(ins, attrs, ctx):
    """Prints the value on the host (a sync on the card), as
    ``jax.debug.print`` does from the compiled step."""
    v = x(ins, "In")
    msg = attrs.get("message") or "{}"
    if "{}" not in msg:
        msg = msg.replace("{", "{{").replace("}", "}}") + " {}"
    print(msg.format(v.detach().cpu().numpy()))
    return out(Out=v)


@register_op("backward_meta")
def _backward_meta(ins, attrs, ctx):
    raise RuntimeError(
        "backward_meta must be handled by the Executor's top-level run (it "
        "marks the autograd split); it cannot appear in a sub-block")
