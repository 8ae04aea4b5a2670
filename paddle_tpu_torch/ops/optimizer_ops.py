"""Optimizer update op rules on tensors: sgd, momentum and the dense branch
of adam (counterparts of ``paddle_tpu/ops/optimizer_ops.py:26``, ``:39``
and ``:94``; the other optimizers' rules wait).

Parity: operators/optimizers/sgd_op.cc, momentum_op.cc, adam_op.cc.  Each
rule consumes Param/Grad/LearningRate (+ state slots) and returns the new
values under the same variable names, which the executor writes back to the
scope.  A SelectedRows gradient raises: sparse updates through the executor
wait (ROADMAP Queue 1 item 3).
"""

import torch

from ..registry import register_op
from ..sparse import SelectedRows
from .common import x, out


def _lr(ins):
    lr = x(ins, "LearningRate")
    return lr.reshape(()) if lr.ndim else lr


def _dense(op, g):
    if isinstance(g, SelectedRows):
        raise NotImplementedError(
            "%s with a SelectedRows gradient: sparse updates through the "
            "executor wait (ROADMAP Queue 1 item 3)" % op)


@register_op("sgd")
def _sgd(ins, attrs, ctx):
    p, g = x(ins, "Param"), x(ins, "Grad")
    _dense("sgd", g)
    return out(ParamOut=(p - _lr(ins) * g).to(p.dtype))


@register_op("momentum")
def _momentum(ins, attrs, ctx):
    p, g, v = x(ins, "Param"), x(ins, "Grad"), x(ins, "Velocity")
    _dense("momentum", g)
    mu = attrs.get("mu", 0.9)
    lr = _lr(ins)
    v_new = mu * v + g
    if attrs.get("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    return out(ParamOut=p_new.to(p.dtype), VelocityOut=v_new)


@register_op("adam")
def _adam(ins, attrs, ctx):
    p, g = x(ins, "Param"), x(ins, "Grad")
    _dense("adam", g)
    m, v = x(ins, "Moment1"), x(ins, "Moment2")
    b1p, b2p = x(ins, "Beta1Pow"), x(ins, "Beta2Pow")
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = _lr(ins)
    lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * torch.square(g)
    p_new = p - lr_t * m_new / (torch.sqrt(v_new) + eps)
    return out(
        ParamOut=p_new.to(p.dtype),
        Moment1Out=m_new,
        Moment2Out=v_new,
        Beta1PowOut=b1p * b1,
        Beta2PowOut=b2p * b2,
    )
