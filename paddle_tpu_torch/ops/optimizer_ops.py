"""Optimizer update op rules on tensors: sgd, momentum, adam and adagrad,
each with its SelectedRows branch (counterparts of
``paddle_tpu/ops/optimizer_ops.py:26``, ``:39``, ``:94`` and ``:160``; the
other optimizers' rules wait).

Parity: operators/optimizers/sgd_op.cc, momentum_op.cc, adam_op.cc,
adagrad_op.cc and their SelectedRows overloads.  Each rule consumes
Param/Grad/LearningRate (+ state slots) and returns the new values under
the same variable names, which the executor writes back to the scope.

A sparse gradient (``sparse.SelectedRows``, from an ``is_sparse`` lookup)
is applied as the JAX rules apply it: ``sgd`` adds every slot's update in
place of its row; ``momentum``, ``adam`` and ``adagrad`` merge duplicate
rows first (``g.merged()``, through ``sparse.merge_rows``) and then set
the touched rows.  Row writes follow JAX's ``mode="drop"`` scatter: an id
in [-height, 0) counts from the end and any other id outside
[0, height) — the merge's sentinel among them — is dropped.
"""

import torch

from ..kernels.segment_update import scatter_rows_drop
from ..registry import register_op
from ..sparse import SelectedRows
from .common import x, out


def _lr(ins):
    lr = x(ins, "LearningRate")
    return lr.reshape(()) if lr.ndim else lr


def _set_rows_drop(table, rows, values):
    """A copy of ``table`` with ``table[rows] = values`` under JAX's
    ``mode="drop"``: the dropped slots write a spare row past the end,
    which is cut off, so nothing syncs with the host."""
    height = table.shape[0]
    rows = torch.where(rows < 0, rows + height, rows)
    valid = (rows >= 0) & (rows < height)
    ext = torch.cat([table, table.new_zeros((1,) + tuple(table.shape[1:]))])
    ext.index_copy_(0, torch.where(valid, rows, height).long(),
                    values.to(table.dtype))
    return ext[:height]


def _merged(g):
    """(rows, summed values, rows clamped into the table) of a
    SelectedRows: the clamped rows read the state the update starts from,
    as the JAX rules read ``p[jnp.clip(rows, 0, height - 1)]``."""
    rows, gv = g.merged()
    return rows, gv, rows.clamp(0, g.height - 1)


@register_op("sgd")
def _sgd(ins, attrs, ctx):
    p, g = x(ins, "Param"), x(ins, "Grad")
    lr = _lr(ins)
    if isinstance(g, SelectedRows):
        # duplicate rows accumulate, as the dense sum of their gradients
        return out(ParamOut=scatter_rows_drop(p.clone(), g.rows,
                                              (-lr * g.values).to(p.dtype)))
    return out(ParamOut=(p - lr * g).to(p.dtype))


@register_op("momentum")
def _momentum(ins, attrs, ctx):
    p, g, v = x(ins, "Param"), x(ins, "Grad"), x(ins, "Velocity")
    mu = attrs.get("mu", 0.9)
    lr = _lr(ins)
    nesterov = attrs.get("use_nesterov", False)
    if isinstance(g, SelectedRows):
        # the reference's SparseMomentumFunctor has no lazy mode: every row
        # takes the g = 0 update (decays and coasts), then the touched rows
        # are set to their full-gradient values
        v_dense = mu * v
        p_dense = p - (lr * (mu * v_dense if nesterov else v_dense)).to(p.dtype)
        rows, gv, safe = _merged(g)
        v_rows = mu * v[safe] + gv
        step = gv + mu * v_rows if nesterov else v_rows
        p_rows = p[safe] - (lr * step).to(p.dtype)
        return out(ParamOut=_set_rows_drop(p_dense, rows, p_rows),
                   VelocityOut=_set_rows_drop(v_dense, rows, v_rows))
    v_new = mu * v + g
    if nesterov:
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    return out(ParamOut=p_new.to(p.dtype), VelocityOut=v_new)


@register_op("adam")
def _adam(ins, attrs, ctx):
    p, g = x(ins, "Param"), x(ins, "Grad")
    m, v = x(ins, "Moment1"), x(ins, "Moment2")
    b1p, b2p = x(ins, "Beta1Pow"), x(ins, "Beta2Pow")
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = _lr(ins)
    lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    pows = dict(Beta1PowOut=b1p * b1, Beta2PowOut=b2p * b2)
    if isinstance(g, SelectedRows):
        # SparseAdamFunctor: lazy_mode touches only the gradient's rows;
        # without it (the reference default) every row takes the g = 0
        # update (moments decay, params keep moving) and the touched rows
        # are then set to their full-gradient values
        rows, gv, safe = _merged(g)
        m_rows = b1 * m[safe] + (1 - b1) * gv
        v_rows = b2 * v[safe] + (1 - b2) * torch.square(gv)
        p_rows = p[safe] - (lr_t * m_rows / (torch.sqrt(v_rows) + eps)).to(p.dtype)
        if attrs.get("lazy_mode", False):
            p_base, m_base, v_base = p, m, v
        else:
            m_base, v_base = b1 * m, b2 * v
            p_base = p - (lr_t * m_base / (torch.sqrt(v_base) + eps)).to(p.dtype)
        return out(ParamOut=_set_rows_drop(p_base, rows, p_rows),
                   Moment1Out=_set_rows_drop(m_base, rows, m_rows),
                   Moment2Out=_set_rows_drop(v_base, rows, v_rows), **pows)
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * torch.square(g)
    p_new = p - lr_t * m_new / (torch.sqrt(v_new) + eps)
    return out(ParamOut=p_new.to(p.dtype), Moment1Out=m_new,
               Moment2Out=v_new, **pows)


@register_op("adagrad")
def _adagrad(ins, attrs, ctx):
    p, g, m = x(ins, "Param"), x(ins, "Grad"), x(ins, "Moment")
    eps = attrs.get("epsilon", 1e-6)
    lr = _lr(ins)
    if isinstance(g, SelectedRows):
        # SparseAdagradFunctor: only the touched rows move
        rows, gv, safe = _merged(g)
        m_rows = m[safe] + torch.square(gv)
        p_rows = p[safe] - (lr * gv / (torch.sqrt(m_rows) + eps)).to(p.dtype)
        return out(ParamOut=_set_rows_drop(p, rows, p_rows),
                   MomentOut=_set_rows_drop(m, rows, m_rows))
    m_new = m + torch.square(g)
    p_new = p - lr * g / (torch.sqrt(m_new) + eps)
    return out(ParamOut=p_new.to(p.dtype), MomentOut=m_new)
