"""Optimizer update op rules on tensors: sgd, momentum, adam and adagrad,
each with its SelectedRows branch, and the dense rules lars_momentum,
adamax, decayed_adagrad, adadelta, rmsprop, ftrl, lamb, dpsgd and
dgc_momentum (counterparts of every rule in
``paddle_tpu/ops/optimizer_ops.py``).

Parity: operators/optimizers/sgd_op.cc, momentum_op.cc, adam_op.cc,
adagrad_op.cc and their SelectedRows overloads; lars_momentum_op.cc,
adamax_op.cc, decayed_adagrad_op.cc, adadelta_op.cc, rmsprop_op.cc,
ftrl_op.cc, lamb_op.cc, dpsgd_op.cc and dgc_op.cc.  Each rule consumes
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
from .common import op_generator, x, out


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


@register_op("lars_momentum")
def _lars_momentum(ins, attrs, ctx):
    """LARS: a layer-wise local learning rate from the norms of the
    parameter and its gradient (lars_momentum_op.cc)."""
    p, g, v = x(ins, "Param"), x(ins, "Grad"), x(ins, "Velocity")
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    wd = attrs.get("lars_weight_decay", 0.0005)
    eps = attrs.get("epsilon", 0.0)
    lr = _lr(ins)
    p_norm = torch.sqrt(torch.sum(torch.square(p)))
    g_norm = torch.sqrt(torch.sum(torch.square(g)))
    local_lr = torch.where((p_norm > 0) & (g_norm > 0),
                           lr * coeff * p_norm / (g_norm + wd * p_norm + eps),
                           lr)
    v_new = mu * v + local_lr * (g + wd * p)
    return out(ParamOut=(p - v_new).to(p.dtype), VelocityOut=v_new)


@register_op("adamax")
def _adamax(ins, attrs, ctx):
    """Adam with the infinity norm; Beta1Pow is advanced by the class's own
    ``scale`` op."""
    p, g = x(ins, "Param"), x(ins, "Grad")
    m, inf = x(ins, "Moment"), x(ins, "InfNorm")
    b1p = x(ins, "Beta1Pow")
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    inf_new = torch.maximum(b2 * inf, torch.abs(g))
    p_new = p - (_lr(ins) / (1 - b1p.reshape(()))) * m_new / (inf_new + eps)
    return out(ParamOut=p_new.to(p.dtype), MomentOut=m_new,
               InfNormOut=inf_new)


@register_op("decayed_adagrad")
def _decayed_adagrad(ins, attrs, ctx):
    p, g, m = x(ins, "Param"), x(ins, "Grad"), x(ins, "Moment")
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    m_new = decay * m + (1 - decay) * torch.square(g)
    p_new = p - _lr(ins) * g / (torch.sqrt(m_new) + eps)
    return out(ParamOut=p_new.to(p.dtype), MomentOut=m_new)


@register_op("adadelta")
def _adadelta(ins, attrs, ctx):
    p, g = x(ins, "Param"), x(ins, "Grad")
    avg_g, avg_u = x(ins, "AvgSquaredGrad"), x(ins, "AvgSquaredUpdate")
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    g2 = rho * avg_g + (1 - rho) * torch.square(g)
    upd = -torch.sqrt((avg_u + eps) / (g2 + eps)) * g
    u2 = rho * avg_u + (1 - rho) * torch.square(upd)
    return out(ParamOut=(p + upd).to(p.dtype), AvgSquaredGradOut=g2,
               AvgSquaredUpdateOut=u2)


@register_op("rmsprop")
def _rmsprop(ins, attrs, ctx):
    """Centered or not; MeanGradOut only when the op reads MeanGrad."""
    p, g = x(ins, "Param"), x(ins, "Grad")
    ms, mom, mg = x(ins, "MeanSquare"), x(ins, "Moment"), x(ins, "MeanGrad")
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mu = attrs.get("momentum", 0.0)
    ms_new = rho * ms + (1 - rho) * torch.square(g)
    if attrs.get("centered", False):
        mg_new = rho * mg + (1 - rho) * g
        denom = ms_new - torch.square(mg_new) + eps
    else:
        mg_new = mg
        denom = ms_new + eps
    mom_new = mu * mom + _lr(ins) * g / torch.sqrt(denom)
    res = out(ParamOut=(p - mom_new).to(p.dtype), MeanSquareOut=ms_new,
              MomentOut=mom_new)
    if mg is not None:
        res["MeanGradOut"] = [mg_new]
    return res


@register_op("ftrl")
def _ftrl(ins, attrs, ctx):
    p, g = x(ins, "Param"), x(ins, "Grad")
    sq, lin = x(ins, "SquaredAccumulator"), x(ins, "LinearAccumulator")
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    power = attrs.get("lr_power", -0.5)
    lr = _lr(ins)
    new_sq = sq + torch.square(g)
    sigma = (torch.pow(new_sq, -power) - torch.pow(sq, -power)) / lr
    new_lin = lin + g - sigma * p
    pre = torch.clamp(new_lin, -l1, l1) - new_lin
    p_new = pre / (torch.pow(new_sq, -power) / lr + 2 * l2)
    return out(ParamOut=p_new.to(p.dtype), SquaredAccumOut=new_sq,
               LinearAccumOut=new_lin)


@register_op("lamb")
def _lamb(ins, attrs, ctx):
    """LAMB: Adam's direction plus weight decay, scaled by the trust ratio
    ||p|| / ||r|| (1 where either norm is 0; lamb_op.cc)."""
    p, g = x(ins, "Param"), x(ins, "Grad")
    m, v = x(ins, "Moment1"), x(ins, "Moment2")
    b1p, b2p = x(ins, "Beta1Pow"), x(ins, "Beta2Pow")
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * torch.square(g)
    m_hat = m_new / (1 - b1p.reshape(()))
    v_hat = v_new / (1 - b2p.reshape(()))
    r = m_hat / (torch.sqrt(v_hat) + eps) + wd * p
    p_norm = torch.sqrt(torch.sum(torch.square(p)))
    r_norm = torch.sqrt(torch.sum(torch.square(r)))
    trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm, 1.0)
    p_new = p - _lr(ins) * trust * r
    return out(ParamOut=p_new.to(p.dtype), Moment1Out=m_new, Moment2Out=v_new,
               Beta1PowOut=b1p * b1, Beta2PowOut=b2p * b2)


@register_op("dpsgd")
def _dpsgd(ins, attrs, ctx):
    """Differentially private SGD: the gradient clipped to norm ``clip``
    plus Gaussian noise of std clip * sigma over ``batch_size``
    (dpsgd_op.cc).  The noise comes from ``op_generator``: another stream
    than JAX's, the same distribution; at sigma 0 the step is exact."""
    p, g = x(ins, "Param"), x(ins, "Grad")
    clip = attrs.get("clip", 10.0)
    batch_size = attrs.get("batch_size", 16.0)
    sigma = attrs.get("sigma", 1.0)
    g_norm = torch.sqrt(torch.sum(torch.square(g)))
    g = torch.where(g_norm > clip, g * (clip / g_norm), g)
    noise = torch.randn(g.shape, generator=op_generator(ctx, attrs),
                        device=g.device, dtype=g.dtype) * (clip * sigma)
    g = g + noise / batch_size
    return out(ParamOut=(p - _lr(ins) * g).to(p.dtype))


@register_op("dgc_momentum")
def _dgc_momentum(ins, attrs, ctx):
    """Deep Gradient Compression (dgc_op.cc): u = mu u + g, v += u; the
    entries of |v| at or above the k-th largest, k from the ramped sparsity
    schedule, make the sparse gradient of an SGD step and are cleared from
    u and v.  Before ``rampup_begin_step`` it is plain momentum.  The k-th
    magnitude is read from the sorted |v| at an index computed on the
    device, so nothing syncs with the host.  A SelectedRows gradient is
    made dense first."""
    p, g, u = x(ins, "Param"), x(ins, "Grad"), x(ins, "Velocity")
    v = x(ins, "ErrorAccum")
    step = x(ins, "Step").reshape(())
    mu = attrs.get("mu", 0.9)
    lr = _lr(ins)
    begin = int(attrs.get("rampup_begin_step", 0))
    rampup = max(int(attrs.get("rampup_step", 1)), 1)
    sparsity = [float(s) for s in (attrs.get("sparsity") or [0.999])]
    if isinstance(g, SelectedRows):
        rows, gv = g.merged()
        g = torch.zeros(p.shape, dtype=gv.dtype, device=p.device).index_add_(
            0, rows.clamp(0, g.height - 1), gv)

    # momentum (before the ramp-up)
    u_mom = mu * u + g
    if attrs.get("use_nesterov", False):
        p_mom = p - (g + mu * u_mom) * lr
    else:
        p_mom = p - lr * u_mom

    # DGC: momentum correction, error accumulation, top-k, error feedback
    u_d = mu * u + g
    v_d = v + u_d
    flat = torch.abs(v_d).reshape(-1)
    n = flat.shape[0]
    si = torch.clamp((step - begin).to(torch.int32) * len(sparsity) // rampup,
                     0, len(sparsity) - 1)
    ratio = torch.tensor(sparsity, dtype=torch.float32, device=p.device)[si]
    k = torch.clamp((n * (1.0 - ratio)).to(torch.int32), 1, n)
    thresh = torch.sort(flat).values[torch.clamp(n - k, 0, n - 1)]
    mask = (torch.abs(v_d) >= thresh).to(v_d.dtype)
    p_dgc = p - lr * (v_d * mask)
    use_dgc = step >= begin
    return out(ParamOut=torch.where(use_dgc, p_dgc, p_mom).to(p.dtype),
               VelocityOut=torch.where(use_dgc, u_d * (1.0 - mask), u_mom),
               ErrorAccumOut=torch.where(use_dgc, v_d * (1.0 - mask), v),
               StepOut=(step + 1).reshape(1))
