"""Op rules on tensors: the counterparts of every rule in
``paddle_tpu/ops/misc_ops4.py`` (ctc_align since ROADMAP Queue 1 item
3-B's tranche 4, the other sixteen since tranche 5): the distillation,
CTR and host-interop tail.

Parity (operators/): fsp_op.cc,.h, teacher_student_sigmoid_loss_op.cc,.h,
ctc_align_op.cc,.h (merge repeated tokens, then drop the blanks),
hash_op.cc (the JAX rule's integer mix, not xxhash: the same contract),
average_accumulates_op.cc,.h (ModelAverage), optimizers/proximal_gd_op.cc,
is_empty_op.cc, uniform_random_batch_size_like_op.cc,
gaussian_random_batch_size_like_op.cc,
get_tensor_from_selected_rows_op.cc, merge_selected_rows_op.cc,
positive_negative_pair_op.cc, py_func_op.cc, scatter_nd_op.cc,
activation_op.cc (soft_relu), conv_transpose_op.cc (3-D),
tree_conv_op.cc with math/tree2col.cc.

``py_func`` calls its function on the host with numpy arrays (the JAX
rule's ``jax.pure_callback``); the functions live in this module's own
table (``register_py_func``), which ``layers.py_func`` fills.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..dtypes import convert_dtype
from ..registry import register_op
from ..sparse import SelectedRows
from .common import (exact_conv, exact_matmul, op_generator, out,
                     promote_float, promoting_matmul, saturating_cast, x)
from .math_ops import _abs_like_jax, _clip_values
from .misc_ops2 import scatter_add_rows


@register_op("ctc_align")
def _ctc_align(ins, attrs, ctx):
    """Input [B, T] ids with InputLength [B] (all T without it): each row's
    kept tokens (not ``blank``, and with ``merge_repeated`` not equal to
    the step before, a blank included) packed to the front of Output
    [B, T], ``padding_value`` after; OutputLength [B, 1] their count."""
    inp = x(ins, "Input")
    lens = x(ins, "InputLength")
    blank = int(attrs.get("blank", 0))
    pad = int(attrs.get("padding_value", 0))
    B, T = inp.shape[:2]
    inp = inp.reshape(B, T).to(torch.int32)
    dev = inp.device
    lens = (torch.full((B,), T, dtype=torch.long, device=dev) if lens is None
            else lens.reshape(-1).long())
    keep = (torch.arange(T, device=dev)[None, :] < lens[:, None]) & (inp != blank)
    if attrs.get("merge_repeated", True):
        prev = torch.cat([torch.full((B, 1), -1, dtype=inp.dtype, device=dev),
                          inp[:, :-1]], dim=1)
        keep = keep & (inp != prev)
    slot = torch.where(keep, torch.cumsum(keep.long(), dim=1) - 1, T)
    packed = torch.full((B, T + 1), pad, dtype=torch.int32, device=dev)
    packed = packed.scatter(1, slot, inp)          # column T takes the drops
    return out(Output=packed[:, :T],
               OutputLength=keep.sum(dim=1).to(torch.int32).reshape(B, 1))


@register_op("fsp")
def _fsp(ins, attrs, ctx):
    """The flow of solution procedure matrix: X [N, Ca, H, W] and Y
    [N, Cb, H, W] give [N, Ca, Cb] = X Y^T / (H W)."""
    a, b = x(ins, "X"), x(ins, "Y")
    hw = a.shape[2] * a.shape[3]
    af = a.reshape(a.shape[0], a.shape[1], hw)
    bf = b.reshape(b.shape[0], b.shape[1], hw)
    return out(Out=exact_matmul(af, bf.transpose(1, 2)) / hw)


@register_op("teacher_student_sigmoid_loss")
def _teacher_student_sigmoid_loss(ins, attrs, ctx):
    """The label bands of teacher_student_sigmoid_loss_op.h:40: below -1
    no click, [-1, 0) a click, [0, 1) no click with teacher score q, [1, 2]
    a click with teacher score q - 1; sp = softplus(x) in its stable
    form."""
    xv = promote_float(x(ins, "X").reshape(-1))
    lab = x(ins, "Label").reshape(-1).to(torch.float32)
    sp = (torch.maximum(xv, torch.zeros((), dtype=xv.dtype, device=xv.device))
          + torch.log1p(torch.exp(-_abs_like_jax(xv))))
    y = torch.where(lab < -1.0, sp,
        torch.where(lab < 0.0, sp - xv,
        torch.where(lab < 1.0, sp + sp - xv * lab,
                    sp - xv + sp - xv * (lab - 1.0))))
    return out(Y=y.reshape(x(ins, "X").shape))


_U32 = 0xFFFFFFFF


def _mul32(a, b):
    """(a b) mod 2^32 of int64 tensors holding uint32 values, in products
    that stay below 2^49 (no signed overflow on either device)."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _as_u32(v):
    """``astype(uint32)`` into int64: integers wrap mod 2^32, floats
    truncate and saturate to [0, 2^32 - 1] with NaN at 0, as XLA
    converts."""
    if v.is_floating_point():
        f = v.double()
        f = torch.where(torch.isnan(f), 0.0, f).clamp(0.0, float(_U32))
        return f.trunc().long()
    return v.long() & _U32


@register_op("hash")
def _hash(ins, attrs, ctx):
    """Bucketed row hash in uint32 arithmetic (int64 masked to 32 bits
    after every product and sum, so that the card and the CPU give JAX's
    bits): each seat k mixes the row's ids with multiplier
    (k 2654435761) | 1, then acc = (acc ^ mixed_j) 16777619 + j + 1 over
    the columns; Out [N, num_hash, 1] = acc % mod_by as int32."""
    v = x(ins, "X")
    mod_by = int(attrs.get("mod_by", 100000))
    num_hash = int(attrs.get("num_hash", 1))
    n = v.shape[0]
    row = _as_u32(v.reshape(n, -1))
    seats = torch.arange(1, num_hash + 1, dtype=torch.int64, device=v.device)
    mult = _mul32(seats, torch.tensor(2654435761, device=v.device)) | 1
    mixed = _mul32(row[:, None, :], mult[None, :, None])
    acc = torch.zeros((n, num_hash), dtype=torch.int64, device=v.device)
    for j in range(row.shape[1]):
        acc = (_mul32(acc ^ mixed[:, :, j], torch.tensor(16777619, device=v.device))
               + (j + 1)) & _U32
    o = torch.remainder(acc, mod_by & _U32)
    # uint32 to int32 keeps the bits
    o = torch.where(o >= 2 ** 31, o - 2 ** 32, o).to(torch.int32)
    return out(Out=o.reshape(n, num_hash, 1))


@register_op("average_accumulates")
def _average_accumulates(ins, attrs, ctx):
    """ModelAverage's accumulators (average_accumulates_op.h:41), the
    counters in int32: sum_1 gathers the parameter; every kMax = 16384
    updates it rolls into sum_2; once the window is full (at least
    min_average_window accumulations, and min(max_average_window,
    int32(num_updates average_window)) of them, the product in f32) both
    roll into sum_3 and the accumulation count restarts."""
    param = x(ins, "param")
    s1, s2, s3 = x(ins, "in_sum_1"), x(ins, "in_sum_2"), x(ins, "in_sum_3")
    nacc = x(ins, "in_num_accumulates").reshape(()).to(torch.int32)
    oacc = x(ins, "in_old_num_accumulates").reshape(()).to(torch.int32)
    nupd = x(ins, "in_num_updates").reshape(()).to(torch.int32)
    avg_win = float(attrs.get("average_window", 0))
    max_win = int(attrs.get("max_average_window", 2 ** 31 - 1))
    min_win = int(attrs.get("min_average_window", 10000))
    kMax = 16384
    nupd = nupd + 1
    nacc = nacc + 1
    o1 = s1 + param
    o2, o3 = s2, s3
    roll = torch.remainder(nupd, kMax) == 0
    o2 = torch.where(roll, o2 + o1, o2)
    o1 = torch.where(roll, torch.zeros_like(o1), o1)
    win = saturating_cast(nupd.to(torch.float32) * np.float32(avg_win),
                          torch.int32)
    win_full = (nacc >= min_win) & (nacc >= torch.clamp(win, max=max_win))
    o3 = torch.where(win_full, o1 + o2, o3)
    o1 = torch.where(win_full, torch.zeros_like(o1), o1)
    o2 = torch.where(win_full, torch.zeros_like(o2), o2)
    oacc = torch.where(win_full, nacc, oacc)
    nacc = torch.where(win_full, torch.zeros_like(nacc), nacc)
    return out(out_sum_1=o1, out_sum_2=o2, out_sum_3=o3,
               out_num_accumulates=nacc.reshape(1),
               out_old_num_accumulates=oacc.reshape(1),
               out_num_updates=nupd.reshape(1))


@register_op("proximal_gd")
def _proximal_gd(ins, attrs, ctx):
    """prox = p - lr g; p' = sign(prox) max(|prox| - lr l1, 0) /
    (1 + lr l2), in p's dtype."""
    p, g = x(ins, "Param"), x(ins, "Grad")
    lr = x(ins, "LearningRate").reshape(())
    l1 = float(attrs.get("l1", 0.0))
    l2 = float(attrs.get("l2", 0.0))
    prox = p - lr * g
    shrunk = _abs_like_jax(prox) - lr * l1
    o = (torch.sign(prox) * torch.maximum(shrunk, torch.zeros(
        (), dtype=shrunk.dtype, device=shrunk.device)) / (1.0 + lr * l2))
    return out(ParamOut=saturating_cast(o, p.dtype))


@register_op("is_empty")
def _is_empty(ins, attrs, ctx):
    v = x(ins, "X")
    return out(Out=torch.tensor(v.numel() == 0, device=v.device))


def _batch_size_like_shape(v, attrs):
    shape = [int(s) for s in attrs["shape"]]
    shape[int(attrs.get("output_dim_idx", 0))] = v.shape[
        int(attrs.get("input_dim_idx", 0))]
    return shape


@register_op("uniform_random_batch_size_like")
def _uniform_random_batch_size_like(ins, attrs, ctx):
    """U[min, max) in f32 (``op_generator``'s stream), the batch axis
    ``output_dim_idx`` taken from Input's ``input_dim_idx``, then cast to
    ``dtype``."""
    v = x(ins, "Input")
    lo, hi = float(attrs.get("min", -1.0)), float(attrs.get("max", 1.0))
    u = torch.rand(_batch_size_like_shape(v, attrs),
                   generator=op_generator(ctx, attrs), device=ctx.device)
    return out(Out=(lo + (hi - lo) * u).to(
        convert_dtype(attrs.get("dtype", "float32"))))


@register_op("gaussian_random_batch_size_like")
def _gaussian_random_batch_size_like(ins, attrs, ctx):
    """N(mean, std^2) in f32 (``op_generator``'s stream), shaped as
    ``uniform_random_batch_size_like``, then cast to ``dtype``."""
    v = x(ins, "Input")
    r = torch.randn(_batch_size_like_shape(v, attrs),
                    generator=op_generator(ctx, attrs), device=ctx.device)
    r = r * float(attrs.get("std", 1.0)) + float(attrs.get("mean", 0.0))
    return out(Out=r.to(convert_dtype(attrs.get("dtype", "float32"))))


@register_op("get_tensor_from_selected_rows")
def _get_tensor_from_selected_rows(ins, attrs, ctx):
    """A SelectedRows' merged values (duplicate rows summed, sorted and
    compacted to the front); a dense input passes through."""
    v = x(ins, "X")
    if isinstance(v, SelectedRows):
        return out(Out=v.merged()[1])
    return out(Out=v)


@register_op("merge_selected_rows")
def _merge_selected_rows(ins, attrs, ctx):
    """A SelectedRows with its duplicate rows summed (sorted, compacted,
    the free slots at row ``height``); a dense input passes through."""
    v = x(ins, "X")
    if isinstance(v, SelectedRows):
        rows, vals = v.merged()
        return out(Out=SelectedRows(rows=rows, values=vals, height=v.height))
    return out(Out=v)


@register_op("positive_negative_pair")
def _positive_negative_pair(ins, attrs, ctx):
    """Within each query, the weighted count of label-differing pairs whose
    score order agrees (positive) or not (negative, score ties
    included), and the tied ones (neutral), each pair weighted by its
    mean weight; the Accumulate* inputs added."""
    scores = x(ins, "Score")
    col = int(attrs.get("column", -1))
    score = scores.reshape(scores.shape[0], -1)[:, col]
    label = x(ins, "Label").reshape(-1)
    qid = x(ins, "QueryID").reshape(-1)
    wt = x(ins, "Weight")
    w = (torch.ones_like(score) if wt is None
         else wt.reshape(-1).to(torch.float32))
    n = score.shape[0]
    upper = torch.ones((n, n), dtype=torch.bool, device=score.device).triu(1)
    pairs = (qid[:, None] == qid[None, :]) & upper \
        & (label[:, None] != label[None, :])
    pw = (w[:, None] + w[None, :]) * 0.5
    concordant = ((score[:, None] - score[None, :])
                  * (label[:, None] - label[None, :])) > 0
    tie = score[:, None] == score[None, :]
    pos = torch.where(pairs & concordant, pw, 0.0).sum()
    neg = torch.where(pairs & ~concordant, pw, 0.0).sum()
    neu = torch.where(pairs & tie, pw, 0.0).sum()
    res = []
    for v, slot in ((pos, "AccumulatePositivePair"),
                    (neg, "AccumulateNegativePair"),
                    (neu, "AccumulateNeutralPair")):
        acc = x(ins, slot)
        res.append((v + (0.0 if acc is None else acc.reshape(()))).reshape(1))
    return out(PositivePair=res[0], NegativePair=res[1], NeutralPair=res[2])


# py_func's table (py_func_op.cc keeps the callables in a registered
# table; the op's attr carries the index)
_PY_FUNCS = []


def register_py_func(fn):
    _PY_FUNCS.append(fn)
    return len(_PY_FUNCS) - 1


@register_op("py_func")
def _py_func(ins, attrs, ctx):
    """Calls the registered function on the host with the inputs as numpy
    arrays; each result is cast to its declared dtype, must have its
    declared shape, and comes back on the inputs' device (the executor's
    without inputs).  Like ``jax.pure_callback``, it has no gradient: the
    results are new leaves."""
    fn = _PY_FUNCS[int(attrs["forward_callable_id"])]
    xs = ins.get("X") or []
    shapes = [tuple(int(d) for d in s) for s in attrs["out_shapes"]]
    dtypes = [convert_dtype(d) for d in attrs["out_dtypes"]]
    device = xs[0].device if xs else ctx.device
    r = fn(*[t.detach().cpu().numpy() for t in xs])
    if not isinstance(r, (list, tuple)):
        r = (r,)
    if len(r) != len(shapes):
        raise ValueError("py_func: the function returned %d results, %d "
                         "declared" % (len(r), len(shapes)))
    res = []
    for a, shape, dt in zip(r, shapes, dtypes):
        t = torch.as_tensor(np.asarray(a)).to(dt)
        if tuple(t.shape) != shape:
            raise ValueError("py_func: a result of shape %s, declared %s" % (
                tuple(t.shape), shape))
        res.append(t.to(device))
    return out(Out=res)


@register_op("scatter_nd")
def _scatter_nd(ins, attrs, ctx):
    """Zeros of ``shape`` (Updates' dtype) with Updates added at Index
    (duplicates accumulate, an index out of range dropped)."""
    upd = x(ins, "Updates")
    base = torch.zeros([int(s) for s in attrs["shape"]], dtype=upd.dtype,
                       device=upd.device)
    return out(Out=scatter_add_rows(base, x(ins, "Index"), upd))


@register_op("soft_relu")
def _soft_relu(ins, attrs, ctx):
    """log(1 + exp(clip(x, -t, t))), the clip ``jnp.clip``'s (half the
    gradient at a bound)."""
    t = float(attrs.get("threshold", 40.0))
    v = _clip_values(promote_float(x(ins, "X")), -t, t)
    return out(Out=torch.log1p(torch.exp(v)))


@register_op("conv3d_transpose")
def _conv3d_transpose(ins, attrs, ctx):
    """The transposed 3-D convolution of NCDHW Input by Filter
    [C, M, kd, kh, kw] (``F.conv_transpose3d``, the gradient of a
    convolution; integers and bool through ``exact_conv``)."""
    v, w = x(ins, "Input"), x(ins, "Filter")
    return out(Output=exact_conv(
        F.conv_transpose3d, v, w,
        stride=tuple(int(a) for a in attrs.get("strides", [1, 1, 1])),
        padding=tuple(int(a) for a in attrs.get("paddings", [0, 0, 0])),
        dilation=tuple(int(a) for a in attrs.get("dilations", [1, 1, 1]))))


@register_op("tree_conv")
def _tree_conv(ins, attrs, ctx):
    """Tree-based convolution (TBCNN): NodesVector [B, N, F] (node n in row
    n - 1), EdgeSet [B, E, 2] (parent, child) pairs up to the first pair
    holding a 0, Filter [F, 3, S, M] (left, right, top); Out [B, N, S, M].
    As the JAX rule: the nodes reachable at depth k are the k-th power of
    the adjacency (a tree's paths are unique, so its entries are 0 or 1),
    the eta coefficients become per-depth coefficient matrices, and
    tree2col is three batched [N+1, N+1] x [N+1, F] products feeding one
    patch x W."""
    nodes, edges, filt = x(ins, "NodesVector"), x(ins, "EdgeSet"), x(ins, "Filter")
    max_depth = int(attrs.get("max_depth", 2))
    B, N, Fdim = nodes.shape
    E = edges.shape[1]
    S, M = filt.shape[2], filt.shape[3]
    dt, dev = nodes.dtype, nodes.device
    es = edges.to(torch.int32).long()
    valid = (es[:, :, 0] != 0) & (es[:, :, 1] != 0)
    valid = torch.cumprod(valid.to(torch.int32), dim=1) == 1
    node_count = valid.sum(dim=1) + 1                          # [B]
    u = torch.where(valid, es[:, :, 0], 0)
    v = torch.where(valid, es[:, :, 1], 0)
    fv = valid.to(dt)
    bidx = torch.arange(B, device=dev)[:, None].expand(B, E)
    A = torch.zeros((B, N + 1, N + 1), dtype=dt, device=dev).index_put(
        (bidx, u, v), fv, accumulate=True)
    A[:, 0, :] = 0
    A[:, :, 0] = 0
    same_parent = ((u[:, None, :] == u[:, :, None]) & valid[:, None, :]
                   & valid[:, :, None])
    earlier = torch.ones((E, E), dtype=torch.bool, device=dev).tril(-1)
    rank = (same_parent & earlier).sum(dim=2)
    fanout = same_parent.sum(dim=2)
    idx = torch.zeros((B, N + 1), dtype=dt, device=dev).index_put(
        (bidx, v), fv * (rank + 1).to(dt), accumulate=True)
    pcl = torch.zeros((B, N + 1), dtype=dt, device=dev).index_put(
        (bidx, v), fv * fanout.to(dt), accumulate=True)
    CL = torch.zeros((B, N + 1, N + 1), dtype=dt, device=dev)
    CR, CT = torch.zeros_like(CL), torch.zeros_like(CL)
    Rk = torch.eye(N + 1, dtype=dt, device=dev).expand(B, N + 1, N + 1)
    one = torch.ones((), dtype=pcl.dtype, device=dev)
    for k in range(max_depth):
        eta_t = (max_depth - k) / max_depth
        if k == 0:
            temp = torch.full((B, N + 1), 0.5, dtype=promote_float(pcl).dtype,
                              device=dev)
        else:
            temp = torch.where(pcl == 1, 0.5,
                               (idx - 1) / torch.maximum(pcl - 1, one))
        eta_l = (1.0 - eta_t) * temp
        eta_r = (1.0 - eta_t) * (1.0 - eta_l)
        CT = CT + Rk * eta_t
        CL = CL + Rk * eta_l[:, None, :]
        CR = CR + Rk * eta_r[:, None, :]
        Rk = exact_matmul(Rk, A)
    rows = torch.arange(N + 1, device=dev)[None, :]
    rowmask = ((rows >= 1) & (rows <= node_count[:, None])).to(dt)
    feat1 = torch.cat([torch.zeros((B, 1, Fdim), dtype=dt, device=dev), nodes],
                      dim=1)
    parts = [promoting_matmul(C * rowmask[:, :, None], feat1)
             for C in (CL, CR, CT)]
    patch = torch.stack(parts, dim=-1).reshape(B, N + 1, 3 * Fdim)[:, 1:]
    W2 = filt.reshape(Fdim * 3, S * M)
    return out(Out=promoting_matmul(patch, W2).reshape(B, N, S, M))
