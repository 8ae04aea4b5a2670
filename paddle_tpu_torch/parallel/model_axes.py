"""The model-axis table of program-mode tensor parallelism.

The JAX package runs a program whose weights ``layers.fc(tp_split=...)``
and ``layers.embedding(tp_split=...)`` marked with
``BuildStrategy.tensor_parallel_degree = tp`` as one GSPMD ``jit`` over a
("data", "model") mesh: the marked weights (and the optimizer accumulators
that carry the mark) are split over "model", "col" at their last dim and
"row" at their first (``compiler.py`` ``_tp_specs``), and XLA's partitioner
makes the program compute the one-device function.  The port runs the
program once a rank, each rank holding its slice of every split var, and
this module is what the partitioner does, op by op.  It composes with the
batch-axis table (``batch_axes.py``): every rule runs behind both, the
model layer outside, so a value can be batch-sharded, model-split, both,
or neither.

Each value of a run is *whole*, *split at axis a* over the model group, or
a *partial sum* over it (``Run.layout``).  The entries:

- ``mul``: a col-split Y with a whole X gives a split at the last axis (a
  split X is gathered first: an activation moves, never the weight); a
  row-split Y with X split at its contracted axis gives a partial sum, and
  with a whole X slices X's contracted columns locally, which also gives a
  partial sum;
- ``elementwise_*``: operands split at one output axis give a split there;
  a whole operand spanning that axis is sliced first (the encoder's mask
  bias against split heads); a partial sum is reduced before anything is
  added to it (the Megatron row-parallel all-reduce);
- the unary activations, ``scale`` and ``cast``: the layout passes through;
- ``dropout`` on a split value draws the whole value's mask (the global
  batch's and the whole model axis's) as one rank would, and keeps this
  rank's block, so a tp run equals the one-rank run;
- ``lookup_table``: a col-split table gives a split at the last axis; a
  row-split one is a masked local gather, a partial sum (the form of
  ``embedding.sharded_embedding_lookup``);
- ``softmax_with_cross_entropy`` with its logits split at the class axis is
  the vocab-parallel rule: the max over ranks of the detached max, the sum
  over ranks of the exp-sums, the picked logit summed over ranks (the
  arithmetic of ``transformer.final_logits_loss`` at tp > 1);
- the attention core on split heads: ``reshape2`` (the shape resolved
  against the whole input), ``transpose2``, ``matmul`` of two values split
  on one batch-dim axis (and its row / column / contracted cases) and
  ``softmax`` over an axis that is not split;
- the optimizer ops run on the shards, LAMB and LARS with their norms
  summed over the model group (the rule's ``_norm_group``).

Every other op that reads a split value all-gathers it to whole first
(and reduces a partial sum), then runs its plain rule; its outputs are
whole.  That is not a refusal: GSPMD runs any op, and a whole input gives
the one-device value.  The gathers are counted (``counts``), those of an
activation apart.  A state var that stays split at rest (a marked weight
and its marked accumulators) is cut back to this rank's block whatever
writes it.

The gradients come out as the one-device ones: a replicated loss's
cotangent is seeded with 1/(dp * tp) on each rank, every collective's
transpose is a sum (``collectives.py``'s ``_Psum`` and ``_AllGather``), a
whole parameter's gradient is summed over the whole world and a split one's
over the data group only (``executor.py``).  At tp = 1 no rule is wrapped,
so the run is the plain run bit for bit.
"""

import math

import torch

from . import batch_axes as _batch_axes
from . import collectives as col
from .embedding import _owned_gather
from .mesh import TP

__all__ = ["PARTIAL", "TABLE", "OPTIMIZERS", "Run", "wrap", "counts",
           "reset_counts"]

PARTIAL = "partial"     # a layout: each rank holds a summand of the value

TABLE = {}

# optimizer ops that run on the shards (their norms summed over the model
# group for NORM_SUMMED)
OPTIMIZERS = _batch_axes.ROW_SEPARABLE | _batch_axes.NORM_SUMMED

# the fallback's all-gathers, summed over runs until ``reset_counts``
_COUNTS = {"fallback_gathers": 0, "activation_gathers": 0,
           "partial_reductions": 0}


def counts():
    """``{"fallback_gathers", "activation_gathers", "partial_reductions"}``
    since the last ``reset_counts``: the split values the fallback gathered
    (those of an activation apart: not a state var, not a gradient) and
    the partial sums reduced (the row-parallel all-reduces)."""
    return dict(_COUNTS)


def reset_counts():
    for k in _COUNTS:
        _COUNTS[k] = 0


class Run:
    """One run's model-axis state: the model group's size ``n``, this
    rank's coordinate ``rank`` and ``group`` (None at one rank), the vars
    that stay split at rest with their split dim (``dims``), and every
    value's layout (``layout``: an axis, ``PARTIAL``; a whole value is
    absent)."""

    def __init__(self, info, dims):
        self.n, self.rank, self.group = info.tp, info.tp_rank, info.tp_group
        self.dims = dict(dims)
        self.layout = dict(dims)
        self.gathered = []          # (op type, var) of this run's fallback
        self.whole = {}             # var -> (its split value, the whole)

    def block(self, size):
        """This rank's [lo, hi) of an axis of whole size ``size``."""
        per = size // self.n
        return self.rank * per, (self.rank + 1) * per

    def cut(self, v, axis):
        """This rank's block of a whole value at ``axis``."""
        lo, hi = self.block(v.shape[axis])
        return v.narrow(axis, lo, hi - lo)

    def set(self, name, lay):
        if lay is None:
            self.layout.pop(name, None)
        else:
            self.layout[name] = lay


def _register(*types):
    def deco(fn):
        for t in types:
            TABLE[t] = fn
        return fn

    return deco


def _norm(axis, ndim):
    return axis + ndim if axis < 0 else axis


def _names(op, env):
    return {slot: [n for n in names if n in env]
            for slot, names in op.inputs.items()}


def _reduce(run, name, v):
    """The sum of a partial-sum value over the model group, once a value."""
    done = run.whole.get(name)
    if done is not None and done[0] is v:
        return done[1]
    _COUNTS["partial_reductions"] += 1
    w = col.psum(v, TP)
    run.whole[name] = (v, w)
    return w


def _gather(op, run, name, v, lay):
    """The whole value of a split or partial-sum input, once a value."""
    if lay == PARTIAL:
        return _reduce(run, name, v)
    done = run.whole.get(name)
    if done is not None and done[0] is v:
        return done[1]
    _COUNTS["fallback_gathers"] += 1
    if name not in run.dims and not name.endswith("@GRAD"):
        _COUNTS["activation_gathers"] += 1
    run.gathered.append((op.type, name))
    w = col.all_gather(v, TP, lay)
    run.whole[name] = (v, w)
    return w


def _whole_ins(op, ins, names, run):
    """Every input whole: split values gathered, partial sums reduced."""
    out = {}
    for slot, vals in ins.items():
        ns = names.get(slot, [])
        out[slot] = [v if run.layout.get(n) is None
                     else _gather(op, run, n, v, run.layout[n])
                     for n, v in zip(ns, vals)]
    return out


def _reduced_ins(ins, names, run):
    """Partial sums reduced; split values kept."""
    out = {}
    for slot, vals in ins.items():
        ns = names.get(slot, [])
        out[slot] = [_reduce(run, n, v) if run.layout.get(n) == PARTIAL
                     else v for n, v in zip(ns, vals)]
    lay = {slot: [run.layout.get(n) if run.layout.get(n) != PARTIAL else None
                  for n in ns] for slot, ns in names.items()}
    return out, lay


def _batch_axis(ctx, name):
    dp = ctx.dp
    return None if dp is None else dp.axes.get(name)


def _record_batch(op, ctx, axis):
    """A rule this layer computes without the batch layer's (inner) rule:
    every output carries the batch where ``axis`` says."""
    if ctx.dp is not None:
        _batch_axes._record(op, ctx.dp, axis)


def wrap(call):
    """``call.rule`` (the batch-axis table's rule) behind the model-axis
    table, for a run at tp > 1 (``ctx.tp`` holds the run's ``Run``)."""
    rule, op = call.rule, call.op

    def tp_rule(ins, attrs, ctx):
        run = ctx.tp
        names = _names(op, ctx.env)
        touched = any(run.layout.get(n) is not None
                      for ns in names.values() for n in ns)
        res = None
        if touched:
            handler = TABLE.get(op.type)
            if handler is None and "Param" in op.inputs and \
                    op.type in OPTIMIZERS:
                handler = _optimizer
            if handler is not None:
                res = handler(rule, ins, names, attrs, ctx, run, op)
        if res is None:
            outs = rule(_whole_ins(op, ins, names, run) if touched else ins,
                        attrs, ctx)
            out_lay = None
        else:
            outs, out_lay = res
        return _finish(op, run, outs, out_lay)

    return tp_rule


def _finish(op, run, outs, out_lay):
    """Record each output's layout (``out_lay``: one layout for every
    output, or {slot: layout}); a var that stays split at rest is cut to
    this rank's block of its dim whatever the rule gave."""
    if not outs:
        return outs
    for slot, names in op.outputs.items():
        lay = out_lay.get(slot) if isinstance(out_lay, dict) else out_lay
        vals = outs.get(slot)
        for i, n in enumerate(names):
            want = run.dims.get(n)
            if want is not None and vals is not None and i < len(vals) \
                    and lay != want:
                v = vals[i]
                if lay is not None:
                    v = _gather(op, run, n, v, lay)
                vals[i] = run.cut(v, want).contiguous()
                run.set(n, want)
            else:
                run.set(n, lay)
    return outs


# -- the activations ---------------------------------------------------------

_UNARY = ("relu", "gelu", "sigmoid", "tanh", "exp", "log", "sqrt", "rsqrt",
          "square", "abs", "scale", "cast", "assign", "leaky_relu", "elu",
          "relu6", "softplus", "softsign", "swish", "hard_swish",
          "hard_sigmoid", "logsigmoid", "clip", "pow", "sign", "floor",
          "ceil", "round", "reciprocal", "erf", "brelu", "stanh",
          "thresholded_relu")


@_register(*_UNARY)
def _unary(rule, ins, names, attrs, ctx, run, op):
    """Element by element: a split layout passes through; a partial sum is
    reduced first."""
    ins, lay = _reduced_ins(ins, names, run)
    return rule(ins, attrs, ctx), lay["X"][0]


@_register("softmax", "log_softmax")
def _softmax(rule, ins, names, attrs, ctx, run, op):
    ins, lay = _reduced_ins(ins, names, run)
    a = lay["X"][0]
    if a is not None and a == _norm(int(attrs.get("axis", -1)),
                                    ins["X"][0].ndim):
        return None
    return rule(ins, attrs, ctx), a


@_register("transpose2")
def _transpose(rule, ins, names, attrs, ctx, run, op):
    ins, lay = _reduced_ins(ins, names, run)
    a = lay["X"][0]
    outs = rule(ins, attrs, ctx)
    if a is None:
        return outs, None
    perm = [_norm(int(p), ins["X"][0].ndim) for p in attrs["axis"]]
    return outs, {"Out": perm.index(a), "XShape": None}


@_register("reshape2")
def _reshape(rule, ins, names, attrs, ctx, run, op):
    """The shape resolved against the whole input (0 copies a dim, -1 is
    inferred); the split axis must lead the axes it merges with (or split
    into output axes whose first divides over the ranks).  The literal at
    that output axis is rewritten to this rank's size; a 0 there must copy
    the split input axis itself, and a -1 is inferred locally."""
    ins, lay = _reduced_ins(ins, names, run)
    a = lay["X"][0]
    if a is None:
        return rule(ins, attrs, ctx), None
    if ins.get("Shape") or ins.get("ShapeTensor"):
        return None
    v = ins["X"][0]
    whole = list(v.shape)
    whole[a] *= run.n
    attr = [int(s) for s in attrs["shape"]]
    shape = ([whole[i] if s == 0 else s for i, s in enumerate(attr[:v.ndim])]
             + attr[v.ndim:])
    if -1 in shape:
        i = shape.index(-1)
        rest = math.prod(s for j, s in enumerate(shape) if j != i)
        shape[i] = math.prod(whole) // rest if rest else 0
    lead = math.prod(whole[:a])
    k, prod = 0, 1
    while k < len(shape) and (prod != lead or shape[k] % run.n
                              or shape[k] < run.n):
        prod *= shape[k]
        k += 1
    if k == len(shape) or prod != lead:
        return None
    if attr[k] == 0 and k != a:
        return None
    if attr[k] > 0:
        attr[k] //= run.n
    return rule(ins, dict(attrs, shape=attr), ctx), {"Out": k,
                                                     "XShape": None}


# -- products ----------------------------------------------------------------

@_register("mul")
def _mul(rule, ins, names, attrs, ctx, run, op):
    """Y [in, out] flattened at ``y_num_col_dims`` = 1; X's contracted
    axes are those from ``x_num_col_dims``."""
    ins, lay = _reduced_ins(ins, names, run)
    lx, ly = lay["X"][0], lay["Y"][0]
    x, y = ins["X"][0], ins["Y"][0]
    xd = int(attrs.get("x_num_col_dims", 1))
    if int(attrs.get("y_num_col_dims", 1)) != 1 or y.ndim != 2:
        return None
    if ly == 1:                                           # column-parallel
        if lx is not None:      # gather the activation, never the weight
            ins = dict(ins, X=[_gather(op, run, names["X"][0], x, lx)])
        return rule(ins, attrs, ctx), xd
    if ly == 0 and x.ndim == xd + 1:                      # row-parallel
        if lx is None:
            ins = dict(ins, X=[run.cut(x, x.ndim - 1)])
        elif lx != x.ndim - 1:
            return None
        return rule(ins, attrs, ctx), PARTIAL
    if ly is None and lx is not None and lx < xd:         # split rows of X
        return rule(ins, attrs, ctx), lx
    return None


@_register("matmul")
def _matmul(rule, ins, names, attrs, ctx, run, op):
    """X and Y split on one batch-dim axis (the heads) give a split there
    (a whole operand spanning it is sliced); X split at its rows or Y at
    its columns, the other whole, give a split there; both split at the
    contracted axis, or one split there and the other sliced locally, give
    a partial sum."""
    ins, lay = _reduced_ins(ins, names, run)
    a, b = ins["X"][0], ins["Y"][0]
    la, lb = lay["X"][0], lay["Y"][0]
    if a.ndim < 2 or b.ndim < 2:
        return None
    nd = max(a.ndim, b.ndim)
    ta, tb = attrs.get("transpose_X", False), attrs.get("transpose_Y", False)
    # (tensor, layout, offset, output axis of its free matrix axis,
    #  its free matrix axis, its contracted axis)
    sides = [(a, la, nd - a.ndim, nd - 2, a.ndim - 1 if ta else a.ndim - 2,
              a.ndim - 2 if ta else a.ndim - 1),
             (b, lb, nd - b.ndim, nd - 1, b.ndim - 2 if tb else b.ndim - 1,
              b.ndim - 1 if tb else b.ndim - 2)]
    contracted = [s[1] is not None and s[1] == s[5] for s in sides]
    if any(contracted):
        new = []
        for (t, l, off, mo, free, con), c in zip(sides, contracted):
            if c:
                new.append(t)
            elif l is None:
                new.append(run.cut(t, con))
            else:
                return None
        return rule(dict(ins, X=[new[0]], Y=[new[1]]), attrs, ctx), PARTIAL
    found = set()
    for t, l, off, mo, free, con in sides:
        if l is None:
            continue
        found.add(off + l if l < t.ndim - 2 else mo)
    if len(found) != 1:
        return None
    p = found.pop()
    new = []
    for t, l, off, mo, free, con in sides:
        if l is None and p < nd - 2 and 0 <= p - off < t.ndim - 2 \
                and t.shape[p - off] != 1:
            t = run.cut(t, p - off)
        new.append(t)
    return rule(dict(ins, X=[new[0]], Y=[new[1]]), attrs, ctx), p


@_register("elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "elementwise_pow", "elementwise_max",
           "elementwise_min", "elementwise_mod", "elementwise_floordiv")
def _elementwise(rule, ins, names, attrs, ctx, run, op):
    """``ops/math_ops.py`` ``_bcast``: Y aligned to X at ``axis``, or
    numpy's trailing broadcast when ``axis`` is -1 or the ranks agree.
    Partial sums are reduced first."""
    ins, lay = _reduced_ins(ins, names, run)
    a, b = ins["X"][0], ins["Y"][0]
    la, lb = lay["X"][0], lay["Y"][0]
    ax = int(attrs.get("axis", -1))
    if ax == -1 or a.ndim == b.ndim:
        nd = max(a.ndim, b.ndim)
        offs = (nd - a.ndim, nd - b.ndim)
    else:
        nd, offs = a.ndim, (0, ax)
    pos = {off + l for l, off in ((la, offs[0]), (lb, offs[1]))
           if l is not None}
    if len(pos) != 1:
        return None
    p = pos.pop()
    new = []
    for t, l, off in ((a, la, offs[0]), (b, lb, offs[1])):
        if l is None and 0 <= p - off < t.ndim and t.shape[p - off] != 1:
            if t.shape[p - off] % run.n:
                return None
            t = run.cut(t, p - off)
        new.append(t)
    return rule(dict(ins, X=[new[0]], Y=[new[1]]), attrs, ctx), p


# -- random ops --------------------------------------------------------------

@_register("dropout")
def _dropout(rule, ins, names, attrs, ctx, run, op):
    """A split value: the mask of the whole value (the global batch's rows
    and the whole split axis), drawn as one rank draws it, cut to this
    rank's rows and block."""
    from ..ops import nn_ops

    ins, lay = _reduced_ins(ins, names, run)
    a = lay["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    if a is None or attrs.get("is_test", False) or p == 0.0:
        return rule(ins, attrs, ctx), a
    v = ins["X"][0]
    shape = list(v.shape)
    shape[a] *= run.n
    b = _batch_axis(ctx, names["X"][0])
    if b is not None and ctx.dp.group is not None:
        shape[b] *= ctx.dp.n
    u = nn_ops.dropout_draw(shape, attrs, ctx, v.device)
    if b is not None and ctx.dp.group is not None:
        lo, hi = ctx.dp.local(u.shape[b])
        u = u.narrow(b, lo, hi - lo)
    u = run.cut(u, a).contiguous()
    _record_batch(op, ctx, b)
    return nn_ops.dropout_apply(v, u, attrs), a


# -- lookups and the vocab-parallel loss ---------------------------------------

@_register("lookup_table", "lookup_table_v2")
def _lookup(rule, ins, names, attrs, ctx, run, op):
    """A col-split table gives rows split at their last axis; a row-split
    one the rows this rank owns (zeros elsewhere; ``embedding.py``'s
    owned-rows gather, its backward merging duplicate ids), a partial sum.
    Ids outside the whole table read NaN (on rank 0 alone, so the sum
    does) and a ``padding_idx`` row reads zeros, as the rule reads them."""
    ins, lay = _reduced_ins(ins, names, run)
    lw = lay["W"][0]
    if lay["Ids"][0] is not None:
        return None
    if lw == 1:
        outs = rule(ins, attrs, ctx)
        return outs, outs["Out"][0].ndim - 1
    if lw != 0:
        return None
    w, ids = ins["W"][0], ins["Ids"][0]
    rows = w.shape[0]
    V = rows * run.n
    flat = ids[..., 0] if ids.ndim > 1 and ids.shape[-1] == 1 else ids
    wrapped = torch.where(flat < 0, flat + V, flat)
    r = _owned_gather(w, wrapped, run.rank * rows)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    if run.rank == 0:
        bad = (wrapped < 0) | (wrapped >= V)
        r = torch.where(bad[..., None], float("nan"), r)
    pad = int(attrs.get("padding_idx", -1))
    if pad >= 0:
        r = torch.where((flat == pad)[..., None], zero, r)
    _record_batch(op, ctx, _batch_axis(ctx, names["Ids"][0]))
    return {"Out": [r]}, PARTIAL


@_register("softmax_with_cross_entropy")
def _softmax_xent(rule, ins, names, attrs, ctx, run, op):
    """Logits split at the class axis: the vocab-parallel loss, lse - picked
    with the max (without a gradient) the ranks' max, the exp-sum and the
    picked logit summed over the ranks; ``Softmax`` stays split.  A label
    outside the whole class range gives NaN, an ignored one 0, as the
    rule's."""
    from ..ops.common import promote_float

    ins, lay = _reduced_ins(ins, names, run)
    logits = promote_float(ins["Logits"][0])
    axis = int(attrs.get("axis", -1)) % logits.ndim
    if (lay["Logits"][0] != axis or lay["Label"][0] is not None
            or attrs.get("soft_label", False)):
        return None
    label = ins["Label"][0]
    li = label[..., 0] if label.ndim > 1 and label.shape[-1] == 1 else label
    li = li.long().unsqueeze(axis)
    local_n = logits.shape[axis]
    V = local_n * run.n
    mx = col.backend_all_reduce(logits.detach().amax(dim=axis, keepdim=True),
                                run.group, "max")
    e = torch.exp(logits - mx)
    s = col.psum(e.sum(dim=axis, keepdim=True), TP)
    lse = torch.log(s) + mx
    wrapped = torch.where(li < 0, li + V, li)
    lo = run.rank * local_n
    hit = (wrapped >= lo) & (wrapped < lo + local_n)
    picked = torch.gather(logits, axis, (wrapped - lo).clamp(0, local_n - 1))
    picked = col.psum(torch.where(hit, picked, 0.0), TP)
    loss = lse - picked
    in_range = (wrapped >= 0) & (wrapped < V)
    loss = torch.where(in_range, loss, float("nan"))
    ignore = int(attrs.get("ignore_index", -100))
    loss = torch.where(li == ignore, torch.zeros((), dtype=loss.dtype,
                                                 device=loss.device), loss)
    _record_batch(op, ctx, _batch_axis(ctx, names["Logits"][0]))
    return ({"Loss": [loss], "Softmax": [torch.exp(logits - lse)]},
            {"Loss": None, "Softmax": axis})


# -- the optimizer -------------------------------------------------------------

def _optimizer(rule, ins, names, attrs, ctx, run, op):
    """On a split parameter's block: every input of the parameter's whole
    shape that is not split is cut to this rank's block; LAMB's and LARS's
    norms are summed over the model group.  The outputs named as a split
    input (ParamOut, the moments) keep its split."""
    p_name = names["Param"][0]
    d = run.layout.get(p_name)
    if d is None or d == PARTIAL:
        return None
    p = ins["Param"][0]
    whole = list(p.shape)
    whole[d] *= run.n
    new = {}
    for slot, vals in ins.items():
        ns = names.get(slot, [])
        new[slot] = []
        for n, v in zip(ns, vals):
            lay = run.layout.get(n)
            if lay is not None and lay != d:
                v, lay = _gather(op, run, n, v, lay), None
            if lay is None and isinstance(v, torch.Tensor) \
                    and list(v.shape) == whole:
                v = run.cut(v, d)
            new[slot].append(v)
    if op.type in _batch_axes.NORM_SUMMED and run.group is not None:
        attrs = dict(attrs, _norm_group=run.group)
    outs = rule(new, attrs, ctx)
    split_names = {n for ns in names.values() for n in ns
                   if run.layout.get(n) == d} | {p_name}
    out_lay = {}
    for slot, ns in op.outputs.items():
        out_lay[slot] = d if ns and ns[0] in split_names else None
    return outs, out_lay
