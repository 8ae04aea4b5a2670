"""The batch-axis table of program-mode data parallelism (ROADMAP item 5-B).

The JAX package runs a data-parallel Fluid program as one GSPMD ``jit``
with every feed's dimension 0 split over the mesh's data axis
(``paddle_tpu/compiler.py`` ``_ShardingInfo``): XLA's partitioner makes the
sharded program compute what the one-device program computes, so every
reduction over the batch (the mean loss, batch-norm statistics, metrics) is
over the global batch.  The port runs the program once a rank, each rank on
its rows of the global batch, and this module says what that takes, op by
op: for each op type, which axis of each output carries the batch, and how
the op runs when it reads a batch-sharded value:

- on its local rows as its rule is (the elementwise and row-wise ops, the
  products, convolutions, pools, lookups, normalisations over other axes);
- with attributes rewritten from the global to the local batch (``reshape2``
  resolves its shape against the global input, ``squeeze2`` the axes it
  drops);
- with a collective over the batch: ``mean`` and ``reduce_*`` whose axes
  include the batch (sum, max or min over the ranks), ``batch_norm`` in
  training (the global mean and mean square, through the rule's
  ``_sync_axis``), ``accuracy`` and ``auc`` (their counts);
- drawing what the one-rank run draws for the global batch and keeping its
  rows (``dropout``, ``uniform_random_batch_size_like``,
  ``gaussian_random_batch_size_like``), so a program at world n equals the
  port's world-1 run.

The table starts from every feed's dimension 0 (the reference shards every
feed; a ``-1`` in a var's shape does not mark the batch).  There is no
default: an op type that is not in the table and reads a batch-sharded value
raises, naming the op and item 5-B, as does an op of a sub-block that reads
one.  An op whose inputs are all replicated runs as it is, and its outputs
are replicated.

The gradients come out as the one-device ones (``executor.py``): the
backward seeds a replicated loss's cotangent with 1/n on each rank, every
collective above differentiates as a sum of the ranks' cotangents
(``collectives.py``'s ``_Psum`` and ``_AllGather``), and the dense
``@GRAD``s are summed over the ranks.  Under kReduce (``ReduceStrategy.
Reduce``) the optimizer accumulators hold 1/n of their rows a rank; the
optimizer ops that update a row from that row alone (``ROW_SEPARABLE``)
update their rows of the parameter, which is then gathered; any other op
that reads such an accumulator raises.

At one rank every entry runs the plain rule, so the data-parallel run of a
world of one is the plain run, bit for bit.
"""

import math

import torch

from . import collectives as col
from .mesh import DP

__all__ = ["TABLE", "ROW_SEPARABLE", "Run", "wrap", "refuse"]

_ITEM = "ROADMAP Queue 1 item 5-B"


def refuse(what):
    return NotImplementedError(
        "%s under data parallelism is not in the batch-axis table (%s)"
        % (what, _ITEM))


class Run:
    """One data-parallel run's state: the world's size ``n`` and this
    rank's ``rank``, the collective group (None at one rank), the batch axis
    of every batch-sharded var (``axes``; a replicated var is absent) and
    the kReduce accumulators held as 1/n of their rows (``rows``)."""

    def __init__(self, info, feed_names, rows=()):
        self.n, self.rank, self.group = info.n, info.rank, info.group
        self.local = info.rows          # this rank's [lo, hi) of an axis
        self.axes = dict.fromkeys(feed_names, 0)
        self.rows = set(rows)


TABLE = {}

# optimizer ops whose update of a row reads that row alone (and scalars):
# under kReduce each rank updates its rows of the parameter
ROW_SEPARABLE = {"sgd", "momentum", "adam", "adamax", "adagrad",
                 "decayed_adagrad", "adadelta", "rmsprop", "ftrl"}


def _register(*types):
    def deco(fn):
        for t in types:
            TABLE[t] = fn
        return fn

    return deco


def _slot_axes(op, env, axes):
    """{slot: [batch axis or None]} in the order the executor builds the
    rule's inputs (names missing from env are skipped, as there)."""
    return {slot: [axes.get(n) for n in names if n in env]
            for slot, names in op.inputs.items()}


def wrap(call, in_sub_block=False):
    """``call.rule`` wrapped for a data-parallel run (``ctx.dp`` holds the
    run's ``Run``)."""
    rule, op = call.rule, call.op

    def dp_rule(ins, attrs, ctx):
        run = ctx.dp
        in_axes = _slot_axes(op, ctx.env, run.axes)
        rows_in = [n for names in op.inputs.values() for n in names
                   if n in run.rows and n in ctx.env]
        sharded = any(a is not None for v in in_axes.values() for a in v)
        if rows_in:
            if op.type not in ROW_SEPARABLE or sharded or in_sub_block:
                raise refuse("op %r reading the kReduce-sharded accumulator "
                             "%s" % (op.type, rows_in[0]))
            outs = _row_update(rule, op, ins, attrs, ctx, run)
            _record(op, run, None)
            return outs
        if not sharded:
            outs = rule(ins, attrs, ctx)
            _record(op, run, None)
            return outs
        name = next(n for names in op.inputs.values() for n in names
                    if run.axes.get(n) is not None and n in ctx.env)
        handler = TABLE.get(op.type)
        if handler is None or in_sub_block:
            raise refuse("op %r%s, which reads the batch-sharded %r,"
                         % (op.type, " in a sub-block" if in_sub_block else "",
                            name))
        outs, out_axes = handler(rule, ins, in_axes, attrs, ctx, run, op.type)
        _record(op, run, out_axes)
        return outs

    return dp_rule


def _record(op, run, out_axes):
    """Each output's batch axis: ``out_axes`` is one axis (or None) for
    every output, or {slot: axis}."""
    for slot, names in op.outputs.items():
        a = out_axes.get(slot) if isinstance(out_axes, dict) else out_axes
        for n in names:
            if a is None:
                run.axes.pop(n, None)
            else:
                run.axes[n] = a


def _only_axis(op_type, in_axes, slots=None):
    """The one batch axis of the inputs (of ``slots``); inputs sharded on
    different axes raise."""
    found = {a for s, v in in_axes.items() if slots is None or s in slots
             for a in v if a is not None}
    if len(found) != 1:
        raise refuse("op %r with inputs sharded on axes %s"
                     % (op_type, sorted(found)))
    return found.pop()


def _replicated(op_type, in_axes, slots):
    for s in slots:
        if any(a is not None for a in in_axes.get(s, [])):
            raise refuse("op %r with its %s sharded over the batch"
                         % (op_type, s))


def _norm(axis, ndim):
    return axis + ndim if axis < 0 else axis


def _global_shape(t, axis, n):
    shape = list(t.shape)
    shape[axis] *= n
    return shape


# -- row-wise ops: each output carries the batch where the input does ---------

@_register("relu", "gelu", "sigmoid", "tanh", "exp", "log", "sqrt", "rsqrt",
           "square", "abs", "scale", "cast", "assign", "leaky_relu", "elu",
           "relu6", "softplus", "softsign", "swish", "hard_swish",
           "hard_sigmoid", "logsigmoid", "clip", "pow", "sign", "floor",
           "ceil", "round", "reciprocal", "erf", "brelu", "stanh",
           "thresholded_relu", "label_smooth", "square_error_cost",
           "sigmoid_cross_entropy_with_logits", "huber_loss", "log_loss",
           "smooth_l1_loss", "sum", "where")
def _rowwise(rule, ins, in_axes, attrs, ctx, run, op_type, must_not=()):
    """Row by row: every input sharded at the same axis (a replicated
    operand would hold global rows), which is not one of ``must_not`` (the
    axes the op reduces or mixes)."""
    a = _only_axis(op_type, in_axes)
    if any(ax is None for v in in_axes.values() for ax in v):
        raise refuse("op %r mixing batch-sharded and replicated operands"
                     % op_type)
    if a in must_not:
        raise refuse("op %r reducing or mixing its batch axis %d" % (op_type, a))
    return rule(ins, attrs, ctx), a


def _broadcast(op_type, operands, out_nd):
    """The output axis of a broadcast: ``operands`` are (tensor, batch axis
    or None, its dims' offset into the output's).  Sharded operands must
    meet at one output axis, and a replicated operand must not span it."""
    pos = {off + a for t, a, off in operands if a is not None}
    if len(pos) != 1:
        raise refuse("op %r broadcasting the batch to axes %s"
                      % (op_type, sorted(pos)))
    p = pos.pop()
    for t, a, off in operands:
        if a is None and 0 <= p - off < t.ndim and t.shape[p - off] != 1:
            raise refuse("op %r broadcasting a replicated operand over the "
                         "batch axis" % op_type)
    if not 0 <= p < out_nd:
        raise refuse("op %r" % op_type)
    return p


@_register("elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "elementwise_pow", "elementwise_max",
           "elementwise_min", "elementwise_mod", "elementwise_floordiv")
def _elementwise(rule, ins, in_axes, attrs, ctx, run, op_type):
    """``ops/math_ops.py`` ``_bcast``: Y aligned to X at ``axis``, or
    numpy's trailing broadcast when ``axis`` is -1 or the ranks agree."""
    a, b = ins["X"][0], ins["Y"][0]
    ax = int(attrs.get("axis", -1))
    if ax == -1 or a.ndim == b.ndim:
        nd = max(a.ndim, b.ndim)
        offs = (nd - a.ndim, nd - b.ndim)
    else:
        nd, offs = a.ndim, (0, ax)
    p = _broadcast(op_type, [(a, in_axes["X"][0], offs[0]),
                             (b, in_axes["Y"][0], offs[1])], nd)
    return rule(ins, attrs, ctx), p


@_register("softmax", "log_softmax")
def _softmax(rule, ins, in_axes, attrs, ctx, run, op_type):
    v = ins["X"][0]
    return _rowwise(rule, ins, in_axes, attrs, ctx, run, op_type,
                    must_not=(_norm(int(attrs.get("axis", -1)), v.ndim),))


@_register("softmax_with_cross_entropy")
def _softmax_xent(rule, ins, in_axes, attrs, ctx, run, op_type):
    v = ins["Logits"][0]
    return _rowwise(rule, ins, in_axes, attrs, ctx, run, op_type,
                    must_not=(_norm(int(attrs.get("axis", -1)), v.ndim),))


@_register("cross_entropy", "top_k")
def _last_axis_rowwise(rule, ins, in_axes, attrs, ctx, run, op_type):
    """Over the last axis (the classes), row by row."""
    v = ins["X"][0]
    return _rowwise(rule, ins, in_axes, attrs, ctx, run, op_type,
                    must_not=(v.ndim - 1,))


@_register("layer_norm")
def _layer_norm(rule, ins, in_axes, attrs, ctx, run, op_type):
    """Statistics over the axes from ``begin_norm_axis``: the batch must
    come before them (Mean and Variance keep the leading axes)."""
    _replicated(op_type, in_axes, ("Scale", "Bias"))
    a = _only_axis(op_type, in_axes)
    if a >= int(attrs.get("begin_norm_axis", 1)):
        raise refuse("layer_norm normalising over its batch axis")
    return rule(ins, attrs, ctx), a


@_register("conv2d", "depthwise_conv2d", "conv3d", "conv2d_transpose",
           "pool2d", "pool3d")
def _images(rule, ins, in_axes, attrs, ctx, run, op_type):
    """Images batched on axis 0; the filter replicated."""
    _replicated(op_type, in_axes, ("Filter", "Bias"))
    a = _only_axis(op_type, in_axes)
    if a != 0:
        raise refuse("op %r with the batch on axis %d" % (op_type, a))
    return rule(ins, attrs, ctx), 0


@_register("batch_norm")
def _batch_norm(rule, ins, in_axes, attrs, ctx, run, op_type):
    """In training, the statistics are the global batch's: the rule's
    ``_sync_axis`` pmeans the mean and the mean square over the ranks, so
    the running statistics and the saved ones are replicated."""
    _replicated(op_type, in_axes, ("Scale", "Bias", "Mean", "Variance"))
    a = _only_axis(op_type, in_axes, ("X",))
    v = ins["X"][0]
    c_axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else v.ndim - 1
    if a == c_axis:
        raise refuse("batch_norm over a batch-sharded channel axis")
    training = not (attrs.get("is_test", False)
                    or attrs.get("use_global_stats", False))
    if training and run.group is not None:
        attrs = dict(attrs, _sync_axis=DP)
    return rule(ins, attrs, ctx), {"Y": a}


@_register("mul")
def _mul(rule, ins, in_axes, attrs, ctx, run, op_type):
    """X flattened at ``x_num_col_dims``: the batch must be a row axis."""
    _replicated(op_type, in_axes, ("Y",))
    a = _only_axis(op_type, in_axes)
    if a >= int(attrs.get("x_num_col_dims", 1)):
        raise refuse("mul contracting its batch axis")
    return rule(ins, attrs, ctx), a


@_register("matmul")
def _matmul(rule, ins, in_axes, attrs, ctx, run, op_type):
    """The batch on a batch dim of either side (broadcast as the batch dims
    are), on X's rows or on Y's columns; never on a contracted axis."""
    a, b = ins["X"][0], ins["Y"][0]
    if a.ndim < 2 or b.ndim < 2:
        raise refuse("matmul of a vector over the batch")
    nd = max(a.ndim, b.ndim)
    sides = ((a, in_axes["X"][0], nd - a.ndim, nd - 2,
              a.ndim - 1 if attrs.get("transpose_X", False) else a.ndim - 2),
             (b, in_axes["Y"][0], nd - b.ndim, nd - 1,
              b.ndim - 2 if attrs.get("transpose_Y", False) else b.ndim - 1))
    found = set()
    for t, axis, off, mat_out, mat_axis in sides:
        if axis is None:
            continue
        if axis < t.ndim - 2:
            found.add(off + axis)
        elif axis == mat_axis:
            found.add(mat_out)
        else:
            raise refuse("matmul contracting its batch axis")
    if len(found) != 1:
        raise refuse("matmul with the batch on axes %s" % sorted(found))
    p = found.pop()
    for t, axis, off, _, _ in sides:
        if (axis is None and p < nd - 2 and 0 <= p - off < t.ndim - 2
                and t.shape[p - off] != 1):
            raise refuse("matmul broadcasting a replicated operand over the "
                         "batch axis")
    return rule(ins, attrs, ctx), p


@_register("transpose2")
def _transpose(rule, ins, in_axes, attrs, ctx, run, op_type):
    a = _only_axis(op_type, in_axes)
    perm = [_norm(int(p), ins["X"][0].ndim) for p in attrs["axis"]]
    return rule(ins, attrs, ctx), {"Out": perm.index(a)}


@_register("reshape2")
def _reshape(rule, ins, in_axes, attrs, ctx, run, op_type):
    """The shape resolved against the global input (0 copies a dim, -1 is
    inferred), then the global batch's rows cut to this rank's: the batch
    must lead the flattened layout of the axes it merges with."""
    if ins.get("Shape") or ins.get("ShapeTensor"):
        raise refuse("reshape2 with a shape tensor")
    v = ins["X"][0]
    a = _only_axis(op_type, in_axes)
    g_in = _global_shape(v, a, run.n)
    shape = [int(s) for s in attrs["shape"]]
    shape = ([g_in[i] if s == 0 else s for i, s in enumerate(shape[:v.ndim])]
             + shape[v.ndim:])
    if -1 in shape:
        i = shape.index(-1)
        rest = math.prod(s for j, s in enumerate(shape) if j != i)
        shape[i] = math.prod(g_in) // rest if rest else 0
    lead = math.prod(g_in[:a])
    k, prod = 0, 1
    while k < len(shape) and (prod != lead or shape[k] % run.n
                              or shape[k] < run.n):
        prod *= shape[k]
        k += 1
    if k == len(shape) or prod != lead:
        raise refuse("reshape2 of %s to %s mixing the batch with the axes "
                     "before it" % (g_in, shape))
    shape[k] //= run.n
    return rule(ins, dict(attrs, shape=shape), ctx), {"Out": k}


@_register("flatten2")
def _flatten(rule, ins, in_axes, attrs, ctx, run, op_type):
    a = _only_axis(op_type, in_axes)
    if a != 0 or int(attrs.get("axis", 1)) < 1:
        raise refuse("flatten2 merging the batch with another axis")
    return rule(ins, attrs, ctx), {"Out": 0}


@_register("squeeze2")
def _squeeze(rule, ins, in_axes, attrs, ctx, run, op_type):
    """The axes the global squeeze drops: a local batch of one stays."""
    v = ins["X"][0]
    a = _only_axis(op_type, in_axes)
    g = _global_shape(v, a, run.n)
    axes = [_norm(int(x), v.ndim) for x in attrs.get("axes") or []] or \
        [i for i, s in enumerate(g) if s == 1]
    axes = [x for x in axes if g[x] == 1]
    if not axes:
        return {"Out": [v], "XShape": [v.new_zeros((0,))]}, {"Out": a}
    return (rule(ins, dict(attrs, axes=axes), ctx),
            {"Out": a - sum(1 for x in set(axes) if x < a)})


@_register("unsqueeze2")
def _unsqueeze(rule, ins, in_axes, attrs, ctx, run, op_type):
    a = _only_axis(op_type, in_axes)
    nd = ins["X"][0].ndim
    for x in sorted(int(x) for x in attrs["axes"]):
        x = x + nd + 1 if x < 0 else x
        if x <= a:
            a += 1
        nd += 1
    return rule(ins, attrs, ctx), {"Out": a}


@_register("stack")
def _stack(rule, ins, in_axes, attrs, ctx, run, op_type):
    a = _only_axis(op_type, in_axes)
    if any(x is None for x in in_axes["X"]):
        raise refuse("stack of batch-sharded and replicated operands")
    s = _norm(int(attrs.get("axis", 0)), ins["X"][0].ndim + 1)
    return rule(ins, attrs, ctx), a if a < s else a + 1


@_register("concat")
def _concat(rule, ins, in_axes, attrs, ctx, run, op_type):
    a = _only_axis(op_type, in_axes)
    if any(x is None for x in in_axes["X"]):
        raise refuse("concat of batch-sharded and replicated operands")
    if _norm(int(attrs.get("axis", 0)), ins["X"][0].ndim) == a:
        raise refuse("concat along the batch axis")
    return rule(ins, attrs, ctx), a


@_register("split")
def _split(rule, ins, in_axes, attrs, ctx, run, op_type):
    v = ins["X"][0]
    return _rowwise(rule, ins, in_axes, attrs, ctx, run, op_type,
                    must_not=(_norm(int(attrs.get("axis", 0)), v.ndim),))


@_register("slice")
def _slice(rule, ins, in_axes, attrs, ctx, run, op_type):
    v = ins["Input"][0]
    return _rowwise(rule, ins, in_axes, attrs, ctx, run, op_type,
                    must_not=tuple(_norm(int(x), v.ndim)
                                   for x in attrs["axes"]))


@_register("lookup_table", "lookup_table_v2")
def _lookup(rule, ins, in_axes, attrs, ctx, run, op_type):
    """Rows of a replicated table at batch-sharded ids (a trailing ids dim
    of 1, which the rule drops, cannot be the batch)."""
    _replicated(op_type, in_axes, ("W",))
    ids = ins["Ids"][0]
    a = _only_axis(op_type, in_axes)
    if ids.ndim > 1 and ids.shape[-1] == 1 and a == ids.ndim - 1:
        raise refuse("%s with the batch on the dropped ids axis" % op_type)
    return rule(ins, attrs, ctx), a


@_register("one_hot")
def _one_hot(rule, ins, in_axes, attrs, ctx, run, op_type):
    v = ins["X"][0]
    a = _only_axis(op_type, in_axes)
    if v.ndim > 1 and v.shape[-1] == 1 and a == v.ndim - 1:
        raise refuse("one_hot with the batch on the dropped axis")
    return rule(ins, attrs, ctx), a


# -- reductions over the batch: a collective -----------------------------------

@_register("mean")
def _mean(rule, ins, in_axes, attrs, ctx, run, op_type):
    """The global mean: the ranks' sums over the global count."""
    if run.group is None:
        return rule(ins, attrs, ctx), None
    v = ins["X"][0]
    v = v if v.is_floating_point() else v.float()
    total = col.psum(v.sum(), DP)
    return {"Out": [(total / (v.numel() * run.n)).reshape(())]}, None


_REDUCE_GATHERED = {
    "reduce_max": lambda g: g.amax(dim=0),
    "reduce_min": lambda g: g.amin(dim=0),
    "reduce_prod": lambda g: g.prod(dim=0),
    "reduce_all": lambda g: g.all(dim=0),
    "reduce_any": lambda g: g.any(dim=0),
}


@_register("reduce_sum", "reduce_mean", *_REDUCE_GATHERED)
def _reduce(rule, ins, in_axes, attrs, ctx, run, op_type):
    """Over axes without the batch, row by row; over the batch, the local
    reduction, then a sum over the ranks (``reduce_sum``; ``reduce_mean``
    divides by the global count) or the reduction of the ranks' results
    gathered (max, min, prod, all, any)."""
    v = ins["X"][0]
    a = _only_axis(op_type, in_axes)
    keep = bool(attrs.get("keep_dim", False))
    if attrs.get("reduce_all", False):
        dims = tuple(range(v.ndim))
    else:
        dims = tuple(_norm(int(d), v.ndim) for d in attrs.get("dim", [0]))
    if a not in dims:
        return rule(ins, attrs, ctx), (a if keep else
                                       a - sum(1 for d in set(dims) if d < a))
    if run.group is None:
        return rule(ins, attrs, ctx), None
    if op_type == "reduce_mean":
        r = (v if v.is_floating_point() else v.float()).sum(dim=dims,
                                                            keepdim=keep)
        count = math.prod(v.shape[d] for d in set(dims)) * run.n
        return {"Out": [col.psum(r, DP) / count]}, None
    r = rule(ins, attrs, ctx)["Out"][0]
    if op_type == "reduce_sum":
        return {"Out": [col.psum(r, DP)]}, None
    gathered = col.all_gather(r.unsqueeze(0), DP, 0)
    return {"Out": [_REDUCE_GATHERED[op_type](gathered)]}, None


@_register("accuracy")
def _accuracy(rule, ins, in_axes, attrs, ctx, run, op_type):
    """The ranks' correct counts summed, over the global row count."""
    a = _only_axis(op_type, in_axes)
    outs = rule(ins, attrs, ctx)
    if a != 0:
        raise refuse("accuracy with the batch on axis %d" % a)
    if run.group is None:
        return outs, None
    correct = col.backend_all_reduce(outs["Correct"][0], run.group)
    total = int(ins["Indices"][0].shape[0]) * run.n
    return {"Accuracy": [(correct.float().sum() / total).reshape(())],
            "Correct": [correct],
            "Total": [torch.full_like(outs["Total"][0], total)]}, None


@_register("auc")
def _auc(rule, ins, in_axes, attrs, ctx, run, op_type):
    """The batch's histograms are each rank's counts summed; the streaming
    statistics and the AUC follow from them as in the one-device rule (run
    again on no rows over the summed statistics)."""
    _replicated(op_type, in_axes, ("StatPos", "StatNeg"))
    if run.group is None:
        return rule(ins, attrs, ctx), None
    zeros = {k: [torch.zeros_like(ins[k][0])] for k in ("StatPos", "StatNeg")}
    local = rule(dict(ins, **zeros), attrs, ctx)
    stats = {k: [ins[k][0] + col.backend_all_reduce(local[k + "Out"][0],
                                                    run.group)]
             for k in ("StatPos", "StatNeg")}
    empty = {k: [ins[k][0][:0]] for k in ("Predict", "Label")}
    return rule(dict(ins, **empty, **stats), attrs, ctx), None


# -- random ops: the global batch's draws, this rank's rows ---------------------

@_register("dropout")
def _dropout(rule, ins, in_axes, attrs, ctx, run, op_type):
    """The mask the one-rank run draws for the global batch, cut to this
    rank's rows (``ops/nn_ops.py`` ``dropout_draw`` and ``dropout_apply``)."""
    from ..ops import nn_ops

    a = _only_axis(op_type, in_axes)
    v = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    if run.group is None or attrs.get("is_test", False) or p == 0.0:
        return rule(ins, attrs, ctx), a
    u = nn_ops.dropout_draw(_global_shape(v, a, run.n), attrs, ctx, v.device)
    lo, hi = run.local(u.shape[a])
    return nn_ops.dropout_apply(v, u.narrow(a, lo, hi - lo).contiguous(),
                                attrs), a


@_register("fill_constant_batch_size_like", "uniform_random_batch_size_like",
           "gaussian_random_batch_size_like")
def _batch_size_like(rule, ins, in_axes, attrs, ctx, run, op_type):
    """Shaped by Input's ``input_dim_idx``: from the batch axis, the output
    carries the batch on ``output_dim_idx``; a random one draws for the
    global batch (the rule on a shape-only global Input) and keeps this
    rank's rows."""
    v = ins["Input"][0]
    a = _only_axis(op_type, in_axes)
    ii = _norm(int(attrs.get("input_dim_idx", 0)), v.ndim)
    oi = int(attrs.get("output_dim_idx", 0))
    if ii != a:
        return rule(ins, attrs, ctx), None
    if op_type == "fill_constant_batch_size_like" or run.group is None:
        return rule(ins, attrs, ctx), oi
    meta = torch.empty(_global_shape(v, a, run.n), device="meta")
    r = rule(dict(ins, Input=[meta]), attrs, ctx)["Out"][0]
    oi = _norm(oi, r.ndim)
    lo, hi = run.local(r.shape[oi])
    return {"Out": [r.narrow(oi, lo, hi - lo).contiguous()]}, oi


# -- kReduce: the optimizer on this rank's rows ----------------------------------

def _row_update(rule, op, ins, attrs, ctx, run):
    """A row-separable optimizer op under kReduce: its Param and Grad cut to
    this rank's rows (the accumulators already are), the rule on those, and
    ParamOut gathered back to the whole parameter."""
    if not all(isinstance(v, torch.Tensor) for vs in ins.values() for v in vs):
        raise refuse("op %r with a SelectedRows gradient under kReduce"
                     % op.type)
    local = dict(ins)
    for slot in ("Param", "Grad"):
        if slot in ins:
            t = ins[slot][0]
            lo, hi = run.local(t.shape[0])
            local[slot] = [t[lo:hi]]
    outs = rule(local, attrs, ctx)
    if run.group is not None and "ParamOut" in outs:
        outs = dict(outs, ParamOut=[col.backend_all_gather(
            outs["ParamOut"][0].contiguous(), run.group, 0)])
    return outs
