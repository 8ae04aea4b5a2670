"""The batch-axis table of program-mode data parallelism (ROADMAP items
5-B and 5-B').

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
  products, convolutions, pools, lookups, normalisations over other axes,
  ``arg_max`` over another axis, the CTC and CRF ops, ``im2sequence``,
  ``hierarchical_sigmoid``, ``cos_sim``, and the LoD ops, whose lengths are
  feeds sharded with their rows);
- with attributes rewritten from the global to the local batch (``reshape2``
  resolves its shape against the global input, ``squeeze2`` the axes it
  drops), or on the global value, gathered, of which it keeps its rows
  (``expand`` tiling the batch axis, ``arg_max`` over it);
- with a collective over the batch: ``mean`` and ``reduce_*`` whose axes
  include the batch (sum, max or min over the ranks; a tied extreme's
  cotangent splits over every tied element of every rank, as ``jnp.max``'s),
  ``batch_norm`` in training (the global mean and mean square, through the
  rule's ``_sync_axis``), ``accuracy``, ``auc``, ``chunk_eval`` and
  ``edit_distance`` (their counts);
- drawing what the one-rank run draws for the global batch and keeping its
  rows (``dropout``, ``nce``'s negatives, ``uniform_random_batch_size_like``,
  ``gaussian_random_batch_size_like``), so a program at world n equals the
  port's world-1 run;
- ``scan``: its body's ops run through the table, one step's slice carrying
  the batch one axis lower than the time-major scanned input.

The table starts from every feed's dimension 0 (the reference shards every
feed; a ``-1`` in a var's shape does not mark the batch).  There is no
default: an op type that is not in the table and reads a batch-sharded value
raises, naming the op and item 5-B, as does an op of a ``while``,
``conditional_block`` or ``cond`` body that reads one.  An op whose inputs
are all replicated runs as it is, and its outputs are replicated.

The gradients come out as the one-device ones (``executor.py``): the
backward seeds a replicated loss's cotangent with 1/n on each rank (1/(n
tp) under tensor parallelism, ``model_axes.py``), every
collective above differentiates as a sum of the ranks' cotangents
(``collectives.py``'s ``_Psum`` and ``_AllGather``), and the dense
``@GRAD``s are summed over the ranks.  Under kReduce (``ReduceStrategy.
Reduce``) the optimizer accumulators hold 1/n of their rows a rank; the
optimizer ops that update a row from that row alone (``ROW_SEPARABLE``)
update their rows of the parameter, which is then gathered, a SelectedRows
gradient keeping the ids of those rows; LAMB and LARS (``NORM_SUMMED``) do
so with their norms summed over the ranks; any other op that reads such an
accumulator runs on whole tensors, the accumulators gathered, and keeps
this rank's rows of what it writes.

At one rank every entry runs the plain rule, so the data-parallel run of a
world of one is the plain run, bit for bit.
"""

import math

import torch

from ..sparse import SelectedRows
from . import collectives as col
from .mesh import DP

__all__ = ["TABLE", "ROW_SEPARABLE", "NORM_SUMMED", "Run", "wrap",
           "refuse"]

_ITEM = "ROADMAP Queue 1 item 5-B"


def refuse(what):
    return NotImplementedError(
        "%s under data parallelism is not in the batch-axis table (%s)"
        % (what, _ITEM))


class Run:
    """One data-parallel run's state: the data group's size ``n`` and this
    rank's ``rank`` in it, its collective group (None at one rank), the
    world's size (``world``: the data group times the model group of
    tensor parallelism, ``model_axes.py``), the batch axis of every
    batch-sharded var (``axes``; a replicated var is absent) and the
    kReduce accumulators held as 1/n of their rows (``rows``)."""

    def __init__(self, info, feed_names, rows=()):
        self.n, self.rank, self.group = info.n, info.rank, info.group
        # a layout without a model axis: the world is the data group
        self.world = getattr(info, "world", info.n)
        self.world_groups = getattr(
            info, "world_groups", () if info.group is None else (info.group,))
        self.local = info.rows          # this rank's [lo, hi) of an axis
        self.axes = dict.fromkeys(feed_names, 0)
        self.rows = set(rows)


TABLE = {}

# optimizer ops whose update of a row reads that row alone (and scalars):
# under kReduce each rank updates its rows of the parameter
ROW_SEPARABLE = {"sgd", "momentum", "adam", "adamax", "adagrad",
                 "decayed_adagrad", "adadelta", "rmsprop", "ftrl"}
# optimizer ops whose update reads whole-parameter norms: under kReduce each
# rank updates its rows with the norms summed over the ranks
NORM_SUMMED = {"lamb", "lars_momentum"}


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
    run's ``Run``).  ``in_sub_block``: the op lies in a ``while``,
    ``conditional_block`` or ``cond`` body (or a block inside one), where
    reading a batch-sharded value raises; a ``scan`` body's ops run through
    the table as the global block's do."""
    rule, op = call.rule, call.op

    def dp_rule(ins, attrs, ctx):
        run = ctx.dp
        in_axes = _slot_axes(op, ctx.env, run.axes)
        rows_in = [n for names in op.inputs.values() for n in names
                   if n in run.rows and n in ctx.env]
        sharded = [n for names in op.inputs.values() for n in names
                   if run.axes.get(n) is not None and n in ctx.env]
        if rows_in:
            if sharded or in_sub_block:
                raise refuse("op %r reading the kReduce-sharded accumulator "
                             "%s%s" % (op.type, rows_in[0], " in a sub-block"
                                       if in_sub_block else ""))
            outs = _kreduce_update(rule, op, ins, attrs, ctx, run)
            _record(op, run, None)
            return outs
        if in_sub_block or not (sharded or op.type == "scan"):
            if sharded:
                raise refuse("op %r in a sub-block, which reads the "
                             "batch-sharded %r," % (op.type, sharded[0]))
            outs = rule(ins, attrs, ctx)
            _record(op, run, None)
            return outs
        handler = TABLE.get(op.type)
        if handler is None:
            raise refuse("op %r, which reads the batch-sharded %r,"
                         % (op.type, sharded[0]))
        outs, out_axes = handler(rule, ins, in_axes, attrs, ctx, run, op.type)
        _record(op, run, out_axes)
        return outs

    return dp_rule


def _set_axis(run, name, axis):
    if axis is None:
        run.axes.pop(name, None)
    else:
        run.axes[name] = axis


def _record(op, run, out_axes):
    """Each output's batch axis: ``out_axes`` is one axis (or None) for
    every output, or {slot: axis, or a list of one axis a name}."""
    for slot, names in op.outputs.items():
        a = out_axes.get(slot) if isinstance(out_axes, dict) else out_axes
        for n, ax in zip(names, a if isinstance(a, list) else [a] * len(names)):
            _set_axis(run, n, ax)


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


@_register("arg_max", "arg_min")
def _arg_extreme(rule, ins, in_axes, attrs, ctx, run, op_type):
    """Row by row over another axis; over the batch axis, the rule on the
    global X (gathered), whose index is then the global row's."""
    v = ins["X"][0]
    a = _only_axis(op_type, in_axes)
    axis = _norm(int(attrs.get("axis", -1)), v.ndim)
    if axis != a:
        return rule(ins, attrs, ctx), a if a < axis else a - 1
    if run.group is None:
        return rule(ins, attrs, ctx), None
    whole = col.backend_all_gather(v.detach(), run.group, a)
    return rule(dict(ins, X=[whole]), attrs, ctx), None


def _check_rows(op_type, in_axes, weights=()):
    """Row by row over axis 0: the ``weights`` slots replicated, every other
    input sharded on axis 0 (lengths and labels are fed with their rows)."""
    _replicated(op_type, in_axes, weights)
    for slot, axes in in_axes.items():
        if slot not in weights and any(ax != 0 for ax in axes):
            raise refuse("op %r with its %s %s" % (
                op_type, slot, "replicated" if None in axes
                else "sharded on axis %s" % axes))


def _batch_rows(rule, ins, in_axes, attrs, ctx, op_type, weights=(),
                out_axes=0):
    _check_rows(op_type, in_axes, weights)
    return rule(ins, attrs, ctx), out_axes


@_register("im2sequence", "warpctc", "ctc_align", "crf_decoding",
           "linear_chain_crf", "hierarchical_sigmoid")
def _row_ops(rule, ins, in_axes, attrs, ctx, run, op_type):
    """Each row's image, sequence or tag path alone; the CRF's transition and
    the tree's weights replicated (``W_Out`` is the weight, replicated).
    ``ctc_align`` pads its output to the input's static length, so every
    rank's rows have one shape."""
    weights = {"linear_chain_crf": ("Transition",),
               "crf_decoding": ("Transition",),
               "hierarchical_sigmoid": ("W", "Bias")}.get(op_type, ())
    out_axes = ({"Out": 0, "PreOut": 0} if op_type == "hierarchical_sigmoid"
                else 0)
    return _batch_rows(rule, ins, in_axes, attrs, ctx, op_type, weights,
                       out_axes)


@_register("cos_sim")
def _cos_sim(rule, ins, in_axes, attrs, ctx, run, op_type):
    """Row cosines; a replicated Y of one row broadcasts over the rows."""
    ax, ay = in_axes["X"][0], in_axes["Y"][0]
    if ax != 0 or ay not in (0, None) or (ay is None
                                          and ins["Y"][0].shape[0] != 1):
        raise refuse("cos_sim with X on axis %s and Y on axis %s" % (ax, ay))
    return rule(ins, attrs, ctx), {"Out": 0, "XNorm": 0, "YNorm": ay}


@_register("expand")
def _expand(rule, ins, in_axes, attrs, ctx, run, op_type):
    """``jnp.tile``: a batch axis tiled once stays row by row; tiled more
    often, the global X is tiled (gathered, differentiably) and this rank
    keeps its rows of the global result."""
    v = ins["X"][0]
    a = _only_axis(op_type, in_axes)
    times = [int(t) for t in attrs["expand_times"]]
    lead = max(len(times) - v.ndim, 0)
    full = [1] * (v.ndim - len(times)) + times
    p = a + lead
    if full[p] == 1 or run.group is None:
        return rule(ins, attrs, ctx), p
    r = rule(dict(ins, X=[col.all_gather(v, DP, a)]), attrs, ctx)["Out"][0]
    lo, hi = run.local(r.shape[p])
    return {"Out": [r.narrow(p, lo, hi - lo)]}, p


# -- LoD ops: the padded rows with their lengths --------------------------------

@_register("sequence_pool", "sequence_conv", "sequence_reverse",
           "sequence_mask")
def _sequence(rule, ins, in_axes, attrs, ctx, run, op_type):
    """Padded rows [B, T, ...] with their lengths [B] (a feed, sharded with
    its rows): each row alone.  ``sequence_mask``'s static ``maxlen`` gives
    every rank one width."""
    return _batch_rows(rule, ins, in_axes, attrs, ctx, op_type,
                       ("Filter", "PaddingData"))


# -- scan bodies ------------------------------------------------------------------

@_register("scan")
def _scan(rule, ins, in_axes, attrs, ctx, run, op_type):
    """The body runs through the table: the scanned inputs are time-major,
    so one step's slice carries the batch one axis lower than ``Xs``; the
    carries keep the axes of their initial values (a body that moves one
    raises); ``Ys`` stack the steps on axis 0, the batch one axis higher
    than in the body."""
    carry_names, xs_names = attrs["carry_names"], attrs["xs_names"]
    carry_axes = list(in_axes.get("Carry", []))
    for n, ax in zip(carry_names, carry_axes):
        _set_axis(run, n, ax)
    for n, ax in zip(xs_names, in_axes.get("Xs", [])):
        if ax == 0:
            raise refuse("scan over its batch axis")
        _set_axis(run, n, None if ax is None else ax - 1)
    outs = rule(ins, attrs, ctx)
    moved = [n for n, ax in zip(carry_names, carry_axes)
             if run.axes.get(n) != ax]
    if moved:
        raise refuse("scan whose body moves the batch axis of its carry %r"
                     % moved[0])
    ys = [run.axes.get(n) for n in attrs["ys_names"]]
    return outs, {"CarryOut": carry_axes,
                  "Ys": [None if ax is None else ax + 1 for ax in ys]}


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
    "reduce_prod": lambda g: g.prod(dim=0),
    "reduce_all": lambda g: g.all(dim=0),
    "reduce_any": lambda g: g.any(dim=0),
}


class _Extreme(torch.autograd.Function):
    """``reduce_max`` / ``reduce_min`` over ``dims``, which hold the batch:
    the extreme of the ranks' local extremes (gathered, so that a NaN wins
    as in ``amax``), with ``jnp.max``'s cotangent rule over the global
    batch: the cotangent (the ranks' cotangents summed) splits evenly over
    every element of every rank that equals the extreme."""

    @staticmethod
    def forward(ctx, v, dims, shape, group, op):
        local = (v.amax if op == "max" else v.amin)(dim=dims, keepdim=True)
        gathered = col.backend_all_gather(local.unsqueeze(0), group, 0)
        m = gathered.amax(dim=0) if op == "max" else gathered.amin(dim=0)
        tie = v == m
        count = col.backend_all_reduce(tie.sum(dim=dims, keepdim=True), group)
        ctx.save_for_backward(tie, count)
        ctx.group = group
        return m.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        tie, count = ctx.saved_tensors
        g = col.backend_all_reduce(g, ctx.group).reshape(count.shape)
        share = g / count.to(g.dtype)
        return (torch.where(tie, share, torch.zeros_like(share)),
                None, None, None, None)


@_register("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
           *_REDUCE_GATHERED)
def _reduce(rule, ins, in_axes, attrs, ctx, run, op_type):
    """Over axes without the batch, row by row; over the batch, the local
    reduction, then a sum over the ranks (``reduce_sum``; ``reduce_mean``
    divides by the global count), the global extreme with its ties counted
    over the ranks (``_Extreme``), or the reduction of the ranks' results
    gathered (prod, all, any)."""
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
    if op_type in ("reduce_max", "reduce_min"):
        with torch.no_grad():
            shape = rule(ins, attrs, ctx)["Out"][0].shape
        return {"Out": [_Extreme.apply(v, tuple(sorted(set(dims))), shape,
                                       run.group, op_type[-3:])]}, None
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


@_register("chunk_eval")
def _chunk_eval(rule, ins, in_axes, attrs, ctx, run, op_type):
    """The three chunk counts summed over the ranks; precision, recall and
    F1 computed from the sums as the rule computes them."""
    from ..ops import misc_ops3

    outs, _ = _batch_rows(rule, ins, in_axes, attrs, ctx, op_type)
    if run.group is None:
        return outs, None
    counts = [col.backend_all_reduce(outs[k][0], run.group)
              for k in ("NumInferChunks", "NumLabelChunks",
                        "NumCorrectChunks")]
    return misc_ops3.chunk_scores(*counts), None


@_register("edit_distance")
def _edit_distance(rule, ins, in_axes, attrs, ctx, run, op_type):
    """Each row's distance; ``SequenceNum`` the ranks' counts summed."""
    outs, _ = _batch_rows(rule, ins, in_axes, attrs, ctx, op_type)
    if run.group is not None:
        outs = dict(outs, SequenceNum=[col.backend_all_reduce(
            outs["SequenceNum"][0], run.group)])
    return outs, {"Out": 0}


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


@_register("nce")
def _nce(rule, ins, in_axes, attrs, ctx, run, op_type):
    """The negatives the one-rank run draws for the global batch (one draw
    a row, ``ops/sampling_ops.py`` ``nce_negatives``), cut to this rank's
    rows; fixed ``custom_neg_classes`` are every row's."""
    from ..ops import sampling_ops

    weights = ("Weight", "Bias", "CustomDistProbs")
    if run.group is None or attrs.get("custom_neg_classes"):
        return _batch_rows(rule, ins, in_axes, attrs, ctx, op_type, weights)
    _check_rows(op_type, in_axes, weights)
    inp = ins["Input"][0]
    g = inp.shape[0] * run.n
    probs = ins.get("CustomDistProbs") or [None]
    negs = sampling_ops.nce_negatives(g, attrs, ctx, inp.device, probs[0])
    lo, hi = run.local(g)
    return sampling_ops.nce_apply(ins, attrs, negs[lo:hi]), 0


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

def _kreduce_update(rule, op, ins, attrs, ctx, run):
    """An optimizer op that reads a kReduce accumulator: a row-separable one
    on this rank's rows; LAMB and LARS on this rank's rows with their norms
    summed over the ranks (the rule's ``_norm_group``); any other on whole
    tensors (``_whole_update``)."""
    if op.type in NORM_SUMMED:
        if run.group is not None:
            attrs = dict(attrs, _norm_group=run.group)
        return _row_update(rule, op, ins, attrs, ctx, run)
    if op.type in ROW_SEPARABLE:
        return _row_update(rule, op, ins, attrs, ctx, run)
    return _whole_update(rule, op, ins, attrs, ctx, run)


def _local_rows(g, lo, hi):
    """A SelectedRows gradient on this rank's rows [lo, hi) of the table:
    an id in [-height, 0) counts from the end, as JAX indexing does, and
    an id outside the rank's rows points past them, where drop-mode writes
    drop it."""
    ids = torch.where(g.rows < 0, g.rows + g.height, g.rows) - lo
    ids = torch.where((ids >= 0) & (ids < hi - lo), ids, hi - lo)
    return SelectedRows(ids, g.values, hi - lo)


def _row_update(rule, op, ins, attrs, ctx, run):
    """Under kReduce: Param and Grad cut to this rank's rows (the
    accumulators already are; a SelectedRows gradient keeps the ids of
    those rows), the rule on those, and ParamOut gathered back to the whole
    parameter."""
    local = dict(ins)
    lo, hi = run.local(ins["Param"][0].shape[0])
    local["Param"] = [ins["Param"][0][lo:hi]]
    if "Grad" in ins:
        g = ins["Grad"][0]
        local["Grad"] = [_local_rows(g, lo, hi) if isinstance(g, SelectedRows)
                         else g[lo:hi]]
    outs = rule(local, attrs, ctx)
    if run.group is not None and "ParamOut" in outs:
        outs = dict(outs, ParamOut=[col.backend_all_gather(
            outs["ParamOut"][0].contiguous(), run.group, 0)])
    return outs


def _whole_update(rule, op, ins, attrs, ctx, run):
    """Under kReduce, an op that needs whole tensors: the accumulators' rows
    gathered, the rule on the whole parameter (its draws and its top-k are
    the one-rank run's), and this rank's rows kept of each accumulator it
    writes, so the state stays 1/n a rank at rest."""
    whole = {}
    for slot, vals in ins.items():
        names = [n for n in op.inputs[slot] if n in ctx.env]
        whole[slot] = [col.backend_all_gather(v.contiguous(), run.group, 0)
                       if n in run.rows and run.group is not None else v
                       for n, v in zip(names, vals)]
    outs = rule(whole, attrs, ctx)
    for slot, names in op.outputs.items():
        vals = outs.get(slot) or []
        for i, (n, v) in enumerate(zip(names, vals)):
            if n in run.rows:
                lo, hi = run.local(v.shape[0])
                vals[i] = v[lo:hi].contiguous()
    return outs
