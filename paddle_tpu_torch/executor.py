"""Executor: runs a Program op by op on ``torch`` tensors.

Parity surface: python/paddle/fluid/executor.py:418 (Executor.run with
feed/fetch_list/scope) and framework/executor.cc:192 (C++ Executor::Run).

Counterpart of the JAX package's ``executor.py``: its ``_lower`` (forward,
one autodiff step, optimizer ops) with the sparse-lookup and AMP branches,
run eagerly instead of traced and compiled.  The forward ops run with the
dense parameters as fresh leaves that require grad; ``torch.autograd.grad``
of the summed loss gives each ``<param>@GRAD``; the ops after the backward
section (the optimizer) run under ``torch.no_grad()``; the persistables
they write go back to the scope.  What the JAX executor caches as a
compiled step, this one caches as an analysed plan (op rules, sections,
state names, sparse tables), keyed by program version, feed shapes and
fetch names.

- Sparse lookups (``lookup_table(is_sparse=True)``): an eligible table
  (``_find_sparse_lookups``) is not a leaf; each of its lookups' gathered
  rows is, so its gradient is a ``sparse.SelectedRows`` of (ids, row
  gradients) and the [V, D] dense gradient never exists.  An ineligible
  table warns once and takes the dense gradient.
- AMP (a program ``amp.decorate`` tagged): the float32 params and env
  values are cast to bfloat16 at the forward's boundary; the loss is summed
  in f32, so the gradients come back f32 for the f32 masters; the optimizer
  section sees the f32 masters, moments and LR state again, and state the
  forward wrote (``batch_norm``'s running stats) is cast back to its dtype.

Sub-blocks (``while``, ``conditional_block``, ``cond``, ``scan``) run
through ``OpLoweringContext.interpret_block``: each block's op rules are
looked up once, when the plan is made, and a control-flow rule runs its
sub-block's list on a copy of the env as often as it needs.

Data parallelism (a ``with_data_parallel`` CompiledProgram, or a program
``fleet.distributed_optimizer`` or the transpiler tagged, as the JAX
executor's ``:942-956`` wraps one): every rank is fed the global batch and
keeps its rows (``compiler._ShardingInfo``); each op runs through the
batch-axis table (``parallel/batch_axes.py``), so every reduction over the
batch is global; the backward seeds a replicated loss's cotangent with 1/n
and the dense gradients are summed over the ranks (a ``SelectedRows``
gradient gathers every rank's ids and rows), so the optimizer section runs
on the one-device gradients, on identical values on every rank.
Batch-shaped fetches are gathered to the global value.  Under kReduce the
marked accumulators stay 1/n of their rows a rank in the scope.  With
``tensor_parallel_degree`` = tp > 1 the world is a (data, model) mesh:
each rank holds its block of every ``tp_split``-marked var (``Scope``
records the split), every rule runs behind the model-axis table
(``parallel/model_axes.py``) outside the batch-axis one, a replicated
loss's cotangent is seeded with 1/(dp * tp), a whole parameter's gradient
is summed over the world and a split one's over the data group, and a
fetch of a split value or a partial sum is gathered whole.  A
GeoSGD-tagged program runs locally, and its started ``Communicator`` ticks
after each run.  A started ``py_reader`` injects the global batch, which
the run slices like any feed; ``feed_converter`` of a data-parallel program
stages only this rank's rows (cut on the host before the copy), which the
run takes as they are.

The monitor's hooks sit where the JAX executor's sit in its ``_run``
(``monitor/``): the spans ``executor.run``, ``executor.feed_convert``,
``executor.compile`` (the plan build, on a plan-cache miss, which the
recompile detector records with the key split into the reference's named
parts), ``executor.dispatch`` and ``executor.device_sync``; the
``feed_stall`` and ``compute`` phases; ``record_step`` with a sampled
``device_ms`` from CUDA events around the dispatch (synchronised only on a
sampled step); MemScope's plan ledger, measured on the plan's first run,
and its headroom check before each later dispatch; the chaos points
``nan_batch`` and ``oom_step``; the sentinel's health bundle and guard
before the state commits to the scope; ``FLAGS_check_nan_inf`` through
``localize_nonfinite``; and the memory sample after the commit.  With the
monitor off, a run launches exactly what it launched before the hooks: the
same kernels in the same order, with no extra sync.

The data path (``trainer.py``): a started ``py_reader`` of the program
injects its next staged batch as the feed and raises ``EOFException`` at
the end, as the JAX executor's does; ``train_from_dataset`` and
``infer_from_dataset`` drive a Dataset through ``feed_pipe.DeviceFeedPipe``
(``feed_converter`` stages each batch on the card off the training thread)
with lazy fetches, and the executor's ``InFlightWindow`` bounds how many
lazily fetched steps may be outstanding (``drain`` waits for them all).

A ``PipelineOptimizer`` program runs as the JAX executor's pipeline
branch (``:617-748``): the forward split at the cut vars into sections,
run in turn on each microbatch of the batch-major feeds with the forward's
persistable outputs carried over, the gradients accumulated and scaled
(1/M for a mean or unknown loss, 1 for a sum), the optimizer section once.
Data-parallel, each rank holds its rows of every global microbatch
(``_ShardingInfo.shard_feed``), so each microbatch is the one-device run's.

The JAX executor's other branches (recompute, the warm store) raise
``NotImplementedError`` naming the ROADMAP item that brings them; none
quietly runs another path.
"""

import contextlib
import os
import time
import warnings

import numpy as np
import torch

from . import monitor as _monitor
from .dtypes import convert_dtype, numpy_dtype
from .feed_pipe import InFlightWindow, make_feed_convert, make_placer
from .enforce import EnforceNotMet, NotDifferentiable, format_op_error
from .flags import globals_ as _flags
from .ft import chaos as _chaos
from .monitor import memscope as _memscope
from .monitor import sentinel as _sentinel
from .monitor import trace as _trace
from .framework import Parameter, Program, Variable, default_main_program
from .compiler import CompiledProgram, is_data_parallel
from .kernels._common import resolve_device
from .parallel import batch_axes as _batch_axes
from .parallel import model_axes as _model_axes
from .parallel.collectives import backend_all_gather, backend_all_reduce
from .registry import OpLoweringContext, get_lowering
from .scope import global_scope
from .sparse import SelectedRows

__all__ = ["Executor"]


def _as_fetch_name(f):
    return f.name if isinstance(f, Variable) else f


def _collect_state_names(program):
    """Split persistable vars into (read-before-written, written) sets by a
    forward walk — the run's state input and output."""
    written = set()
    reads = set()
    persistable = {
        v.name for v in program.list_vars() if v.persistable
    }
    for block in program.blocks:
        for op in block.ops:
            for n in op.input_arg_names:
                if n in persistable and n not in written:
                    reads.add(n)
            for n in op.output_arg_names:
                if n in persistable:
                    written.add(n)
    return sorted(reads), sorted(written | reads)


def _refuse_unported(program):
    """Raise for a program that asks for a branch of the JAX executor the
    port does not have yet."""
    for op in program.global_block().ops:
        if op.type == "backward_meta" and op.attrs.get("use_remat"):
            raise NotImplementedError(
                "recompute (RecomputeOptimizer / use_remat) waits (ROADMAP "
                "Queue 1 item 3)")


def _loss_reduction(fwd_ops, loss_name):
    """'mean' / 'sum' / 'unknown' by the op producing the loss: decides the
    microbatch gradient scale of a PipelineOptimizer program (JAX
    ``executor.py:391``)."""
    producer = None
    for op in fwd_ops:
        if loss_name in op.output_arg_names:
            producer = op
    if producer is None:
        return "unknown"
    if producer.type in ("mean", "reduce_mean"):
        return "mean"
    if producer.type in ("sum", "reduce_sum"):
        return "sum"
    return "unknown"


def _split_sections(fwd_ops, cut_names):
    """Partition the forward ops at the cut variables (the PipelineOptimizer
    contract, ref optimizer.py:3020; JAX ``executor.py:510``): section k
    ends with the op producing cut_names[k]; K cuts -> K+1 sections."""
    sections, cur = [], []
    remaining = list(cut_names)
    for op in fwd_ops:
        cur.append(op)
        if remaining and remaining[0] in op.output_arg_names:
            sections.append(cur)
            cur = []
            remaining.pop(0)
    if remaining:
        raise ValueError(
            "pipeline cut vars %r are not produced by the forward section "
            "in order" % (remaining,))
    sections.append(cur)
    return sections


def _feed_microbatches(program, name):
    """The microbatches a feed splits into: a PipelineOptimizer program's
    batch-major feeds (declared with a -1 leading dim) split into
    ``num_microbatches``; every other feed stays whole (1)."""
    pipeline = getattr(program, "_pipeline", None)
    if pipeline is None:
        return 1
    var = program.global_block()._find_var_recursive(name)
    if var is None or not var.shape or var.shape[0] != -1:
        return 1
    return int(pipeline["num_microbatches"])


# optimizer ops with a SelectedRows branch (ops/optimizer_ops.py); any other
# terminal consumer of a sparse gradient makes the table take the dense
# gradient, as in the JAX executor
_SPARSE_GRAD_CONSUMERS = {"sgd", "momentum", "adam", "adagrad"}

# gradient transforms the JAX executor lets a sparse gradient through (the
# regularizer's scale/sign + sum, the clips); the port's rules for sum,
# scale and the elementwise binaries keep it sparse, and a clip the port
# lacks raises "no lowering registered" as any unported op does
_SPARSE_GRAD_TRANSFORMS = {"sum", "clip", "clip_by_norm", "scale",
                           "elementwise_mul", "elementwise_div"}

# index-preserving ops an Ids tensor may pass through between the feed and
# the lookup: the derived ids can be computed from the feeds alone, ahead
# of the forward
_IDS_CHAIN_OPS = {"reshape", "reshape2", "squeeze", "squeeze2", "unsqueeze",
                  "unsqueeze2", "slice", "concat", "split", "cast",
                  "transpose", "transpose2", "assign"}

_SPARSE_FALLBACK_WARNED = set()


def _first_unsupported_consumer(w_grad, rest_ops, block):
    """None when every consumer chain from ``w_grad`` reaches an optimizer
    op with a SelectedRows branch through sparse-capable transforms, else
    the op type that breaks a chain (JAX ``executor.py:161``)."""
    frontier = {w_grad}
    seen = set()
    while frontier:
        name = frontier.pop()
        if name in seen:
            continue
        seen.add(name)
        for op in rest_ops:
            if name not in op.input_arg_names:
                continue
            if op.type in _SPARSE_GRAD_CONSUMERS:
                continue
            if op.type == "squared_l2_norm":
                continue        # reduces to a dense scalar; the chain ends
            if op.type in _SPARSE_GRAD_TRANSFORMS:
                if op.type in ("elementwise_mul", "elementwise_div"):
                    # only a sparse X by a scalar Y stays sparse
                    if op.inputs.get("X", [None])[0] != name:
                        return op.type
                    y = block._find_var_recursive(
                        (op.inputs.get("Y") or [None])[0])
                    yshape = tuple(getattr(y, "shape", ()) or ())
                    if any(int(d) != 1 for d in yshape):
                        return op.type
                frontier.update(op.output_arg_names)
                continue
            return op.type
    return None


def _ids_chain(ids_name, fwd_ops, feed_names):
    """The ops, in program order, that derive ``ids_name`` from feeds
    through index-preserving ops; [] if it is a feed; None if it cannot be
    derived so (JAX ``executor.py:407``)."""
    if ids_name in feed_names:
        return []
    producer, writes = {}, {}
    for op in fwd_ops:
        for n in op.output_arg_names:
            producer[n] = op
            writes[n] = writes.get(n, 0) + 1
    chain, seen = [], set()

    def walk(name):
        if name in feed_names:
            return True
        op = producer.get(name)
        if op is None or op.type not in _IDS_CHAIN_OPS:
            return False
        if writes.get(name, 0) > 1:
            return False        # which write the lookup reads is unclear
        if id(op) in seen:
            return True
        if not all(walk(i) for i in op.input_arg_names):
            return False
        seen.add(id(op))
        chain.append(op)
        return True

    if not walk(ids_name):
        return None
    order = {id(op): i for i, op in enumerate(fwd_ops)}
    chain.sort(key=lambda op: order[id(op)])
    return chain


def _warn_sparse_fallback(program, w, reason):
    key = (id(program), w)
    if key in _SPARSE_FALLBACK_WARNED:
        return
    _SPARSE_FALLBACK_WARNED.add(key)
    warnings.warn(
        "lookup_table(is_sparse=True) on table %r falls back to the DENSE "
        "gradient path (%s); the full [V, D] gradient will materialize"
        % (w, reason), stacklevel=3)


def _find_sparse_lookups(program, fwd_ops, rest_ops, param_names, feed_names):
    """Tables eligible for the SelectedRows gradient (JAX
    ``executor.py:458``): every forward use of the table is an
    ``is_sparse`` lookup whose Ids come from the feed (directly or through
    index-preserving ops), and every consumer of its ``@GRAD`` is an
    optimizer op with a sparse branch.  Returns {table: [(op, ids_name,
    attrs, chain_ops)]}; an ineligible ``is_sparse`` table warns once."""
    uses = {}
    eligible = {}
    for op in fwd_ops:
        for n in op.input_arg_names:
            if n in param_names:
                uses.setdefault(n, []).append(op)
    lookups = ("lookup_table", "lookup_table_v2")
    for w, ops_using in uses.items():
        wants_sparse = any(op.type in lookups and op.attrs.get("is_sparse")
                           for op in ops_using)
        specs, reason = [], None
        for op in ops_using:
            if (op.type in lookups and op.attrs.get("is_sparse")
                    and op.inputs.get("W", [None])[0] == w):
                ids_name = op.inputs.get("Ids", [None])[0]
                chain = _ids_chain(ids_name, fwd_ops, feed_names)
                if chain is None:
                    specs, reason = None, (
                        "Ids %r are not derivable from feeds by "
                        "index-preserving ops" % ids_name)
                    break
                specs.append((op, ids_name, op.attrs, chain))
            else:
                specs, reason = None, (
                    "table has a non-sparse-lookup use (%s)" % op.type)
                break
        if specs is not None:
            bad = _first_unsupported_consumer(
                w + "@GRAD", rest_ops, program.global_block())
            if bad is not None:
                specs, reason = None, (
                    "gradient consumer %r has no SelectedRows branch" % bad)
        if specs:
            eligible[w] = specs
        elif wants_sparse:
            _warn_sparse_fallback(program, w, reason or "ineligible")
    return eligible


def refuse_warm_dir():
    """The warm executable store (the executor's and the exported
    predictor's persistence) is not ported."""
    if os.environ.get("PADDLE_TPU_WARM_DIR", "").strip():
        raise NotImplementedError(
            "PADDLE_TPU_WARM_DIR: the warm executable store waits (ROADMAP "
            "Queue 1 item 8)")


_MONITOR_IDENT_SEQ = [0]


def _resolve_parallel(program, device):
    """``(program, data-parallel layout or None, GeoSGD communicator or
    None)`` for a run (JAX ``executor.py:922-960``): a CompiledProgram
    unwraps to its program and layout; a fleet- or transpiler-tagged program
    runs data-parallel through a CompiledProgram made once from its
    strategy; a GeoSGD-tagged one runs locally and ticks its started
    communicator."""
    if isinstance(program, CompiledProgram):
        return (program._program_for_run(), program._sharding_info(device),
                None)
    if not isinstance(program, Program):
        raise TypeError("Executor.run takes a Program or a CompiledProgram, "
                        "not %s" % type(program).__name__)
    dist_info = getattr(program, "_dist_info", None)
    if dist_info is not None and dist_info.get("mode") == "geo":
        comm = getattr(program, "_communicator", None)
        if comm is None and not getattr(program, "_geo_warned", False):
            program._geo_warned = True
            warnings.warn(
                "geo_sgd_mode program running WITHOUT a started "
                "Communicator: training is purely local (replicas never "
                "reconcile) — create distributed.Communicator(program) and "
                "call start()")
        return program, None, comm
    if not is_data_parallel(program):
        return program, None, None
    compiled = getattr(program, "_fleet_compiled", None)
    if compiled is None:
        compiled = CompiledProgram(program).with_data_parallel(
            build_strategy=getattr(program, "_fleet_strategy", None))
        program._fleet_compiled = compiled
    return program, compiled._sharding_info(device), None


def _shard_rows(dp, scope, block, env):
    """kReduce: the marked accumulators whose rows divide over the ranks, in
    ``env`` as this rank's rows (cut from a whole value a startup program or
    a load left in the scope).  Returns their names."""
    rows = set()
    for n in dp.shard_state_names:
        var = block._find_var_recursive(n)
        if (n not in env or var is None or not dp.row_sharded(var.shape)
                or dp.tp_dim(n, var.shape) is not None):
            continue        # a tensor-parallel split wins over kReduce
        rows.add(n)
        if scope.row_shards(n) != dp.n:
            lo, hi = dp.rows(env[n].shape[0])
            env[n] = env[n][lo:hi].clone()
    return rows


def _split_model(dp, scope, block, env):
    """Tensor parallelism: the marked state vars whose split dim divides,
    in ``env`` as this rank's block of that dim (cut from a whole value a
    startup program or a load left in the scope).  Returns {name: dim}."""
    dims = {}
    for n in dp.tp_specs:
        var = block._find_var_recursive(n)
        if n not in env or var is None:
            continue
        d = dp.tp_dim(n, tuple(var.shape))
        if d is None:
            continue
        dims[n] = d
        if scope.split(n) != (d, dp.tp):
            k = env[n].shape[d] // dp.tp
            env[n] = env[n].narrow(d, dp.tp_rank * k, k).clone()
    return dims


def _tp_global(dp, tp, name, t, whole):
    """A value's whole value over the model axis: a split one gathered, a
    partial sum reduced (a fetch, ``whole``), or kept as this rank's block
    where it stays split at rest (state)."""
    if tp is None:
        return t
    lay = tp.layout.get(name)
    if lay is None or (not whole and name in tp.dims):
        return t
    if lay == _model_axes.PARTIAL:
        return backend_all_reduce(t, dp.tp_group)
    return backend_all_gather(t.contiguous(), dp.tp_group, lay)


def _dp_global(dp, run, name, t, whole_rows):
    """A data-parallel run's value of ``name`` as the one-device run has it:
    a batch-sharded one gathered on its axis; a kReduce accumulator gathered
    when ``whole_rows`` (a fetch), else kept as this rank's rows."""
    if name in run.rows:
        return dp.gather(t, 0) if whole_rows else t
    axis = run.axes.get(name)
    return t if axis is None else dp.gather(t, axis)


class _LocalRows(dict):
    """A feed ``Executor.feed_converter`` staged for a data-parallel
    program: this rank's rows of each value, with each feed's global row
    count (``global_rows``)."""

    def __init__(self, feed, global_rows):
        super().__init__(feed)
        self.global_rows = global_rows


def _dp_rows(dp, feed, name, value, microbatches=1):
    """This rank's rows of a feed value: a value the feed converter staged
    is taken as it is when it holds the local rows of its global batch,
    cut when it holds the global batch, and refused otherwise; any other
    value is the global batch (``_ShardingInfo.shard_feed``, this rank's
    part of each of ``microbatches`` microbatches)."""
    total = (feed.global_rows.get(name) if isinstance(feed, _LocalRows)
             else None)
    if total is None:
        return dp.shard_feed(name, value, microbatches)
    rows = int(value.shape[0]) if value.ndim else None
    if total % dp.n == 0 and rows == total // dp.n:
        return value
    if rows == total:
        return dp.shard_feed(name, value, microbatches)
    raise ValueError(
        "feed %r was staged with %s rows of a global batch of %d, which is "
        "neither the global batch nor its 1/%d a rank"
        % (name, rows, total, dp.n))


def _monitor_ident(obj, prefix):
    """Stable telemetry identity for a Program/Executor, stored on the
    object (a dead object's recycled id must not make a fresh object's
    first plan look like a rebuild of the old one's)."""
    ident = getattr(obj, "_monitor_ident", None)
    if ident is None:
        _MONITOR_IDENT_SEQ[0] += 1
        ident = obj._monitor_ident = "%s#%d" % (prefix, _MONITOR_IDENT_SEQ[0])
    return ident


class _OpCall:
    """One op with its rule, and for each output whether it is detached: a
    non-persistable stop_gradient var, as the JAX executor's
    ``stop_gradient`` at the same place."""

    def __init__(self, op, block):
        self.op = op
        self.rule = get_lowering(op.type)
        self.outputs = []
        for slot, names in op.outputs.items():
            flags = []
            for n in names:
                var = block._find_var_recursive(n)
                flags.append(var is not None and var.stop_gradient
                             and not isinstance(var, Parameter)
                             and not var.persistable)
            self.outputs.append((slot, list(zip(names, flags))))


def _run_calls(calls, env, ctx):
    """Run ops in order on the tensors in ``env`` (the analogue of the
    executor.cc:445 per-op loop)."""
    for c in calls:
        op = c.op
        ins = {slot: [env[n] for n in names if n in env]
               for slot, names in op.inputs.items()}
        ctx.env = env  # control-flow rules read carried vars by name
        try:
            outs = c.rule(ins, op.attrs, ctx)
        except (EnforceNotMet, NotDifferentiable):
            raise
        except Exception as e:
            # PADDLE_ENFORCE-style context: name the op and the user code
            # that built it (enforce.py; op_call_stack.cc parity)
            raise EnforceNotMet(format_op_error(op, e)) from e
        for slot, named in c.outputs:
            vals = outs.get(slot, []) if outs else []
            for (n, detach), v in zip(named, vals):
                env[n] = v.detach() if detach else v


class _Plan:
    """A program analysed for one run key: its state names, its global
    block's ops split at the backward section and each sub-block's ops, each
    op with its rule, and the tables whose gradient is sparse."""

    def __init__(self, program, feed_names=(), dense=()):
        _refuse_unported(program)
        self.program = program
        self.feed_names = list(feed_names)
        block = program.global_block()
        self.state_in, self.state_out = _collect_state_names(program)
        self.sub = {b.idx: [_OpCall(op, b) for op in b.ops]
                    for b in program.blocks[1:]}
        ops = block.ops
        bwd_idxs = [i for i, op in enumerate(ops) if op.type == "backward_meta"]
        if len(bwd_idxs) > 1:
            raise NotImplementedError(
                "program has %d backward sections (append_backward + "
                "gradients() combined?); the executor runs exactly one — "
                "compute extra gradients in a separate program, or via "
                "gradients() alone" % len(bwd_idxs))
        self.sparse = {}
        self.written_in_fwd = set()
        self.pipeline = None
        if not bwd_idxs:
            self.fwd, self.rest = [_OpCall(op, block) for op in ops], []
            self.loss_name, self.param_names = None, []
            return
        i = bwd_idxs[0]
        fwd_ops, rest_ops = ops[:i], ops[i + 1:]
        self.loss_name = ops[i].attrs["loss_name"]
        self.param_names = list(ops[i].attrs["param_names"])
        self.fwd = [_OpCall(op, block) for op in fwd_ops]
        self.rest = [_OpCall(op, block) for op in rest_ops]
        self.written_in_fwd = {n for op in fwd_ops for n in op.output_arg_names}
        amp = getattr(program, "_amp", None)
        self.amp_dtype = (torch.bfloat16 if amp and amp.get("enabled")
                          else None)
        pipeline = getattr(program, "_pipeline", None)
        if pipeline is not None:
            self._plan_pipeline(pipeline, fwd_ops)
            return
        # sparse tables: each lookup's output is its gathered rows, a leaf
        # of its own, so autograd yields row gradients (JAX executor.py
        # :747-767)
        specs = _find_sparse_lookups(program, fwd_ops, rest_ops,
                                     set(self.param_names), set(feed_names))
        for w in set(specs) & set(dense):
            _warn_sparse_fallback(program, w, "a tensor-parallel split table "
                                  "takes the dense gradient")
            del specs[w]
        by_op = {id(c.op): c for c in self.fwd}
        for w, lookups in specs.items():
            self.sparse[w] = []
            for k, (op, ids_name, attrs, chain) in enumerate(lookups):
                leaf = "@ROWS@%s@%d" % (w, k)
                by_op[id(op)].rule = (
                    lambda ins, attrs_, ctx, leaf=leaf:
                    {"Out": [ctx.env[leaf]]})
                self.sparse[w].append(
                    (leaf, ids_name, attrs, [by_op[id(c)] for c in chain]))

    def _plan_pipeline(self, pipeline, fwd_ops):
        """A PipelineOptimizer program (JAX ``executor.py:617-748``): the
        forward split at the cut vars into sections (run in turn on each
        microbatch), the gradient scale from the loss's reduction (1/M for
        a mean or an unknown one, which warns; 1 for a sum), the forward's
        persistable outputs carried from microbatch to microbatch, and the
        dense gradient for ``is_sparse`` lookups, which warn."""
        self.pipeline = dict(pipeline)
        by_op = {id(c.op): c for c in self.fwd}
        self.sections = [[by_op[id(op)] for op in sec] for sec in
                         _split_sections(fwd_ops, pipeline["cut_vars"])]
        for op in fwd_ops:
            if (op.type in ("lookup_table", "lookup_table_v2")
                    and op.attrs.get("is_sparse")):
                _warn_sparse_fallback(
                    self.program, op.inputs.get("W", ["?"])[0],
                    "PipelineOptimizer accumulates dense grads")
        reduction = _loss_reduction(fwd_ops, pipeline["loss_name"])
        if reduction == "unknown":
            warnings.warn(
                "PipelineOptimizer: cannot tell whether loss %r is mean- or "
                "sum-reduced; assuming mean (grads and loss divided by "
                "num_microbatches)" % pipeline["loss_name"], stacklevel=4)
        M = int(pipeline["num_microbatches"])
        self.pipeline_scale = 1.0 / M if reduction != "sum" else 1.0
        self.pers_written = sorted(self.written_in_fwd & set(self.state_out))

    def distribute(self, model=False):
        """Every rule behind the batch-axis table, for a data-parallel run:
        a ``scan`` body's ops go through the table; an op of any other
        sub-block (a ``while``, ``conditional_block`` or ``cond`` body, or
        a block inside one) may read no batch-sharded value.  ``model``
        (tp > 1): every rule behind the model-axis table too, outside the
        batch-axis one."""
        owner = {}
        for block in self.program.blocks:
            for op in block.ops:
                for key in ("sub_block_index", "true_block_index",
                            "false_block_index"):
                    if key in op.attrs:
                        owner[int(op.attrs[key])] = (op.type, block.idx)

        def closed(idx):
            if idx == 0:
                return False
            kind, parent = owner.get(idx, (None, 0))
            return kind != "scan" or closed(parent)

        for c in self.fwd + self.rest:
            c.rule = _batch_axes.wrap(c)
        for idx, calls in self.sub.items():
            for c in calls:
                c.rule = _batch_axes.wrap(c, in_sub_block=closed(idx))
        if model:
            for c in self.fwd + self.rest + [c for calls in self.sub.values()
                                             for c in calls]:
                c.rule = _model_axes.wrap(c)
        return self

    def context(self, generator):
        """The rules' context for one run: sub-blocks run from this plan."""
        ctx = OpLoweringContext(self.program, generator)
        ctx.interpret_block = lambda idx, env: self.interpret_block(
            idx, env, ctx)
        return ctx

    def interpret_block(self, idx, env, ctx):
        """Run sub-block ``idx`` on a copy of ``env``; returns the copy."""
        env = dict(env)
        _run_calls(self.sub[idx], env, ctx)
        return env

    def _sparse_rows(self, env, ctx):
        """Each sparse lookup's gathered rows as a leaf that requires grad,
        by leaf name; the ids a lookup reads are made first from the feeds
        when an index-preserving chain derives them."""
        lookup = get_lowering("lookup_table")
        leaves = {}
        for w, lookups in self.sparse.items():
            for leaf, ids_name, attrs, chain in lookups:
                if ids_name not in env:
                    _run_calls(chain, env, ctx)
                rows = lookup({"W": [env[w]], "Ids": [env[ids_name]]},
                              attrs, ctx)["Out"][0]
                leaves[leaf] = rows.detach().requires_grad_(True)
        return leaves

    def _sparse_grad(self, env, w, grads, dp=None, ctx=None):
        """``w@GRAD`` as a SelectedRows of the lookups' ids and row
        gradients; a ``padding_idx`` id points at the out-of-range
        sentinel, so its row does not train (JAX executor.py:824-845).
        Data-parallel, the ids and rows of every rank, in rank order."""
        height = env[w].shape[0]
        ids_parts, val_parts = [], []
        tp = getattr(ctx, "tp", None) if ctx is not None else None
        for leaf, ids_name, attrs, _ in self.sparse[w]:
            g = grads[leaf]
            ids = env[ids_name]
            if tp is not None and tp.group is not None:
                # each rank of the model group holds a summand of the rows'
                # gradient (a whole table's convention)
                g = backend_all_reduce(g, tp.group)
            if dp is not None and dp.group is not None:
                ids, g = _gather_rows(dp, ids_name, ids, g)
            if ids.ndim > 1 and ids.shape[-1] == 1:
                ids = ids[..., 0]
            ids = ids.reshape(-1)
            pad = int(attrs.get("padding_idx", -1))
            if pad >= 0:
                ids = torch.where(ids == pad, height, ids)
            ids_parts.append(ids)
            val_parts.append(g.reshape(-1, g.shape[-1]))
        return SelectedRows(torch.cat(ids_parts), torch.cat(val_parts),
                            height)

    def _fwd_bwd(self, env, leaves, calls, ctx):
        """``calls`` run on ``env`` with ``leaves`` as the parameters, and
        the loss's gradients into the leaves (zero for a leaf the loss does
        not reach, as jax.grad gives it).  AMP: bf16 compute with f32
        masters, float32 values cast at the forward's boundary, ints as they
        are.  Returns (the forward's env, the loss, the gradients by name);
        the forward's env is ``env`` itself without AMP."""
        amp = self.amp_dtype
        if amp is None:
            env.update(leaves)
        else:
            env = {k: _amp_cast(v, amp) for k, v in env.items()}
            env.update({k: _amp_cast(v, amp) for k, v in leaves.items()})
        dp = ctx.dp
        with torch.enable_grad():
            _run_calls(calls, env, ctx)
            loss = env[self.loss_name].float().sum()
        seed = None
        if (dp is not None and dp.world > 1
                and self.loss_name not in dp.axes):
            # a replicated loss: each rank seeds 1/world of its cotangent
            # (the world: the data group times the model group), every
            # collective's backward sums the ranks' cotangents, and the
            # gradients are summed over the ranks (``_update``)
            seed = torch.full_like(loss, 1.0 / dp.world)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    grad_outputs=seed, allow_unused=True)
        return env, loss, {
            n: torch.zeros_like(leaves[n]) if g is None else g
            for n, g in zip(leaves, grads)}

    def _update(self, env, ctx, grads):
        """The dense gradients (data-parallel: a whole parameter's summed
        over the data and model groups, a tensor-parallel split one's over
        the data group) into ``env`` as ``p@GRAD``, then the optimizer
        section."""
        dp, tp = ctx.dp, getattr(ctx, "tp", None)
        for name, g in grads.items():
            if dp is not None:
                d = None if tp is None else tp.dims.get(name)
                groups = dp.world_groups if d is None else (dp.group,)
                for group in groups:
                    if group is not None:
                        g = backend_all_reduce(g, group)
                if d is not None:
                    tp.set(name + "@GRAD", d)
            env[name + "@GRAD"] = g
        with torch.no_grad():
            _run_calls(self.rest, env, ctx)

    def _run_pipeline(self, env, ctx):
        """The microbatch loop: each microbatch of the batch-major feeds
        through the sections, with the forward's persistables carried over
        and its gradients accumulated; then the loss and the gradients
        scaled, and the optimizer section run once (AMP: f32 gradients for
        the f32 masters, written persistables back in their own dtype).
        Data-parallel, each rank holds its rows of every global microbatch,
        and the gradients are summed over the ranks."""
        M = int(self.pipeline["num_microbatches"])
        feed_mb = {}
        for n in self.feed_names:
            if _feed_microbatches(self.program, n) == 1:
                continue
            a = env[n]
            if a.shape[0] % M:
                raise ValueError(
                    "batch dim %d of feed %r does not divide into %d "
                    "microbatches" % (a.shape[0], n, M))
            feed_mb[n] = a.reshape((M, a.shape[0] // M) + tuple(a.shape[1:]))
        if not feed_mb:
            raise ValueError(
                "PipelineOptimizer: no batch-major feeds to microbatch "
                "(declare inputs via layers.data with append_batch_size=True)")
        params = {p: env[p] for p in self.param_names if p in env}
        base = {k: v for k, v in env.items() if k not in params}
        carry = {n: env[n] for n in self.pers_written if n in env}
        acc = {p: torch.zeros_like(v) for p, v in params.items()}
        acc_loss = torch.zeros((), device=next(iter(feed_mb.values())).device)
        sections = [c for sec in self.sections for c in sec]
        for m in range(M):
            leaves = {p: v.detach().requires_grad_(True)
                      for p, v in params.items()}
            e = dict(base)
            e.update(carry)       # the previous microbatch's written state
            e.update({n: v[m] for n, v in feed_mb.items()})
            e, loss, grads = self._fwd_bwd(e, leaves, sections, ctx)
            for p, g in grads.items():
                acc[p] += g
            acc_loss = acc_loss + loss.detach()
            carry = {n: e[n].detach().to(env[n].dtype) for n in carry}
        env.update(carry)           # the last microbatch's written state
        env[self.loss_name] = acc_loss * self.pipeline_scale
        self._update(env, ctx, {p: g * self.pipeline_scale
                                for p, g in acc.items()})

    def run(self, env, ctx):
        if self.loss_name is None:
            with torch.no_grad():
                _run_calls(self.fwd, env, ctx)
            return
        if self.pipeline is not None:
            return self._run_pipeline(env, ctx)
        dense = [p for p in self.param_names
                 if p in env and p not in self.sparse]
        with torch.no_grad():
            leaves = self._sparse_rows(env, ctx)
        leaves.update({p: env[p].detach().requires_grad_(True)
                       for p in dense})
        fwd_env, _, grads = self._fwd_bwd(env, leaves, self.fwd, ctx)
        if fwd_env is not env:
            # AMP: the optimizer section sees the f32 masters, moments and
            # LR state; state the forward wrote (batch_norm's running stats)
            # comes back in its own dtype
            for k, v in fwd_env.items():
                orig = env.get(k)
                if orig is None:
                    env[k] = v
                elif k in self.written_in_fwd:
                    env[k] = v.to(orig.dtype)
        for name in dense:
            env[name] = leaves[name].detach()
        for w in self.sparse:
            for leaf, *_ in self.sparse[w]:
                env.pop(leaf, None)
            env[w + "@GRAD"] = self._sparse_grad(env, w, grads, ctx.dp, ctx)
        self._update(env, ctx, {p: grads[p] for p in dense})


def _gather_rows(dp, ids_name, ids, g):
    """A sparse lookup's ids and row gradients from every rank: gathered in
    rank order where the ids carry the batch on axis 0, summed where they
    are replicated (each rank then holds a part of every row's gradient)."""
    from .parallel.collectives import backend_all_gather

    axis = dp.axes.get(ids_name)
    if axis is None:
        return ids, backend_all_reduce(g, dp.group)
    if axis != 0:
        raise _batch_axes.refuse("a sparse lookup whose ids carry the batch "
                                 "on axis %d" % axis)
    return (backend_all_gather(ids.contiguous(), dp.group, 0),
            backend_all_gather(g.contiguous(), dp.group, 0))


def _amp_cast(v, dtype):
    if isinstance(v, torch.Tensor) and v.dtype == torch.float32:
        return v.to(dtype)
    return v


class Executor:
    """Parity: executor.py:418.  ``place`` names the device:
    ``CPUPlace()`` the CPU, ``CUDAPlace(i)`` (or its second name
    ``TPUPlace(i)``) card i.  With no place it runs on the card, and raises
    without one."""

    def __init__(self, place=None):
        self.place = place
        self.device = resolve_device(None if place is None else place.device())
        self._cache = {}
        self._step = 0
        # async-fetch depth governor (feed_pipe.py): bounds outstanding
        # lazy-fetch runs to K steps (PADDLE_TPU_MAX_INFLIGHT, default 2)
        self.inflight = InFlightWindow()

    def drain(self):
        """Wait for every outstanding lazy-fetch run, so run wall times
        measure completed work, not queued work."""
        self.inflight.drain()

    def close(self):
        """Parity: executor.cc:110-118 Executor::Close -> SendComplete —
        waits for outstanding runs, drops the cached plans, and marks this
        worker complete for the failure monitor
        (``distributed/heartbeat.py``)."""
        from .distributed import heartbeat as _hb

        self.drain()
        self._cache.clear()
        _hb.notify_complete()

    def feed_converter(self, program=None):
        """The feed-conversion closure ``feed_dict -> staged feed`` for use
        OFF the training thread (the DeviceFeedPipe stage): declared dtypes
        applied, and on a card the copy through a pinned buffer started on
        a side stream, so the copy of batch k+1 overlaps step k.  ``run``
        takes the staged tensors as they are.  For a data-parallel program
        the closure stages this rank's rows of the global batch (cut on the
        host, so a rank copies 1/n of the batch), marked so that ``run``
        does not cut them again."""
        program = program if program is not None else default_main_program()
        program, dp, _ = _resolve_parallel(program, self.device)
        block = program.global_block()

        def dtype_of(name):
            var = block._find_var_recursive(name)
            if var is None:
                return None
            try:
                return numpy_dtype(var.dtype)
            except ValueError:
                return None          # bfloat16: run() casts the tensor

        placer = make_placer(self.device)
        if dp is None:
            return make_feed_convert(dtype_of, placer)

        def local_placer(arrays):
            # data-parallel: this rank's rows, cut on the host before the
            # copy, marked with each feed's global row count
            rows = {n: int(v.shape[0]) if len(getattr(v, "shape", ()))
                    else None for n, v in arrays.items()}
            staged = placer({n: dp.shard_feed(
                n, v, _feed_microbatches(program, n))
                for n, v in arrays.items()})
            if isinstance(staged, dict):
                return _LocalRows(staged, rows)
            staged.feed = _LocalRows(staged.feed, rows)
            return staged

        return make_feed_convert(dtype_of, local_placer)

    def infer_from_dataset(self, *args, **kwargs):
        from .trainer import _run_from_dataset

        return _run_from_dataset(self, *args, train=False, **kwargs)

    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, **kwargs):
        """Parity: executor.py:1093 — the dataset/trainer path."""
        from .trainer import _run_from_dataset

        return _run_from_dataset(self, program=program, dataset=dataset,
                                 scope=scope, thread=thread, train=True,
                                 **kwargs)

    def _feed_tensor(self, block, name, value):
        """A feed value as a tensor on this executor's device, in the var's
        declared dtype (int64 ids stay int64)."""
        var = block._find_var_recursive(name)
        if isinstance(value, torch.Tensor):
            dtype = convert_dtype(var.dtype) if var is not None else value.dtype
            return value.to(self.device, dtype)
        arr = np.asarray(value, dtype=numpy_dtype(var.dtype)
                         if var is not None else None)
        return torch.tensor(arr, device=self.device)

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, use_program_cache=True):
        """Run ``program`` once: feed by name, fetch by name or Variable,
        state read from and written back to ``scope``.  Returns the fetches
        as numpy arrays, or as tensors on the device when ``return_numpy``
        is false."""
        with _trace.span("executor.run"):
            return self._run(program, feed, fetch_list, scope, return_numpy,
                             use_program_cache)

    def _run(self, program, feed, fetch_list, scope, return_numpy,
             use_program_cache):
        mon = _monitor.active()
        t_start = time.perf_counter() if mon is not None else 0.0
        sent = getattr(mon, "sentinel", None) if mon is not None else None
        program = program if program is not None else default_main_program()
        program, dp, geo = _resolve_parallel(program, self.device)
        refuse_warm_dir()
        feed = feed or {}
        # py_reader-fed programs (layers/io.py py_reader): a started reader
        # injects its next staged batch as the feed (data-parallel: the
        # global batch, sliced below); exhaustion raises EOFException, as the
        # reference's read_file does at the end of an epoch
        for rdr in getattr(program, "_py_readers", ()):
            feed = rdr._inject_feed(feed)
        fetch_names = [_as_fetch_name(f) for f in (fetch_list or [])]
        scope = scope if scope is not None else global_scope()
        block = program.global_block()
        ident = None
        if mon is not None:
            # the telemetry identity of (program, this executor): tags the
            # plan's ledger and compile events and every step record
            ident = "%s@%s" % (_monitor_ident(program, "Program"),
                               _monitor_ident(self, "Exec"))
            _memscope.note_scope(scope)
        t_feed = time.perf_counter()
        with _trace.span("executor.feed_convert"):
            # data-parallel: this rank's rows of the global batch (a feed
            # the feed converter staged holds them already)
            feed_tensors = {n: self._feed_tensor(
                block, n, v if dp is None else _dp_rows(
                    dp, feed, n, v, _feed_microbatches(program, n)))
                for n, v in feed.items()}
        if mon is not None:
            mon.phase_add("feed_stall", (time.perf_counter() - t_feed) * 1e3)
        if _chaos.maybe_fire("nan_batch"):
            # the tripwire drill (ft/chaos.py): this run's batch gets a NaN
            feed_tensors = _sentinel.poison_feed(feed_tensors)

        key = (id(program), program._version,
               tuple(sorted((n, tuple(t.shape), t.dtype)
                            for n, t in feed_tensors.items())),
               tuple(fetch_names), None if dp is None else dp.key)
        # a cached plan holds its program, so the program's id stays its own
        plan = self._cache.get(key) if use_program_cache else None
        first_run = plan is None
        if first_run:
            with _trace.span("executor.compile"):
                plan = _Plan(program, feed_tensors,
                             dense=() if dp is None else dp.tp_specs)
                if dp is not None:
                    plan.distribute(model=dp.tp > 1)
            if use_program_cache:
                self._cache[key] = plan
            if mon is not None:
                self._record_plan(mon, ident, key, plan, use_program_cache)

        missing = [n for n in plan.state_in if not scope.has_var(n)]
        if missing:
            raise RuntimeError(
                "persistable vars %s are not initialized in scope; run the "
                "startup program first (parity: executor.cc CreateVariables)"
                % missing)
        env = {n: scope.find_var(n).to(self.device) for n in plan.state_in}
        rows = () if dp is None else _shard_rows(dp, scope, block, env)
        dims = ({} if dp is None or dp.tp == 1
                else _split_model(dp, scope, block, env))
        env.update(feed_tensors)
        step = self._step
        seed = (program.random_seed * 1000003 + step) % (2 ** 32)
        self._step += 1
        health = sent is not None and plan.loss_name is not None \
            and sent.wants_health(step)
        state_in = dict(env) if health else None
        probe = timer = None
        if mon is not None:
            if first_run and use_program_cache:
                probe = _memscope.LedgerProbe(self.device, env.values())
            elif not first_run:
                # a measured plan's admission check (MemScope), before its
                # second dispatch
                _memscope.predict_dispatch(mon, ident)
            if mon.take_device_sample():
                timer = _DeviceTimer(self.device)
        t_call = time.perf_counter()
        try:
            with _trace.span("executor.dispatch", compiled=first_run):
                if _chaos.maybe_fire("oom_step"):
                    # the OOM drill (ft/chaos.py): this run's dispatch dies
                    raise _memscope.InjectedOOMError(
                        "RESOURCE_EXHAUSTED: injected oom_step fault "
                        "dispatching %s" % (ident or "program"))
                ctx = plan.context(torch.Generator(self.device).manual_seed(seed))
                if dp is not None:
                    ctx.dp = _batch_axes.Run(dp, feed_tensors, rows)
                    if dp.tp > 1:
                        ctx.tp = _model_axes.Run(dp, dims)
                try:
                    with dp.mesh if dp is not None else contextlib.nullcontext():
                        plan.run(env, ctx)
                finally:
                    # the context and its sub-block closure form a cycle: a
                    # reference to the run's tensors kept there would keep
                    # every intermediate of the step alive until the cyclic
                    # collector ran (tens of GB at BERT-base, B = 16, f32)
                    ctx.env = None
        except Exception as e:
            # the OOM postmortem, with the memory section, before the
            # exception propagates
            if mon is not None and _memscope.is_resource_exhausted(e):
                _memscope.note_oom(mon, ident, e)
            raise

        missing = [n for n in fetch_names if n not in env]
        if missing and plan.pipeline is not None:
            raise NotImplementedError(
                "PipelineOptimizer programs expose the loss and persistable "
                "state; fetches %r are per-microbatch forward intermediates "
                "that do not survive the microbatch loop" % missing)
        if missing:
            raise KeyError("fetch targets %s are neither fed nor computed by "
                           "the program" % missing)
        sparse = [n for n in fetch_names if isinstance(env[n], SelectedRows)]
        if sparse:
            raise TypeError(
                "fetch targets %s are SelectedRows gradients of is_sparse "
                "lookups; fetch the updated tables instead" % sparse)
        fetches = [env[n].detach() for n in fetch_names]
        state_out = {n: env[n].detach() for n in plan.state_out if n in env}
        if dp is not None:
            # the global values of batch-shaped fetches (and of state a
            # batch-shaped value wrote); kReduce's rows fetched whole and
            # kept as rows in the scope
            run, tp = ctx.dp, getattr(ctx, "tp", None)
            fetches = [_dp_global(dp, run, n, _tp_global(dp, tp, n, t, True),
                                  True)
                       for n, t in zip(fetch_names, fetches)]
            state_out = {n: _dp_global(dp, run, n,
                                       _tp_global(dp, tp, n, t, False), False)
                         for n, t in state_out.items()}
            rows = run.rows
        vec = names = None
        if health:
            vec, names = _health(plan, env, state_in)
            if sent.guard_on_device:
                state_out, vec = _sentinel.traced_guard(vec, state_in,
                                                        state_out)

        if mon is not None:
            host_ms = (time.perf_counter() - t_start) * 1e3
            device_ms = None
            if timer is not None:
                with _trace.span("executor.device_sync"):
                    device_ms = timer.stop()
                mon.registry.counter("monitor.fetch.sampled_sync").incr()
            if not first_run:
                mon.phase_add("compute", device_ms if device_ms is not None
                              else (time.perf_counter() - t_call) * 1e3)
            batch = max((int(t.shape[0]) for t in feed_tensors.values()
                         if t.ndim > 0), default=None)
            mon.record_step(step, host_ms, device_ms, batch=batch,
                            fetches=len(fetch_names), compiled=first_run,
                            ident=ident, defer_memory=True)
            if probe is not None:
                _memscope.record_program(
                    mon, ident, probe.finish(fetches + list(state_out.values())),
                    source="compile")

        if vec is not None:
            # may raise NonFiniteError (halt) before the state commits
            sent.after_step(step, vec, names, state_out=state_out,
                            fetches=fetches, fetch_names=fetch_names,
                            feed=feed_tensors, ident=ident)

        if _flags["FLAGS_check_nan_inf"]:
            # per-run NaN/Inf validation (flags.cc FLAGS_check_nan_inf),
            # naming the tensor through the sentinel's localizer
            bad = _sentinel.localize_nonfinite(
                list(state_out.items()) + list(zip(fetch_names, fetches)))
            if bad:
                _sentinel.record_nonfinite(
                    bad, mon.registry if mon is not None else None)
                first = bad[0]
                more = ", ".join(b["name"] for b in bad[1:4])
                raise RuntimeError(
                    "FLAGS_check_nan_inf: variable %r contains NaN/Inf "
                    "after this step (%d NaN, %d Inf; first at flat "
                    "index %d)%s"
                    % (first["name"], first["nan"], first["inf"],
                       first["first_index"],
                       "; also nonfinite: %s" % more if more else ""))

        for n, v in state_out.items():
            scope.var(n)
            if dp is None:
                scope.set(n, v)
            else:
                scope.set(n, v, row_shards=dp.n if n in rows else 1,
                          rows_group=dp.group,
                          split=(dims[n], dp.tp, dp.tp_group)
                          if n in dims else None)
        if mon is not None:
            # the time-sampled memory watermark, after the commit, so the
            # owner walk sees the new state in the scope
            mon.maybe_sample_memory()
            if return_numpy and fetches:
                mon.registry.counter("monitor.fetch.inline_sync").incr()
        if geo is not None:
            geo.tick(scope)         # GeoSGD: every K-th run reconciles
        if return_numpy:
            return [(f.float() if f.dtype == torch.bfloat16 else f).cpu().numpy()
                    for f in fetches]
        # lazy fetches: bound the host's run-ahead by this step's outputs
        # (an event after them; the window waits on the (K+1)-oldest)
        self.inflight.admit(fetches or list(state_out.values()))
        return fetches

    def _record_plan(self, mon, ident, key, plan, cached):
        """A plan-cache miss: the recompile detector gets the key split into
        the reference's named parts; an uncached run is counted, never as
        recompile churn."""
        if cached:
            feed = tuple((n, shape, str(dtype).replace("torch.", ""))
                         for n, shape, dtype in key[2])
            mon.recompiles.record_compile(ident, {
                "version": key[1], "feed": feed, "fetch": key[3],
                "state": tuple(plan.state_in), "sharding": None})
        else:
            mon.registry.counter("monitor.compile.uncached").incr()
            mon.timeline.emit("compile", ident=ident, recompile=False,
                              diff=[], cached=False)


def _health(plan, env, state_in):
    """The sentinel's bundle from a training step's env: the dense
    gradients by parameter and the sparse ones by their row values, the
    parameters before and after the step (the reference's health
    arguments)."""
    dense = [p for p in plan.param_names
             if p in env and p not in plan.sparse]
    grads = {p: env[p + "@GRAD"] for p in dense}
    for w in plan.sparse:
        grads[w] = env[w + "@GRAD"].values
    return _sentinel.traced_health(
        env[plan.loss_name], grads, {p: state_in[p] for p in dense},
        {p: env[p] for p in dense})


class _DeviceTimer:
    """The sampled step's device time: CUDA events around the dispatch on
    a card (its ``stop`` waits for the end event), the host clock on the
    CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self):
        if not self.cuda:
            return (time.perf_counter() - self.t0) * 1e3
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        return self.start.elapsed_time(end)
