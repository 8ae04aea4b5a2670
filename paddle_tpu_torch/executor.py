"""Executor: runs a Program op by op on ``torch`` tensors.

Parity surface: python/paddle/fluid/executor.py:418 (Executor.run with
feed/fetch_list/scope) and framework/executor.cc:192 (C++ Executor::Run).

Counterpart of the JAX package's ``executor.py``: the plain path of its
``_lower`` (forward, one autodiff step, optimizer ops), run eagerly instead
of traced and compiled.  The forward ops run with the dense parameters as
fresh leaves that require grad; ``torch.autograd.grad`` of the summed loss
gives each ``<param>@GRAD``; the ops after the backward section (the
optimizer) run under ``torch.no_grad()``; the persistables they write go
back to the scope.  What the JAX executor caches as a compiled step, this
one caches as an analysed plan (op rules, sections, state names), keyed by
program version, feed shapes and fetch names.

Sub-blocks (``while``, ``conditional_block``, ``cond``, ``scan``) run
through ``OpLoweringContext.interpret_block``: each block's op rules are
looked up once, when the plan is made, and a control-flow rule runs its
sub-block's list on a copy of the env as often as it needs.  A one-device
``CompiledProgram`` runs as the program it wraps.

The JAX executor's other branches (pipeline, sparse lookups, AMP,
recompute, data-parallel CompiledProgram/fleet, monitor and sentinel, the
warm store, py_reader) raise ``NotImplementedError`` naming the ROADMAP
item that brings them; none quietly runs another path.
"""

import os

import numpy as np
import torch

from .dtypes import convert_dtype, numpy_dtype
from .enforce import EnforceNotMet, NotDifferentiable, format_op_error
from .framework import Parameter, Program, Variable, default_main_program
from .compiler import CompiledProgram
from .kernels._common import resolve_device
from .registry import OpLoweringContext, get_lowering
from .scope import global_scope

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
    if getattr(program, "_pipeline", None) is not None:
        raise NotImplementedError(
            "PipelineOptimizer programs: the microbatched pipeline path "
            "waits (ROADMAP Queue 1 item 5, pipeline)")
    amp = getattr(program, "_amp", None)
    if amp and amp.get("enabled"):
        raise NotImplementedError(
            "AMP programs: bf16 compute with f32 masters waits (ROADMAP "
            "Queue 1 item 3, amp.py)")
    if (getattr(program, "_fleet_strategy", None) is not None
            or getattr(program, "_dist_info", None) is not None):
        raise NotImplementedError(
            "fleet/transpiler-tagged programs: data-parallel execution waits "
            "(ROADMAP Queue 1 item 5)")
    if getattr(program, "_py_readers", None):
        raise NotImplementedError(
            "py_reader-fed programs: the reader pipeline waits (ROADMAP "
            "Queue 1 item 4)")
    for op in program.global_block().ops:
        if op.type == "backward_meta" and op.attrs.get("use_remat"):
            raise NotImplementedError(
                "recompute (RecomputeOptimizer / use_remat) waits (ROADMAP "
                "Queue 1 item 3)")
        if (op.type in ("lookup_table", "lookup_table_v2")
                and op.attrs.get("is_sparse")):
            raise NotImplementedError(
                "lookup_table(is_sparse=True): SelectedRows gradients through "
                "the executor wait (ROADMAP Queue 1 item 3)")


def refuse_warm_dir():
    """The warm executable store (the executor's and the exported
    predictor's persistence) is not ported."""
    if os.environ.get("PADDLE_TPU_WARM_DIR", "").strip():
        raise NotImplementedError(
            "PADDLE_TPU_WARM_DIR: the warm executable store waits (ROADMAP "
            "Queue 1 item 8)")


def _refuse_unported_env():
    if os.environ.get("PADDLE_TPU_MONITOR") == "1":
        raise NotImplementedError(
            "PADDLE_TPU_MONITOR=1: the monitor and its sentinel wait (ROADMAP "
            "Queue 1 item 9)")
    refuse_warm_dir()


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
    op with its rule."""

    def __init__(self, program):
        _refuse_unported(program)
        self.program = program
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
        if not bwd_idxs:
            self.fwd, self.rest = [_OpCall(op, block) for op in ops], []
            self.loss_name, self.param_names = None, []
            return
        i = bwd_idxs[0]
        self.fwd = [_OpCall(op, block) for op in ops[:i]]
        self.rest = [_OpCall(op, block) for op in ops[i + 1:]]
        self.loss_name = ops[i].attrs["loss_name"]
        self.param_names = list(ops[i].attrs["param_names"])

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

    def run(self, env, ctx):
        if self.loss_name is None:
            with torch.no_grad():
                _run_calls(self.fwd, env, ctx)
            return
        params = {p: env[p].detach().requires_grad_(True)
                  for p in self.param_names if p in env}
        env.update(params)
        with torch.enable_grad():
            _run_calls(self.fwd, env, ctx)
            loss = env[self.loss_name].float().sum()
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        for (name, leaf), g in zip(params.items(), grads):
            env[name] = leaf.detach()
            # a parameter the loss does not reach has a zero gradient, as
            # jax.grad gives it
            env[name + "@GRAD"] = torch.zeros_like(env[name]) if g is None else g
        with torch.no_grad():
            _run_calls(self.rest, env, ctx)


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

    def close(self):
        """Parity: executor.cc Executor::Close — drops the cached plans."""
        self._cache.clear()

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
        program = program if program is not None else default_main_program()
        if isinstance(program, CompiledProgram):
            program = program._program_for_run()
        if not isinstance(program, Program):
            raise TypeError("Executor.run takes a Program or a "
                            "CompiledProgram, not %s" % type(program).__name__)
        _refuse_unported_env()
        feed = feed or {}
        fetch_names = [_as_fetch_name(f) for f in (fetch_list or [])]
        scope = scope if scope is not None else global_scope()
        block = program.global_block()
        feed_tensors = {n: self._feed_tensor(block, n, v)
                        for n, v in feed.items()}

        key = (id(program), program._version,
               tuple(sorted((n, tuple(t.shape), t.dtype)
                            for n, t in feed_tensors.items())),
               tuple(fetch_names))
        # a cached plan holds its program, so the program's id stays its own
        plan = self._cache.get(key) if use_program_cache else None
        if plan is None:
            plan = _Plan(program)
            if use_program_cache:
                self._cache[key] = plan

        missing = [n for n in plan.state_in if not scope.has_var(n)]
        if missing:
            raise RuntimeError(
                "persistable vars %s are not initialized in scope; run the "
                "startup program first (parity: executor.cc CreateVariables)"
                % missing)
        env = {n: scope.find_var(n).to(self.device) for n in plan.state_in}
        env.update(feed_tensors)
        seed = (program.random_seed * 1000003 + self._step) % (2 ** 32)
        self._step += 1
        plan.run(env, plan.context(
            torch.Generator(self.device).manual_seed(seed)))

        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError("fetch targets %s are neither fed nor computed by "
                           "the program" % missing)
        fetches = [env[n].detach() for n in fetch_names]
        for n in plan.state_out:
            if n in env:
                scope.var(n)
                scope.set(n, env[n].detach())
        if return_numpy:
            return [(f.float() if f.dtype == torch.bfloat16 else f).cpu().numpy()
                    for f in fetches]
        return fetches
