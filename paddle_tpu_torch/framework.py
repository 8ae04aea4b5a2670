"""Graph-builder core: Program / Block / Operator / Variable.

Parity with the reference's Python graph builder
(python/paddle/fluid/framework.py: Program :3515, Block :2132, Operator :1680,
Variable :561, Parameter :4459) and the C++ ProgramDesc/BlockDesc/OpDesc/VarDesc
wrappers (framework/program_desc.h:30, block_desc.h:38, op_desc.h:30,
var_desc.h:58).  Unlike the reference there is no protobuf: a Program is a
lightweight in-memory op graph that the Executor interprets op by op on
``torch`` tensors.  A copy of the JAX package's ``framework.py``; only the
places differ.
"""

import contextlib
import copy

import numpy as np

from . import unique_name
from .dtypes import normalize_dtype

__all__ = [
    "Program",
    "Block",
    "Operator",
    "Variable",
    "Parameter",
    "program_guard",
    "default_main_program",
    "default_startup_program",
    "switch_main_program",
    "switch_startup_program",
    "name_scope",
    "CPUPlace",
    "TPUPlace",
    "CUDAPlace",
    "CUDAPinnedPlace",
    "in_dygraph_mode",
]


# ---------------------------------------------------------------------------
# Places (parity: platform/place.h:81 — CPUPlace/CUDAPlace/CUDAPinnedPlace).
# A place names the torch device the Executor runs on (``device()``).
# ---------------------------------------------------------------------------

class Place:
    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __repr__(self):
        return type(self).__name__ + "()"


class CPUPlace(Place):
    def device(self):
        return "cpu"


class CUDAPlace(Place):
    """The card: ``cuda:<device_id>``."""

    def __init__(self, device_id=0):
        self.device_id = device_id

    def __repr__(self):
        return "CUDAPlace(%d)" % self.device_id

    def device(self):
        return "cuda:%d" % self.device_id


# A second name for the accelerator place, so that programs written against
# the JAX package (``TPUPlace()``) run unchanged on the card.
TPUPlace = CUDAPlace


class CUDAPinnedPlace(Place):
    """Parity alias: feeds already stage through the host; behaves as
    CPUPlace."""

    def device(self):
        return "cpu"


# ---------------------------------------------------------------------------
# Op roles (parity: framework.py OpRole / op_role attr used by backward and
# optimizer passes to prune programs for inference).
# ---------------------------------------------------------------------------

class OpRole:
    Forward = 0
    Backward = 1
    Optimize = 2
    RPC = 3
    Dist = 4
    LRSched = 16
    Loss = 256


_dygraph_tracer_ = None


def in_dygraph_mode():
    """Parity: framework.py:173 in_dygraph_mode()."""
    return _dygraph_tracer_ is not None


def _dygraph_tracer():
    return _dygraph_tracer_


@contextlib.contextmanager
def _dygraph_guard(tracer):
    global _dygraph_tracer_
    old = _dygraph_tracer_
    _dygraph_tracer_ = tracer
    try:
        yield
    finally:
        _dygraph_tracer_ = old


class Variable:
    """A named tensor in a Block (parity: framework.py:561).

    Carries static metadata (shape with -1 for dynamic dims, dtype string,
    persistable / stop_gradient flags).  The actual value lives in a Scope at
    run time (scope.py) as a torch.Tensor.
    """

    def __init__(
        self,
        block,
        name=None,
        shape=None,
        dtype="float32",
        persistable=False,
        stop_gradient=False,
        is_data=False,
        lod_level=0,
        **kwargs,
    ):
        self.block = block
        if name is None:
            name = unique_name.generate("_generated_var")
        self.name = name
        self.shape = tuple(int(s) if s is not None else -1 for s in (shape or ()))
        self.dtype = normalize_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.lod_level = lod_level

    # -- metadata ----------------------------------------------------------
    @property
    def ndim(self):
        return len(self.shape)

    def astype(self, dtype):
        from .layers import tensor as tensor_layers

        return tensor_layers.cast(self, dtype)

    def __repr__(self):
        return "Variable(name=%s, shape=%s, dtype=%s)" % (self.name, self.shape, self.dtype)

    # -- operator overloads (parity: framework.py monkey-patched math ops) --
    def _binary(self, other, op, reverse=False):
        from .layers import math_ops

        return math_ops._elementwise_op_with_scalar(op, self, other, reverse)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __rsub__(self, other):
        return self._binary(other, "elementwise_sub", reverse=True)

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")

    def __rtruediv__(self, other):
        return self._binary(other, "elementwise_div", reverse=True)

    def __pow__(self, other):
        return self._binary(other, "elementwise_pow")

    def __neg__(self):
        from .layers import math_ops

        return math_ops.scale(self, scale=-1.0)

    def __lt__(self, other):
        return self._binary(other, "less_than")

    def __le__(self, other):
        return self._binary(other, "less_equal")

    def __gt__(self, other):
        return self._binary(other, "greater_than")

    def __ge__(self, other):
        return self._binary(other, "greater_equal")

    def __getitem__(self, item):
        from .layers import tensor as tensor_layers

        return tensor_layers._getitem(self, item)


class Parameter(Variable):
    """A persistable trainable Variable (parity: framework.py:4459)."""

    def __init__(self, block, shape, dtype, **kwargs):
        self.trainable = kwargs.pop("trainable", True)
        self.optimize_attr = kwargs.pop("optimize_attr", {"learning_rate": 1.0})
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        self.do_model_average = kwargs.pop("do_model_average", None)
        self.initializer = kwargs.pop("initializer", None)
        super().__init__(block, shape=shape, dtype=dtype, persistable=True, **kwargs)
        self.stop_gradient = not self.trainable


class Operator:
    """One node of the op graph (parity: framework.py:1680 / op_desc.h:30).

    inputs/outputs map slot name -> list of variable names; attrs is a plain
    dict.  Lowering rules live in registry.py keyed by `type`.
    """

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {}
        self.outputs = {}
        self.attrs = dict(attrs or {})
        for slot, vars_ in (inputs or {}).items():
            self.inputs[slot] = [v.name if isinstance(v, Variable) else v for v in _as_list(vars_)]
        for slot, vars_ in (outputs or {}).items():
            self.outputs[slot] = [v.name if isinstance(v, Variable) else v for v in _as_list(vars_)]
        # user-code location that built this op, attached to lowering errors
        # (op_call_stack.cc parity; see enforce.format_op_error)
        from .enforce import creation_frame

        self._creation_frame = creation_frame()

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def _clone(self, block):
        op = Operator(block, self.type)
        op.inputs = {k: list(v) for k, v in self.inputs.items()}
        op.outputs = {k: list(v) for k, v in self.outputs.items()}
        op.attrs = copy.deepcopy(self.attrs)
        return op

    def __repr__(self):
        return "Operator(%s, in=%s, out=%s)" % (self.type, self.inputs, self.outputs)


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class Block:
    """Ordered op list + var table (parity: framework.py:2132 / block_desc.h:38)."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}
        self.ops = []

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    # -- vars --------------------------------------------------------------
    def create_var(self, **kwargs):
        var = Variable(self, **kwargs)
        self.vars[var.name] = var
        self.program._bump_version()
        return var

    def create_parameter(self, **kwargs):
        param = Parameter(self, kwargs.pop("shape"), kwargs.pop("dtype"), **kwargs)
        self.vars[param.name] = param
        self.program._bump_version()
        return param

    def var(self, name):
        v = self.vars.get(name)
        if v is None:
            raise KeyError("variable %r not found in block %d" % (name, self.idx))
        return v

    def _find_var_recursive(self, name):
        block = self
        while block is not None:
            if name in block.vars:
                return block.vars[name]
            block = block.parent_block
        return None

    def has_var(self, name):
        return name in self.vars

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # -- ops ---------------------------------------------------------------
    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        attrs = dict(attrs or {})
        attrs.setdefault("op_role", self.program._current_role)
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump_version()
        return op

    def prepend_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        self.program._bump_version()
        return op

    def __repr__(self):
        return "Block(idx=%d, ops=%d, vars=%d)" % (self.idx, len(self.ops), len(self.vars))


class Program:
    """A whole program: list of blocks, block 0 is global (parity:
    framework.py:3515 / program_desc.h:30)."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._version = 0
        self._current_role = OpRole.Forward
        self._seed_counter = 0
        # set by append_backward: (loss_name, [param names], [grad names])
        self._backward_info = None
        # set by CompiledProgram/data-parallel build
        self._sharding_info = None
        self._lr_schedulers = []

    # -- structure ---------------------------------------------------------
    def global_block(self):
        return self.blocks[0]

    def block(self, idx):
        return self.blocks[idx]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def _create_block(self, parent_idx=None):
        parent_idx = self.current_block_idx if parent_idx is None else parent_idx
        block = Block(self, len(self.blocks), parent_idx)
        self.blocks.append(block)
        self.current_block_idx = block.idx
        return block

    def _rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    def _bump_version(self):
        self._version += 1

    @contextlib.contextmanager
    def _optimized_guard(self, _param_and_grads=None):
        """Parity: framework.py Program._optimized_guard — ops created inside
        are tagged with the Optimize role (pruned by clone(for_test=True))."""
        old = self._current_role
        self._current_role = OpRole.Optimize
        try:
            yield
        finally:
            self._current_role = old

    @contextlib.contextmanager
    def _backward_role_guard(self):
        old = self._current_role
        self._current_role = OpRole.Backward
        try:
            yield
        finally:
            self._current_role = old

    @contextlib.contextmanager
    def _lr_schedule_guard(self):
        old = self._current_role
        self._current_role = OpRole.LRSched
        try:
            yield
        finally:
            self._current_role = old

    # -- queries -----------------------------------------------------------
    def all_parameters(self):
        return [p for b in self.blocks for p in b.all_parameters()]

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def next_seed(self):
        """Per-op deterministic seed stream derived from program.random_seed."""
        self._seed_counter += 1
        return self._seed_counter

    # -- transforms --------------------------------------------------------
    def clone(self, for_test=False):
        """Parity: framework.py Program.clone — a deep structural copy; with
        for_test=True backward/optimize ops are pruned and is_test is set."""
        p = Program()
        p.random_seed = self.random_seed
        p.blocks = []
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            for name, v in b.vars.items():
                nv = copy.copy(v)
                nv.block = nb
                nb.vars[name] = nv
            for op in b.ops:
                role = op.attr("op_role", OpRole.Forward)
                if for_test and role in (OpRole.Backward, OpRole.Optimize, OpRole.LRSched):
                    continue
                nop = op._clone(nb)
                if for_test and "is_test" in nop.attrs:
                    nop.attrs["is_test"] = True
                nb.ops.append(nop)
            p.blocks.append(nb)
        p.current_block_idx = 0
        if not for_test:
            p._backward_info = copy.deepcopy(self._backward_info)
        p._bump_version()
        return p

    def _prune(self, targets):
        """Prune the program to the ops needed to compute `targets` (parity:
        framework/prune.cc used by save_inference_model io.py:1011)."""
        target_names = set(t.name if isinstance(t, Variable) else t for t in targets)
        block = self.global_block()
        needed = set(target_names)
        kept = []
        for op in reversed(block.ops):
            if any(o in needed for o in op.output_arg_names):
                kept.append(op)
                needed.update(op.input_arg_names)
        kept.reverse()
        p = self.clone(for_test=True)
        nb = p.global_block()
        kept_ids = {id(op) for op in kept}
        # clone(for_test) copies exactly the non-backward/optimize/lr ops in
        # order, so clone ops correspond 1:1 positionally to that filtered
        # subsequence — no content matching (which could confuse repeated
        # identical ops, e.g. two increments of the same counter var)
        fwd_orig = [
            op for op in block.ops
            if op.attr("op_role", OpRole.Forward)
            not in (OpRole.Backward, OpRole.Optimize, OpRole.LRSched)
        ]
        assert len(fwd_orig) == len(nb.ops), (len(fwd_orig), len(nb.ops))
        nb.ops = [cop for op, cop in zip(fwd_orig, nb.ops)
                  if id(op) in kept_ids]
        return p

    def __repr__(self):
        return "Program(blocks=%d, ops=%d)" % (
            len(self.blocks),
            sum(len(b.ops) for b in self.blocks),
        )


_main_program_ = Program()
_startup_program_ = Program()


def default_main_program():
    return _main_program_


def default_startup_program():
    return _startup_program_


def switch_main_program(program):
    global _main_program_
    old = _main_program_
    _main_program_ = program
    return old


def switch_startup_program(program):
    global _startup_program_
    old = _startup_program_
    _startup_program_ = program
    return old


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    """Parity: framework.py:4679 program_guard."""
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)


_name_scope_stack = []


@contextlib.contextmanager
def name_scope(prefix):
    """Profiling/visualization name scope (parity: framework.py name_scope)."""
    _name_scope_stack.append(prefix)
    try:
        yield
    finally:
        _name_scope_stack.pop()
