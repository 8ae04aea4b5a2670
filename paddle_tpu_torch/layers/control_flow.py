"""Control-flow layers (parity: layers/control_flow.py — While, cond,
Switch, less_than/equal helpers, increment, array ops).  A copy of the JAX
package's ``layers/control_flow.py``.

The layers capture sub-blocks; the op rules run them eagerly
(``ops/control_flow_ops.py``).  ``Switch`` is the JAX package's: each
case's ``assign`` becomes a ``where`` chain in which the last matching case
wins (Paddle's own Switch takes the first match).
"""

from ..layer_helper import LayerHelper
from ..framework import Variable, default_main_program
from . import tensor as T

__all__ = ["While", "Switch", "cond", "less_than", "less_equal", "greater_than",
           "greater_equal", "equal", "not_equal", "logical_and", "logical_or",
           "logical_not", "is_empty", "increment", "array_write", "array_read",
           "array_length", "create_array"]


# single shared implementation lives in math_ops (both modules export the
# fluid API names; keeping one body avoids divergent cond=/out= semantics)
from .math_ops import (less_than, less_equal, greater_than,  # noqa: F401
                       greater_equal, equal, not_equal,
                       logical_and, logical_or)


def logical_not(x, out=None, name=None):
    helper = LayerHelper("logical_not")
    if out is None:
        out = helper.create_variable_for_type_inference("bool", x.shape)
    helper.append_op(type="logical_not", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def increment(x, value=1.0, in_place=True):
    return T.increment(x, value, in_place)


def is_empty(x, cond=None):
    helper = LayerHelper("is_empty")
    from .nn import reduce_sum

    # static shapes: emptiness is compile-time known; keep API shape
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool", ())
    helper.append_op(type="fill_constant", outputs={"Out": [cond]},
                     attrs={"shape": [], "dtype": "bool",
                            "value": float(any(s == 0 for s in x.shape))})
    return cond


class While:
    """Parity: layers/control_flow.py While — context manager capturing the
    loop body into a sub-block, run by the ``while`` op's loop.

    Usage (reference-compatible):
        i = fill_constant(shape=[1], dtype='int64', value=0)
        loop_len = fill_constant(shape=[1], dtype='int64', value=10)
        c = less_than(i, loop_len)
        w = While(cond=c)
        with w.block():
            ...ops writing loop vars (must include updating `c`)...
    Loop-carried variables are every var assigned inside the block that also
    exists outside (detected from sub-block op outputs).
    """

    def __init__(self, cond, is_test=False, name=None):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond
        self.program = default_main_program()

    def block(self):
        return _WhileBlockGuard(self)


class _WhileBlockGuard:
    def __init__(self, while_op):
        self.w = while_op

    def __enter__(self):
        self.parent_block = self.w.program.current_block()
        self.sub_block = self.w.program._create_block()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        program = self.w.program
        sub = self.sub_block
        program._rollback()
        parent = self.parent_block
        # loop-carried vars: outputs of sub-block ops whose names resolve in
        # the parent scope chain (i.e. pre-existing outside the loop)
        carried = []
        seen = set()
        for op in sub.ops:
            for n in op.output_arg_names:
                if n in seen:
                    continue
                if parent._find_var_recursive(n) is not None:
                    carried.append(n)
                    seen.add(n)
        cond_name = self.w.cond_var.name
        if cond_name not in seen:
            carried.append(cond_name)
        carried_vars = [parent._find_var_recursive(n) for n in carried]
        parent.append_op(
            type="while",
            inputs={"X": carried_vars, "Condition": [self.w.cond_var]},
            outputs={"Out": carried_vars},
            attrs={
                "sub_block_index": sub.idx,
                "cond_name": cond_name,
                "loop_var_names": carried,
            },
        )
        return False


def cond(pred, true_fn=None, false_fn=None, name=None):
    """Parity: layers/control_flow.py cond (2.0-style two-branch cond) — both
    branches are captured into sub-blocks; the ``cond`` op runs the taken
    one."""
    helper = LayerHelper("cond", name=name)
    program = default_main_program()

    def capture(fn):
        sub = program._create_block()
        res = fn() if fn is not None else None
        program._rollback()
        outs = res if isinstance(res, (list, tuple)) else ([res] if res is not None else [])
        return sub, [o.name for o in outs], outs

    true_block, true_names, true_vars = capture(true_fn)
    false_block, false_names, false_vars = capture(false_fn)
    if len(true_names) != len(false_names):
        raise ValueError("cond branches must return the same number of outputs")
    outs = [
        helper.create_variable_for_type_inference(v.dtype, v.shape) for v in true_vars
    ]
    helper.append_op(
        type="cond",
        inputs={"Cond": [pred]},
        outputs={"Out": outs},
        attrs={
            "true_block_index": true_block.idx,
            "false_block_index": false_block.idx,
            "true_out_names": true_names,
            "false_out_names": false_names,
        },
    )
    if not outs:
        return None
    return outs[0] if len(outs) == 1 else outs


class Switch:
    """Parity: layers/control_flow.py Switch — sequential case selection used
    by LR-warmup schedules.  Implemented over nested `where` selections: each
    case assigns into pre-existing output vars."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self._cases = []
        self._default = None

    def __enter__(self):
        return self

    def __exit__(self, *args):
        return False

    def case(self, condition):
        return _SwitchCaseGuard(self, condition)

    def default(self):
        return _SwitchCaseGuard(self, None)


class _SwitchCaseGuard:
    """Captures case-body assignments; at exit rewires each `assign`ed target
    through a `where(cond, case_value, previous_value)` chain so the last
    matching case in program order wins (reference executes first match; with
    mutually exclusive warmup conditions this is equivalent)."""

    def __init__(self, switch, condition):
        self.switch = switch
        self.condition = condition
        self.program = default_main_program()

    def __enter__(self):
        if self.condition is not None:
            self.switch._cases.append(self.condition)
        elif self.switch._cases:
            # default() fires only when no prior case matched: build
            # NOT(any(case conds)) BEFORE the body so the interpreter
            # computes it ahead of the rewired assigns
            any_cond = self.switch._cases[0]
            for c in self.switch._cases[1:]:
                any_cond = logical_or(any_cond, c)
            self.condition = logical_not(any_cond)
        block = self.program.current_block()
        self._op_start = len(block.ops)
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is not None:
            return False
        block = self.program.current_block()
        if self.condition is None:
            return False  # default with no preceding cases: unconditional
        # wrap every assign target since case start in a where-select
        for op in block.ops[self._op_start:]:
            if op.type == "assign":
                target = op.outputs["Out"][0]
                src = op.inputs["X"][0]
                op.type = "where"
                op.inputs = {"Condition": [self.condition.name], "X": [src], "Y": [target]}
        return False


def create_array(dtype):
    """TensorArray analogue: a python list of Variables at build time."""
    return []


def array_write(x, i, array=None):
    """Parity: layers/control_flow.py array_write (TensorArray write op).
    Build-time static index: honors `i` (overwrite or append-at-end); a
    fill_constant index Variable created by array_length is resolved to its
    static value."""
    if array is None:
        array = []
    idx = _static_index(i)
    if idx is None:
        raise NotImplementedError(
            "dynamic array_write index requires a scan capture "
            "(layers.scan/StaticRNN wait: ROADMAP Queue 1 item 3)"
        )
    if idx < len(array):
        array[idx] = x
    elif idx == len(array):
        array.append(x)
    else:
        raise IndexError(
            "array_write index %d out of range for TensorArray of length %d"
            % (idx, len(array))
        )
    return array


def _static_index(i):
    """Resolve a build-time-constant index: python int, or a Variable
    produced by a single fill_constant / increment-free chain."""
    if isinstance(i, int):
        return i
    if isinstance(i, Variable):
        block = i.block
        for op in reversed(block.ops):
            if i.name in op.output_arg_names:
                if op.type == "fill_constant":
                    return int(op.attrs.get("value", 0))
                return None
    return None


def array_read(array, i):
    idx = _static_index(i)
    if idx is not None:
        return array[idx]
    # Dynamic (runtime) index over a uniform TensorArray: stack the elements
    # and gather at the index variable (lod_tensor_array read with a loop
    # counter var — ref control_flow.py:array_read).  Requires all elements
    # written so far to share one shape (true for RNN-style arrays).
    if array and all(tuple(a.shape) == tuple(array[0].shape) for a in array):
        from .nn import reshape as _reshape

        stacked = T.stack(list(array), axis=0)
        flat_i = _reshape(i, [-1]) if getattr(i, "shape", None) else i
        picked = T.gather(stacked, flat_i)
        return _reshape(picked, list(array[0].shape))
    raise NotImplementedError(
        "dynamic array_read over ragged TensorArray requires a scan "
        "capture (layers.scan/StaticRNN wait: ROADMAP Queue 1 item 3)"
    )


def array_length(array):
    return T.fill_constant([1], "int64", len(array))
