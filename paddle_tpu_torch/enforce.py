"""Error machinery — the PADDLE_ENFORCE / op-call-stack tier.

Parity: platform/enforce.h:224-260 (PADDLE_ENFORCE*/PADDLE_THROW raising
EnforceNotMet with context) and framework/op_call_stack.cc (attaching the
Python creation stack of the failing op to C++ errors, so users see WHERE in
their model code the bad op was built, not just where the kernel died).

Here the "kernel" is an op rule run on tensors by the executor; when one raises,
the executor re-raises an EnforceNotMet carrying the op type, its input
shapes, and the user-code line that appended the op (recorded at
Operator construction).  A copy of the JAX package's ``enforce.py``."""

import collections
import sys

__all__ = ["EnforceNotMet", "NotDifferentiable", "enforce", "creation_frame"]

_Frame = collections.namedtuple("_Frame", ["filename", "lineno", "name"])


class EnforceNotMet(RuntimeError):
    """Parity: enforce.h EnforceNotMet."""


class NotDifferentiable(ValueError):
    """A differentiated value flows through an op the reference cannot
    differentiate in reverse mode (``while``: ``lax.while_loop``).  The JAX
    package raises this as a ``ValueError`` from ``jax.grad``, outside any op
    rule, so the executor passes it on unwrapped."""


def enforce(condition, message, *fmt_args):
    """PADDLE_ENFORCE(cond, msg, args...): raise EnforceNotMet unless
    condition holds.  For host-side (graph-build-time) checks; conditions on
    tensor values belong in the op rules, not here."""
    if not condition:
        raise EnforceNotMet(message % fmt_args if fmt_args else message)


def creation_frame():
    """The innermost user frame (outside paddle_tpu_torch) of the current stack —
    recorded on each Operator so lowering errors can point at the model
    code that built the op (op_call_stack.cc parity).  Walks raw frames
    (no traceback/linecache work): this runs on every op construction, the
    graph-build hot path."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename.replace("\\", "/")
        if "/paddle_tpu_torch/" not in fn:
            return _Frame(fn, f.f_lineno, f.f_code.co_name)
        f = f.f_back
    return None


def format_op_error(op, err):
    """One-line context for a failed op lowering."""
    fr = getattr(op, "_creation_frame", None)
    where = (" [created at %s:%d in %s]" % (fr.filename, fr.lineno, fr.name)
             if fr is not None else "")
    io = []
    for slot, names in op.inputs.items():
        io.append("%s=%s" % (slot, names))
    return "op %r failed during lowering (%s: %s)%s; inputs: %s" % (
        op.type, type(err).__name__, err, where, "; ".join(io))
