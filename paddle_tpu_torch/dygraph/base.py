"""DyGraph core: VarBase (tensor + tape node) and the Tracer/engine.

Parity: imperative/layer.h:55 (VarBase), tracer.h:44 (Tracer::TraceOp),
engine.h:69 (BasicEngine reverse sweep), gradient_accumulator.cc (grad sums).

The counterpart of the JAX package's ``dygraph/base.py``, with its tape's
semantics.  Each traced op is one node: its function, its input VarBases
and its output.  ``_apply`` runs the function once, on detached copies of
its inputs, with ``requires_grad`` on the float inputs that want a
gradient, so the node keeps its own small autograd graph; the reverse
sweep asks each node for its vector-Jacobian product with
``torch.autograd.grad`` instead of running the forward again.  The sweep
is the reference's: topological order, gradients summed per node, leaves
accumulating into ``_grad``, ``stop_gradient`` inputs skipped, the
incoming gradient cast to the node's dtype, and after a sweep without
``retain_graph`` every node of it loses its recipe (a second
``backward()`` through it is a no-op; a node reached later counts as a
leaf).  A float input that was ``stop_gradient`` when the op ran gets no
gradient from it, even if the flag is cleared afterwards.

The tracer carries its device: ``guard(CPUPlace())`` runs on the CPU,
``guard()`` or ``guard(CUDAPlace(0))`` on the card (and raises without
one).  ``to_variable`` and a layer's parameters are placed there.
"""

import contextlib
import functools

import numpy as np
import torch

from ..dtypes import convert_dtype, normalize_dtype
from ..framework import _dygraph_guard, _dygraph_tracer, in_dygraph_mode
from ..kernels._common import resolve_device
from ..ops.common import saturating_cast

__all__ = ["guard", "enabled", "to_variable", "no_grad", "VarBase", "Tracer",
           "enable_dygraph", "disable_dygraph"]


def place_device(place=None):
    """The torch device of a place: ``CPUPlace()`` the CPU; ``None`` or a
    ``CUDAPlace`` the card, through ``resolve_device`` (which raises
    without one); a device name or ``torch.device`` as it is."""
    if place is None or isinstance(place, (str, torch.device)):
        return resolve_device(place)
    return resolve_device(place.device())


class Tracer:
    """Parity: imperative/tracer.h — records ops onto the tape implicitly via
    VarBase recipes; carries the no_grad flag and the device."""

    def __init__(self, device=None):
        self._no_grad = False
        self._train_mode = True
        self.device = place_device(device)


def current_device():
    """The tracer's device; outside a guard the card (``resolve_device``)."""
    tracer = _dygraph_tracer()
    if tracer is not None and getattr(tracer, "device", None) is not None:
        return tracer.device
    return resolve_device(None)


def as_tensor(value, device=None):
    """``value`` as a tensor on ``device`` (the tracer's by default), with
    ``jnp.asarray``'s canonical floats: a float64 or complex128 array (not
    a tensor) becomes float32 or complex64."""
    device = current_device() if device is None else device
    if isinstance(value, torch.Tensor):
        return value.to(device)
    arr = np.asarray(value)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    elif arr.dtype == np.complex128:
        arr = arr.astype(np.complex64)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


class VarBase:
    """Tensor with autograd tape node (parity: imperative/layer.h:55)."""

    _name_counter = 0

    def __init__(self, value, name=None, stop_gradient=False, persistable=False,
                 trainable=None):
        self._value = value if isinstance(value, torch.Tensor) else as_tensor(value)
        VarBase._name_counter += 1
        self.name = name or ("eager_tmp_%d" % VarBase._name_counter)
        self.stop_gradient = stop_gradient
        self.persistable = persistable
        self.trainable = trainable if trainable is not None else (not stop_gradient)
        self._grad = None
        # tape recipe: (fn, input VarBases); None for leaves
        self._recipe = None
        # the node's autograd graph: (output, [input copies]) while recorded
        self._node = None
        self._shared = False        # one of several outputs of one node

    # -- value access ------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._value.shape)

    @property
    def dtype(self):
        return normalize_dtype(self._value.dtype)

    def numpy(self):
        return self._value.detach().cpu().numpy()

    def set_value(self, value):
        """Replace the value (never written in place: a recorded node and a
        traced program keep the tensor they read)."""
        self._value = as_tensor(value, self._value.device)

    @property
    def gradient(self):
        return None if self._grad is None else self._grad.detach().cpu().numpy()

    @property
    def grad(self):
        return self._grad

    def clear_gradient(self):
        self._grad = None

    def detach(self):
        return VarBase(self._value, stop_gradient=True)

    def astype(self, dtype):
        return _apply(lambda v: saturating_cast(v, convert_dtype(dtype)), self)

    # -- autograd ----------------------------------------------------------
    def backward(self, retain_graph=False):
        """Parity: BasicEngine::Execute — reverse topological sweep with
        gradient accumulation; each node's VJP from its own graph."""
        topo = []
        visited = set()

        def visit(node):
            if id(node) in visited or node._recipe is None:
                return
            visited.add(id(node))
            for parent in node._recipe[1]:
                visit(parent)
            topo.append(node)

        visit(self)
        grads = {id(self): torch.ones_like(self._value)}
        for node in reversed(topo):
            g = grads.pop(id(node), None)
            if g is None:
                continue
            inputs = node._recipe[1]
            out, copies = node._node
            wanted = [i for i, p in enumerate(inputs)
                      if copies[i].requires_grad and not p.stop_gradient]
            if not wanted or not out.requires_grad:
                in_grads = [None] * len(wanted)
            else:
                # several outputs share one graph: keep it for the others
                in_grads = torch.autograd.grad(
                    out, [copies[i] for i in wanted], g.to(out.dtype),
                    retain_graph=retain_graph or node._shared,
                    allow_unused=True)
            for i, pg in zip(wanted, in_grads):
                parent = inputs[i]
                if pg is None:
                    pg = torch.zeros_like(parent._value)
                if parent._recipe is None:
                    # leaf: accumulate into .grad (GradientAccumulator)
                    parent._grad = pg if parent._grad is None else parent._grad + pg
                else:
                    key = id(parent)
                    grads[key] = pg if key not in grads else grads[key] + pg
        if not retain_graph:
            for node in topo:
                node._recipe = None
                node._node = None

    # -- operators ---------------------------------------------------------
    def _b(self, other, fn, reverse=False):
        if not isinstance(other, VarBase):
            other = VarBase(torch.tensor(other, dtype=self._value.dtype,
                                         device=self._value.device),
                            stop_gradient=True)
        a, b = (other, self) if reverse else (self, other)
        return _apply(fn, a, b)

    def __add__(self, o):
        return self._b(o, torch.add)

    __radd__ = __add__

    def __sub__(self, o):
        return self._b(o, torch.sub)

    def __rsub__(self, o):
        return self._b(o, torch.sub, reverse=True)

    def __mul__(self, o):
        return self._b(o, torch.mul)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._b(o, torch.true_divide)

    def __neg__(self):
        return _apply(torch.neg, self)

    def __getitem__(self, idx):
        return _apply(lambda v: v[idx], self)

    def __repr__(self):
        return "VarBase(name=%s, shape=%s)\n%r" % (self.name, self.shape, self._value)

    def __len__(self):
        return self.shape[0]


def _no_autograd():
    """``torch.no_grad()``, or nothing where autograd is already off (a
    nested ``no_grad`` inside a ``torch.export`` trace makes the saved
    program fail to load)."""
    return torch.no_grad() if torch.is_grad_enabled() else contextlib.nullcontext()


def _needs_grad(inputs):
    tracer = _dygraph_tracer()
    return (tracer is not None and not tracer._no_grad
            and any(not v.stop_gradient for v in inputs))


def _record(fn, inputs):
    """Run ``fn`` on detached copies of the inputs, a float copy wanting a
    gradient where its VarBase does: (outputs, copies)."""
    copies = []
    for v in inputs:
        c = v._value.detach()
        if not v.stop_gradient and c.is_floating_point():
            c.requires_grad_(True)
        copies.append(c)
    with torch.enable_grad():
        return fn(*copies), copies


def _apply(fn, *inputs, **kwargs):
    """Trace one eager op: run it, record the recipe (parity: Tracer::TraceOp
    + TraceBackward)."""
    if kwargs:
        fn = functools.partial(fn, **kwargs)
    if not _needs_grad(inputs):
        with _no_autograd():
            return VarBase(fn(*[v._value for v in inputs]), stop_gradient=True)
    out_val, copies = _record(fn, inputs)
    out = VarBase(out_val.detach(), stop_gradient=False)
    out._recipe = (fn, list(inputs))
    out._node = (out_val, copies)
    return out


def _apply_multi(fn, n_out, *inputs, **kwargs):
    """Trace an op with multiple outputs: one run, each output a node of
    its own over the shared graph (the reference records a projected fn
    for each and runs it again in the sweep; the gradients are the same)."""
    if kwargs:
        fn = functools.partial(fn, **kwargs)
    if not _needs_grad(inputs):
        with _no_autograd():
            out_vals = fn(*[v._value for v in inputs])
        return [VarBase(out_vals[i], stop_gradient=True) for i in range(n_out)]
    out_vals, copies = _record(fn, inputs)
    outs = []
    for i in range(n_out):
        o = VarBase(out_vals[i].detach(), stop_gradient=False)
        o._recipe = (fn, list(inputs))
        o._node = (out_vals[i], copies)
        o._shared = n_out > 1
        outs.append(o)
    return outs


@contextlib.contextmanager
def guard(place=None):
    """Parity: dygraph/base.py guard — enables imperative mode on the
    place's device (the card unless ``place`` is ``CPUPlace()``)."""
    tracer = Tracer(place)
    with _dygraph_guard(tracer):
        yield


_global_tracer_ctx = None


def enable_dygraph(place=None):
    global _global_tracer_ctx
    _global_tracer_ctx = _dygraph_guard(Tracer(place))
    _global_tracer_ctx.__enter__()


def disable_dygraph():
    global _global_tracer_ctx
    if _global_tracer_ctx is not None:
        _global_tracer_ctx.__exit__(None, None, None)
        _global_tracer_ctx = None


def enabled():
    return in_dygraph_mode()


def to_variable(value, name=None, zero_copy=None):
    """Parity: dygraph/base.py to_variable."""
    if isinstance(value, VarBase):
        return value
    return VarBase(as_tensor(value), name=name, stop_gradient=True)


@contextlib.contextmanager
def no_grad():
    tracer = _dygraph_tracer()
    if tracer is None:
        yield
        return
    old = tracer._no_grad
    tracer._no_grad = True
    try:
        yield
    finally:
        tracer._no_grad = old
