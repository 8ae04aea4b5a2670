"""Dygraph→static capture (parity: dygraph/jit.py TracedLayer +
imperative/jit/ ProgramDesc tracing).

The counterpart of the JAX package's ``dygraph/jit.py``.  A TracedLayer
captures one program per call signature (input shapes and dtypes): the
layer's forward exported with ``torch.export`` under ``torch.no_grad()``,
its parameters an input the program reads, and beside it the parameter
tensors of the moment of that capture.  So, as the reference's
``jax.jit`` closes over them, a call at a captured signature keeps the
values the layer had then, whatever ``set_value`` did since, and a new
signature captures the current ones.  On the card each signature is
replayed as one CUDA graph with static input buffers, as
``inference.ExportedPredictor`` replays its artifact; on the CPU the
exported module runs directly.  A new signature is reported to the
monitor as a compile (``recompiles.record_compile``).

The traced call never writes to the layer: the parameters it reads are
swapped in for the capture and restored after it, so a ``BatchNorm`` in
training mode keeps real tensors in its moving statistics.
``save_inference_model`` writes the example signature's program
(``torch.export.save``) with the layer's current parameters;
``TracedLayer.load`` serves it with no layer code, on the card unless the
caller asks for the CPU."""

import io as _bytesio
import os
import pickle

import numpy as np
import torch

from ..dtypes import convert_dtype
from ..framework import _dygraph_guard
from ..kernels._common import resolve_device
from .base import Tracer, VarBase, as_tensor

__all__ = ["TracedLayer"]

# warm-up calls on a side stream before a capture (cuDNN and cuBLAS pick
# their algorithms and workspaces there, outside the graph)
_WARMUP_CALLS = 3
_PROGRAM = "__traced__"


class _Forward(torch.nn.Module):
    """``forward(state, *arrays)``: the layer's forward with its parameters
    read from ``state``, as a tuple of tensors; the layer's own parameter
    tensors are put back afterwards."""

    def __init__(self, layer, device):
        super().__init__()
        self._target = [layer]         # not an nn.Module: keep it unregistered
        self._device = device

    def forward(self, state, *arrays):
        layer = self._target[0]
        params = dict(layer.named_parameters())
        saved = {n: p._value for n, p in params.items()}
        tracer = Tracer(self._device)
        tracer._no_grad = True
        try:
            for n, p in params.items():
                p._value = state[n]
            with _dygraph_guard(tracer):
                outs = layer(*[VarBase(a, stop_gradient=True) for a in arrays])
        finally:
            for n, p in params.items():
                p._value = saved[n]
        if isinstance(outs, (list, tuple)):
            return tuple(o._value for o in outs)
        return (outs._value,)


def _export(layer, state, arrays, device):
    with torch.no_grad():
        return torch.export.export(_Forward(layer, device),
                                   (state,) + tuple(arrays))


class _Replay:
    """One captured program with the state it reads, served on ``device``:
    through a CUDA graph on the card, directly on the CPU."""

    def __init__(self, module, state, sig, device):
        self.module = module
        self.state = state
        self.device = device
        self.graph = None
        if device.type == "cuda":
            self._capture(sig)

    def _capture(self, sig):
        self.inputs = [torch.zeros(shape, dtype=convert_dtype(dt),
                                   device=self.device) for shape, dt in sig]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), torch.no_grad():
            for _ in range(_WARMUP_CALLS):
                self.module(self.state, *self.inputs)
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(self.graph):
            self.outputs = list(self.module(self.state, *self.inputs))
        torch.cuda.synchronize(self.device)

    def __call__(self, arrays):
        if self.graph is None:
            with torch.no_grad():
                return list(self.module(self.state, *arrays))
        for buf, a in zip(self.inputs, arrays):
            buf.copy_(a)
        self.graph.replay()
        return [o.clone() for o in self.outputs]


def _signature(arrays):
    return tuple((tuple(int(d) for d in a.shape), str(a.dtype).replace("torch.", ""))
                 for a in arrays)


def _wrap(res):
    out = [VarBase(r, stop_gradient=True) for r in res]
    return out if len(out) != 1 else out[0]


class TracedLayer:
    def __init__(self, layer, example_inputs, device):
        self._layer = layer
        self._example = example_inputs
        self._device = device
        self._programs = {}        # signature -> _Replay
        self._multi = None         # the layer returns a list or tuple

    def _tensors(self, inputs):
        return [i._value if isinstance(i, VarBase)
                else as_tensor(i, self._device) for i in inputs]

    def _state(self):
        return {n: p._value for n, p in self._layer.named_parameters()}

    @staticmethod
    def trace(layer, inputs):
        """Returns (outputs, TracedLayer): the layer run eagerly on
        ``inputs``, and the callable that captures its programs."""
        outs = layer(*inputs)
        device = (inputs[0]._value.device if inputs
                  and isinstance(inputs[0], VarBase) else None)
        traced = TracedLayer(layer, inputs, device or resolve_device(None))
        traced._multi = isinstance(outs, (list, tuple))
        return outs, traced

    def _program(self, arrays):
        sig = _signature(arrays)
        prog = self._programs.get(sig)
        if prog is not None:
            return prog
        state = self._state()
        ep = _export(self._layer, state, arrays, self._device)
        prog = self._programs[sig] = _Replay(ep.module(), state, sig,
                                             self._device)
        from .. import monitor as _monitor

        mon = _monitor.active()
        if mon is not None:
            # stored on the instance, not keyed by id(): a recycled id must
            # not chain a fresh layer onto a dead layer's compile history
            from ..executor import _monitor_ident

            ident = "%s(%s)" % (_monitor_ident(self, "TracedLayer"),
                                type(self._layer).__name__)
            mon.recompiles.record_compile(ident, {"signature": sig})
        return prog

    def __call__(self, *inputs):
        arrays = self._tensors(inputs)
        res = self._program(arrays)(arrays)
        if self._multi:
            return [VarBase(r, stop_gradient=True) for r in res]
        return VarBase(res[0], stop_gradient=True)

    def save_inference_model(self, dirname, feed=None, fetch=None):
        """Save the example signature's program (parity: dygraph/jit.py
        TracedLayer.save_inference_model): ``__traced__``, a
        ``torch.export.save`` of it, ``__traced__.npz`` the layer's
        parameters now and ``__traced__.meta`` their names.  Round-trips
        with ``TracedLayer.load``, which needs no layer code."""
        os.makedirs(dirname, exist_ok=True)
        arrays = self._tensors(self._example)
        state = self._state()
        ep = _export(self._layer, state, arrays, self._device)
        buf = _bytesio.BytesIO()
        torch.export.save(ep, buf)
        path = os.path.join(dirname, _PROGRAM)
        with open(path, "wb") as f:
            f.write(buf.getvalue())
        np.savez(path + ".npz", **{n: t.detach().cpu().numpy()
                                   for n, t in state.items()})
        with open(path + ".meta", "wb") as f:
            pickle.dump({"state_names": list(state)}, f)

    @staticmethod
    def load(dirname, device=None):
        """Load a saved traced program as a callable on ``device`` (the card
        unless the caller asks for the CPU; parity: load_inference_model
        over the TracedLayer save)."""
        return _LoadedTracedLayer(dirname, resolve_device(device))


class _LoadedTracedLayer:
    """A saved program: callable on tensors, arrays or VarBases, returning
    VarBases like TracedLayer (one, or a list of several); one CUDA graph
    per signature on the card."""

    def __init__(self, dirname, device):
        from torch.export.passes import move_to_device_pass

        path = os.path.join(dirname, _PROGRAM)
        with open(path, "rb") as f:
            ep = torch.export.load(_bytesio.BytesIO(f.read()))
        with open(path + ".meta", "rb") as f:
            names = pickle.load(f)["state_names"]
        with np.load(path + ".npz") as data:
            self._state = {n: torch.from_numpy(np.array(data[n])).to(device)
                           for n in names}
        self._module = move_to_device_pass(ep, str(device)).module()
        self._device = device
        self._programs = {}

    def __call__(self, *inputs):
        arrays = [i._value if isinstance(i, VarBase)
                  else as_tensor(i, self._device) for i in inputs]
        sig = _signature(arrays)
        prog = self._programs.get(sig)
        if prog is None:
            prog = self._programs[sig] = _Replay(self._module, self._state,
                                                 sig, self._device)
        return _wrap(prog(arrays))
