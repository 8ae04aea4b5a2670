"""Inference stack: the Predictor and the exported predictor.

Parity surface: the reference's deployment API
(inference/api/analysis_predictor.h:47 AnalysisPredictor — `Run` :57,
`Clone` shared-weight predictors :88; api/paddle_api.h AnalysisConfig /
PaddlePredictor contract; framework/naive_executor.h:31 NaiveExecutor).
The counterpart of the JAX package's ``inference.py``.

``Predictor`` loads a directory written by ``io.save_inference_model`` (by
either package) into a private scope and serves ``run(feed)`` through the
executor, op by op.  ``clone()`` shares the weight scope and the executor
(its plan cache): the same tensors, not copies.

``export_inference_model`` writes a ``torch.export`` program beside the
model (``__exported__``, with a ``.meta`` pickle holding the reference's
keys): an ``nn.Module`` whose ``forward(state, feed)`` runs the pruned
program's plan under ``torch.no_grad()``, traced once.  The weights stay in
``__params__.npz``.  ``ExportedPredictor`` runs that artifact with no
Program and no op rules.  On the card, the first request of a feed
signature (or ``ensure_compiled``) loads the module onto the card, warms it
on a side stream and captures one CUDA graph, with static feed buffers and
the weights on the card: the counterpart of the reference's one compiled
executable per signature.  A request then copies its feed into the graph's
buffers, replays it and returns numpy.  Capture or replay errors raise:
there is no eager route on the card.  On the CPU the exported module runs
directly.  The graphs (on the CPU, the signatures seen) are shared
process-wide by every predictor over the same artifact on the same device.
"""

import collections
import hashlib
import io as _bytesio
import os
import pickle
import threading
import time

import numpy as np
import torch

from . import io as _io
from .dtypes import convert_dtype, numpy_dtype
from .executor import Executor, _Plan, refuse_warm_dir
from .framework import CPUPlace, CUDAPlace
from .kernels._common import resolve_device
from .scope import Scope

__all__ = ["AnalysisConfig", "Predictor", "create_predictor",
           "create_paddle_predictor", "export_inference_model",
           "load_exported_model", "ExportedPredictor"]

# sub-block ops: torch.export has no loop of its own to trace them into
_CONTROL_FLOW_OPS = ("while", "conditional_block", "cond", "scan")

# warm-up calls on a side stream before a capture (cuDNN and cuBLAS pick
# their algorithms and workspaces there, outside the graph)
_WARMUP_CALLS = 3


def _place(device):
    device = torch.device(device)
    if device.type == "cpu":
        return CPUPlace()
    return CUDAPlace(device.index if device.index is not None
                     else torch.cuda.current_device())


class AnalysisConfig:
    """Parity: inference/api/paddle_analysis_config.h.  ``use_gpu`` (second
    name ``use_tpu``, so configs written for the JAX package run unchanged)
    selects the card; ``disable_gpu()`` the CPU.  The IR-pass and memory
    knobs are accepted and recorded, as in the JAX package."""

    def __init__(self, model_dir=None, prog_file=None, params_file=None):
        self.model_dir = model_dir
        self.prog_file = prog_file
        self.params_file = params_file
        self.use_gpu = True
        self._cpu_math_threads = 1
        self._mem_optim = True
        self._ir_optim = True

    @property
    def use_tpu(self):
        return self.use_gpu

    @use_tpu.setter
    def use_tpu(self, flag):
        self.use_gpu = flag

    def set_model(self, model_dir, params_file=None):
        self.model_dir = model_dir
        self.params_file = params_file

    def disable_gpu(self):
        self.use_gpu = False

    def enable_use_gpu(self, *_a, **_k):
        self.use_gpu = True

    def switch_ir_optim(self, flag=True):
        self._ir_optim = flag

    def enable_memory_optim(self, flag=True):
        self._mem_optim = flag

    def set_cpu_math_library_num_threads(self, n):
        self._cpu_math_threads = n


class Predictor:
    """Parity: AnalysisPredictor (analysis_predictor.h:47).

    Loads a saved inference model into a private weight scope and serves
    run(feed) -> fetches through the executor (one plan per feed
    signature, made on first use)."""

    def __init__(self, config, _shared=None):
        self._config = config
        if _shared is not None:
            # Clone(): share the weights AND the executor's plan cache
            (self._program, self._feed_names, self._fetch_vars,
             self._scope, self._exe) = _shared
            return
        self._scope = Scope()
        self._exe = Executor(CUDAPlace(0) if config.use_gpu else CPUPlace())
        self._program, self._feed_names, self._fetch_vars = (
            _io.load_inference_model(
                config.model_dir, self._exe,
                model_filename=config.prog_file,
                params_filename=config.params_file,
                scope=self._scope))

    # -- PaddlePredictor contract ---------------------------------------
    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return [v.name for v in self._fetch_vars]

    def run(self, feed):
        """feed: dict name->array, or list of arrays in get_input_names()
        order.  Returns list of numpy arrays (fetch order)."""
        if not isinstance(feed, dict):
            feed = dict(zip(self._feed_names, feed))
        return self._exe.run(self._program, feed=feed,
                             fetch_list=self._fetch_vars, scope=self._scope)

    def clone(self):
        """Parity: AnalysisPredictor::Clone (:88) — a new predictor sharing
        one copy of the weights and the executor's plans."""
        return Predictor(self._config, _shared=(
            self._program, self._feed_names, self._fetch_vars,
            self._scope, self._exe))


def create_predictor(config):
    return Predictor(config)


# reference spelling (api/paddle_api.h CreatePaddlePredictor)
create_paddle_predictor = create_predictor


# ---------------------------------------------------------------------------
# Export: a torch.export program, runnable without the Program machinery
# ---------------------------------------------------------------------------

class _InferenceModule(torch.nn.Module):
    """``forward(state, feed) -> [fetches]``: the pruned program's plan run
    once under ``torch.no_grad()`` (what ``torch.export`` traces)."""

    def __init__(self, program, fetch_names, device):
        super().__init__()
        self._plan = _Plan(program)
        self._fetch_names = list(fetch_names)
        self._ctx = self._plan.context(torch.Generator(device).manual_seed(0))

    def forward(self, state, feed):
        env = dict(state)
        env.update(feed)
        self._plan.run(env, self._ctx)      # forward only: under no_grad
        return [env[n] for n in self._fetch_names]


def export_inference_model(dirname, feed_shapes, exported_name="__exported__",
                           feed_dtypes=None, poly_batch=False,
                           poly_axes=None, device=None):
    """Trace the saved inference model at ``dirname`` with ``torch.export``
    for the given input shapes and save it beside ``__model__``.

    feed_shapes: dict feed_name -> shape tuple (batch included).  The
    artifact (``torch.export.save``) and a small meta file land next to
    ``__model__``; the weights stay in ``__params__.npz``.  Load with
    ``load_exported_model``.

    Symbolic dimensions: ``poly_batch=True`` makes every feed's leading
    axis one ``torch.export.Dim("b")``, so ONE artifact serves every batch
    bucket.  ``poly_axes`` generalises: ``{feed_name: {axis: "symbol"}}``;
    axes naming the same symbol share one ``Dim``.  A symbolic axis is
    traced at size 2 when ``feed_shapes`` gives it less (an example of 0 or
    1 would make the trace specialise it).

    The trace runs on ``device`` (the card unless the caller asks for the
    CPU); ``load_exported_model`` moves the program to the device it
    serves on.  A program with sub-blocks raises: tracing ``while`` /
    ``cond`` / ``scan`` waits (ROADMAP Queue 1 item 3, export of
    sub-blocks)."""
    device = resolve_device(device)
    exe = Executor(_place(device))
    scope = Scope()
    program, feed_names, fetch_vars = _io.load_inference_model(
        dirname, exe, scope=scope)
    flow = sorted({op.type for op in program.global_block().ops
                   if op.type in _CONTROL_FLOW_OPS})
    if flow:
        raise NotImplementedError(
            "export_inference_model: the program runs sub-blocks (%s); "
            "exporting them needs torch.export's control-flow operators and "
            "waits (ROADMAP Queue 1 item 3, export of sub-blocks) — serve it "
            "with create_predictor" % ", ".join(flow))
    fetch_names = [v.name for v in fetch_vars]
    module = _InferenceModule(program, fetch_names, device)

    sym_of = {}              # feed -> {axis: symbol name}
    if poly_batch:
        for n in feed_names:
            sym_of.setdefault(n, {})[0] = "b"
    for n, axes in (poly_axes or {}).items():
        for axis, name in axes.items():
            sym_of.setdefault(n, {})[int(axis)] = str(name)
    dims = {s: torch.export.Dim(s) for s in sorted(
        {s for axes in sym_of.values() for s in axes.values()})}

    block = program.global_block()
    dtypes, feed, dynamic = {}, {}, {}
    for n in sorted(feed_names):
        var = block._find_var_recursive(n)
        dtypes[n] = np.dtype((feed_dtypes or {}).get(
            n, numpy_dtype(var.dtype) if var is not None else "float32")).name
        axes = sym_of.get(n, {})
        shape = [max(int(d), 2) if i in axes else int(d)
                 for i, d in enumerate(feed_shapes[n])]
        feed[n] = torch.zeros(shape, dtype=convert_dtype(dtypes[n]),
                              device=device)
        dynamic[n] = {i: dims[s] for i, s in axes.items()} or None
    state = {n: scope.find_var(n) for n in sorted(module._plan.state_in)}
    exported = torch.export.export(
        module, (state, feed),
        dynamic_shapes={"state": {n: None for n in state}, "feed": dynamic})
    path = os.path.join(dirname, exported_name)
    buf = _bytesio.BytesIO()
    torch.export.save(exported, buf)
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    with open(path + ".meta", "wb") as f:
        pickle.dump({"feed_names": list(feed_names),
                     "fetch_names": fetch_names,
                     "state_names": list(state),
                     "feed_shapes": {k: tuple(v) for k, v in feed_shapes.items()},
                     "poly": {k: dict(v) for k, v in sym_of.items()},
                     "feed_dtypes": dtypes},
                    f)
    return path


class _Graph:
    """One captured feed signature: the graph, its static feed buffers, the
    outputs it writes, and the memory ledger of its capture."""

    def __init__(self, graph, feeds, outputs, seconds, ledger=None):
        self.graph = graph
        self.feeds = feeds
        self.outputs = outputs
        self.capture_seconds = seconds
        self.ledger = ledger


class _SharedCall:
    """One artifact on one device, shared by every predictor over it: the
    exported module and the signatures it has served.  On the card, one
    captured graph per signature, every graph reading the same weight
    buffers; ``loaded`` names the predictor state they hold, and ``lock``
    serialises loading, capturing and replaying."""

    def __init__(self, blob, device):
        from torch.export.passes import move_to_device_pass

        self.device = device
        ep = torch.export.load(_bytesio.BytesIO(blob))
        self.module = move_to_device_pass(ep, str(device)).module()
        self.signatures = {}     # feed signature -> _Graph (None on the CPU)
        self.weights = None
        self.loaded = None
        self.lock = threading.Lock()

    def load(self, pred):
        """Make the graphs' weight buffers hold ``pred``'s state."""
        if self.loaded is pred._token:
            return
        if self.weights is None:
            self.weights = {n: t.clone() for n, t in pred._state.items()}
        else:
            for n, t in self.weights.items():
                t.copy_(pred._state[n])
        self.loaded = pred._token

    def capture(self, sig):
        """Warm the module on a side stream, then capture one graph of it
        reading static feed buffers and the weight buffers."""
        from .monitor import memscope

        t0 = time.perf_counter()
        feeds = {n: torch.zeros(shape, dtype=convert_dtype(dt),
                                device=self.device)
                 for n, shape, dt in sig}
        # the ledger counts the warm-up's transient allocations and the
        # graph's private pool (its outputs included) as what the capture
        # added on the card
        probe = memscope.LedgerProbe(
            self.device, list(self.weights.values()) + list(feeds.values()))
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), torch.no_grad():
            for _ in range(_WARMUP_CALLS):
                self.module(self.weights, feeds)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(graph):
            outputs = self.module(self.weights, feeds)
        torch.cuda.synchronize(self.device)
        g = _Graph(graph, feeds, list(outputs), time.perf_counter() - t0,
                   ledger=probe.finish(outputs))
        self.signatures[sig] = g
        return g


# process-level memo, keyed by (artifact content fingerprint, device): two
# predictors over the same artifact share ONE module and one graph per feed
# signature.  Bounded LRU: a serving process cycling many models must not
# keep every artifact's graphs forever.
_EXPORT_MEMO = collections.OrderedDict()
_EXPORT_MEMO_MAX = 64
_EXPORT_MEMO_LOCK = threading.Lock()


class ExportedPredictor:
    """Runs an exported artifact: weights + traced module, zero Program
    interpretation, one captured CUDA graph per feed signature on the card
    (see the module docstring)."""

    def __init__(self, dirname, exported_name="__exported__", device=None):
        refuse_warm_dir()
        self.device = resolve_device(device)
        path = os.path.join(dirname, exported_name)
        with open(path, "rb") as f:
            self._blob = f.read()
        # content identity: a re-exported (changed) artifact never aliases
        # a stale module or graph
        self._artifact_fp = hashlib.sha256(self._blob).hexdigest()[:40]
        with open(path + ".meta", "rb") as f:
            meta = pickle.load(f)
        self._feed_names = meta["feed_names"]
        self._fetch_names = meta["fetch_names"]
        self._feed_dtypes = meta["feed_dtypes"]
        # declared batch buckets (declare_batch_buckets): when set, run()
        # pads a smaller leading dim UP to the nearest bucket and slices
        # the result, so a fresh request size never means a fresh capture
        self._buckets = None
        with np.load(os.path.join(dirname, "__params__.npz")) as data:
            self._state = {n: torch.from_numpy(np.array(data[n])).to(self.device)
                           for n in sorted(meta["state_names"])}
        # identifies the state the shared graphs' weight buffers hold
        self._token = object()

    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    def _shared(self):
        key = (self._artifact_fp, str(self.device))
        with _EXPORT_MEMO_LOCK:
            call = _EXPORT_MEMO.get(key)
            if call is None:
                call = _EXPORT_MEMO[key] = _SharedCall(self._blob, self.device)
            _EXPORT_MEMO.move_to_end(key)
            while len(_EXPORT_MEMO) > _EXPORT_MEMO_MAX:
                _EXPORT_MEMO.popitem(last=False)
        return call

    # -- bucketed shapes (the serving-lattice contract) ------------------
    def declare_batch_buckets(self, buckets):
        """Declare ascending batch buckets: ``run`` thereafter pads any
        feed whose shared leading dim is smaller than a bucket UP to the
        nearest one (zeros) and slices every leading-dim output back — so
        a varying request size reuses a handful of captured signatures
        (row-wise models make the padding bit-exact; the artifact must
        cover the bucket shapes: one ``poly_batch=True`` export).  ``None``
        clears.

        Caveat: which outputs to slice is a heuristic — any output whose
        leading dim equals the padded bucket is treated as batch-carrying.
        A model with a FIXED-shape output whose leading dim coincides with
        a declared bucket would be wrongly sliced; don't declare buckets
        for such models."""
        if buckets is None:
            self._buckets = None
            return self
        from .serving.lattice import BucketLattice

        lat = BucketLattice(buckets)
        self._buckets = list(lat.batch_buckets)
        self._bucket_for = lat.route_batch   # RequestTooLarge (ValueError)
        return self

    @staticmethod
    def _pad_leading(arr, b):
        if arr.shape[0] == b:
            return arr
        pad = np.zeros((b - arr.shape[0],) + arr.shape[1:], arr.dtype)
        return np.concatenate([arr, pad], axis=0)

    def _host_feed(self, feed):
        if not isinstance(feed, dict):
            feed = dict(zip(self._feed_names, feed))
        return {n: np.ascontiguousarray(np.asarray(
                    v.detach().cpu() if isinstance(v, torch.Tensor) else v,
                    dtype=self._feed_dtypes[n]))
                for n, v in feed.items()}

    @staticmethod
    def _sig(feed_spec):
        return tuple((n, tuple(int(d) for d in shape), np.dtype(dt).name)
                     for n, (shape, dt) in sorted(feed_spec.items()))

    def run(self, feed):
        feed = self._host_feed(feed)
        n = None
        if self._buckets is not None:
            dims = {v.shape[0] for v in feed.values() if v.ndim}
            if len(dims) > 1:
                # refusing beats degrading: silently skipping the pad would
                # capture a fresh signature per request size — the exact
                # failure buckets exist to prevent
                raise ValueError(
                    "batch buckets are declared but the feeds do not "
                    "share one leading dim (%r) — a mixed-leading-dim "
                    "model cannot be bucket-padded; clear the buckets "
                    "(declare_batch_buckets(None)) or restructure the "
                    "feeds" % {k: v.shape for k, v in feed.items()})
            if len(dims) == 1:
                (n,) = dims
                b = self._bucket_for(n)
                if b != n:
                    feed = {k: (self._pad_leading(v, b) if v.ndim else v)
                            for k, v in feed.items()}
                else:
                    n = None           # exact bucket: nothing to slice
        sig = self._sig({k: (v.shape, v.dtype) for k, v in feed.items()})
        out = self._run_sig(sig, feed)
        if n is not None:
            # slice the pad rows back off every leading-dim output (a
            # fetch that does not carry the batch dim passes through)
            b = next(v.shape[0] for v in feed.values() if v.ndim)
            out = [x[:n] if x.ndim and x.shape[0] == b else x for x in out]
        return out

    # the serving surface: a predictor IS its call
    __call__ = run

    def _run_sig(self, sig, feed):
        call = self._shared()
        if self.device.type == "cpu":
            with torch.no_grad():
                outs = call.module(self._state, {k: torch.from_numpy(feed[k])
                                                 for k in sorted(feed)})
            with call.lock:
                call.signatures.setdefault(sig, None)
            return [o.numpy() for o in outs]
        with call.lock:
            call.load(self)
            g = call.signatures.get(sig) or call.capture(sig)
            for k, buf in g.feeds.items():
                buf.copy_(torch.from_numpy(feed[k]))
            g.graph.replay()
            return [o.cpu().numpy() for o in g.outputs]

    def swap_state(self, new_state):
        """Replace the weights with a SAME-SIGNATURE set — the online
        hot-swap primitive.  The graphs read the weights from buffers on
        the card, so a swap that keeps every weight's shape and dtype costs
        no new capture; one that does not is refused (the publish is not
        call-compatible with this artifact).  On the card the new weights
        are copied into those buffers under the lock that ``run`` holds:
        every request sees all-old or all-new weights, never a mix.  Extra
        names in ``new_state`` are ignored."""
        cur = self._state
        missing = [n for n in cur if n not in new_state]
        if missing:
            raise KeyError(
                "swap_state: new state is missing weight(s) %r" % missing)
        staged = {}
        for n, old in cur.items():
            v = new_state[n]
            t = (v.detach() if isinstance(v, torch.Tensor)
                 else torch.from_numpy(np.array(v)))
            if (tuple(t.shape), t.dtype) != (tuple(old.shape), old.dtype):
                raise ValueError(
                    "swap_state: weight %r is %s/%s but the artifact was "
                    "exported with %s/%s — a signature change cannot "
                    "hot-swap; re-export and restart the replica"
                    % (n, tuple(t.shape), t.dtype, tuple(old.shape),
                       old.dtype))
            staged[n] = t.to(self.device, copy=True)
        call = self._shared()
        with call.lock:
            held = call.loaded is self._token
            self._state = staged
            self._token = object()
            if held:
                call.load(self)
        return len(staged)

    def compiled_signature_count(self):
        """How many feed signatures this artifact's shared call has captured
        on this device (on the CPU: served), process-wide.  A serving engine
        snapshots it after capturing its lattice and checks that it never
        grows in steady state."""
        call = self._shared()
        with call.lock:
            return len(call.signatures)

    def ensure_compiled(self, feed_spec):
        """Capture the graph of one feed signature WITHOUT serving a
        request — the serving lattice's capture-first path.

        ``feed_spec``: {feed_name: (shape, dtype)} with the batch dim
        included.  Returns ``(source, graph)``: source is "cached" when the
        signature was already captured, else "compiled"; the graph is the
        captured ``torch.cuda.CUDAGraph`` (None on the CPU, where the module
        runs as it is)."""
        sig = self._sig(feed_spec)
        call = self._shared()
        with call.lock:
            if sig in call.signatures:
                g = call.signatures[sig]
                return "cached", None if g is None else g.graph
            if self.device.type == "cpu":
                call.signatures[sig] = None
                return "compiled", None
            call.load(self)
            return "compiled", call.capture(sig).graph

    def signature_ledger(self, feed_spec):
        """The memory ledger of one captured signature (``memscope``
        keys: argument, output and temp bytes), or None where nothing was
        captured (the CPU, or a signature not captured yet)."""
        sig = self._sig(feed_spec)
        call = self._shared()
        with call.lock:
            g = call.signatures.get(sig)
            return None if g is None else dict(g.ledger or {})

    def capture_seconds(self):
        """{feed signature: seconds its capture took, warm-up included}."""
        call = self._shared()
        with call.lock:
            return {sig: g.capture_seconds
                    for sig, g in call.signatures.items() if g is not None}


def load_exported_model(dirname, exported_name="__exported__", device=None):
    return ExportedPredictor(dirname, exported_name, device=device)
