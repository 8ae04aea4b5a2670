"""ServeLoop: continuous-batching online serving on a pre-captured lattice.

Counterpart of ``paddle_tpu/serving/engine.py``, with its structure and
names.  The reference serves "millions of users" through AnalysisPredictor
pools behind an RPC server — the engine cache holds one optimized program,
a thread pool feeds it, and the PSLib serving scenario pulls sparse CTR
rows read-only.  This module is that deployment shape over the port's own
primitives:

- **the lattice is the capture contract** (lattice.py): every shape the
  server will ever dispatch is declared up front and captured at
  ``start()`` through ``ExportedPredictor.ensure_compiled`` — on the card
  one CUDA graph per lattice point, captured before the loop thread exists
  (a global-mode capture fails if another thread touches the card), so
  steady-state serving only replays.  The recompile detector runs in its
  ``strict`` mode as a hard gate: an off-lattice shape raises
  ``RecompileStorm`` instead of silently capturing under load;

- **continuous batching**: requests are admitted into and evicted from the
  in-flight batch PER STEP.  Each step takes rows round-robin-fairly
  across every in-flight request up to the largest batch bucket, pads to
  the nearest lattice point, dispatches once, and scatters per-row outputs
  back — so a 4-row request admitted next to a 500-row one completes in
  its first step instead of queueing behind the giant (the
  ``mode="static"`` loop, kept for the A/B bench, is exactly that
  head-of-line world: one request at a time, run to completion);

- **admission is memory-aware**: ``submit`` consults the MemScope headroom
  predictor against the lattice's own capture ledgers (temp + output
  bytes of the largest point, as ``memscope.LedgerProbe`` measured each
  capture) and refuses with ``Backpressure`` when dispatching another
  batch could run the card out of memory — a typed, retryable client
  rejection instead of a server OOM;

- **sparse CTR lookups** ride read-only HostPS (service.py
  ``read_only=True``): a ``CTRLookup`` stage resolves id slots through the
  HotRowCache (device hits, host-table misses, zero pushes, zero moment
  updates — the PSLib serving scenario) before the batch pads and
  dispatches.  The port's pull returns the rows on the card; the lookup
  brings them to the host, where the batch is assembled, and the
  predictor copies the batch up into its graph's feed buffer;

- **telemetry** (metrics.py): p50/p99 latency gauges, QPS, per-step
  batch-occupancy histogram, admit/evict/backpressure counters in the
  monitor registry, per-step ``serve`` timeline events and a final
  ``serve_summary`` — the reference's names, so ``trace_summary``'s serve
  section reads a port monitor directory unchanged.
"""

import threading
import time

import numpy as np
import torch

from .. import monitor as _monitor
from ..monitor import memscope as _memscope
from ..monitor import trace as _trace
from ..monitor import tracemesh as _tmesh
from ..monitor.recompile import RecompileDetector
from .lattice import BucketLattice, RequestTooLarge
from .metrics import ServeStats
from .queue import (Backpressure, DeadlineExceeded, QueueFull, RequestQueue,
                    ServeError, ServeRequest)

__all__ = ["ServeEngine", "CTRLookup", "Backpressure", "QueueFull",
           "RequestTooLarge", "ServeError", "ServeRequest",
           "DeadlineExceeded", "BucketLattice"]

# the seq-axis placeholder a feed_spec row shape uses where the sequence
# bucket substitutes (e.g. {"tok": (("seq",), "int32")})
SEQ = "seq"


class CTRLookup:
    """Resolve an id slot through a READ-ONLY HostPS embedding before the
    batch dispatches — the PSLib serving scenario: hot rows gathered from
    the HBM HotRowCache, cold rows from the host table, no push path, no
    moment updates.  ``feed[ids_name]`` ([rows, k] int) is replaced by
    ``feed[out_name]`` = the pulled embeddings flattened to
    [rows, k * dim] float32 (what the exported model was trained on), as
    a host array: the embedding's pull gives a tensor on its device."""

    def __init__(self, embedding, ids_name, out_name=None, flatten=True):
        if not getattr(embedding, "read_only", False):
            raise ValueError(
                "CTRLookup requires a read-only HostPS embedding "
                "(HostPSEmbedding(..., read_only=True)): the serving path "
                "must not be able to write the table")
        self.embedding = embedding
        self.ids_name = ids_name
        self.out_name = out_name or ids_name + "_emb"
        self.flatten = bool(flatten)

    def out_row_shape(self, ids_row_shape):
        """Predictor-side row shape for feed_spec: ids [k] -> [k * dim]
        (flattened) or [k, dim]."""
        k = int(np.prod(ids_row_shape)) if ids_row_shape else 1
        if self.flatten:
            return (k * self.embedding.dim,)
        return tuple(ids_row_shape) + (self.embedding.dim,)

    def __call__(self, feed):
        ids = feed.pop(self.ids_name)
        vals = self.embedding.pull(ids)
        if isinstance(vals, torch.Tensor):
            vals = vals.detach().cpu().numpy()
        vals = np.asarray(vals)
        if self.flatten:
            vals = vals.reshape(vals.shape[0], -1)
        feed[self.out_name] = vals
        return feed


class _Flight:
    """One admitted request's in-flight cursor."""

    __slots__ = ("req", "cursor")

    def __init__(self, req):
        self.req = req
        self.cursor = 0

    @property
    def remaining(self):
        return self.req.rows - self.cursor


class ServeEngine:
    """The serve loop over an ``ExportedPredictor``.

    ``feed_spec`` declares the PREDICTOR-side feeds (post-lookup):
    ``{name: (row_shape, dtype)}`` where ``row_shape`` excludes the
    leading batch dim and may contain the ``SEQ`` placeholder where the
    lattice's sequence bucket substitutes.  ``lookups`` run on each
    assembled (unpadded) batch before dispatch, so the cache sees only
    real ids, never padding."""

    def __init__(self, predictor, lattice, feed_spec, mode="continuous",
                 lookups=(), queue_capacity=256, max_inflight=None,
                 name="serve", registry=None):
        if mode not in ("continuous", "static"):
            raise ValueError("mode must be 'continuous' or 'static'")
        self.predictor = predictor
        self.lattice = lattice
        self.mode = mode
        self.feed_spec = {
            str(k): (tuple(shape), np.dtype(dt))
            for k, (shape, dt) in feed_spec.items()}
        self.lookups = list(lookups)
        self.name = name
        self.stats = ServeStats(registry=registry, prefix=name)
        self.queue = RequestQueue(queue_capacity, name=name + ".queue",
                                  registry=self.stats.registry)
        self.max_inflight = int(max_inflight or 2 * lattice.max_batch)
        self._seq_feeds = {n for n, (shape, _dt) in self.feed_spec.items()
                           if SEQ in shape}
        if self._seq_feeds and lattice.seq_buckets is None:
            raise ValueError("feed_spec declares a %r axis but the lattice "
                             "has no seq_buckets" % SEQ)
        # the REQUEST-side feed names: predictor feeds minus each lookup's
        # output, plus its ids slot.  Submit validates against this set so
        # a malformed request is a per-request ValueError, never a
        # mid-batch KeyError that would take the whole loop down
        req_names = set(self.feed_spec)
        for lk in self.lookups:
            req_names.discard(lk.out_name)
            req_names.add(lk.ids_name)
        self._request_names = frozenset(req_names)
        self._ident = "%s:%s" % (
            name, getattr(predictor, "_artifact_fp", "artifact")[:8])
        self._precompiled = set()
        self._need_bytes = None
        self._admit_verdict = (0.0, True)    # (expires, ok) TTL cache
        self._admit_lock = threading.Lock()
        self._inflight = []
        self.step_count = 0          # dispatch steps taken so far
        self._thread = None
        self._stopping = False
        self._started = False
        self.detector = None
        self.last_summary = None
        self.error = None            # loop-fatal error (RecompileStorm...)
        self._sig_count0 = None
        # hot-swap state (request_swap): the pending swap is applied BY THE
        # LOOP THREAD at an empty-in-flight step boundary, so a version
        # flip is an internal state replacement, never a stop()/start()
        self.version = None
        self._swap = None
        self._swap_lock = threading.Lock()

    # ---------------------------------------------------------------- util
    def _mon(self):
        return _monitor.active()

    def _point_shapes(self, bucket, seq):
        """Predictor-side aval spec {name: (shape, dtype)} for one lattice
        point."""
        out = {}
        for n, (row_shape, dt) in self.feed_spec.items():
            shape = tuple(seq if d == SEQ else d for d in row_shape)
            out[n] = ((bucket,) + shape, dt)
        return out

    def _feed_row_bytes(self, seq):
        total = 0
        for _n, (row_shape, dt) in self.feed_spec.items():
            shape = tuple(seq if d == SEQ else d for d in row_shape)
            total += int(np.prod(shape, dtype=np.int64) or 1) * dt.itemsize
        return total

    # --------------------------------------------------------------- start
    def start(self):
        """Capture every lattice point (``ensure_compiled``: one CUDA graph
        each on the card, shared process-wide by the artifact's
        predictors), seed the strict recompile gate's baseline, derive the
        admission byte requirement, spawn the loop.  ``sources`` counts
        "compiled" (captured now) and "cached" (captured before); "disk"
        stays 0 until the port has a warm store."""
        if self._started:
            return self
        if self._stopping or self.error is not None:
            # an engine is one-shot: the queue is closed and the flags are
            # final — a silent restart would spawn a loop that exits
            # instantly (duplicate serve_summary) while every submit still
            # refuses.  Build a fresh engine instead.
            raise ServeError(
                "engine %r already served and stopped%s — engines are "
                "one-shot; construct a new ServeEngine"
                % (self.name, "" if self.error is None
                   else " (died: %r)" % self.error))
        mon = self._mon()
        reg = self.stats.registry
        self.detector = RecompileDetector(
            reg, mon.timeline if mon else None, warn_after=0, strict=True)
        self.predictor.declare_batch_buckets(self.lattice.batch_buckets)
        need = 0
        t0 = time.perf_counter()
        sources = {"cached": 0, "disk": 0, "compiled": 0}
        for bucket, seq in self.lattice.points():
            shapes = self._point_shapes(bucket, seq)
            src, _graph = self.predictor.ensure_compiled(shapes)
            sources[src] = sources.get(src, 0) + 1
            self._precompiled.add((bucket, seq))
            # the point's capture ledger (memscope.LedgerProbe around the
            # capture; None on the CPU) feeds admission, and the MemScope
            # program tables when a session is live
            ledger = self.predictor.signature_ledger(shapes)
            if mon is not None:
                ident = "%s:b%d%s" % (self._ident, bucket,
                                      "" if seq is None else "s%d" % seq)
                _memscope.record_program(mon, ident, ledger,
                                         source="serve_precompile")
            mb = _memscope.model_bytes(ledger)
            est = bucket * self._feed_row_bytes(seq)
            need = max(need, (mb or 0), est)
        self._need_bytes = need or None
        # seed the strict gate's baseline: the lattice IS the key set; any
        # later drift diffs against it and raises with the component named
        self.detector.record_warm(
            self._ident, {"feed": sorted(self._precompiled)})
        reg.gauge(self.name + ".lattice_points").set(len(self._precompiled))
        if mon is not None:
            mon.timeline.emit(
                "serve_start", mode=self.mode, ident=self._ident,
                lattice=self.lattice.describe(),
                points=len(self._precompiled),
                precompile_ms=round((time.perf_counter() - t0) * 1e3, 1),
                sources=sources, need_bytes=self._need_bytes)
        self.precompile_sources = sources
        # steady-state honesty check: the artifact's captured-signature
        # count must never grow past this point (a silent capture the
        # detector's lattice check could not see)
        try:
            self._sig_count0 = self.predictor.compiled_signature_count()
        except Exception:
            self._sig_count0 = None
        self.stats.start_clock()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=self.name + "-loop")
        self._started = True
        self._thread.start()
        return self

    # ----------------------------------------------------------- admission
    def _headroom_ok(self):
        """MemScope admission: would one more largest-point dispatch fit
        every device's headroom?  Throttled to one live check per 0.25s —
        a headroom read is not per-request work.  Devices that report no
        limit (and no configured one) do not gate."""
        if self._need_bytes is None:
            return True
        now = time.monotonic()
        with self._admit_lock:
            expires, ok = self._admit_verdict
            if now < expires:
                return ok
            try:
                hr = _memscope.headroom()
            except Exception:
                hr = {}
            worst = None
            for h in hr.values():
                if h.get("headroom") is None:
                    continue
                worst = (h["headroom"] if worst is None
                         else min(worst, h["headroom"]))
            ok = worst is None or self._need_bytes <= worst
            self._admit_verdict = (now + 0.25, ok)
            self._last_headroom = worst
            return ok

    def submit(self, feed, seq_len=None, timeout=None, priority=None,
               deadline=None):
        """Enqueue one request; returns the ``ServeRequest`` future.

        ``deadline`` (absolute ``time.time()`` wall seconds) is the
        client's propagated give-up instant: a request still queued past
        it is fast-failed with ``DeadlineExceeded`` — it never takes a
        lattice slot.  ``priority`` rides the request for the router's
        shed policy (the engine itself serves FIFO).

        Raises ``RequestTooLarge`` (sequence past the lattice),
        ``Backpressure`` (MemScope headroom refusal — retry later), or
        ``QueueFull`` (bounded queue stayed full past ``timeout``)."""
        if not self._started or self._stopping:
            raise ServeError("engine not serving")
        if self.error is not None:
            raise ServeError("engine died: %r" % self.error)
        req = feed if isinstance(feed, ServeRequest) \
            else ServeRequest(feed, seq_len=seq_len,
                              priority=1 if priority is None else priority,
                              deadline=deadline)
        if req.expired():
            # already dead on arrival: refuse before the queue, typed
            self.stats.registry.counter(
                self.name + ".deadline_expired").incr()
            raise DeadlineExceeded(
                "request %d: client deadline already passed at submit"
                % req.id)
        if set(req.feed) != self._request_names:
            raise ValueError(
                "request feeds %s do not match the engine's contract %s"
                % (sorted(req.feed), sorted(self._request_names)))
        if self.lattice.seq_buckets is not None:
            if req.seq_len is None:
                raise ValueError("lattice declares seq_buckets: submit "
                                 "needs seq_len")
            self.lattice.route_seq(req.seq_len)   # RequestTooLarge gate
        if not self._headroom_ok():
            self.stats.backpressure()
            raise Backpressure(
                "admission refused: serving the largest lattice point "
                "needs ~%d bytes but device headroom is %s — MemScope "
                "predicts a dispatch would run out of memory; retry later"
                % (self._need_bytes, getattr(self, "_last_headroom", None)))
        # stage decomposition armed only under a monitor session — the
        # unmonitored submit pays one module-global read
        if self._mon() is not None:
            req.stage_ms = {"assemble": 0.0, "device": 0.0, "reply": 0.0}
            if _trace.active_tracer() is not None:
                # each request roots its own trace: the per-request mesh id
                # the ring record, the timeline event, and trace_merge join
                req.tm = _tmesh.link()
        self.queue.put(req, timeout=timeout)
        req.t_admit = time.perf_counter()
        # close the submit/shutdown race: if the loop died (strict trip)
        # or a concurrent stop() began AFTER the checks above but its
        # drain ran BEFORE this put landed, nothing will ever pop the
        # request — take it back and refuse, instead of stranding the
        # future forever.  (remove() returning False means a drain or the
        # loop already owns it: either it serves or it fails, never hangs.)
        if ((self.error is not None or self._stopping)
                and self.queue.remove(req)):
            raise ServeError(
                "engine %s" % ("died: %r" % self.error
                               if self.error is not None else "stopping"))
        return req

    # ------------------------------------------------------------ hot swap
    def request_swap(self, apply_fn, version=None, timeout=None):
        """Schedule a zero-drop version flip (the online VersionSwapper's
        engine half).  ``apply_fn()`` runs ON THE LOOP THREAD at
        the next step boundary with NO requests in flight: admission pauses
        (the queue keeps accepting submits — nothing is dropped), every
        in-flight request completes on the OLD weights, the flip applies,
        admission resumes.  The swap is an internal predictor-state
        replacement — the one-shot stop()/start() contract is untouched,
        the loop never exits, and exactly one ``serve_summary`` is still
        emitted at shutdown.

        ``apply_fn`` may return a dict merged into the ``serve_flip``
        timeline event (train_step, freshness lag...).  Returns the event
        dict once applied; an apply_fn exception leaves the OLD version
        serving and re-raises here.  One swap at a time."""
        if not self._started or self._stopping:
            raise ServeError("engine not serving")
        if self.error is not None:
            raise ServeError("engine died: %r" % self.error)
        holder = {"done": threading.Event(), "t0": time.perf_counter()}
        if _trace.active_tracer() is not None:
            # the caller's mesh context (the swapper's verify span) parents
            # the loop-thread flip span — publish->verify->flip is ONE trace
            holder["tm"] = _tmesh.current()
        with self._swap_lock:
            if self._swap is not None:
                raise ServeError("a version swap is already pending")
            self._swap = (apply_fn, version, holder)
        if not holder["done"].wait(timeout):
            raise ServeError("version swap did not apply within %ss"
                             % timeout)
        if "error" in holder:
            raise holder["error"]
        return holder["event"]

    def _apply_swap(self):
        """Loop-thread half of ``request_swap``: in-flight is empty, apply
        the new version, time the flip, emit ``serve_flip``."""
        with self._swap_lock:
            swap, self._swap = self._swap, None
        if swap is None:
            return
        apply_fn, version, holder = swap
        t_apply = time.perf_counter()
        sp = _trace.null_span()
        if _trace.active_tracer() is not None:
            _ctx, targs = _tmesh.link(holder.get("tm"))
            if version is not None:
                targs["version"] = version
            sp = _trace.span("online.swap.flip", **targs)
        try:
            with sp:
                extra = apply_fn() or {}
        except BaseException as e:               # noqa: BLE001
            # a failed apply leaves the OLD version serving: the loop keeps
            # running, the requester gets the cause
            holder["error"] = e
            holder["done"].set()
            return
        now = time.perf_counter()
        event = {"version": version,
                 "stall_ms": round((now - holder["t0"]) * 1e3, 3),
                 "apply_ms": round((now - t_apply) * 1e3, 3)}
        event.update(extra)
        self.version = version
        if version is not None:
            try:
                self.stats.registry.gauge(self.name + ".version").set(
                    float(version))
            except (TypeError, ValueError):
                pass
        self.stats.registry.counter(self.name + ".swaps").incr()
        mon = self._mon()
        if mon is not None:
            mon.timeline.emit("serve_flip", mode=self.mode,
                              ident=self._ident, **event)
            mon.timeline.flush()
        holder["event"] = event
        holder["done"].set()

    def _fail_pending_swap(self, exc):
        with self._swap_lock:
            swap, self._swap = self._swap, None
        if swap is not None:
            _fn, _version, holder = swap
            holder["error"] = exc
            holder["done"].set()

    # ---------------------------------------------------------- serve loop
    def _loop(self):
        try:
            if self.mode == "continuous":
                self._loop_continuous()
            else:
                self._loop_static()
        except BaseException as e:               # noqa: BLE001
            # a loop-fatal error (RecompileStorm from the strict gate, a
            # poisoned predictor) must not strand waiting clients: every
            # pending future fails with the cause, later submits refuse
            self.error = e
            for fl in list(self._inflight):
                fl.req._fail(e)
            self._inflight[:] = []
            while True:
                req = self.queue.get(timeout=0)
                if req is None:
                    break
                req._fail(e)
        finally:
            # a swap still pending when the loop exits (death or drained
            # stop) must not strand its requester
            self._fail_pending_swap(
                self.error or ServeError("engine stopped before the "
                                         "swap applied"))
            self._emit_summary()

    def _drained(self):
        return self._stopping and not self._inflight and not len(self.queue)

    def _loop_continuous(self):
        while not self._drained():
            if self._swap is not None:
                # flip pending: pause ADMISSION only (submits still queue —
                # zero drops), let the in-flight set complete on the old
                # weights, apply at the empty boundary, then resume
                if self._inflight:
                    self._dispatch_inflight()
                    continue
                self._apply_swap()
            # admit: new requests join the in-flight set up to the window
            while len(self._inflight) < self.max_inflight:
                req = self.queue.get(
                    timeout=0.0 if self._inflight else 0.02)
                if req is None:
                    break
                self._admit(req)
            if not self._inflight:
                continue
            self._dispatch_inflight()

    def _admit(self, req):
        """Dequeue-time admission: a queued request whose client deadline
        already passed is fast-failed with the typed ``DeadlineExceeded``
        — it NEVER takes a lattice slot (the client gave up; serving it
        would burn step rows on an answer nobody reads).  True when the
        request joined the in-flight set."""
        if req.deadline is not None and req.expired():
            self.stats.registry.counter(
                self.name + ".deadline_expired").incr()
            req._fail(DeadlineExceeded(
                "request %d: client deadline passed while queued — "
                "fast-failed before taking a lattice slot" % req.id))
            return False
        req.admit_step = self.step_count
        self._inflight.append(_Flight(req))
        self.stats.admitted()
        return True

    def _dispatch_inflight(self):
        """One continuous-mode step over the current in-flight set: fair
        row allocation — round-robin single rows across every in-flight
        request up to the largest batch bucket, so a small request always
        rides the very next step (the anti-head-of-line property the
        continuous mode exists for) — then dispatch."""
        cap = self.lattice.max_batch
        alloc = [0] * len(self._inflight)
        while cap > 0:
            progressed = False
            for i, fl in enumerate(self._inflight):
                if cap == 0:
                    break
                if alloc[i] < fl.remaining:
                    alloc[i] += 1
                    cap -= 1
                    progressed = True
            if not progressed:
                break
        take = [(fl, fl.cursor, fl.cursor + k)
                for fl, k in zip(self._inflight, alloc) if k]
        if take:
            self._dispatch(take)

    def _loop_static(self):
        """The A/B baseline: one request at a time, run to completion —
        deliberate head-of-line blocking (the reference's
        one-predictor-one-request thread-pool shape)."""
        while not self._drained():
            if self._swap is not None and not self._inflight:
                self._apply_swap()
            if not self._inflight:
                req = self.queue.get(timeout=0.02)
                if req is None or not self._admit(req):
                    continue
            fl = self._inflight[0]
            k = min(fl.remaining, self.lattice.max_batch)
            self._dispatch([(fl, fl.cursor, fl.cursor + k)])

    def _dispatch(self, take):
        """One step: assemble the taken row slices, run the lookups, route
        to the lattice point, dispatch, scatter outputs, evict completed
        requests."""
        n = sum(hi - lo for _fl, lo, hi in take)
        step = self.step_count
        self.step_count += 1
        for fl, lo, _hi in take:
            if lo == 0:
                fl.req.first_step = step
        seq = None
        if self.lattice.seq_buckets is not None:
            seq = self.lattice.route_seq(
                max(fl.req.seq_len for fl, _lo, _hi in take))
        bucket = self.lattice.route_batch(n)
        if (bucket, seq) not in self._precompiled:
            # the serving gate: this shape would capture under load.
            # record_compile diffs against the lattice baseline and, in
            # strict mode, RAISES — the whole point of the lattice
            self.detector.record_compile(
                self._ident, {"feed": [(bucket, seq)]})
        # stage clocks + mesh spans, armed per-step only under a monitor
        # session: queue-wait ends at the first step that takes a
        # request's rows; assemble/device are step walls every taken
        # request shares (critical-path semantics: the wall the request
        # sat through, not a prorated cost split)
        mon = self._mon()
        tr = _trace.active_tracer() if mon is not None else None
        t_step = t1 = t2 = None
        if mon is not None:
            t_step = time.perf_counter()
            for fl, lo, _hi in take:
                if lo == 0 and fl.req.t_take is None:
                    fl.req.t_take = t_step
        ctx = None
        sp_step = _trace.null_span()
        if tr is not None:
            ctx, targs = _tmesh.link()
            targs["rows"] = int(n)
            targs["bucket"] = int(bucket)
            sp_step = _trace.span("serve.step", **targs)
        with sp_step, _tmesh.scope(ctx):
            try:
                # assembly is per-step work over client-supplied arrays:
                # any failure here fails the TAKEN requests, never the
                # loop.  The scope makes every HostPS wire pull a lookup
                # issues a CHILD of serve.step — the cross-process edge
                # trace_merge draws.
                sp = (_trace.span("serve.assemble", rows=int(n))
                      if tr is not None else _trace.null_span())
                with sp:
                    feed = self._assemble(take, seq)
                    for lk in self.lookups:
                        feed = lk(feed)
                if mon is not None:
                    t1 = time.perf_counter()
                sp = (_trace.span("serve.device_step", bucket=int(bucket))
                      if tr is not None else _trace.null_span())
                with sp:
                    outputs = self.predictor.run(feed)
                if mon is not None:
                    t2 = time.perf_counter()
            except Exception as e:               # noqa: BLE001
                for fl, _lo, _hi in take:
                    fl.req._fail(e)
                    self._evict(fl, completed=False)
                return
        if mon is not None:
            a_ms = (t1 - t_step) * 1e3
            d_ms = (t2 - t1) * 1e3
            for fl, _lo, _hi in take:
                sm = fl.req.stage_ms
                if sm is not None:
                    sm["assemble"] += a_ms
                    sm["device"] += d_ms
        outputs = [np.asarray(o) for o in outputs]
        pos = 0
        for fl, lo, hi in take:
            k = hi - lo
            # row-scatter only the fetches that carry the batch dim; a
            # fetch without it (scalar metric, fixed-shape aux output) is
            # handed to each request whole, ONCE (on its first chunk, so a
            # multi-step request does not concatenate replicas).  A fixed
            # output whose leading dim happens to equal this step's row
            # count is indistinguishable — same caveat as the predictor's
            # bucket-slice heuristic.
            chunk = [o[pos:pos + k] if o.ndim and o.shape[0] == n
                     else (o if lo == 0 else None) for o in outputs]
            if seq is not None:
                # normalize seq-carrying outputs to the REQUEST'S own seq
                # bucket: a request co-batched with a longer one (or split
                # across steps with different co-batches) must see ONE
                # predictable output width, and its chunks must
                # concatenate.  Heuristic: an output whose axis-1 equals
                # the step's seq bucket carries the seq axis.
                req_seq = self.lattice.route_seq(fl.req.seq_len)
                if req_seq != seq:
                    chunk = [o[:, :req_seq]
                             if o is not None and o.ndim >= 2
                             and o.shape[1] == seq else o
                             for o in chunk]
            fl.req._append(chunk, rows=k)
            fl.cursor += k
            pos += k
            if fl.remaining == 0:
                fl.req.done_step = step
                fl.req._complete()
                self.stats.completed(fl.req.latency_ms)
                if mon is not None:
                    self._note_request_done(fl.req, mon, tr, t2)
                self._evict(fl, completed=True)
        occ = self.stats.step(n, bucket, len(self._inflight))
        if mon is not None:
            mon.timeline.emit(
                "serve", mode=self.mode, rows=n, bucket=bucket,
                seq=seq, occupancy=round(occ, 4),
                inflight=len(self._inflight))

    def _note_request_done(self, req, mon, tr, t_scatter0):
        """Per-request stage record at completion: one ``serve_request``
        timeline event + one ``serve.request`` ring record (explicit
        submit->done timestamps via record_complete — the span started on
        the client thread and ended on the loop thread).  Stage keys:
        admit / queue_wait / assemble / device / reply."""
        sm = req.stage_ms
        if sm is None:
            return
        if t_scatter0 is not None:
            sm["reply"] += (req.t_done - t_scatter0) * 1e3
        t_admit = req.t_admit if req.t_admit is not None else req.t_submit
        t_take = req.t_take if req.t_take is not None else req.t_done
        stages = {"admit": round((t_admit - req.t_submit) * 1e3, 3),
                  "queue_wait": round((t_take - t_admit) * 1e3, 3),
                  "assemble": round(sm["assemble"], 3),
                  "device": round(sm["device"], 3),
                  "reply": round(sm["reply"], 3)}
        tmid = None
        args = {"id": req.id, "rows": req.rows, "stages": stages}
        if req.tm is not None:
            ctx, targs = req.tm
            args.update(targs)
            tmid = ctx[0]
        if tr is not None:
            tr.record_complete("serve.request", req.t_submit,
                               req.t_done - req.t_submit, args=args)
        mon.timeline.emit("serve_request", id=req.id, rows=req.rows,
                          latency_ms=round(req.latency_ms, 3),
                          stages=stages,
                          **({"trace": tmid} if tmid else {}))

    def _assemble(self, take, seq):
        """Request-side feeds for the taken rows: per-request slices
        concatenated in take order; seq-axis feeds padded (zeros) to the
        step's sequence bucket BEFORE concatenation so ragged requests
        stack."""
        feed = {}
        names = set()
        for fl, _lo, _hi in take:
            names.update(fl.req.feed)
        for name in names:
            parts = []
            for fl, lo, hi in take:
                arr = fl.req.feed[name][lo:hi]
                if seq is not None and self._is_seq_feed(name):
                    arr = self._pad_seq(arr, seq)
                parts.append(arr)
            feed[name] = (np.concatenate(parts, axis=0)
                          if len(parts) > 1 else parts[0])
        return feed

    def _is_seq_feed(self, name):
        # predictor-side names only: a lookup's ids slot is per-row shaped
        # and never seq-padded
        return name in self._seq_feeds

    def _pad_seq(self, arr, seq):
        if arr.shape[1] == seq:
            return arr
        pad = np.zeros((arr.shape[0], seq - arr.shape[1])
                       + arr.shape[2:], arr.dtype)
        return np.concatenate([arr, pad], axis=1)

    def _evict(self, fl, completed):
        try:
            self._inflight.remove(fl)
        except ValueError:
            pass
        if completed:
            self.stats.evicted()

    # ----------------------------------------------------------- shutdown
    def _emit_summary(self):
        summary = self.stats.summary()
        summary.update(mode=self.mode, ident=self._ident,
                       lattice=self.lattice.describe(),
                       points=len(self._precompiled),
                       recompiles=(self.detector.recompiles()
                                   if self.detector else 0))
        if self._sig_count0 is not None:
            try:
                summary["new_compiled_sigs"] = (
                    self.predictor.compiled_signature_count()
                    - self._sig_count0)
            except Exception:
                pass
        self.last_summary = summary
        mon = self._mon()
        if mon is not None:
            mon.timeline.emit("serve_summary", **summary)
            mon.timeline.flush()

    def stop(self, drain=True, timeout=60.0):
        """Stop serving.  ``drain=True`` serves everything already queued
        or in flight first; queued requests are failed otherwise."""
        if not self._started:
            return self.last_summary
        self._stopping = True
        if not drain:
            while True:
                req = self.queue.get(timeout=0)
                if req is None:
                    break
                req._fail(ServeError("engine stopped"))
        if self._thread is not None:
            self._thread.join(timeout)
        # leftovers that raced past the loop's exit (or a non-drain stop)
        # must fail, not hang their clients
        while True:
            req = self.queue.get(timeout=0)
            if req is None:
                break
            req._fail(self.error or ServeError("engine stopped"))
        self.queue.close()
        self._started = False
        return self.last_summary

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=exc[0] is None)
        return False
