"""Bounded request queue + the request/future surface of the serve loop
(counterpart of ``paddle_tpu/serving/queue.py``, a copy on the port's
``monitor.registry``).

Parity: the reference serves "millions of users" through a thread pool in
front of AnalysisPredictor instances; the queue was implicit in the RPC
server.  Here it is explicit and bounded, because the queue IS the
backpressure surface: a full queue (or a MemScope headroom refusal) must
push back on the client as a fast, typed rejection — never by letting work
pile up until the device OOMs.

- ``ServeRequest``: one client call — named feed arrays sharing a leading
  row dimension, an arrival timestamp, and a result future.  The engine
  admits rows (possibly across several steps), scatters per-row outputs
  back, and completes the future.
- ``RequestQueue``: bounded FIFO.  ``put`` blocks up to ``timeout`` and
  then raises ``QueueFull`` (the client's signal to shed or retry);
  ``Backpressure`` is the admission-gate refusal (MemScope headroom, see
  engine.py) — same family, different cause, so clients can tell "you are
  sending too fast" from "the device is out of memory headroom".

Every rejection class carries a stable machine-readable ``code`` — the
LoadShield contract: the wire serializes it next to the error text and the
router SWITCHES on it (never on substrings), so a new rejection kind is a
new code, not a new string to pattern-match.

Counters ride the default StatRegistry (``serve.queue.*``) so the fleet
exporters see queue depth and rejects without a monitor session.
"""

import threading
import time

import numpy as np

from ..monitor.registry import default_registry

__all__ = ["ServeRequest", "RequestQueue", "QueueFull", "Backpressure",
           "ServeError", "DeadlineExceeded", "Shed", "Draining",
           "PRIORITY_LOW", "PRIORITY_NORMAL", "PRIORITY_HIGH"]

# priority classes (ServeRequest.priority): the shed policy drops the
# lowest class first when the fleet crosses its load watermark
PRIORITY_LOW = 0
PRIORITY_NORMAL = 1
PRIORITY_HIGH = 2


class ServeError(RuntimeError):
    """Base class of serving rejections.  ``code`` is the wire-stable
    machine-readable discriminator (subclasses override)."""

    code = "serve_error"


class QueueFull(ServeError):
    """The bounded request queue stayed full past the submit timeout."""

    code = "queue_full"


class Backpressure(ServeError):
    """Admission refused BEFORE enqueue: the MemScope headroom predictor
    says dispatching another lattice-point batch would exhaust device
    memory (``MemoryBudgetError`` semantics, surfaced as backpressure —
    the client retries later; the server never OOMs chasing the queue)."""

    code = "backpressure"


class DeadlineExceeded(ServeError):
    """The request's client deadline passed before it could be served —
    fast-failed (in the wire inbox, the replica queue, or by the router's
    unservable-deadline refusal) instead of burning a lattice slot on an
    answer nobody is waiting for."""

    code = "deadline"


class Shed(ServeError):
    """Load shed: the fleet is past its overload watermark and this
    request's priority class lost the triage.  ``retry_after_ms`` is the
    client's backoff hint — a typed, sub-millisecond fast-fail, never a
    queue-to-timeout."""

    code = "shed"

    def __init__(self, msg, retry_after_ms=50.0):
        super().__init__(msg)
        self.retry_after_ms = float(retry_after_ms)


class Draining(ServeError):
    """The replica is a lame duck (retire/drain in progress): it refuses
    new admits while finishing its in-flight work.  The router re-routes
    to a sibling without suspecting the replica — draining is health, not
    failure."""

    code = "draining"


class ServeRequest:
    """One request: ``feed`` maps name -> [rows, ...] array; every feed
    shares the leading row count.  ``seq_len`` names the real length along
    the lattice's sequence axis (pre-padding), when one is declared.

    ``priority`` is the shed class (PRIORITY_LOW/NORMAL/HIGH);
    ``deadline`` is the client's ABSOLUTE wall-clock give-up time
    (``time.time()`` seconds) — it rides the wire from the original
    caller, so a replica can fast-fail a queued request whose client
    already gave up instead of serving it into the void."""

    _ids = iter(range(1, 1 << 62))
    _ids_lock = threading.Lock()

    def __init__(self, feed, seq_len=None, priority=PRIORITY_NORMAL,
                 deadline=None):
        if not feed:
            raise ValueError("empty feed")
        self.feed = {k: np.asarray(v) for k, v in feed.items()}
        rows = {v.shape[0] for v in self.feed.values() if v.ndim}
        if len(rows) != 1:
            raise ValueError(
                "request feeds must share one leading row dim, got %r"
                % {k: v.shape for k, v in self.feed.items()})
        self.rows = rows.pop()
        if self.rows <= 0:
            raise ValueError("request needs at least one row")
        self.seq_len = None if seq_len is None else int(seq_len)
        self.priority = int(priority)
        self.deadline = None if deadline is None else float(deadline)
        with ServeRequest._ids_lock:
            self.id = next(ServeRequest._ids)
        self.t_submit = time.perf_counter()
        self.t_done = None
        # stage decomposition (set by the engine only when a monitor
        # session is live — the unmonitored request pays two None slots):
        # t_admit = queue.put returned; t_take = first step that took rows
        self.t_admit = None
        self.t_take = None
        self.stage_ms = None         # accumulators: assemble/device/reply
        self.tm = None               # tracemesh ((trace_id, span_id), args)
        self._done = threading.Event()
        self._chunks = None          # per-fetch list of row-chunk arrays
        self._error = None
        self.served_rows = 0         # cursor: rows already dispatched
        self.result_rows = 0         # rows whose outputs landed
        # the engine's step indices: when the request joined the in-flight
        # set, the first step that took its rows, the step that completed
        # it (the head-of-line property is stated in steps)
        self.admit_step = None
        self.first_step = None
        self.done_step = None

    def expired(self, now=None):
        """True when the client's wall-clock deadline has passed (False
        when no deadline was declared)."""
        if self.deadline is None:
            return False
        return (time.time() if now is None else now) > self.deadline

    # -- engine side -----------------------------------------------------
    def _append(self, outputs, rows=None):
        """Outputs for the next chunk of rows, in fetch order; chunks land
        in cursor order so completion is a concatenate.  A ``None`` entry
        means "this fetch was already delivered whole on an earlier
        chunk" (non-batch outputs of a multi-step request)."""
        if self._chunks is None:
            self._chunks = [[] for _ in outputs]
        for buf, out in zip(self._chunks, outputs):
            if out is not None:
                buf.append(out)
        if rows is not None:
            self.result_rows += int(rows)

    def _complete(self):
        self.t_done = time.perf_counter()
        self._done.set()

    def _fail(self, exc):
        self._error = exc
        self.t_done = time.perf_counter()
        self._done.set()

    # -- client side -----------------------------------------------------
    @property
    def latency_ms(self):
        if self.t_done is None:
            return None
        return (self.t_done - self.t_submit) * 1e3

    def done(self):
        return self._done.is_set()

    def result(self, timeout=None):
        """Block for the fetch-ordered outputs ([rows, ...] each).  Raises
        the engine-side error when the request failed."""
        if not self._done.wait(timeout):
            raise TimeoutError("request %d not served within %ss"
                               % (self.id, timeout))
        if self._error is not None:
            raise self._error
        return [np.concatenate(buf, axis=0) if len(buf) > 1 else buf[0]
                for buf in (self._chunks or [])]


class RequestQueue:
    """Bounded FIFO between client threads and the serve loop.  Stats land
    in ``registry`` (default: the process registry) — the engine threads
    its own through so one engine's telemetry lives in ONE registry."""

    def __init__(self, capacity=256, name="serve.queue", registry=None):
        if capacity <= 0:
            raise ValueError("queue capacity must be positive")
        self.capacity = int(capacity)
        self.name = name
        self.registry = registry or default_registry()
        self._items = []
        self._cond = threading.Condition()
        self._closed = False

    def __len__(self):
        with self._cond:
            return len(self._items)

    def put(self, req, timeout=None):
        """Enqueue or raise QueueFull after ``timeout`` (None = wait
        forever; 0 = non-blocking)."""
        reg = self.registry
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while len(self._items) >= self.capacity and not self._closed:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    reg.counter(self.name + ".rejected").incr()
                    raise QueueFull(
                        "serve queue full (%d requests) for %ss — shed or "
                        "retry" % (self.capacity, timeout))
                self._cond.wait(remaining)
            if self._closed:
                raise ServeError("serve queue closed")
            self._items.append(req)
            reg.counter(self.name + ".submitted").incr()
            reg.gauge(self.name + ".depth").set(len(self._items))
            self._cond.notify_all()

    def get(self, timeout=0.05):
        """Dequeue the oldest request, or None on timeout/empty."""
        with self._cond:
            if not self._items:
                self._cond.wait(timeout)
            if not self._items:
                return None
            req = self._items.pop(0)
            self.registry.gauge(self.name + ".depth").set(
                len(self._items))
            self._cond.notify_all()
            return req

    def remove(self, req):
        """Take a specific request back out (the submit/engine-death race:
        a put that landed after the loop's failure drain).  True when it
        was still queued."""
        with self._cond:
            try:
                self._items.remove(req)
            except ValueError:
                return False
            self.registry.gauge(self.name + ".depth").set(
                len(self._items))
            self._cond.notify_all()
            return True

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()
