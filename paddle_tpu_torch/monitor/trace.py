"""Span tracer: where inside a step did the time go, per thread.

Parity: platform/profiler's RecordEvent tree rendered by tools/timeline.py
into chrome://tracing JSON — but grown for the pipelined step engine, where
one step is THREE threads (trainer dispatch, DeviceFeedPipe worker, HostPS
prefetch) and a flat per-step number cannot show which stage hid or leaked
time.

Design:

- ``span(name, **args)`` — context manager; nesting follows the with-stack.
  Each thread keeps its OWN span stack and bounded ring buffer of completed
  spans (newest win; a week-long run cannot OOM the tracer), so producer
  threads never contend with the training thread on a lock — the only
  shared mutation is one-time thread registration.
- near-zero when disabled: no active Tracer means ``span()`` returns a
  shared no-op object after ONE module-global read.  Hook sites stay
  instrumented permanently; `scripts/monitor_overhead.py` measures the
  disabled path (gate: <= 0.5% of step-loop time).
- ``to_chrome_trace()`` — Chrome Trace Event Format (``ph:"X"`` complete
  events, one track per thread via ``thread_name`` metadata), loadable in
  Perfetto (https://ui.perfetto.dev) or chrome://tracing.  The monitor
  session writes it to ``<out_dir>/trace.json`` on ``disable()``.
- ``snapshot()`` — recent + still-OPEN spans per thread, the flight
  recorder's view of "what was executing" when a run died (flight.py).

The tracer rides the monitor session (``monitor.enable`` installs one
unless ``tracing=False`` / ``PADDLE_TPU_TRACE=0``); ``install``/``uninstall``
are the low-level switch for standalone use.

The port's copy of the JAX package's ``monitor/trace.py``: stdlib only, so
the copy needs no change beyond its package.
"""

import collections
import itertools
import json
import os
import threading
import time
import weakref

from .timeline import _jsonable

__all__ = ["Tracer", "span", "instant", "active_tracer", "install",
           "uninstall", "null_span"]

_active = None                 # the module-global the disabled path reads


class _NullSpan:
    """Shared no-op: the entire disabled-tracer cost after the global read."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **args):
        return self


_NULL = _NullSpan()


def active_tracer():
    """The installed Tracer or None."""
    return _active


def install(tracer):
    """Make ``tracer`` the process-global span sink; returns it."""
    global _active
    _active = tracer
    return tracer


def uninstall():
    global _active
    _active = None


def span(name, **args):
    """Context manager timing a region on the current thread's span stack.
    When no tracer is installed this is one global read + a no-op object —
    THE hot-path contract (hook sites live in Executor.run, the feed-pipe
    worker loop, and HostPS pull)."""
    t = _active
    if t is None:
        return _NULL
    return _Span(t._state(), name, args or None)


def null_span():
    """The shared no-op span — for hook sites that build their span args
    conditionally (``sp = trace.span(...) if tracing else trace.null_span()``)
    and must not pay the kwargs construction when disabled."""
    return _NULL


def instant(name, **args):
    """Zero-duration marker event on the current thread's track."""
    t = _active
    if t is not None:
        st = t._state()
        st.ring.append((name, time.perf_counter(), None, len(st.stack),
                        args or None, False))


class _Span:
    __slots__ = ("_st", "name", "args", "_t0")

    def __init__(self, st, name, args):
        self._st = st
        self.name = name
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        self._st.stack.append((self.name, self._t0))
        return self

    def add(self, **args):
        """Attach fields discovered mid-span (e.g. batch size after
        conversion)."""
        self.args = dict(self.args, **args) if self.args else args
        return self

    def __exit__(self, etype, evalue, tb):
        t1 = time.perf_counter()
        st = self._st
        st.stack.pop()
        # (name, t0, dur_s, depth, args, errored) — tuples, not dicts: the
        # append is the per-span cost every instrumented region pays
        st.ring.append((self.name, self._t0, t1 - self._t0, len(st.stack),
                        self.args, etype is not None))
        return False


class _ThreadState:
    __slots__ = ("tid", "name", "ring", "stack", "thread_ref")

    def __init__(self, tid, thread, ring_size):
        self.tid = tid
        self.name = thread.name
        self.ring = collections.deque(maxlen=ring_size)
        self.stack = []              # open spans: (name, t0)
        # weakref: tracking liveness must not keep dead threads alive
        self.thread_ref = weakref.ref(thread)

    def alive(self):
        t = self.thread_ref()
        return t is not None and t.is_alive()


# registered thread-state cap: short-lived threads (one HostPS prefetch
# thread per announcement) each register once; beyond the cap, DEAD
# threads' states drop oldest-first — never a live thread's (evicting the
# training thread because 512 prefetch daemons came and went would erase
# the most important track from the export and the crash postmortem)
_MAX_THREAD_STATES = 512


class Tracer:
    """Per-thread span rings + stacks, chrome-trace/flight export."""

    def __init__(self, ring_size=4096, process_name=None):
        self.ring_size = int(ring_size)
        self.process_name = process_name or ("paddle_tpu pid=%d" % os.getpid())
        self.pid = os.getpid()
        self._local = threading.local()
        self._lock = threading.Lock()
        self._states = []
        self._tids = itertools.count(1)
        # perf_counter is the span clock (monotonic, ns-resolution); anchor
        # it to the wall clock once so exported ts can be correlated with
        # the JSONL timeline's unix-seconds ts.  FleetScope publishes this
        # anchor (plus the fleet epoch + measured clock skew, set_epoch) so
        # merged multi-rank exports share one timeline
        self._perf0 = time.perf_counter()
        self._wall0 = time.time()
        self._epoch_wall = None
        self._clock_skew_ms = None
        self._rank = None

    # -- per-thread state ------------------------------------------------
    def _state(self):
        try:
            return self._local.st
        except AttributeError:
            return self._register_thread()

    def _register_thread(self):
        t = threading.current_thread()
        with self._lock:
            if len(self._states) >= _MAX_THREAD_STATES:
                dead = [s for s in self._states if not s.alive()]
                drop = set(dead[:len(self._states)
                                - _MAX_THREAD_STATES + 1] or
                           self._states[:1])       # all alive: oldest goes
                self._states = [s for s in self._states if s not in drop]
            st = _ThreadState(next(self._tids), t, self.ring_size)
            self._states.append(st)
        self._local.st = st
        return st

    def anchor(self):
        """The perf→wall anchor: a span at perf_counter ``t`` happened at
        wall time ``wall0 + (t - perf0)`` by this process's clock."""
        return {"perf0": self._perf0, "wall0": self._wall0}

    def set_epoch(self, epoch_wall, clock_skew_ms=None, rank=None):
        """Attach the fleet epoch (rank 0's shared-fs beacon) and this
        rank's measured clock skew so the export is self-describing for
        ``fleetscope.merge_chrome_traces``."""
        self._epoch_wall = epoch_wall
        self._clock_skew_ms = clock_skew_ms
        self._rank = rank

    def record_complete(self, name, t0, dur_s, args=None, errored=False):
        """Append an already-finished span with EXPLICIT perf_counter
        timestamps to the calling thread's ring — for per-request records
        whose start (submit) and end (reply) happened on different threads
        and cannot ride a with-block.  Depth 0: these are top-level tracks,
        not nested inside whatever the recording thread is doing."""
        st = self._state()
        st.ring.append((name, t0, dur_s, 0, dict(args) if args else None,
                        bool(errored)))

    def record_count(self):
        """Total spans currently buffered (overhead-probe instrumentation)."""
        with self._lock:
            states = list(self._states)
        return sum(len(st.ring) for st in states)

    # -- export ----------------------------------------------------------
    def _us(self, t):
        return round((t - self._perf0) * 1e6, 3)

    def to_chrome_trace(self):
        """Chrome Trace Event Format dict: one ``thread_name`` track per
        registered thread, ``X`` complete events for finished spans, ``B``
        begin events for spans still open (a crash export shows what was
        mid-flight), ``i`` instants.  Nesting needs no explicit parent —
        Perfetto nests X events on a track by time containment."""
        with self._lock:
            states = list(self._states)
        events = [{"ph": "M", "pid": self.pid, "tid": 0, "ts": 0,
                   "name": "process_name",
                   "args": {"name": self.process_name}}]
        for st in states:
            events.append({"ph": "M", "pid": self.pid, "tid": st.tid,
                           "ts": 0, "name": "thread_name",
                           "args": {"name": st.name}})
        spans = []
        for st in states:
            for (name, t0, dur, depth, args, err) in list(st.ring):
                e = {"pid": self.pid, "tid": st.tid, "name": name,
                     "cat": name.split(".", 1)[0], "ts": self._us(t0)}
                if dur is None:
                    e["ph"] = "i"
                    e["s"] = "t"
                else:
                    e["ph"] = "X"
                    e["dur"] = round(dur * 1e6, 3)
                a = dict(args) if args else {}
                if err:
                    a["error"] = True
                if a:
                    e["args"] = a
                spans.append(e)
            for (name, t0) in list(st.stack):
                spans.append({"ph": "B", "pid": self.pid, "tid": st.tid,
                              "name": name, "cat": name.split(".", 1)[0],
                              "ts": self._us(t0)})
        spans.sort(key=lambda e: e["ts"])
        other = {"pid": self.pid, "t0_unix": self._wall0,
                 "ring_size": self.ring_size}
        if self._epoch_wall is not None:
            other["epoch_wall"] = self._epoch_wall
        if self._clock_skew_ms is not None:
            other["clock_skew_ms"] = self._clock_skew_ms
        if self._rank is not None:
            other["rank"] = self._rank
        return {"traceEvents": events + spans,
                "displayTimeUnit": "ms",
                "otherData": other}

    def write_chrome_trace(self, path):
        """Write the trace JSON atomically (a crash-time export must never
        leave a half file a later Perfetto load chokes on)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome_trace(), f, default=_jsonable)
        os.replace(tmp, path)
        return path

    def snapshot(self, last=64):
        """Per-thread recent spans + OPEN spans (flight-recorder view):
        ``[{"thread", "tid", "open": [...], "spans": [...]}]``, newest
        spans last.  ``open`` spans carry elapsed_ms — at crash time they
        say what each thread was inside."""
        now = time.perf_counter()
        with self._lock:
            states = list(self._states)
        out = []
        for st in states:
            spans = [{"name": name,
                      "ts_ms": round((t0 - self._perf0) * 1e3, 3),
                      "dur_ms": (None if dur is None
                                 else round(dur * 1e3, 4)),
                      "depth": depth,
                      **({"args": args} if args else {}),
                      **({"error": True} if err else {})}
                     for (name, t0, dur, depth, args, err)
                     in list(st.ring)[-last:]]
            open_spans = [{"name": name,
                           "elapsed_ms": round((now - t0) * 1e3, 3)}
                          for (name, t0) in list(st.stack)]
            out.append({"thread": st.name, "tid": st.tid,
                        "open": open_spans, "spans": spans})
        return out
