"""Crash flight recorder: a failed run leaves evidence instead of nothing.

The monitor's telemetry is built for LIVE runs — the JSONL timeline flushes
every 64 events and the Prometheus exposition lands on ``disable()``.  A
run that DIES mid-step gets neither: the interesting tail of the timeline
may still sit in the write buffer, the span rings (trace.py) evaporate with
the process, and the registry was never exported.  The flight recorder is
the black box: on an uncaught exception (``sys.excepthook``) or an explicit
``dump()`` from a failure path (trainer.py calls it when an exception
escapes ``train_from_dataset``), it writes ``postmortem*.json`` into the
monitor out_dir with:

- the exception (type, message, formatted traceback);
- every thread's recent AND still-open spans (what was mid-flight);
- the last N timeline records (Timeline keeps an in-memory tail ring);
- the StatRegistry snapshot (step counts, recompiles, hostps counters);
- a best-effort device-memory snapshot (an OOM postmortem should say how
  full the chip was).

One dump per exception object: the trainer's except-path dump and the
process-exit excepthook see the SAME exception — the second call is a
no-op returning the first dump's path.  ``install()`` chains the previous
excepthook (the traceback still prints); ``uninstall()`` restores it.

The port's copy of the JAX package's ``monitor/flight.py``: stdlib only, so
the copy needs no change beyond its package.
"""

import json
import os
import sys
import time
import traceback

from .timeline import _jsonable

__all__ = ["FlightRecorder"]


class FlightRecorder:
    def __init__(self, monitor, span_tail=64, timeline_tail=None):
        self.monitor = monitor
        self.span_tail = int(span_tail)
        self.timeline_tail = timeline_tail     # None = whatever the ring holds
        self._prev_hook = None
        self._installed = False
        self._n_dumps = 0
        # STRONG reference to the last-dumped exception: identity dedup by
        # bare id() would let a freed exception's recycled id eat a later,
        # different exception's dump, and builtin exceptions cannot be
        # weakly referenced.  One pinned exception per session, released
        # on uninstall().
        self._last_exc = None
        self._last_path = None

    # -- excepthook wiring -----------------------------------------------
    def install(self):
        if not self._installed:
            self._prev_hook = sys.excepthook
            # bind ONCE: `self._excepthook` makes a fresh bound-method
            # object per access, so the identity check in uninstall() needs
            # the exact object that was installed
            self._hook = self._excepthook
            sys.excepthook = self._hook
            self._installed = True
        return self

    def uninstall(self):
        if self._installed:
            # only restore when the hook is still OURS — someone may have
            # chained their own on top after us
            if sys.excepthook is self._hook:
                sys.excepthook = self._prev_hook or sys.__excepthook__
            self._installed = False
            self._prev_hook = None
            self._last_exc = None      # stop pinning frames past the session

    def _excepthook(self, etype, evalue, tb):
        try:
            self.dump(exc=(etype, evalue, tb), reason="sys.excepthook")
        except Exception:
            pass                      # the black box must never mask the crash
        (self._prev_hook or sys.__excepthook__)(etype, evalue, tb)

    # -- the dump --------------------------------------------------------
    def dump(self, exc=None, reason="manual", extra=None):
        """Write the postmortem JSON; returns its path.  ``exc`` is a
        ``sys.exc_info()`` triple (defaults to the in-flight exception).
        Re-dumping the SAME exception object (trainer except-path first,
        excepthook second) is a no-op.  ``extra`` merges caller-owned
        evidence sections into the record (the sentinel's ``health``
        localization rides here)."""
        if exc is None:
            exc = sys.exc_info()
        evalue = exc[1] if exc else None
        if evalue is not None and evalue is self._last_exc:
            return self._last_path
        mon = self.monitor
        rec = {"ev": "postmortem", "reason": reason, "time": time.time(),
               "pid": os.getpid()}
        if extra:
            rec.update(extra)
        if evalue is not None:
            rec["exception"] = {
                "type": getattr(exc[0], "__name__", str(exc[0])),
                "message": str(evalue),
                "traceback": traceback.format_exception(*exc),
            }
        tracer = getattr(mon, "tracer", None)
        if tracer is not None:
            try:
                rec["spans"] = tracer.snapshot(last=self.span_tail)
            except Exception:
                pass
        try:
            tail = mon.timeline.tail()
            if self.timeline_tail:
                tail = tail[-self.timeline_tail:]
            rec["timeline_tail"] = tail
        except Exception:
            pass
        try:
            # zero-call histograms carry +/-inf min/max — not strict JSON;
            # they also say nothing, so the postmortem drops them
            rec["registry"] = [r for r in mon.registry.snapshot()
                               if r["kind"] != "histogram" or r["calls"]]
        except Exception:
            pass
        try:
            from .memory import memory_snapshot

            rec["memory"] = memory_snapshot()
        except Exception:
            pass
        self._n_dumps += 1
        name = ("postmortem.json" if self._n_dumps == 1
                else "postmortem-%d.json" % self._n_dumps)
        path = os.path.join(mon.out_dir, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f, indent=1, default=_jsonable)
        os.replace(tmp, path)
        if evalue is not None:
            self._last_exc = evalue
        self._last_path = path
        try:
            # the crash also lands on the timeline (and flushes it: the
            # buffered tail is exactly what a crashed run loses)
            mon.timeline.emit("postmortem", path=path, reason=reason)
            mon.timeline.flush()
        except Exception:
            pass
        return path
