"""JSONL run timeline (parity: tools/timeline.py — but structured events,
not just a chrome-trace re-encode).

One line per event, append-only, schema:

    {"ev": <type>, "ts": <unix seconds>, ...event fields}

Event types emitted by the subsystem:

- ``step``     — one Executor.run / one bench step: ``step``, ``host_ms``
  (dispatch wall time), ``device_ms`` (sampled block_until_ready, absent on
  unsampled steps), ``batch``, ``examples_per_sec`` (only on device-sampled
  steps — host dispatch time is not throughput);
- ``compile``  — executor compile-cache miss / jit retrace: ``ident``,
  ``recompile`` (bool: this program compiled before under another key),
  ``diff`` (which key components changed), ``n_compiles``;
- ``memory``   — watermark sample: ``live_bytes``, ``arrays``, per-device
  ``bytes_in_use``/``peak_bytes_in_use`` when the backend reports them;
- ``run_start`` / ``run_end`` — train_from_dataset bracketing: ``steps``,
  ``seconds``, ``train``.

Low overhead on purpose: one ``json.dumps`` + one buffered ``write`` per
event, no fsync on the hot path (``flush()``/``close()`` make it durable);
a lock serializes writers (prefetch daemons may emit while the training
thread steps).

Flush-critical events: alert-relevant records (health trips, fleet
re-routes, publish vetoes, watchtower alerts) must be readable by live
consumers — fleet_top tails, the watchtower rule engine, a drill reading
its own evidence mid-run — the moment they happen, not up to 63 events
later.  ``emit(..., flush=True)`` forces a flush for one record, and any
event whose type is in ``FLUSH_EVENTS`` flushes unconditionally, so
callers of those types need no hand-flush discipline.

The port's copy of the JAX package's ``monitor/timeline.py``: stdlib only,
so the copy needs no change beyond its package.
"""

import collections
import json
import os
import threading
import time

__all__ = ["Timeline", "read_events", "FLUSH_EVENTS"]

_TAIL = 256       # in-memory tail ring: the flight recorder's postmortem
                  # view of "what the run was doing" (flight.py)

# Event types that never wait out the 64-event buffer: each one is
# evidence some live reader (alert rules, drills, fleet_top) acts on.
FLUSH_EVENTS = frozenset({
    "health_trip", "health_alert", "fleet_reroute", "fleet_replica_restart",
    "fleet_lost", "publish_veto", "watchtower_alert", "postmortem",
    "preempted", "ps_degraded", "ps_recovered",
})


class Timeline:
    def __init__(self, path, tail=_TAIL):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(path, "a", buffering=1 << 16)
        self._n = 0
        self._tail = collections.deque(maxlen=tail)

    def emit(self, ev, flush=False, **fields):
        rec = {"ev": ev, "ts": time.time()}
        rec.update(fields)
        line = json.dumps(rec, default=_jsonable)
        with self._lock:
            if self._f is None:
                return
            self._tail.append(rec)
            self._f.write(line)
            self._f.write("\n")
            self._n += 1
            if flush or ev in FLUSH_EVENTS or self._n % 64 == 0:
                self._f.flush()     # bound loss on a crashed run; make
                                    # flush-critical evidence live

    def tail(self):
        """The last records still in memory (postmortem evidence — survives
        even when the crash beat the 64-event flush)."""
        with self._lock:
            return list(self._tail)

    def flush(self):
        with self._lock:
            if self._f is not None:
                self._f.flush()

    def close(self):
        with self._lock:
            if self._f is not None:
                self._f.flush()
                self._f.close()
                self._f = None


def _jsonable(o):
    """Numpy scalars / shapes leak into event fields; stringify the rest."""
    try:
        import numpy as np

        if isinstance(o, np.generic):
            return o.item()
    except Exception:
        pass
    return str(o)


def read_events(path, ev=None, with_torn=False):
    """Parse a timeline JSONL file back into event dicts; ``ev`` filters by
    type.  Tolerates torn lines (the truncated final line a SIGKILL mid-
    write leaves behind): skipped and COUNTED, never raised.  With
    ``with_torn`` returns ``(events, torn_line_count)`` so a reader can
    surface how much evidence the crash ate; the default return stays a
    plain list."""
    out = []
    torn = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                torn += 1
                continue
            if not isinstance(rec, dict):
                torn += 1
                continue
            if ev is None or rec.get("ev") == ev:
                out.append(rec)
    return (out, torn) if with_torn else out
