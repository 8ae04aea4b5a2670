"""StatRegistry: typed named stats (parity: platform/monitor.h:29).

The reference keeps a process-global ``StatRegistry`` of ``StatValue<int64>``
entries fed through ``STAT_ADD``/``STAT_RESET`` macros (PSLib's pull/push
accounting, feasign counts in memory, ...).  This is that surface grown to
what a telemetry consumer actually needs:

- ``Counter`` — monotonic int64 (STAT_ADD parity: add-only);
- ``Gauge``   — last-set value, plus ``set_max`` for watermarks;
- ``Histogram`` — calls/total/min/max/last over observed samples (the
  profiler's ``observe`` store, typed), plus a bounded stride-decimated
  sample buffer that yields p50/p95/p99 on snapshot — the summary
  quantiles the Prometheus exposition ships;
- labels — every stat may carry a small ``{k: v}`` label set, so one name
  ("hostps.cache.hit") can split per table the way the reference splits
  per-table pull counters inside FleetWrapper.

Thread-safety contract: creation and mutation share one registry lock (the
HostPS prefetch daemons and the training thread write concurrently — the
same concurrency the reference's std::mutex in StatValue guards).  Snapshots
copy under the lock so exporters never see a torn stat.

The port's copy of the JAX package's ``monitor/registry.py``: stdlib only,
so the copy needs no change beyond its package.
"""

import threading

__all__ = ["Counter", "Gauge", "Histogram", "StatRegistry",
           "default_registry", "stat_add", "stat_reset"]


class _Stat:
    kind = None

    def __init__(self, name, labels, lock):
        self.name = name
        self.labels = labels          # tuple of sorted (k, v) pairs
        self._lock = lock


class Counter(_Stat):
    """Monotonic event count (STAT_ADD parity)."""

    kind = "counter"

    def __init__(self, name, labels, lock):
        super().__init__(name, labels, lock)
        self._value = 0

    def incr(self, amount=1):
        with self._lock:
            self._value += int(amount)

    @property
    def value(self):
        with self._lock:
            return self._value

    def _snapshot(self):
        return {"value": self._value}

    def _reset(self):
        self._value = 0


class Gauge(_Stat):
    """Last-set value; ``set_max`` keeps a high-water mark."""

    kind = "gauge"

    def __init__(self, name, labels, lock):
        super().__init__(name, labels, lock)
        self._value = 0.0

    def set(self, value):
        with self._lock:
            self._value = float(value)

    def set_max(self, value):
        with self._lock:
            if float(value) > self._value:
                self._value = float(value)

    @property
    def value(self):
        with self._lock:
            return self._value

    def _snapshot(self):
        return {"value": self._value}

    def _reset(self):
        self._value = 0.0


class Histogram(_Stat):
    """Sample accumulator: calls/total/min/max/last (+avg on snapshot),
    plus quantiles over a bounded sample buffer.  Past ``SAMPLE_CAP``
    samples it keeps a deterministic stride-decimated tail (every other
    sample, stride doubling — the LatencyTracker scheme: no RNG, bounded
    RAM), so p50/p95/p99 stay representative on a long-lived stat."""

    kind = "histogram"
    SAMPLE_CAP = 512
    QUANTILES = (0.5, 0.95, 0.99)

    def __init__(self, name, labels, lock):
        super().__init__(name, labels, lock)
        self._reset()

    def observe(self, value):
        v = float(value)
        with self._lock:
            self.calls += 1
            self.total += v
            self.last = v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            self._skip += 1
            if self._skip >= self._stride:
                self._skip = 0
                self._samples.append(v)
                if len(self._samples) >= self.SAMPLE_CAP:
                    self._samples = self._samples[::2]
                    self._stride *= 2

    def quantiles(self, qs=QUANTILES):
        """{q: value} nearest-rank quantiles over the held samples
        (empty -> {})."""
        with self._lock:
            samples = sorted(self._samples)
        if not samples:
            return {}
        n = len(samples)
        return {q: samples[min(n - 1, int(q * n))] for q in qs}

    def _snapshot(self):
        snap = {"calls": self.calls, "total": self.total, "min": self.min,
                "max": self.max, "last": self.last,
                "avg": self.total / max(self.calls, 1)}
        if self._samples:
            s = sorted(self._samples)
            n = len(s)
            snap["quantiles"] = {q: s[min(n - 1, int(q * n))]
                                 for q in self.QUANTILES}
        return snap

    def _reset(self):
        self.calls = 0
        self.total = 0.0
        self.last = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._samples = []
        self._stride = 1
        self._skip = 0


class StatRegistry:
    """Name -> typed stat, get-or-create (parity: StatRegistry::GetStat)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._stats = {}              # (name, labels) -> stat

    def _get(self, cls, name, labels):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            s = self._stats.get(key)
            if s is None:
                s = self._stats[key] = cls(name, key[1], self._lock)
            elif s.kind != cls.kind:
                raise TypeError(
                    "stat %r is a %s, requested as %s"
                    % (name, s.kind, cls.kind))
            return s

    def counter(self, name, **labels):
        return self._get(Counter, name, labels)

    def gauge(self, name, **labels):
        return self._get(Gauge, name, labels)

    def histogram(self, name, **labels):
        return self._get(Histogram, name, labels)

    def get_stat(self, name, **labels):
        """Parity alias (StatRegistry::GetStat): the stat or None."""
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            return self._stats.get(key)

    def snapshot(self):
        """List of ``{"name", "kind", "labels", ...values}`` rows, sorted by
        (name, labels) — the exporter/report surface."""
        with self._lock:
            rows = []
            for (name, labels), s in sorted(self._stats.items()):
                row = {"name": name, "kind": s.kind, "labels": dict(labels)}
                row.update(s._snapshot())
                rows.append(row)
            return rows

    def reset(self, kinds=None, exclude_prefixes=()):
        """DRAIN stats (profiler.reset_profiler semantics): matching stats
        are removed outright, so a later snapshot shows only what happened
        since — a zeroed-but-present counter would read as "event seen 0
        times" where the drain contract says "never seen".  ``kinds``
        restricts to a subset, e.g. ``("counter", "histogram")`` so
        watermark gauges survive; ``exclude_prefixes`` spares whole
        namespaces (the monitor session's own run telemetry must survive a
        profiler drain).  Per-stat zeroing (STAT_RESET parity) is
        ``stat_reset``."""
        with self._lock:
            for key in [k for k, s in self._stats.items()
                        if (kinds is None or s.kind in kinds)
                        and not k[0].startswith(tuple(exclude_prefixes))]:
                del self._stats[key]


_default = StatRegistry()


def default_registry():
    """The process-global registry (parity: the monitor.h singleton) — the
    profiler counter API, the executor's step stats, and the HostPS gauges
    all land here."""
    return _default


def stat_add(name, value=1, **labels):
    """STAT_ADD macro parity."""
    _default.counter(name, **labels).incr(value)


def stat_reset(name, **labels):
    """STAT_RESET macro parity (no-op when the stat does not exist yet)."""
    s = _default.get_stat(name, **labels)
    if s is not None:
        with s._lock:
            s._reset()
