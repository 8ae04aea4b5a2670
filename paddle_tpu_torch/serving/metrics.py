"""Serving telemetry: latency quantiles, QPS, occupancy — monitor-wired
(counterpart of ``paddle_tpu/serving/metrics.py``, a copy).

The monitor registry's ``Histogram`` keeps calls/total/min/max/last — the
right shape for step timing, the wrong one for a latency SLO: p50/p99 need
the distribution.  ``LatencyTracker`` keeps a bounded sample buffer (every
completion up to ``cap``, then a deterministic stride-decimated tail — no
RNG in the serving path) and publishes quantile GAUGES
(``serve.latency_p50_ms`` / ``serve.latency_p99_ms``) the Prometheus
exposition and ``trace_summary`` read directly, next to the counters the
engine bumps per step (``serve.admitted`` / ``serve.evicted`` /
``serve.completed`` / ``serve.steps`` / ``serve.backpressure``) and the
``serve.occupancy`` histogram (real rows / bucket rows per dispatched
step — padding waste made visible).
"""

import threading

import numpy as np

from ..monitor.registry import default_registry

__all__ = ["LatencyTracker", "ServeStats"]


class LatencyTracker:
    """Bounded latency sample store with exact quantiles over what it
    holds.  Past ``cap`` samples it decimates by keeping every other
    sample (deterministic; a serving process must not burn RNG or RAM on
    its own telemetry) — quantiles stay representative for the smooth
    traffic a long-lived tracker sees."""

    def __init__(self, cap=65536):
        self.cap = int(cap)
        self._samples = []
        self._stride = 1
        self._skip = 0
        self._lock = threading.Lock()
        self.count = 0
        self.total_ms = 0.0

    def observe(self, ms):
        ms = float(ms)
        with self._lock:
            self.count += 1
            self.total_ms += ms
            self._skip += 1
            if self._skip >= self._stride:
                self._skip = 0
                self._samples.append(ms)
                if len(self._samples) >= self.cap:
                    self._samples = self._samples[::2]
                    self._stride *= 2

    def quantiles(self, qs=(0.5, 0.99)):
        """{q: ms} over the held samples (empty -> {})."""
        with self._lock:
            samples = list(self._samples)
        if not samples:
            return {}
        arr = np.asarray(samples)
        return {q: float(np.percentile(arr, 100.0 * q)) for q in qs}

    @property
    def mean_ms(self):
        with self._lock:
            return self.total_ms / self.count if self.count else 0.0


class ServeStats:
    """The engine's telemetry bundle: registry counters/gauges plus the
    latency tracker, with a ``summary()`` dict the serve_summary timeline
    event and the bench report both serialize."""

    _COUNTERS = ("admitted", "evicted", "steps", "rows", "backpressure")

    def __init__(self, registry=None, prefix="serve"):
        self.registry = registry or default_registry()
        self.prefix = prefix
        self.latency = LatencyTracker()
        self._t0 = None
        self._lock = threading.Lock()
        # registry stats are process-cumulative per name; summary() reports
        # THIS engine's deltas so two engines sharing a prefix (an engine
        # restarted in-process) stay internally consistent
        self._base = {}
        self._occ_base = (0, 0.0)

    def _c(self, name):
        return self.registry.counter("%s.%s" % (self.prefix, name))

    def _g(self, name):
        return self.registry.gauge("%s.%s" % (self.prefix, name))

    def start_clock(self):
        import time

        with self._lock:
            if self._t0 is None:
                self._t0 = time.perf_counter()
                self._base = {c: self._c(c).value for c in self._COUNTERS}
                occ = self.registry.get_stat(
                    "%s.occupancy" % self.prefix)
                self._occ_base = ((occ.calls, occ.total)
                                  if occ is not None else (0, 0.0))

    def wall_s(self):
        import time

        with self._lock:
            return (0.0 if self._t0 is None
                    else time.perf_counter() - self._t0)

    # -- engine hooks ----------------------------------------------------
    def admitted(self, n=1):
        self._c("admitted").incr(n)

    def evicted(self, n=1):
        self._c("evicted").incr(n)

    def backpressure(self):
        self._c("backpressure").incr()

    def step(self, rows, bucket, inflight):
        self._c("steps").incr()
        self._c("rows").incr(rows)
        occ = rows / float(bucket) if bucket else 0.0
        self.registry.histogram(
            "%s.occupancy" % self.prefix).observe(occ)
        self._g("inflight").set(inflight)
        return occ

    def completed(self, latency_ms):
        self._c("completed").incr()
        # the registry histogram's own bounded sample buffer puts
        # {quantile="0.5|0.95|0.99"} samples on the Prometheus exposition
        # (fleet_top's serve-latency columns) next to the gauges below
        self.registry.histogram(
            "%s.latency_ms" % self.prefix).observe(latency_ms)
        self.latency.observe(latency_ms)
        # quantile gauges refresh every 16 completions (and at summary):
        # cheap enough to keep the exposition live without a sort per
        # request
        if self.latency.count % 16 == 0:
            self.publish_quantiles()

    def publish_quantiles(self):
        q = self.latency.quantiles()
        if q:
            self._g("latency_p50_ms").set(q[0.5])
            self._g("latency_p99_ms").set(q[0.99])
        wall = self.wall_s()
        if wall > 0:
            self._g("qps").set(self.latency.count / wall)
        return q

    # -- report ----------------------------------------------------------
    def summary(self):
        q = self.publish_quantiles()
        occ = self.registry.get_stat("%s.occupancy" % self.prefix)
        wall = self.wall_s()
        out = {
            "completed": self.latency.count,
            "wall_s": round(wall, 4),
            "qps": (round(self.latency.count / wall, 3)
                    if wall > 0 else None),
            "latency_mean_ms": round(self.latency.mean_ms, 3),
            "p50_ms": round(q[0.5], 3) if q else None,
            "p99_ms": round(q[0.99], 3) if q else None,
        }
        for c in self._COUNTERS:
            stat = self.registry.get_stat("%s.%s" % (self.prefix, c))
            out[c] = ((stat.value if stat is not None else 0)
                      - self._base.get(c, 0))
        if occ is not None:
            calls = occ.calls - self._occ_base[0]
            if calls > 0:
                out["occupancy_avg"] = round(
                    (occ.total - self._occ_base[1]) / calls, 4)
        return out
