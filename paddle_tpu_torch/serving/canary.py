"""CanaryProber: synthetic known-answer requests through the FleetRouter
(counterpart of ``paddle_tpu/serving/canary.py``, a copy: it runs over
anything with ``submit`` + ``snapshot``, a router or a ``ServeEngine``
front).

Parity: the reference's serving deployments pair the predictor pool with
liveness probing at the RPC layer — a health endpoint that proves the
process answers.  A fleet that hot-swaps model versions under load (the
online publish chain, rolling swaps) needs more than "answers": it needs
proof the *train→serve loop end to end* still computes the right
function.  The canary is that proof, on a fixed cadence:

- **known-answer correctness** — each probe submits a synthetic feed
  whose expected output was computed locally against the exported
  artifact (``np.allclose``, the serve_bench correctness tolerance); a
  wrong-weights publish flips ``canary.ok`` within one cadence;
- **per-probe latency** — the ``canary.probe_ms`` histogram is the
  client-visible latency floor a burn-rate rule can watch even when real
  traffic is idle;
- **served-version skew** — distinct versions across the router's
  replica view (``canary.version_skew``): non-zero mid-rolling-swap is
  expected, non-zero at steady state is a stuck replica;
- **freshness** — ``canary.freshness_lag_s`` from the replicas' exported
  ``online.train_wall`` gauges: how stale is what the fleet serves.

Every probe rides a TraceMesh context (``tracemesh.link`` root), so its
wire request/serve spans land under one trace id — a FAILING canary
names its causal chain, and the watchtower's incident ledger links that
trace id as evidence.  Probes emit ``canary_probe`` timeline events
(failures flush-critical) the watchtower's timeline scanner consumes.
"""

import os
import threading
import time

import numpy as np

from ..monitor import trace as _trace
from ..monitor import tracemesh as _tmesh
from ..monitor.exporters import parse_prometheus_file
from ..monitor.registry import default_registry

__all__ = ["CanaryProber"]


class CanaryProber:
    """Background known-answer prober over a FleetRouter (or anything
    with ``submit(feed)`` + ``snapshot()``).

    ``probes`` — list of ``(feed_dict, want_array)`` known-answer pairs,
    cycled round-robin; compute ``want`` locally from the exported
    artifact so the probe checks the *served* function, not a recording.
    ``mon_root`` — optional fleet monitor root whose ``replica-*/
    metrics.prom`` expositions carry ``paddle_tpu_online_train_wall``
    (the freshness source).
    """

    def __init__(self, router, probes, interval_s=1.0, registry=None,
                 timeline=None, mon_root=None, rtol=1e-5, atol=1e-6,
                 name="canary"):
        if not probes:
            raise ValueError("canary needs at least one known-answer probe")
        self.router = router
        self.probes = [(dict(feed), np.asarray(want))
                       for feed, want in probes]
        self.interval_s = float(interval_s)
        self.registry = registry or default_registry()
        self.timeline = timeline
        self.mon_root = mon_root
        self.rtol, self.atol = float(rtol), float(atol)
        self.name = name
        self.probes_sent = 0
        self.failures = 0
        self.consecutive_failures = 0
        self.last = None            # the last probe's record dict
        self._cursor = 0
        self._thread = None
        self._stop = threading.Event()

    # -- one probe --------------------------------------------------------
    def probe_once(self):
        """Submit the next known-answer probe; returns its record dict
        (also kept on ``self.last`` and emitted as a ``canary_probe``
        timeline event)."""
        feed, want = self.probes[self._cursor % len(self.probes)]
        self._cursor += 1
        ctx, targs = _tmesh.link(None)     # fresh root: one trace per probe
        trace_id = ctx[0]
        ok, err, outs = False, None, None
        t0 = time.perf_counter()
        try:
            with _tmesh.scope(ctx):
                with _trace.span("canary.probe", **targs):
                    outs = self.router.submit(feed)
            ok = bool(np.allclose(np.asarray(outs[0]), want,
                                  rtol=self.rtol, atol=self.atol))
            if not ok:
                err = "known-answer mismatch (max |Δ| %.3g)" % float(
                    np.max(np.abs(np.asarray(outs[0], dtype=np.float64)
                                  - np.asarray(want, dtype=np.float64))))
        except Exception as e:
            err = "%s: %s" % (type(e).__name__, str(e)[:200])
        dt_ms = (time.perf_counter() - t0) * 1000.0
        return self._record(ok, dt_ms, trace_id, err)

    def _record(self, ok, dt_ms, trace_id, err):
        """Probe bookkeeping — the part monitor_overhead --watchtower
        measures (gauges + skew/freshness reads, no wire time)."""
        g, c = self.registry.gauge, self.registry.counter
        self.probes_sent += 1
        c(self.name + ".probes").incr()
        if ok:
            self.consecutive_failures = 0
        else:
            self.failures += 1
            self.consecutive_failures += 1
            c(self.name + ".failures").incr()
        g(self.name + ".ok").set(1.0 if ok else 0.0)
        g(self.name + ".consecutive_failures").set(
            self.consecutive_failures)
        self.registry.histogram(self.name + ".probe_ms").observe(dt_ms)
        skew = self._version_skew()
        if skew is not None:
            g(self.name + ".version_skew").set(skew)
        fresh = self._freshness_lag_s()
        if fresh is not None:
            g(self.name + ".freshness_lag_s").set(round(fresh, 3))
        rec = {"ok": ok, "ms": round(dt_ms, 3), "trace_id": trace_id,
               "version_skew": skew, "freshness_lag_s": fresh,
               "consecutive_failures": self.consecutive_failures}
        if err:
            rec["error"] = err
        self.last = rec
        if self.timeline is not None:
            try:
                # failures are alert evidence: never let one sit in the
                # 64-event buffer while the watchtower polls
                self.timeline.emit("canary_probe", flush=not ok, **rec)
            except Exception:
                pass
        return rec

    def _version_skew(self):
        """Distinct served versions across replicas minus one (0 = the
        fleet agrees; transiently 1 mid-rolling-swap)."""
        try:
            snap = self.router.snapshot()
        except Exception:
            return None
        versions = {s.get("version") for s in snap.values()
                    if s.get("version") is not None}
        return max(len(versions) - 1, 0) if versions else None

    def _freshness_lag_s(self):
        """now - newest ``online.train_wall`` any replica exports; None
        when no replica publishes one (a frozen-at-export fleet)."""
        if not self.mon_root:
            return None
        newest = None
        try:
            names = sorted(os.listdir(self.mon_root))
        except OSError:
            return None
        for d in names:
            if not d.startswith("replica-"):
                continue
            prom = parse_prometheus_file(
                os.path.join(self.mon_root, d, "metrics.prom"))
            if not prom:
                continue
            tw = prom.get("paddle_tpu_online_train_wall")
            if tw and (newest is None or tw > newest):
                newest = tw
        return None if newest is None else max(time.time() - newest, 0.0)

    # -- cadence ----------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="canary-prober", daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.probe_once()
            except Exception:
                pass               # the prober must outlive a flaky fleet
            self._stop.wait(self.interval_s)

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)
