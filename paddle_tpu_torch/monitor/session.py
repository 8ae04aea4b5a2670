"""Monitor session: one enabled run's telemetry sinks, wired together.

``enable(out_dir)`` opens the JSONL timeline (``<out_dir>/timeline.jsonl``),
binds the recompile detector and the default StatRegistry, and makes the
session visible to the hook sites (``active()``); ``disable()`` writes the
final Prometheus exposition (``<out_dir>/metrics.prom``) and a memory
watermark sample, then closes the timeline.

The pipelined step engine (feed_pipe.py) reports through the same registry
and timeline: ``monitor.pipe.*`` stats (feed_stall_ms / overlap_ms /
put_wait_ms / fetch_wait_ms / depth / batches), per-batch ``pipe`` timeline
events, and the fetch-sync counters ``monitor.fetch.inline_sync`` (eager
materialization on the training thread — steady-state pipelined runs keep
it flat) vs ``monitor.fetch.sampled_sync`` (this session's own sampled
device timing, the one permitted serialization point).

Hot-path contract: when monitoring is off, every hook site pays exactly one
``active()`` call (a module attribute read) — nothing else.  When on, a
step records one timeline line plus a few registry updates; device time is
SAMPLED (``device_time_every``, default every 8th step) because
``block_until_ready`` serializes the dispatch pipeline — always-on sync
would be the monitor slowing down the thing it measures.  Auto-enable: the
first ``active()`` honors ``PADDLE_TPU_MONITOR=1`` with the directory from
``PADDLE_TPU_MONITOR_DIR`` so dataset jobs and the bench can switch the
whole subsystem on from the environment.

The port's copy of the JAX package's ``monitor/session.py``: stdlib only, so
the copy needs no change beyond its package, and its default directory
under ``tempfile.gettempdir()`` (the reference's ``/tmp``).
"""

import os
import tempfile
import time

from . import fleetscope as _fleetscope
from .memory import sample_memory
from .recompile import RecompileDetector
from .registry import default_registry
from .timeline import Timeline

__all__ = ["Monitor", "enable", "disable", "active", "report", "phase_add"]

_active = None
_env_checked = False


class Monitor:
    def __init__(self, out_dir, registry=None, device_time_every=8,
                 memory_interval_s=2.0, warn_after_recompiles=3,
                 tracing=None, trace_ring=None, flight=True,
                 sentinel=None, phases=None):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.registry = registry if registry is not None else default_registry()
        self.timeline = Timeline(os.path.join(out_dir, "timeline.jsonl"))
        self.recompiles = RecompileDetector(
            self.registry, self.timeline, warn_after=warn_after_recompiles)
        self.device_time_every = max(int(device_time_every), 1)
        self.memory_interval_s = float(memory_interval_s)
        self._next_mem = 0.0          # first step takes a memory sample
        self._steps = 0
        # span tracer (trace.py): per-thread span rings feeding the
        # <out_dir>/trace.json chrome-trace export on close().  Session-
        # scoped so "monitor on" means "tracer on" unless opted out
        # (tracing=False / PADDLE_TPU_TRACE=0).
        if tracing is None:
            tracing = os.environ.get(
                "PADDLE_TPU_TRACE", "1").strip().lower() not in (
                    "0", "false", "off")
        self.tracer = None
        if tracing:
            from .trace import Tracer, install

            ring = trace_ring or int(
                os.environ.get("PADDLE_TPU_TRACE_RING", "4096"))
            self.tracer = install(Tracer(ring_size=ring))
        # crash flight recorder (flight.py): postmortem dump from
        # sys.excepthook / the trainer's failure path
        self.flight = None
        if flight:
            from .flight import FlightRecorder

            self.flight = FlightRecorder(self).install()
        # TrainSentinel (sentinel.py): model-health telemetry + NaN/Inf
        # tripwire.  Opt-in — sentinel=True / PADDLE_TPU_SENTINEL=1 here,
        # or monitor.sentinel.enable() after the session is up; off means
        # the executor compiles the exact pre-sentinel step.
        if sentinel is None:
            sentinel = os.environ.get(
                "PADDLE_TPU_SENTINEL", "").strip().lower() in ("1", "true",
                                                               "on")
        self.sentinel = None
        if sentinel:
            from .sentinel import Sentinel

            self.sentinel = Sentinel(self)
        # FleetScope phase accounting (fleetscope.py): hook sites attribute
        # training-thread ms to feed_stall/compute/fetch/ckpt/barrier_wait;
        # record_step drains the ledger into the step event + phase gauges.
        # Default on (a few dict adds per step); PADDLE_TPU_PHASES=0 opts
        # out.
        if phases is None:
            phases = os.environ.get(
                "PADDLE_TPU_PHASES", "1").strip().lower() not in (
                    "0", "false", "off")
        self.phases = _fleetscope.PhaseLedger() if phases else None
        self._phase_cum = {}
        # fleet clock anchor: publish/observe the rank-0 epoch beacon and
        # this rank's measured fs-clock skew into <out_dir>/clock.json (and
        # onto the tracer export) so merged fleet views share one timeline
        self.clock = _fleetscope.init_fleet_clock(
            out_dir,
            wall0=self.tracer.anchor()["wall0"] if self.tracer else None)
        if self.tracer is not None:
            self.tracer.set_epoch(self.clock["epoch_wall"],
                                  self.clock["clock_skew_ms"],
                                  self.clock["rank"])
        self.timeline.emit("monitor_start", pid=os.getpid())

    # -- step telemetry ---------------------------------------------------
    def take_device_sample(self):
        """True on steps whose fetches should be block_until_ready-timed
        (every ``device_time_every``-th, counting from the first)."""
        return self._steps % self.device_time_every == 0

    def maybe_sample_memory(self, force=False):
        """Time-sampled memory watermark + MemScope owner attribution
        (default every ~2s, not per-step: live_arrays() walks every buffer
        the client holds, which a sub-millisecond step loop must not pay
        per step).  Returns the snapshot when one was taken."""
        now = time.perf_counter()
        if force or now >= self._next_mem:
            self._next_mem = now + self.memory_interval_s
            return sample_memory(self.registry, self.timeline)
        return None

    def record_step(self, step, host_ms, device_ms=None, batch=None,
                    fetches=None, compiled=False, ident=None,
                    defer_memory=False):
        self._steps += 1
        reg = self.registry
        reg.counter("monitor.steps").incr()
        ev = {"step": step, "host_ms": round(host_ms, 4)}
        if ident is not None:
            # which compiled program ran: joins the step to its "cost"
            # event so trace_summary can report achieved-vs-model FLOPs/s
            ev["ident"] = ident
        if device_ms is not None:
            ev["device_ms"] = round(device_ms, 4)
        if batch:
            ev["batch"] = int(batch)
        if compiled:
            # this step paid trace+XLA compile inside its wall time: tag it
            # and keep it OUT of the steady-state step histograms — one
            # multi-second outlier would own the avg/max the stats exist to
            # watch.  Its cost is tracked under its own name instead.
            ev["compiled"] = True
            reg.histogram("monitor.step.compile_ms").observe(host_ms)
        else:
            reg.histogram("monitor.step.host_ms").observe(host_ms)
            if device_ms is not None:
                reg.histogram("monitor.step.device_ms").observe(device_ms)
            # examples/sec only from SAMPLED device time: on an async
            # backend host_ms is just dispatch latency, and batch/host_ms
            # would report fantasy throughput on the 7-of-8 unsampled steps
            if batch and device_ms is not None and device_ms > 0:
                eps = batch / (device_ms / 1e3)
                reg.histogram("monitor.step.examples_per_sec").observe(eps)
                ev["examples_per_sec"] = round(eps, 2)
        if fetches is not None:
            ev["fetches"] = fetches
        if self.phases is not None:
            # the per-step phase ledger: everything the hook sites
            # attributed since the previous boundary.  Gauges carry the
            # latest step's split, cum counters the run total (what the
            # fleet console reads from metrics.prom).
            ph = self.phases.drain()
            if ph:
                ev["phases"] = {k: round(v, 4) for k, v in ph.items()}
                for k, v in ph.items():
                    reg.gauge("monitor.phase.%s_ms" % k).set(round(v, 4))
                    # run-cumulative ms as a monotonic gauge (Counter.incr
                    # truncates to int — sub-ms phases would vanish); the
                    # fleet console reads these from metrics.prom
                    cum = self._phase_cum.get(k, 0.0) + v
                    self._phase_cum[k] = cum
                    reg.gauge("monitor.phase.%s_ms_cum" % k).set(
                        round(cum, 4))
            # the per-step gauges really mean THIS step: a phase paid
            # earlier but not now (a checkpoint two steps ago) must read
            # 0, not its stale last value, on a mid-run scrape
            for k in self._phase_cum:
                if k not in ph:
                    reg.gauge("monitor.phase.%s_ms" % k).set(0)
        self.timeline.emit("step", **ev)
        # memory watermarks are TIME-sampled, not per-step (see
        # maybe_sample_memory).  ``defer_memory``: the executor takes the
        # sample itself AFTER the step's state commits to the scope —
        # sampling here would catch the in-flight state_out as
        # unattributed and the donated old scope buffers as dead
        if not defer_memory:
            self.maybe_sample_memory()

    def phase_add(self, name, ms):
        """Attribute ``ms`` of training-thread time to a FleetScope phase
        (no-op when phase accounting is off)."""
        if self.phases is not None:
            self.phases.add(name, ms)

    # -- exporters --------------------------------------------------------
    def export_prometheus(self, path=None):
        from .exporters import write_prometheus

        return write_prometheus(
            path or os.path.join(self.out_dir, "metrics.prom"),
            self.registry)

    def close(self):
        if self.sentinel is not None:
            self.sentinel.close()
        # a rank that raced ahead of rank 0's epoch beacon retries once so
        # the published anchor (and the trace export) carry the fleet epoch
        self.clock = _fleetscope.refresh_epoch(self.out_dir, self.clock)
        if self.tracer is not None:
            self.tracer.set_epoch(self.clock["epoch_wall"],
                                  self.clock["clock_skew_ms"],
                                  self.clock["rank"])
        sample_memory(self.registry, self.timeline)
        self.timeline.emit("monitor_end", steps=self._steps)
        self.export_prometheus()
        if self.flight is not None:
            self.flight.uninstall()
        if self.tracer is not None:
            from . import trace as _trace

            try:
                self.tracer.write_chrome_trace(
                    os.path.join(self.out_dir, "trace.json"))
            except Exception:
                pass             # a failed export must not wedge shutdown
            if _trace.active_tracer() is self.tracer:
                _trace.uninstall()
        self.timeline.close()


def enable(out_dir=None, **kwargs):
    """Switch run telemetry on; returns the Monitor.  Re-enabling with a
    session already active closes the old session first (its exports land
    in its own out_dir)."""
    global _active
    if _active is not None:
        _active.close()
    out_dir = out_dir or os.environ.get(
        "PADDLE_TPU_MONITOR_DIR",
        os.path.join(tempfile.gettempdir(), "paddle_tpu_monitor"))
    _active = Monitor(out_dir, **kwargs)
    return _active


def disable():
    """Close the active session (writes metrics.prom, final memory sample)."""
    global _active
    if _active is not None:
        _active.close()
        _active = None


def active():
    """The active Monitor or None — THE hook-site check; must stay cheap."""
    global _env_checked
    if _active is None and not _env_checked:
        _env_checked = True
        if os.environ.get("PADDLE_TPU_MONITOR") == "1":
            return enable()
    return _active


def report(registry=None):
    """StatRegistry.snapshot() rows — the monitor section of
    ``stop_profiler``'s output (and anything else that wants the table).
    Defaults to the ACTIVE session's registry when one is enabled (a
    session built over a custom registry must report its own data), else
    the process-global default."""
    if registry is None:
        registry = _active.registry if _active is not None \
            else default_registry()
    return registry.snapshot()


def phase_add(name, ms):
    """Module-level FleetScope phase hook for sites without the Monitor in
    hand (the checkpoint writer): one global read when no session is
    active."""
    m = _active
    if m is not None and m.phases is not None:
        m.phases.add(name, ms)


def _now_ms():
    return time.perf_counter() * 1e3
