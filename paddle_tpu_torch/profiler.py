"""Profiler (parity: python/paddle/fluid/profiler.py — profiler ctx :228,
start_profiler :129 / stop_profiler :171; C++ platform/profiler.h RecordEvent +
CUPTI DeviceTracer device_tracer.h:41): the counterpart of the JAX
package's ``profiler.py``.

The capture is ``torch.profiler`` (host activity, and on a card the CUDA
kernels CUPTI records); ``stop_profiler`` writes the chrome trace torch
exports into the trace directory, and ``aggregate_profile`` reads it back
into the reference's summary table (the same rows, sort keys, and error
for an unknown key).  ``RecordEvent`` is ``torch.profiler.record_function``.
The counter half (``incr``, ``observe``, ``counters``,
``counter_report``) is a copy over the port's monitor registry.
"""

import contextlib
import glob
import json
import os
import re
import tempfile

import torch

from .monitor.registry import default_registry as _registry

__all__ = ["profiler", "start_profiler", "stop_profiler", "reset_profiler",
           "RecordEvent", "cuda_profiler", "aggregate_profile",
           "export_chrome_tracing", "incr", "observe", "counters",
           "observations", "counter_report"]

_trace_dir = None
_profile = None

_SORT_KEYS = ("total", "calls", "max", "min", "ave")

# -- generic counters (no CUPTI analogue in the reference; the PSLib
# client kept its own pull/push counters inside FleetWrapper — this is that
# surface made generic).  incr() for monotonic event counts, observe() for
# latency/size samples; both show up in stop_profiler's report and are
# drained by reset_profiler.  Thread-safe: hostps prefetch threads report
# while the main thread trains.  Since the monitor subsystem landed these
# are thin views over monitor.StatRegistry (monitor.h parity): incr() is a
# Counter, observe() a Histogram, and the same stats flow out through the
# Prometheus exporter and monitor.report().


def incr(name, amount=1):
    """Add `amount` to the named monotonic counter (e.g. cache hits)."""
    _registry().counter(name).incr(amount)


def observe(name, value):
    """Record one sample of a named quantity (e.g. a pull latency in ms)."""
    _registry().histogram(name).observe(value)


def _render_name(row):
    if not row["labels"]:
        return row["name"]
    return row["name"] + "{%s}" % ",".join(
        "%s=%s" % kv for kv in sorted(row["labels"].items()))


def counters():
    """Snapshot of ALL counters in the unified registry — including the
    monitor subsystem's own ("monitor.*", "bench.*") — as {name: value}
    (labeled stats render as 'name{k=v}')."""
    return {_render_name(r): r["value"]
            for r in _registry().snapshot() if r["kind"] == "counter"}


def observations():
    """Snapshot of the observe() stats: {name: {calls,total,min,max,avg}}."""
    return {_render_name(r): {k: r[k]
                              for k in ("calls", "total", "min", "max", "avg")}
            for r in _registry().snapshot()
            if r["kind"] == "histogram" and r["calls"]}


def counter_report():
    """Rows for the counter section of the profiling report, sorted by name:
    {"name", "kind": "counter"|"observed", ...}."""
    rows = [{"name": n, "kind": "counter", "value": v}
            for n, v in counters().items()]
    rows += [{"name": n, "kind": "observed", **s}
             for n, s in observations().items()]
    rows.sort(key=lambda r: r["name"])
    return rows


def _print_counter_report(rows):
    # counters get their own Value column; observed rows keep Calls..Max —
    # every field lands under its header in both row kinds
    print("-------------------------  Counters  -------------------------")
    print(f"{'Name':40s} {'Value':>12s} {'Calls':>8s} {'Total':>12s} "
          f"{'Avg':>10s} {'Min':>10s} {'Max':>10s}")
    for r in rows:
        if r["kind"] == "counter":
            print(f"{r['name'][:40]:40s} {r['value']:12g}")
        else:
            print(f"{r['name'][:40]:40s} {'':>12s} {r['calls']:8d} "
                  f"{r['total']:12.3f} {r['avg']:10.4f} {r['min']:10.4f} "
                  f"{r['max']:10.4f}")


def start_profiler(state="All", tracer_option="Default", trace_dir=None):
    """Parity: profiler.py:129.  state kCPU/kGPU/kAll: "CPU" records host
    activity only; otherwise the card's kernels too, where there is one."""
    global _trace_dir, _profile
    _trace_dir = trace_dir or os.environ.get(
        "PADDLE_TPU_TRACE_DIR",
        os.path.join(tempfile.gettempdir(), "paddle_tpu_trace"))
    os.makedirs(_trace_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if str(state).upper() != "CPU" and torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    _profile = torch.profiler.profile(activities=activities)
    _profile.__enter__()


def _load_chrome_trace(trace_dir):
    """The newest chrome trace ``stop_profiler`` wrote under trace_dir."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "*.trace.json")),
                   key=os.path.getmtime)
    if not paths:
        return None
    with open(paths[-1]) as f:
        return json.load(f)


# chrome-trace categories torch gives the card's activity
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")


def aggregate_profile(trace_dir=None, sorted_key="total"):
    """Per-event summary rows from the captured trace (the
    platform/profiler.h:166 EnableProfiler/DisableProfiler table).  Each row:
    {"name", "calls", "total_ms", "avg_ms", "min_ms", "max_ms", "device"}.
    sorted_key: total | calls | max | min | ave (profiler.py:171); anything
    else raises ValueError (the reference rejects unknown keys too — a typo
    must not silently re-sort by total)."""
    if sorted_key is not None and sorted_key not in _SORT_KEYS:
        raise ValueError(
            "unknown sorted_key %r; valid keys: %s"
            % (sorted_key, ", ".join(_SORT_KEYS)))
    tr = _load_chrome_trace(trace_dir or _trace_dir)
    if tr is None:
        return []
    pid_names = {}
    for e in tr.get("traceEvents", []):
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_names[e["pid"]] = str(e.get("args", {}).get("name", ""))
    rows = {}
    for e in tr.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        name = e.get("name", "")
        if not name or re.fullmatch(r"\d+", name):
            continue
        pname = pid_names.get(e.get("pid"), "").lower()
        dev = "device" if (e.get("cat") in _DEVICE_CATS
                           or "device" in pname or "gpu" in pname) \
            else "host"
        key = (name, dev)
        r = rows.setdefault(key, dict(name=name, device=dev, calls=0,
                                      total_ms=0.0, min_ms=float("inf"),
                                      max_ms=0.0))
        d = float(e.get("dur", 0.0)) / 1000.0
        r["calls"] += 1
        r["total_ms"] += d
        r["min_ms"] = min(r["min_ms"], d)
        r["max_ms"] = max(r["max_ms"], d)
    result = []
    for r in rows.values():
        r["avg_ms"] = r["total_ms"] / max(r["calls"], 1)
        result.append(r)
    keyf = {"total": lambda r: -r["total_ms"],
            "calls": lambda r: -r["calls"],
            "max": lambda r: -r["max_ms"],
            "min": lambda r: -r["min_ms"],
            "ave": lambda r: -r["avg_ms"]}[sorted_key or "total"]
    result.sort(key=keyf)
    return result


def export_chrome_tracing(path, trace_dir=None):
    """Write the captured trace as an uncompressed chrome://tracing JSON
    (parity: tools/timeline.py:15 Timeline)."""
    tr = _load_chrome_trace(trace_dir or _trace_dir)
    if tr is None:
        raise RuntimeError("no captured trace under %r" % (trace_dir or _trace_dir))
    with open(path, "w") as f:
        json.dump(tr, f)
    return path


def stop_profiler(sorted_key=None, profile_path=None):
    """Parity: profiler.py:171 — ends capture, prints the per-event summary
    table (platform/profiler.h DisableProfiler), and (if profile_path)
    writes a chrome://tracing JSON (tools/timeline.py parity).  Returns the
    table rows."""
    global _profile
    prof, _profile = _profile, None
    prof.__exit__(None, None, None)
    prof.export_chrome_trace(os.path.join(
        _trace_dir, "profile_%d.trace.json" % os.getpid()))
    rows = aggregate_profile(_trace_dir, sorted_key)
    if rows:
        print("------------------------->  Profiling Report  "
              "<-------------------------")
        print(f"{'Event':48s} {'Where':6s} {'Calls':>7s} {'Total(ms)':>11s} "
              f"{'Avg(ms)':>9s} {'Min(ms)':>9s} {'Max(ms)':>9s}")
        for r in rows[:40]:
            print(f"{r['name'][:48]:48s} {r['device']:6s} {r['calls']:7d} "
                  f"{r['total_ms']:11.3f} {r['avg_ms']:9.4f} "
                  f"{r['min_ms']:9.4f} {r['max_ms']:9.4f}")
    crows = counter_report()
    from . import monitor as _monitor

    if _monitor.active() is not None:
        # the monitor table below shows the full registry (typed, labeled);
        # keep the run-session namespaces out of the Counters table so the
        # same stat never prints twice
        crows = [r for r in crows
                 if not r["name"].startswith(("monitor.", "bench."))]
    if crows:
        _print_counter_report(crows)
    if _monitor.active() is not None:
        mrows = _monitor.report()
        if mrows:
            print(_monitor.format_report(mrows))
    if profile_path:
        export_chrome_tracing(profile_path, _trace_dir)
    return rows


def reset_profiler():
    """Parity: profiler.py reset_profiler — drains the counter/observation
    stores (the capture itself restarts per start_profiler).  The
    monitor SUBSYSTEM's own run telemetry survives the drain: gauges are
    level samples not run accumulations, and the "monitor."/"bench."
    namespaces belong to the run session (recompile counts, step times) —
    a profiler drain inside one bench config must not erase the run's
    history."""
    _registry().reset(kinds=("counter", "histogram"),
                      exclude_prefixes=("monitor.", "bench."))


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=None, tracer_option="Default"):
    """Parity: profiler.py:228 context manager.  profile_path (a FILE, like
    the reference's profile proto path) receives the chrome-trace export;
    the raw capture goes to the default trace dir."""
    start_profiler(state, tracer_option)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


class RecordEvent:
    """Parity: platform/profiler.h:78 RAII host annotation →
    ``torch.profiler.record_function``."""

    def __init__(self, name):
        self.name = name
        self._fn = None

    def __enter__(self):
        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()
        return self

    def __exit__(self, *args):
        self._fn.__exit__(*args)
        return False


@contextlib.contextmanager
def cuda_profiler(*args, **kwargs):
    """Legacy API parity (profiler.py cuda_profiler) — the same capture."""
    with profiler():
        yield
