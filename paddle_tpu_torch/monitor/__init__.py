"""Run-telemetry subsystem (parity: platform/monitor.h StatRegistry +
tools/timeline.py export, grown into structured run telemetry): the port's
counterpart of the JAX package's ``monitor``, with the same module and
public names.  The stdlib modules are copies; ``memory``, ``memscope`` and
``sentinel`` read the card through ``torch.cuda`` and compute on tensors.
The files a session writes (``timeline.jsonl``, ``trace.json``,
``metrics.prom``, ``postmortem.json``) are the reference's, field for
field, so ``scripts/trace_summary.py`` reads them unchanged.

Four pieces, one registry:

- ``registry``  — typed named stats (Counter/Gauge/Histogram, labels); the
  profiler's ``incr``/``observe`` counters are views over this;
- ``timeline``  — JSONL per-step event log (host dispatch ms, sampled
  device ms, batch size, examples/sec) + compile/memory/run events;
- ``recompile`` — compile-cache-miss detector with key diffs and a warning
  after N recompiles of the same program (the TPU perf footgun);
- ``memory``    — device memory watermark sampling (the owners' tensors +
  the caching allocator's stats);
- ``memscope``  — full-stack memory attribution: per-compiled-program
  memory ledgers (``mem_program`` events + headroom predictor), owner-
  tagged tensor classification with an ``unattributed`` remainder,
  host-side accounting, and the RESOURCE_EXHAUSTED postmortem section;
- ``trace``     — span tracer (context-manager API, per-thread span stacks
  + bounded rings) exported as chrome-trace JSON for Perfetto;
- ``tracemesh`` — cross-process causal tracing: trace-context propagation
  over the HostPS wire, per-request serving-stage decomposition, and the
  clock-aligned multi-process merger behind ``scripts/trace_merge.py``;
- ``flight``    — crash flight recorder: postmortem JSON (spans, timeline
  tail, registry snapshot) from sys.excepthook / the trainer failure path;
- ``exporters`` — Prometheus text-file exposition (single-worker and the
  fleet-merged rollup) and the report table.

Usage::

    from paddle_tpu_torch import monitor
    mon = monitor.enable("run0")           # or PADDLE_TPU_MONITOR=1
    ...train...
    monitor.disable()                      # writes metrics.prom, closes jsonl

``scripts/trace_summary.py`` merges the timeline with the profiler's
aggregate table after the run.
"""

from .registry import (Counter, Gauge, Histogram, StatRegistry,
                       default_registry, stat_add, stat_reset)
from .timeline import Timeline, read_events
from .recompile import RecompileDetector, RecompileStorm
from .memory import memory_snapshot, sample_memory
from . import memscope
from .memscope import MemoryBudgetError, InjectedOOMError
from .exporters import (to_prometheus_text, write_prometheus, format_report,
                        merge_prometheus_texts, merge_prometheus_files,
                        parse_prometheus_text, parse_prometheus_file)
from .session import Monitor, enable, disable, active, report, phase_add
from . import trace
from .trace import Tracer, span, instant
from . import tracemesh
from . import fleetscope
from .fleetscope import PhaseLedger, FleetScope, fleet_attribution
from .flight import FlightRecorder
from . import sentinel
from .sentinel import Sentinel, NonFiniteError, localize_nonfinite

__all__ = [
    "Counter", "Gauge", "Histogram", "StatRegistry", "default_registry",
    "stat_add", "stat_reset",
    "Timeline", "read_events",
    "RecompileDetector", "RecompileStorm",
    "memory_snapshot", "sample_memory",
    "memscope", "MemoryBudgetError", "InjectedOOMError",
    "to_prometheus_text", "write_prometheus", "format_report",
    "merge_prometheus_texts", "merge_prometheus_files",
    "parse_prometheus_text", "parse_prometheus_file",
    "Monitor", "enable", "disable", "active", "report", "phase_add",
    "trace", "Tracer", "span", "instant", "tracemesh", "FlightRecorder",
    "fleetscope", "PhaseLedger", "FleetScope", "fleet_attribution",
    "sentinel", "Sentinel", "NonFiniteError", "localize_nonfinite",
]
