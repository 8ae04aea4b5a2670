"""FleetScope: cross-rank performance attribution over the monitor surfaces.

Parity: the reference pairs its trainer with fleet-level perf forensics —
``tools/timeline.py`` merges per-worker profiles into ONE view and
``platform/profiler`` attributes time per phase.  Our port stopped at
per-process observability: the tracer exports one chrome trace per rank
with *unaligned* wall clocks, and nothing answered "which rank is slow, and
is it feed, compute, collective wait, or checkpoint barrier?".  This module
is that layer, three pieces:

- **Clock alignment.**  Every rank's Tracer anchors ``perf_counter`` to its
  own wall clock; rank 0 additionally publishes a shared-fs *epoch beacon*
  (``publish_epoch``) and every rank measures its wall clock against the
  shared filesystem's clock (``measure_clock_skew`` — write a probe file,
  compare my wall to its server-side mtime; the FS clock is the one clock
  every rank can see).  The per-rank anchor lands in ``<out_dir>/clock.json``
  and in the chrome trace's ``otherData``, so ``merge_chrome_traces`` can
  place every rank's track on ONE epoch-relative timeline with a measured
  ``clock_skew_ms`` per rank.

- **Phase decomposition.**  ``PhaseLedger`` accumulates training-thread
  milliseconds per phase (``feed_stall`` / ``compute`` / ``fetch`` /
  ``ckpt`` / ``barrier_wait``) between step boundaries; the monitor session
  drains it into each ``step`` timeline event (the per-step phase ledger)
  and ``monitor.phase.<name>_ms`` gauges + ``..._ms_cum`` counters.

- **Straggler attribution.**  ``fleet_attribution`` joins per-rank step
  events by step ident, computes the per-step *duration-skew* distribution
  (duration-based, not wall-offset-based: a constant startup/compile offset
  between unsynchronized ranks is not straggling), names the slowest rank
  AND the phase whose per-step cost exceeds the fleet median, and the
  ``FleetScope`` scanner exports it live as ``fleet.straggler{rank}``
  gauges + ``straggler`` timeline events.

This module is deliberately **stdlib-only with no package imports** so the
jax-free CLIs (``scripts/trace_summary.py``, ``scripts/fleet_top.py``) can
load it by file path exactly like ``exporters.py``.

The port's copy of the JAX package's ``monitor/fleetscope.py``: stdlib only,
so the copy needs no change beyond its package.
"""

import json
import os
import threading
import time

__all__ = [
    "PHASES", "PhaseLedger",
    "publish_epoch", "read_epoch", "measure_clock_skew", "init_fleet_clock",
    "read_clock",
    "step_series", "step_durations", "phase_breakdown",
    "fleet_attribution", "merge_chrome_traces",
    "phase_totals_from_prom", "attribute_from_totals",
    "FleetScope",
]

# THE phase taxonomy: training-thread time between two step boundaries is
# attributed to exactly one of these (or to untracked host work).
#   feed_stall   — waiting on / preparing the input batch (pipe take stall,
#                  inline feed conversion)
#   compute      — the step itself (sampled device wall when available,
#                  dispatch wall otherwise — a lower bound on async backends)
#   fetch        — in-flight-window waits on step outputs (host ran ahead)
#   ckpt         — checkpoint snapshot/staging/publish cost
#   barrier_wait — the COMMIT shard-barrier poll (rank 0 waiting on peers —
#                  THE multi-host skew signal)
#   ps_wait      — ShardPS wire waits (hostps/shard_router.py): remote
#                  parameter-server pulls/pushes, sync acks, bounded-
#                  staleness backpressure, dead-shard recovery stalls — a
#                  slow or lost shard shows up HERE, named, instead of
#                  smearing into compute
PHASES = ("feed_stall", "compute", "fetch", "ckpt", "barrier_wait",
          "ps_wait")

EPOCH_FILE = "fleetscope-epoch.json"
CLOCK_FILE = "clock.json"


# --------------------------------------------------------------- ledger --

class PhaseLedger:
    """Thread-safe per-phase millisecond accumulator, drained at each step
    boundary by ``Monitor.record_step`` into the step event's ``phases``
    ledger.  Hook sites (executor, feed pipe, checkpoint writer) call
    ``add`` only when a monitor session is active, so the disabled path
    costs nothing; the enabled path is one lock + one dict update."""

    def __init__(self):
        self._lock = threading.Lock()
        self._acc = {}

    def add(self, phase, ms):
        if ms is None or ms <= 0.0:
            return
        with self._lock:
            self._acc[phase] = self._acc.get(phase, 0.0) + ms

    def drain(self):
        """Return-and-reset the accumulated ``{phase: ms}`` (one step's
        ledger).  Off-thread contributions (an async checkpoint writer's
        barrier wait) land in whichever step drains next — attribution to
        the rank is exact, attribution to the step is best-effort."""
        with self._lock:
            acc, self._acc = self._acc, {}
        return acc

    def peek(self):
        with self._lock:
            return dict(self._acc)


# --------------------------------------------------- clock/epoch beacon --

def _atomic_write_json(path, obj):
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def publish_epoch(fleet_dir, rank=0):
    """Rank 0 writes the fleet's epoch beacon (atomic replace; later
    incarnations overwrite — the newest beacon is the fleet's epoch).
    Returns the epoch record."""
    os.makedirs(fleet_dir, exist_ok=True)
    rec = {"epoch_wall": time.time(), "rank": int(rank), "pid": os.getpid()}
    _atomic_write_json(os.path.join(fleet_dir, EPOCH_FILE), rec)
    return rec


def read_epoch(fleet_dir, timeout=0.0, poll=0.05):
    """Read the epoch beacon, polling up to ``timeout`` seconds for rank 0
    to publish it (non-zero ranks start racing rank 0's session enable).
    Returns the record or None."""
    path = os.path.join(fleet_dir, EPOCH_FILE)
    deadline = time.time() + timeout
    while True:
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            if time.time() >= deadline:
                return None
            time.sleep(poll)


def measure_clock_skew(fleet_dir, rank):
    """Estimate this rank's wall-clock skew against the shared filesystem's
    clock: write a probe file and compare my wall time to its server-side
    mtime.  The FS clock is the one clock every rank observes, so per-rank
    skews measured this way are mutually comparable; the estimate is bounded
    by the probe write latency.  Returns skew in ms (positive = my clock is
    ahead of the FS clock), or None when the probe fails."""
    probe = os.path.join(fleet_dir, ".clock-probe-%d" % int(rank))
    try:
        t0 = time.time()
        with open(probe, "w") as f:
            f.write("%f" % t0)
        mtime = os.stat(probe).st_mtime
        t1 = time.time()
        return round(((t0 + t1) / 2.0 - mtime) * 1e3, 3)
    except OSError:
        return None
    finally:
        try:
            os.remove(probe)       # no litter in the shared fleet dir
        except OSError:
            pass


def default_epoch_timeout():
    """How long a non-zero rank polls for rank 0's beacon at session start
    (``PADDLE_TPU_EPOCH_TIMEOUT``, default 0.5s — a missed beacon degrades
    to the per-process anchor and ``refresh_epoch`` retries at close)."""
    try:
        return float(os.environ.get("PADDLE_TPU_EPOCH_TIMEOUT", "0.5"))
    except ValueError:
        return 0.5


def init_fleet_clock(out_dir, wall0=None, rank=None, world=None,
                     fleet_dir=None, timeout=None):
    """Publish/observe the fleet clock anchors for one monitor session.

    - resolves fleet identity from the launcher contract
      (``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM``) unless given;
    - the fleet dir (shared fs) is ``PADDLE_TPU_FLEET_DIR`` when set, else
      the PARENT of ``out_dir`` for world > 1 (the per-rank monitor dirs of
      one run are siblings — the drill/launcher layout);
    - rank 0 publishes the epoch beacon; every rank reads it (bounded poll)
      and measures its FS-clock skew;
    - writes ``<out_dir>/clock.json`` either way (a single-process run gets
      ``epoch_wall = wall0``, skew 0 — the merged view degrades to the
      per-process view).

    Returns the clock record."""
    if rank is None:
        try:
            rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        except ValueError:
            rank = 0
    if world is None:
        try:
            world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        except ValueError:
            world = 1
    wall0 = time.time() if wall0 is None else float(wall0)
    fleet_dir = fleet_dir or os.environ.get("PADDLE_TPU_FLEET_DIR")
    if fleet_dir is None and world > 1:
        fleet_dir = os.path.dirname(os.path.abspath(out_dir))
    rec = {"rank": int(rank), "world": int(world), "wall0": wall0,
           "epoch_wall": wall0, "clock_skew_ms": 0.0, "fleet_dir": fleet_dir}
    if fleet_dir is not None and world > 1:
        try:
            if rank == 0:
                epoch = publish_epoch(fleet_dir, rank=rank)
            else:
                epoch = read_epoch(
                    fleet_dir,
                    timeout=default_epoch_timeout()
                    if timeout is None else timeout)
            if epoch is not None:
                rec["epoch_wall"] = epoch["epoch_wall"]
            skew = measure_clock_skew(fleet_dir, rank)
            if skew is not None:
                rec["clock_skew_ms"] = skew
        except OSError:
            pass                    # a sick shared mount must not stop
            # telemetry; the record degrades to the per-process anchor
    try:
        os.makedirs(out_dir, exist_ok=True)
        _atomic_write_json(os.path.join(out_dir, CLOCK_FILE), rec)
    except OSError:
        pass
    return rec


def refresh_epoch(out_dir, rec):
    """Session-close retry for a rank that missed the beacon at start
    (``epoch_wall`` still equals its own ``wall0``): one non-blocking read;
    rewrites ``clock.json`` when the beacon has appeared.  Returns the
    (possibly updated) record."""
    if not rec or rec.get("fleet_dir") is None \
            or rec.get("epoch_wall") != rec.get("wall0"):
        return rec
    epoch = read_epoch(rec["fleet_dir"], timeout=0.0)
    if epoch is not None and epoch["epoch_wall"] != rec["epoch_wall"]:
        rec = dict(rec, epoch_wall=epoch["epoch_wall"])
        try:
            _atomic_write_json(os.path.join(out_dir, CLOCK_FILE), rec)
        except OSError:
            pass
    return rec


def read_clock(monitor_dir):
    """The session's published clock anchor (``clock.json``) or None."""
    try:
        with open(os.path.join(monitor_dir, CLOCK_FILE)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# ------------------------------------------------------ offline analysis --

def _median(vals):
    if not vals:
        return None
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2.0


def _stats(vals):
    if not vals:
        return None
    s = sorted(vals)
    n = len(s)
    return {"n": n, "mean": sum(s) / n, "min": s[0], "max": s[-1],
            "p50": s[n // 2]}


def step_series(events):
    """``{step: record}`` from a timeline's ``step`` events (last occurrence
    wins — a resumed run re-emits the boundary step)."""
    out = {}
    for e in events:
        if e.get("ev") != "step" or "step" not in e or "ts" not in e:
            continue
        out[int(e["step"])] = e
    return out


def step_durations(series, outlier_x=10.0):
    """Per-step wall duration from consecutive step events' ``ts`` deltas
    (the real step wall on an async backend, where ``host_ms`` is only
    dispatch latency).  Durations more than ``outlier_x`` × the worker's
    median are dropped: those are compile / restore / preemption-boundary
    gaps, not steady-state step time."""
    steps = sorted(series)
    durs = {}
    for prev, cur in zip(steps, steps[1:]):
        if cur != prev + 1:
            continue
        if series[cur].get("compiled"):
            continue            # this step paid XLA compile in its wall
        d = (series[cur]["ts"] - series[prev]["ts"]) * 1e3
        if d > 0:
            durs[cur] = d
    med = _median(list(durs.values()))
    if med:
        durs = {s: d for s, d in durs.items() if d <= outlier_x * med}
    return durs


def phase_breakdown(events):
    """Aggregate the per-step phase ledgers: ``{phase: {n, mean, p50, min,
    max, sum}}`` over ``step`` events carrying ``phases``."""
    per = {}
    for e in events:
        if e.get("ev") != "step":
            continue
        for ph, ms in (e.get("phases") or {}).items():
            per.setdefault(ph, []).append(float(ms))
    out = {}
    for ph, vals in per.items():
        st = _stats(vals)
        st["sum"] = round(sum(vals), 4)
        out[ph] = st
    return out


def _phase_means(series, steps):
    sums, counts = {}, {}
    for s in steps:
        for ph, ms in (series[s].get("phases") or {}).items():
            sums[ph] = sums.get(ph, 0.0) + float(ms)
            counts[ph] = counts.get(ph, 0) + 1
    return {ph: sums[ph] / counts[ph] for ph in sums}


def fleet_attribution(per_worker_events, clocks=None, min_steps=4):
    """Join per-rank step series and attribute the fleet's skew.

    ``per_worker_events``: ``{label: [timeline events]}`` (>= 2 workers).
    ``clocks``: optional ``{label: clock.json record}`` for skew surfacing.

    Returns None when fewer than 2 workers have ``min_steps`` matched
    consecutive steps; else::

        {"workers": {label: {"steps", "matched_steps", "median_step_ms",
                             "phase_ms": {phase: mean}, "clock_skew_ms",
                             "slowest_steps"}},
         "matched_steps": K,
         "step_skew_ms": {n, mean, p50, min, max},   # per-step max-min dur
         "step_skew_frac": p50 skew / fleet median step,
         "straggler": {"rank", "phase", "excess_ms", "median_step_ms",
                       "fleet_median_step_ms", "slowest_steps"}}

    Skew is DURATION-based (per matched step: max rank duration − min rank
    duration), so a constant wall-clock or startup offset between ranks —
    which is alignment, not straggling — cannot trip the gate.
    """
    series = {lab: (ev if isinstance(ev, dict) else step_series(ev))
              for lab, ev in per_worker_events.items()}
    durs = {lab: step_durations(s) for lab, s in series.items()}
    labs = sorted(lab for lab in durs if durs[lab])
    if len(labs) < 2:
        return None
    common = set(durs[labs[0]])
    for lab in labs[1:]:
        common &= set(durs[lab])
    if len(common) < min_steps:
        return None
    common = sorted(common)

    skews = []
    slowest_steps = dict.fromkeys(labs, 0)
    for s in common:
        vals = {lab: durs[lab][s] for lab in labs}
        mx = max(vals.values())
        skews.append(mx - min(vals.values()))
        slowest_steps[max(vals, key=vals.get)] += 1
    med = {lab: _median([durs[lab][s] for s in common]) for lab in labs}
    fleet_med = _median([durs[lab][s] for lab in labs for s in common])

    straggler = max(labs, key=lambda l: (med[l], slowest_steps[l]))
    pmeans = {lab: _phase_means(series[lab], common) for lab in labs}
    phase, excess = None, 0.0
    for ph in sorted({p for m in pmeans.values() for p in m}):
        others = [pmeans[l].get(ph, 0.0) for l in labs if l != straggler]
        base = _median(others) if others else 0.0
        d = pmeans[straggler].get(ph, 0.0) - base
        if d > excess:
            excess, phase = d, ph

    skew_stats = _stats(skews)
    frac = (round(skew_stats["p50"] / fleet_med, 4)
            if fleet_med else None)
    workers = {}
    for lab in labs:
        w = {"steps": len(series[lab]), "matched_steps": len(common),
             "median_step_ms": round(med[lab], 4),
             "phase_ms": {p: round(v, 4) for p, v in pmeans[lab].items()},
             "slowest_steps": slowest_steps[lab]}
        clk = (clocks or {}).get(lab)
        if clk is not None:
            w["clock_skew_ms"] = clk.get("clock_skew_ms")
        workers[lab] = w
    return {
        "workers": workers,
        "matched_steps": len(common),
        "step_skew_ms": {k: round(v, 4) for k, v in skew_stats.items()},
        "step_skew_frac": frac,
        "straggler": {
            "rank": straggler,
            "phase": phase,
            "excess_ms": round(excess, 4) if phase else None,
            "median_step_ms": round(med[straggler], 4),
            "fleet_median_step_ms": round(fleet_med, 4),
            "slowest_steps": slowest_steps[straggler],
        },
    }


# ------------------------------------------------- merged chrome export --

def merge_chrome_traces(worker_traces, clocks=None, out_path=None):
    """Merge per-rank chrome traces onto ONE epoch-relative timeline.

    ``worker_traces``: ``{label: trace dict}`` (each a Tracer
    ``to_chrome_trace()`` export whose ``otherData.t0_unix`` anchors its
    local perf timeline to that rank's wall clock).  ``clocks``: optional
    ``{label: clock.json record}`` — each rank's wall is corrected by its
    measured ``clock_skew_ms`` before alignment, so the merged view is
    causally ordered across ranks instead of interleaved by each process's
    own clock.  Each rank becomes its own pid/track group; the common epoch
    is the earliest corrected anchor.  Writes atomically when ``out_path``
    is given; returns the merged trace dict."""
    corrected = {}
    for lab, tr in worker_traces.items():
        other = (tr.get("otherData") or {})
        wall0 = float(other.get("t0_unix", 0.0))
        skew_ms = 0.0
        clk = (clocks or {}).get(lab)
        if clk and clk.get("clock_skew_ms") is not None:
            skew_ms = float(clk["clock_skew_ms"])
        elif other.get("clock_skew_ms") is not None:
            skew_ms = float(other["clock_skew_ms"])
        corrected[lab] = wall0 - skew_ms / 1e3
    if not corrected:
        return None
    # the merged timeline's zero: the rank-0 epoch beacon when published
    # (every rank reports the same one), clamped to the earliest corrected
    # anchor so no rank's first span lands before t=0
    epoch = min(corrected.values())
    beacons = [c.get("epoch_wall") for c in (clocks or {}).values()
               if c and c.get("epoch_wall") is not None]
    beacons += [float((tr.get("otherData") or {})["epoch_wall"])
                for tr in worker_traces.values()
                if (tr.get("otherData") or {}).get("epoch_wall") is not None]
    if beacons:
        epoch = min(epoch, min(beacons))

    events, meta, workers_meta = [], [], {}
    for i, lab in enumerate(sorted(worker_traces)):
        tr = worker_traces[lab]
        shift_us = (corrected[lab] - epoch) * 1e6
        workers_meta[str(lab)] = {
            "pid": i, "shift_us": round(shift_us, 3),
            "clock_skew_ms": round((float((tr.get("otherData") or {})
                                          .get("t0_unix", 0.0))
                                    - corrected[lab]) * 1e3, 3)}
        for ev in tr.get("traceEvents", []):
            e = dict(ev)
            e["pid"] = i
            if e.get("ph") == "M":
                if e.get("name") == "process_name":
                    e["args"] = {"name": "rank %s" % lab}
                meta.append(e)
                continue
            e["ts"] = round(float(e.get("ts", 0.0)) + shift_us, 3)
            events.append(e)
    events.sort(key=lambda e: e["ts"])
    merged = {"traceEvents": meta + events, "displayTimeUnit": "ms",
              "otherData": {"epoch_wall": epoch, "workers": workers_meta}}
    if out_path:
        tmp = out_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(merged, f)
        os.replace(tmp, out_path)
    return merged


# ------------------------------------------------- fleet_top prom helpers --

_PROM_PHASE_PREFIX = "paddle_tpu_monitor_phase_"
_PROM_PHASE_SUFFIX = "_ms_cum"


def phase_totals_from_prom(metrics):
    """``{phase: cumulative ms}`` from a parsed exposition's
    ``paddle_tpu_monitor_phase_<name>_ms_cum`` gauges."""
    out = {}
    for name, value in (metrics or {}).items():
        if name.startswith(_PROM_PHASE_PREFIX) \
                and name.endswith(_PROM_PHASE_SUFFIX):
            ph = name[len(_PROM_PHASE_PREFIX):-len(_PROM_PHASE_SUFFIX)]
            out[ph] = float(value)
    return out


def attribute_from_totals(totals_by_rank, steps_by_rank=None):
    """Console-grade straggler attribution from cumulative phase counters
    (what each rank's ``metrics.prom`` carries): the straggler is the rank
    furthest BEHIND in steps (when step gauges are available and spread),
    else the rank with the largest total accounted ms; the attributed phase
    is its largest positive excess over the fleet median of that phase.
    Returns ``(rank, phase, excess_ms)`` or None when indeterminate."""
    ranks = [r for r, t in (totals_by_rank or {}).items() if t]
    if len(ranks) < 2:
        return None
    straggler = None
    steps = {r: s for r, s in (steps_by_rank or {}).items()
             if r in ranks and s is not None}
    if len(steps) == len(ranks) and max(steps.values()) > min(steps.values()):
        straggler = min(steps, key=steps.get)
    if straggler is None:
        totals = {r: sum(totals_by_rank[r].values()) for r in ranks}
        if max(totals.values()) <= min(totals.values()):
            return None
        straggler = max(totals, key=totals.get)
    phase, excess = None, 0.0
    for ph in sorted({p for t in totals_by_rank.values() for p in t}):
        others = [totals_by_rank[r].get(ph, 0.0)
                  for r in ranks if r != straggler]
        base = _median(others) if others else 0.0
        d = totals_by_rank[straggler].get(ph, 0.0) - base
        if d > excess:
            excess, phase = d, ph
    if phase is None:
        return None
    return straggler, phase, round(excess, 3)


# ----------------------------------------------------------- live scanner --

class FleetScope:
    """Live cross-rank scanner: tails each rank's ``timeline.jsonl``
    incrementally, joins step events, and exports straggler attribution as
    gauges + timeline events.  Registry/timeline are passed in (duck-typed)
    so this module stays import-free; ``HeartBeatMonitor`` drives it from
    its scan thread."""

    def __init__(self, monitor_dirs, labels=None, max_steps=512,
                 min_steps=4):
        self.dirs = list(monitor_dirs)
        self.labels = ([str(x) for x in labels] if labels
                       else [str(i) for i in range(len(self.dirs))])
        self.max_steps = int(max_steps)
        self.min_steps = int(min_steps)
        self._offsets = dict.fromkeys(self.labels, 0)
        self._series = {lab: {} for lab in self.labels}
        self._clocks = {}
        self._last_key = None

    def _read_new(self):
        for lab, d in zip(self.labels, self.dirs):
            if lab not in self._clocks:
                clk = read_clock(d)
                if clk is not None:
                    self._clocks[lab] = clk
            path = os.path.join(d, "timeline.jsonl")
            try:
                with open(path, "rb") as f:
                    f.seek(self._offsets[lab])
                    chunk = f.read()
            except OSError:
                continue
            # never CONSUME a partial trailing line: the writer flushes on
            # a cadence, so the live file routinely ends mid-record — a
            # tell()-based offset would skip past the fragment and lose
            # that step forever.  Parse up to the last newline and leave
            # the tail for the next scan to re-read completed.
            nl = chunk.rfind(b"\n")
            if nl < 0:
                continue
            self._offsets[lab] += nl + 1
            ser = self._series[lab]
            for line in chunk[:nl].decode("utf-8",
                                          errors="replace").splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue        # a corrupt line (never a live tail)
                if rec.get("ev") == "step" and "step" in rec \
                        and "ts" in rec:
                    ser[int(rec["step"])] = rec
            if len(ser) > self.max_steps:
                for s in sorted(ser)[:len(ser) - self.max_steps]:
                    del ser[s]

    def scan(self, registry=None, timeline=None):
        """One pass: ingest new events, attribute, export.  Returns the
        attribution dict (or None when the fleet has too little data)."""
        self._read_new()
        attr = fleet_attribution(self._series, clocks=self._clocks,
                                 min_steps=self.min_steps)
        if attr is None:
            return None
        strag = attr["straggler"]
        if registry is not None:
            for lab in self.labels:
                registry.gauge("fleet.straggler", rank=lab).set(
                    1 if lab == strag["rank"] else 0)
            registry.gauge("fleet.step_skew_ms").set(
                attr["step_skew_ms"]["p50"])
            if attr["step_skew_frac"] is not None:
                registry.gauge("fleet.step_skew_frac").set(
                    attr["step_skew_frac"])
            if strag["excess_ms"] is not None:
                registry.gauge("fleet.straggler_excess_ms").set(
                    strag["excess_ms"])
        key = (strag["rank"], strag["phase"])
        if timeline is not None and key != self._last_key:
            timeline.emit("straggler", rank=strag["rank"],
                          phase=strag["phase"],
                          excess_ms=strag["excess_ms"],
                          skew_p50_ms=attr["step_skew_ms"]["p50"],
                          skew_frac=attr["step_skew_frac"])
        self._last_key = key
        return attr
