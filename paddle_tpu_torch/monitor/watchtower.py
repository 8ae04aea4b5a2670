"""Watchtower: live SLO alerting over the monitor stack's published streams.

Parity: the reference's fleet organs — the heartbeat monitor, the
``platform/monitor.h`` StatRegistry, PSLib's fleet metrics — only ever
detect *death*; every quality gate this repo grew (``trace_summary
--check``, ``perf_ledger``, drill assertions) runs *after* the run.  This
module is the missing live half: declarative alert rules evaluated
incrementally over the per-rank Prometheus expositions (``metrics.prom``)
and timeline JSONL streams the monitor stack already publishes, with
firing/resolved state machines, dedup, and an append-only fleet
**incident ledger** that bundles the causal evidence the stack already
produces but never assembled (offending samples, the failing canary's
TraceMesh trace id, flight postmortem paths, FleetScope's straggler
attribution).

Three rule kinds (each a plain dict, loadable from a JSON rules file):

- ``threshold`` — fire when ``op(value, rule.value)`` holds for
  ``for_s`` seconds.  ``metric`` names a prom sample (label'd keys
  verbatim, e.g. ``paddle_tpu_fleet_request_ms{quantile="0.99"}``) or an
  ``event:<type>`` series derived from a timeline stream; ``window_s``
  compares the *increase* over the window instead of the latest sample
  (rate-style thresholds over counters).
- ``absence`` — fire when the metric has not been *updated* within
  ``stale_s`` (a prom file's atomic rewrite stamps every sample it
  carries; a timeline event stamps its own ``ts``).  A SIGKILL'd
  replica's exposition freezes; its respawn resumes it — absence is the
  replica-dead detector with resolution built in.
- ``burn_rate`` — the multi-window SLO error-budget burn: with
  ``objective`` o, budget b = 1-o; per window w the burn is
  (fraction of samples violating ``op(value, rule.value)``) / b.  Fires
  only when burn ≥ ``factor`` in BOTH the ``short_s`` and ``long_s``
  windows (the short window gives speed, the long window immunity to
  blips), resolves when the short window cools.

Evaluation is incremental: prom sources reparse only on mtime change,
timeline sources advance a byte offset and never consume a torn tail
(the fleetscope scanner discipline).  Alert state lands atomically in
``<out_dir>/watchtower_state.json`` (the jax-free ``fleet_top`` ALERTS
pane reads it); fire/resolve transitions emit ``watchtower_alert``
timeline events (flush-critical — timeline.FLUSH_EVENTS) and append to
``<out_dir>/incidents.jsonl``.

This module is deliberately **stdlib-only with no package imports** so
the jax-free CLIs (``fleet_top.py``, ``trace_summary.py``) can load it
by file path exactly like ``fleetscope.py``; live emitters (a monitor
timeline, a straggler provider, extra evidence hooks) are *injected*,
never imported.

The port's copy of the JAX package's ``monitor/watchtower.py``: stdlib only,
so the copy needs no change beyond its package.
"""

import fnmatch
import json
import os
import re
import time

__all__ = [
    "Watchtower", "load_rules", "validate_rule", "read_state",
    "firing_from_state", "DEFAULT_RULES",
]

_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*(?:\{[^}]*\})?)\s+(-?[0-9.eE+naif]+)\s*$')

OPS = {
    ">": lambda a, b: a > b,
    "<": lambda a, b: a < b,
    ">=": lambda a, b: a >= b,
    "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}

# The fleet-serving rule set the drills run with: replica death via
# exposition absence, client-visible p99 burn over the latency SLO, and
# the canary's end-to-end correctness gauge.  Thresholds are injected by
# the caller (``value``/``stale_s`` depend on the deployment's cadence);
# these are the shapes.
DEFAULT_RULES = [
    {"name": "replica_dead", "kind": "absence",
     "metric": "paddle_tpu_serve_version",
     "stale_s": 3.0, "source": "replica-*"},
    {"name": "p99_burn", "kind": "burn_rate",
     "metric": 'paddle_tpu_fleet_request_ms{quantile="0.99"}',
     "op": ">", "value": 250.0, "objective": 0.9,
     "short_s": 5.0, "long_s": 30.0, "factor": 1.0},
    {"name": "canary_fail", "kind": "threshold",
     "metric": "paddle_tpu_canary_ok", "op": "<", "value": 1.0},
]


def validate_rule(rule):
    """Raise ValueError on a malformed rule dict; return it normalized."""
    if not isinstance(rule, dict):
        raise ValueError("rule must be a dict, got %r" % (rule,))
    kind = rule.get("kind")
    if kind not in ("threshold", "absence", "burn_rate"):
        raise ValueError("rule %r: unknown kind %r"
                         % (rule.get("name"), kind))
    if not rule.get("name"):
        raise ValueError("rule needs a name: %r" % (rule,))
    if not rule.get("metric"):
        raise ValueError("rule %r needs a metric" % rule["name"])
    if kind in ("threshold", "burn_rate"):
        if rule.get("op") not in OPS:
            raise ValueError("rule %r: op must be one of %s"
                             % (rule["name"], sorted(OPS)))
        if not isinstance(rule.get("value"), (int, float)):
            raise ValueError("rule %r needs a numeric value" % rule["name"])
    if kind == "absence" and not isinstance(rule.get("stale_s"),
                                            (int, float)):
        raise ValueError("rule %r needs stale_s" % rule["name"])
    if kind == "burn_rate":
        for k in ("objective", "short_s", "long_s", "factor"):
            if not isinstance(rule.get(k), (int, float)):
                raise ValueError("rule %r needs %s" % (rule["name"], k))
        if not (0.0 < rule["objective"] < 1.0):
            raise ValueError("rule %r: objective must be in (0, 1)"
                             % rule["name"])
        if rule["short_s"] >= rule["long_s"]:
            raise ValueError("rule %r: short_s must be < long_s"
                             % rule["name"])
    return rule


def load_rules(path):
    """Load a JSON rules file: a list of rule dicts (see module doc)."""
    with open(path) as f:
        rules = json.load(f)
    if not isinstance(rules, list):
        raise ValueError("rules file %s: expected a JSON list" % path)
    return [validate_rule(r) for r in rules]


def _parse_prom(path):
    """Minimal Prometheus-text parse: ``{sample_key: float}`` with label'd
    keys kept verbatim.  None when unreadable (a replica mid-rewrite)."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError:
        return None
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        try:
            out[m.group(1)] = float(m.group(2))
        except ValueError:
            continue
    return out


def _atomic_write_json(path, obj):
    tmp = path + ".tmp.%d" % os.getpid()
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def read_state(path):
    """The state file fleet_top's ALERTS pane reads; None when absent or
    torn (an atomic-rename writer makes torn rare, not impossible)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def firing_from_state(state):
    """Firing alert dicts out of ``read_state``'s result (the autoscale
    hook's cross-process shape)."""
    if not isinstance(state, dict):
        return []
    return [a for a in state.get("alerts", ())
            if a.get("state") == "firing"]


class _Series:
    """One (source, metric) sample stream: a bounded (ts, value) window
    plus the last time the underlying stream *said anything* about it."""

    __slots__ = ("samples", "updated_ts", "horizon_s")

    def __init__(self, horizon_s):
        self.samples = []
        self.updated_ts = None
        self.horizon_s = horizon_s

    def add(self, ts, value):
        self.samples.append((ts, value))
        self.updated_ts = ts
        cut = ts - self.horizon_s
        if self.samples and self.samples[0][0] < cut:
            self.samples = [s for s in self.samples if s[0] >= cut]

    def touch(self, ts):
        self.updated_ts = ts

    def latest(self):
        return self.samples[-1][1] if self.samples else None

    def window(self, now, secs):
        cut = now - secs
        return [v for (ts, v) in self.samples if ts >= cut]

    def increase(self, now, secs):
        w = [(ts, v) for (ts, v) in self.samples if ts >= now - secs]
        if len(w) < 2:
            return None
        return w[-1][1] - w[0][1]


class _PromSource:
    __slots__ = ("name", "path", "mtime")

    def __init__(self, name, path):
        self.name = name
        self.path = path
        self.mtime = -1.0

    def scan(self, now):
        """(changed, samples): reparse only when the file changed."""
        try:
            mt = os.stat(self.path).st_mtime
        except OSError:
            return False, None
        if mt == self.mtime:
            return False, None
        parsed = _parse_prom(self.path)
        if parsed is None:
            return False, None
        self.mtime = mt
        return True, parsed


class _TimelineSource:
    """Incremental JSONL scanner: advance a byte offset, never consume a
    partial tail line (a writer may be mid-record)."""

    __slots__ = ("name", "path", "offset", "torn")

    def __init__(self, name, path):
        self.name = name
        self.path = path
        self.offset = 0
        self.torn = 0

    def scan(self):
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size <= self.offset:
            return []
        with open(self.path, "rb") as f:
            f.seek(self.offset)
            buf = f.read(size - self.offset)
        nl = buf.rfind(b"\n")
        if nl < 0:
            return []          # only a fragment so far: leave it
        self.offset += nl + 1
        out = []
        for line in buf[:nl].split(b"\n"):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line.decode("utf-8", "replace"))
            except ValueError:
                self.torn += 1
                continue
            if isinstance(rec, dict) and "ev" in rec:
                out.append(rec)
            else:
                self.torn += 1
        return out


class _AlertFSM:
    __slots__ = ("state", "pending_since", "fired_ts", "resolved_ts",
                 "incident", "count", "value")

    def __init__(self):
        self.state = "ok"
        self.pending_since = None
        self.fired_ts = None
        self.resolved_ts = None
        self.incident = None
        self.count = 0
        self.value = None


class Watchtower:
    """The alert-rule engine.

    ``rules`` — list of rule dicts (see module doc; ``validate_rule`` is
    applied).  ``out_dir`` — where ``watchtower_state.json`` and
    ``incidents.jsonl`` land.  ``timeline`` — optional duck-typed emitter
    (``emit(ev, **fields)``) for ``watchtower_alert`` events; injected,
    not imported, to keep this module path-loadable.
    ``straggler_provider`` — optional callable returning FleetScope's
    current attribution dict for incident evidence.  ``now`` — clock
    injection for deterministic tests.
    """

    STATE_FILE = "watchtower_state.json"
    INCIDENTS_FILE = "incidents.jsonl"

    def __init__(self, rules, out_dir=None, timeline=None,
                 straggler_provider=None, dedup_s=0.0, now=time.time):
        self.rules = [validate_rule(dict(r)) for r in rules]
        self.out_dir = out_dir
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        self.timeline = timeline
        self.straggler_provider = straggler_provider
        self.dedup_s = float(dedup_s)
        self.now = now
        self._prom = []
        self._events = []
        self._series = {}           # (source, metric) -> _Series
        self._fsm = {}              # (rule_name, source) -> _AlertFSM
        self._evidence_hooks = []
        self._postmortems = []      # paths seen in timeline streams
        self._canary = {}           # last canary_probe evidence per source
        self._started = None
        self._polls = 0
        self._incidents = 0
        self._horizon = max(
            [r.get("long_s", 0) for r in self.rules]
            + [r.get("window_s", 0) or 0 for r in self.rules]
            + [60.0]) * 2.0

    # -- sources ----------------------------------------------------------
    def add_prom_source(self, name, path):
        self._prom.append(_PromSource(str(name), path))
        return self

    def add_timeline_source(self, name, path):
        self._events.append(_TimelineSource(str(name), path))
        return self

    def add_evidence(self, fn):
        """Register a callable returning a dict merged into every new
        incident's evidence (the hook surface: canary, fleetscope, the
        drill's own context)."""
        self._evidence_hooks.append(fn)
        return self

    def observe(self, source, metric, value, ts=None):
        """Direct sample injection (in-process gauges, tests)."""
        self._sget(str(source), metric).add(
            self.now() if ts is None else ts, float(value))

    def _sget(self, source, metric):
        key = (source, metric)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _Series(self._horizon)
        return s

    # -- the poll ---------------------------------------------------------
    def poll(self):
        """One evaluation round: scan sources, advance every rule's FSM,
        persist state, ledger incidents.  Returns the transitions made
        this round as ``[(state, alert_dict), ...]``."""
        now = self.now()
        if self._started is None:
            self._started = now
        self._polls += 1
        self._scan_prom(now)
        self._scan_events(now)
        transitions = []
        for rule in self.rules:
            for source in self._sources_for(rule):
                tr = self._eval(rule, source, now)
                if tr is not None:
                    transitions.append(tr)
        if self.out_dir:
            self._write_state(now)
        return transitions

    def _scan_prom(self, now):
        for src in self._prom:
            changed, samples = src.scan(now)
            if samples is None:
                continue
            for key, value in samples.items():
                # the file's atomic rewrite stamps every sample it
                # carries: value-unchanged metrics still count as alive
                self._sget(src.name, key).add(src.mtime, value)

    def _scan_events(self, now):
        for src in self._events:
            recs = src.scan()
            if not recs:
                continue
            counts = {}
            last_ts = {}
            for rec in recs:
                ev = rec["ev"]
                counts[ev] = counts.get(ev, 0) + 1
                ts = rec.get("ts")
                if isinstance(ts, (int, float)):
                    last_ts[ev] = ts
                if ev == "postmortem" and rec.get("path"):
                    self._postmortems.append(str(rec["path"]))
                    del self._postmortems[:-8]
                if ev == "canary_probe":
                    self._canary[src.name] = rec
            for ev, n in counts.items():
                s = self._sget(src.name, "event:" + ev)
                prev = s.latest() or 0.0
                s.add(last_ts.get(ev, now), prev + n)

    def _sources_for(self, rule):
        pat = rule.get("source")
        metric = rule["metric"]
        names = sorted({src for (src, m) in self._series if m == metric})
        if pat:
            names = [n for n in names if fnmatch.fnmatch(n, pat)]
        return names

    # -- rule conditions --------------------------------------------------
    def _eval(self, rule, source, now):
        series = self._series[(source, rule["metric"])]
        kind = rule["kind"]
        if kind == "threshold":
            cond, value = self._cond_threshold(rule, series, now)
        elif kind == "absence":
            cond, value = self._cond_absence(rule, series, now)
        else:
            cond, value = self._cond_burn(rule, series, now)
        return self._advance(rule, source, cond, value, now)

    def _cond_threshold(self, rule, series, now):
        if rule.get("window_s"):
            v = series.increase(now, float(rule["window_s"]))
        else:
            v = series.latest()
        if v is None:
            return False, None
        return OPS[rule["op"]](v, rule["value"]), v

    def _cond_absence(self, rule, series, now):
        if series.updated_ts is None:
            return False, None
        age = now - series.updated_ts
        return age > float(rule["stale_s"]), round(age, 3)

    def _cond_burn(self, rule, series, now):
        budget = 1.0 - float(rule["objective"])
        op, thr = OPS[rule["op"]], rule["value"]

        def burn(secs):
            w = series.window(now, secs)
            if not w:
                return None
            bad = sum(1 for v in w if op(v, thr))
            return (bad / float(len(w))) / budget

        b_short = burn(float(rule["short_s"]))
        b_long = burn(float(rule["long_s"]))
        if b_short is None or b_long is None:
            return False, None
        factor = float(rule["factor"])
        return (b_short >= factor and b_long >= factor), round(b_short, 3)

    # -- the firing/resolved state machine --------------------------------
    def _advance(self, rule, source, cond, value, now):
        key = (rule["name"], source)
        fsm = self._fsm.get(key)
        if fsm is None:
            fsm = self._fsm[key] = _AlertFSM()
        fsm.value = value
        for_s = float(rule.get("for_s", 0.0))
        if cond:
            if fsm.state == "firing":
                return None
            if fsm.pending_since is None:
                fsm.pending_since = now
            if now - fsm.pending_since < for_s:
                fsm.state = "pending"
                return None
            return self._fire(rule, source, fsm, now)
        fsm.pending_since = None
        if fsm.state == "firing":
            return self._resolve(rule, source, fsm, now)
        if fsm.state != "resolved":    # resolved stays visible (the pane
            fsm.state = "ok"           # shows it aging) until a re-fire
        return None

    def _fire(self, rule, source, fsm, now):
        fsm.state = "firing"
        fsm.fired_ts = now
        fsm.count += 1
        dedup_s = float(rule.get("dedup_s", self.dedup_s))
        deduped = (fsm.incident is not None and fsm.resolved_ts is not None
                   and now - fsm.resolved_ts <= dedup_s)
        if not deduped:
            self._incidents += 1
            fsm.incident = "inc-%04d" % self._incidents
            self._ledger(self._incident_record(rule, source, fsm, now))
        alert = self._alert_dict(rule, source, fsm)
        alert["deduped"] = deduped
        self._emit("watchtower_alert", state="firing", **alert)
        return ("firing", alert)

    def _resolve(self, rule, source, fsm, now):
        fsm.state = "resolved"
        fsm.resolved_ts = now
        alert = self._alert_dict(rule, source, fsm)
        alert["duration_s"] = round(now - fsm.fired_ts, 3)
        self._ledger({"rec": "resolve", "id": fsm.incident,
                      "rule": rule["name"], "source": source,
                      "resolved_ts": now,
                      "duration_s": alert["duration_s"]})
        self._emit("watchtower_alert", state="resolved", **alert)
        return ("resolved", alert)

    def _alert_dict(self, rule, source, fsm):
        return {"rule": rule["name"], "kind": rule["kind"],
                "source": source, "metric": rule["metric"],
                "value": fsm.value, "incident": fsm.incident,
                "count": fsm.count, "since": fsm.fired_ts}

    # -- the incident ledger ----------------------------------------------
    def _incident_record(self, rule, source, fsm, now):
        series = self._series.get((source, rule["metric"]))
        samples = [[round(ts, 3), v]
                   for (ts, v) in (series.samples[-8:] if series else ())]
        evidence = {}
        if self._postmortems:
            evidence["postmortems"] = list(self._postmortems)
        canary = self._pick_canary()
        if canary is not None:
            evidence["canary_trace_id"] = canary.get("trace_id")
            evidence["canary_ok"] = canary.get("ok")
        if self.straggler_provider is not None:
            try:
                strag = self.straggler_provider()
                if strag:
                    evidence["straggler"] = strag
            except Exception:
                pass
        for hook in self._evidence_hooks:
            try:
                extra = hook()
                if isinstance(extra, dict):
                    evidence.update(extra)
            except Exception:
                pass
        return {"rec": "incident", "id": fsm.incident,
                "rule": rule["name"], "kind": rule["kind"],
                "source": source, "metric": rule["metric"],
                "fired_ts": now, "value": fsm.value, "samples": samples,
                "evidence": evidence}

    def _pick_canary(self):
        """Prefer the latest FAILING probe's record (its trace id names
        the broken causal chain); else the latest probe at all."""
        best = None
        for rec in self._canary.values():
            if not rec.get("ok", True) and (
                    best is None or rec.get("ts", 0) > best.get("ts", 0)):
                best = rec
        if best is None:
            for rec in self._canary.values():
                if best is None or rec.get("ts", 0) > best.get("ts", 0):
                    best = rec
        return best

    def _ledger(self, rec):
        if not self.out_dir:
            return
        path = os.path.join(self.out_dir, self.INCIDENTS_FILE)
        with open(path, "a") as f:
            f.write(json.dumps(rec, sort_keys=True))
            f.write("\n")
            f.flush()

    def _emit(self, ev, **fields):
        if self.timeline is None:
            return
        try:
            self.timeline.emit(ev, **fields)
        except Exception:
            pass

    # -- exposure ---------------------------------------------------------
    def alerts(self):
        """Every alert the engine has an opinion about (firing AND
        recently resolved — the pane shows both)."""
        out = []
        for (rule_name, source), fsm in sorted(self._fsm.items()):
            if fsm.state not in ("firing", "resolved"):
                continue
            rule = next(r for r in self.rules if r["name"] == rule_name)
            a = self._alert_dict(rule, source, fsm)
            a["state"] = fsm.state
            if fsm.resolved_ts is not None:
                a["resolved_ts"] = fsm.resolved_ts
            out.append(a)
        return out

    def firing(self):
        return [a for a in self.alerts() if a["state"] == "firing"]

    def state_path(self):
        return (os.path.join(self.out_dir, self.STATE_FILE)
                if self.out_dir else None)

    def _write_state(self, now):
        torn = sum(s.torn for s in self._events)
        _atomic_write_json(self.state_path(), {
            "ts": now, "polls": self._polls, "rules": len(self.rules),
            "incidents": self._incidents, "torn_lines": torn,
            "alerts": self.alerts(),
        })
