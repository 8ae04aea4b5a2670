"""TraceMesh: cross-process causal tracing over the span tracer.

Parity: the reference's ``platform/profiler`` RecordEvent tree merged by
``tools/timeline.py`` into one chrome trace — grown for a stack where one
user-visible request crosses PROCESSES, not just threads: a serving
request rides the bucket lattice in one process, its CTR rows are pulled
over ``hostps/wire.py`` from a shard owner in another, and an online
publish->verify->flip chain spans a trainer and a serving replica.  A
per-process ``trace.json`` cannot say which process a slow request spent
its time in; this module makes the per-process exports JOINABLE.

Three small pieces, all stdlib-only (the jax-free CLIs path-load this
file the way they load fleetscope.py):

- **context**: a trace is identified by ``(trace_id, span_id)``; child
  spans carry ``tm_tid``/``tm_sid``/``tm_pid`` span args (exported into
  the chrome events' ``args``), so parent links survive serialization
  without any new ring format.  ``scope()`` keeps a thread-local current
  context so nested instrumentation picks up its parent implicitly.
- **wire codec + clock pairs**: the wire client sends
  ``{"tid","sid","t0"}`` on each request; every reply echoes
  ``{"tid","pid","t1","t2"}`` (server recv/send wall clock).  The client
  attaches the completed ``(t0,t1,t2,t3)`` quadruple to its span as a
  ``tm_clock`` arg — an NTP-style sample bounding the two processes'
  wall-clock skew to the round trip.
- **merger**: ``merge_process_traces`` fuses per-process ``trace.json``
  (+ optional ``timeline.jsonl``) into ONE Perfetto-loadable trace: one
  pid / track group per process, clocks aligned through the wire pairs
  (bounded-skew estimate reported per process; unpaired processes fall
  back to the shared-host clock and are flagged), timeline events as
  instants on a dedicated track, and every cross-process parent->child
  span link emitted as a chrome flow event (``ph:"s"`` / ``ph:"f"``).

The port's copy of the JAX package's ``monitor/tracemesh.py``: stdlib only,
so the copy needs no change beyond its package.
"""

import json
import os
import threading

__all__ = ["new_trace_id", "new_span_id", "link", "current", "scope",
           "wire_context", "wire_echo", "clock_pair", "estimate_offset",
           "read_jsonl_tolerant", "merge_process_traces", "find_chain",
           "write_merged"]

# span-arg keys every exported event carries (chrome ``args`` namespace)
TM_TRACE = "tm_tid"
TM_SPAN = "tm_sid"
TM_PARENT = "tm_pid"
TM_CLOCK = "tm_clock"

_tls = threading.local()


def _rand_hex(nbytes):
    return os.urandom(nbytes).hex()


def new_trace_id():
    """128-bit trace id (hex) — one per causal request chain."""
    return _rand_hex(16)


def new_span_id():
    """64-bit span id (hex) — one per span."""
    return _rand_hex(8)


def link(parent=None):
    """Mint a child context under ``parent`` ((trace_id, span_id) or
    None for a new root).  Returns ``((trace_id, span_id), args)`` where
    ``args`` are the ``tm_*`` span-arg fields to attach to the span."""
    sid = new_span_id()
    if parent:
        tid = parent[0]
        return (tid, sid), {TM_TRACE: tid, TM_SPAN: sid,
                            TM_PARENT: parent[1]}
    tid = new_trace_id()
    return (tid, sid), {TM_TRACE: tid, TM_SPAN: sid}


def current():
    """The calling thread's current context ((trace_id, span_id)) or
    None.  One attribute read — safe on hot paths."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


class scope(object):
    """Thread-local context scope: ``with scope(ctx): ...`` makes ``ctx``
    the parent every ``link(current())`` inside picks up.  ``scope(None)``
    is a no-op — hook sites can use one ``with`` unconditionally."""

    __slots__ = ("_ctx",)

    def __init__(self, ctx):
        self._ctx = ctx

    def __enter__(self):
        if self._ctx is None:
            return None
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        if self._ctx is None:
            return False
        try:
            _tls.stack.pop()
        except (AttributeError, IndexError):
            pass
        return False


# --------------------------------------------------------- wire codec --

def wire_context(ctx, t_wall):
    """The compact context a wire REQUEST carries: ids + client send
    wall-clock (the clock pair's t0)."""
    return {"tid": ctx[0], "sid": ctx[1], "t0": t_wall}


def wire_echo(tctx, t_recv, t_send, pid=None):
    """The context echo a wire REPLY carries: trace id, the server's
    process id (the merger's join key against trace.json otherData.pid),
    and the server recv/send wall clocks (the pair's t1/t2)."""
    return {"tid": (tctx or {}).get("tid"),
            "pid": int(pid if pid is not None else os.getpid()),
            "t1": t_recv, "t2": t_send}


def clock_pair(tctx_sent, echo, t_recv_wall):
    """Assemble the NTP-style sample the client span records as its
    ``tm_clock`` arg; None when the reply carried no echo."""
    if not echo or echo.get("t1") is None:
        return None
    return {"peer_pid": echo.get("pid"),
            "t0": tctx_sent.get("t0"), "t1": echo["t1"],
            "t2": echo.get("t2"), "t3": t_recv_wall}


def estimate_offset(pairs):
    """Best bounded-skew estimate from ``(t0,t1,t2,t3)`` quadruples:
    per pair ``offset = ((t1-t0)+(t2-t3))/2`` (peer wall minus local
    wall) with uncertainty ``+- rtt/2``; the minimum-rtt pair wins (the
    classic NTP filter).  Returns ``{"offset_s","bound_s","pairs"}`` or
    None when no usable pair."""
    best = None
    n = 0
    for p in pairs:
        try:
            t0, t1, t2, t3 = (float(p["t0"]), float(p["t1"]),
                              float(p["t2"]), float(p["t3"]))
        except (KeyError, TypeError, ValueError):
            continue
        rtt = (t3 - t0) - (t2 - t1)
        if rtt < 0:
            continue
        n += 1
        off = ((t1 - t0) + (t2 - t3)) / 2.0
        if best is None or rtt < best[1]:
            best = (off, rtt)
    if best is None:
        return None
    return {"offset_s": best[0], "bound_s": best[1] / 2.0, "pairs": n}


# ------------------------------------------------- tolerant jsonl read --

def read_jsonl_tolerant(path):
    """Read a JSONL file, skipping (and counting) unparseable lines —
    a SIGKILLed writer leaves a torn final line; the merger must shrug,
    not raise.  Returns ``(events, skipped)``; a missing file is
    ``([], 0)``."""
    events, skipped = [], 0
    try:
        f = open(path)
    except OSError:
        return events, skipped
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except ValueError:
                skipped += 1
    return events, skipped


# --------------------------------------------------------------- merge --

def _load_trace(trace):
    if isinstance(trace, dict):
        return trace
    try:
        with open(trace) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _span_events(trace):
    for e in trace.get("traceEvents", []):
        if e.get("ph") in ("X", "B", "i"):
            yield e


def _collect_pairs(trace):
    """All ``tm_clock`` quadruples in one process's trace, grouped by
    peer pid."""
    by_peer = {}
    for e in _span_events(trace):
        clk = (e.get("args") or {}).get(TM_CLOCK)
        if isinstance(clk, dict) and clk.get("peer_pid") is not None:
            by_peer.setdefault(int(clk["peer_pid"]), []).append(clk)
    return by_peer


def merge_process_traces(procs, out_path=None):
    """Fuse per-process exports into one chrome trace.

    ``procs``: list of ``{"label": str, "trace": path-or-dict,
    "timeline": path-or-None}`` — one entry per process (a monitor
    out_dir's ``trace.json`` + ``timeline.jsonl``).  Returns the merged
    trace dict; its ``otherData["processes"]`` carries the per-process
    alignment report (offset_ms, bound_ms, pairs, aligned, torn lines).

    Clock model: each trace's events are micros since its own
    ``t0_unix`` wall anchor.  Wire clock pairs give bounded offsets
    between processes' wall clocks; the first process is the reference
    and every pair-connected process is shifted by its estimated offset.
    Processes with no path to the reference keep offset 0 (same-host
    clocks ARE one clock; cross-host unpaired processes are flagged
    ``aligned: false``)."""
    loaded = []
    for p in procs:
        t = _load_trace(p.get("trace"))
        if t is None:
            continue
        other = t.get("otherData") or {}
        loaded.append({
            "label": str(p.get("label", "proc%d" % len(loaded))),
            "trace": t,
            "timeline": p.get("timeline"),
            "orig_pid": other.get("pid"),
            "t0_unix": float(other.get("t0_unix", 0.0)),
            "pairs": _collect_pairs(t),
        })
    if not loaded:
        raise ValueError("merge_process_traces: no loadable trace.json")

    pid_to_idx = {}
    for i, p in enumerate(loaded):
        if p["orig_pid"] is not None:
            pid_to_idx.setdefault(int(p["orig_pid"]), i)

    # offset_to_ref[i]: seconds ADDED to process i's wall clock to land
    # on the reference (process 0) timebase.  BFS over the pair graph;
    # edges are bidirectional (a pair measured from either side).
    edges = {}      # i -> {j: {"offset_s": peer_minus_self, "bound_s"}}
    for i, p in enumerate(loaded):
        for peer_pid, pairs in p["pairs"].items():
            j = pid_to_idx.get(peer_pid)
            if j is None or j == i:
                continue
            est = estimate_offset(pairs)
            if est is None:
                continue
            cur = edges.setdefault(i, {}).get(j)
            if cur is None or est["bound_s"] < cur["bound_s"]:
                edges.setdefault(i, {})[j] = est
    offset = {0: 0.0}
    bound = {0: 0.0}
    frontier = [0]
    while frontier:
        i = frontier.pop()
        hops = dict(edges.get(i, {}))
        # reverse edges: peer j measured i
        for j, outs in edges.items():
            if i in outs and j not in hops:
                e = outs[i]
                hops[j] = {"offset_s": -e["offset_s"],
                           "bound_s": e["bound_s"], "pairs": e["pairs"]}
        for j, e in hops.items():
            if j in offset:
                continue
            # t_j = t_i + offset(i->j)  =>  to-ref(j) = to-ref(i) - off
            offset[j] = offset[i] - e["offset_s"]
            bound[j] = bound[i] + e["bound_s"]
            frontier.append(j)

    anchors = []
    for i, p in enumerate(loaded):
        anchors.append(p["t0_unix"] + offset.get(i, 0.0))
    epoch = min(anchors) if anchors else 0.0

    meta, events, flows = [], [], []
    sid_index = {}          # tm_sid -> (merged_pid, tid, ts, dur)
    child_links = []        # (merged_pid, tid, ts, tm_pid, tm_sid)
    report = {}
    _TL_TID = 999999        # the timeline instants' dedicated track

    for i, p in enumerate(loaded):
        shift_us = (anchors[i] - epoch) * 1e6
        aligned = i == 0 or i in offset
        name = "%s" % p["label"]
        if p["orig_pid"] is not None:
            name += " (pid %s)" % p["orig_pid"]
        meta.append({"ph": "M", "pid": i, "tid": 0, "ts": 0,
                     "name": "process_name", "args": {"name": name}})
        torn = 0
        for e in p["trace"].get("traceEvents", []):
            e = dict(e)
            e["pid"] = i
            if e.get("ph") == "M":
                if e.get("name") == "process_name":
                    continue          # replaced above
                meta.append(e)
                continue
            e["ts"] = round(float(e.get("ts", 0.0)) + shift_us, 3)
            events.append(e)
            a = e.get("args") or {}
            sid = a.get(TM_SPAN)
            if sid:
                dur = float(e.get("dur", 0.0) or 0.0)
                prev = sid_index.get(sid)
                if prev is None:
                    sid_index[sid] = (i, e.get("tid", 0), e["ts"], dur)
            if a.get(TM_PARENT):
                child_links.append((i, e.get("tid", 0), e["ts"],
                                    a[TM_PARENT], sid))
        if p["timeline"]:
            tl, torn = read_jsonl_tolerant(p["timeline"])
            if tl:
                meta.append({"ph": "M", "pid": i, "tid": _TL_TID,
                             "ts": 0, "name": "thread_name",
                             "args": {"name": "timeline"}})
            for ev in tl:
                try:
                    ts = (float(ev.get("ts")) + offset.get(i, 0.0)
                          - epoch) * 1e6
                except (TypeError, ValueError):
                    continue
                args = {k: v for k, v in ev.items()
                        if k not in ("ev", "ts") and _plain(v)}
                events.append({"ph": "i", "s": "t", "pid": i,
                               "tid": _TL_TID, "cat": "timeline",
                               "name": str(ev.get("ev", "event")),
                               "ts": round(ts, 3),
                               **({"args": args} if args else {})})
        report[p["label"]] = {
            "pid": i,
            "orig_pid": p["orig_pid"],
            "shift_us": round(shift_us, 3),
            "offset_ms": round(offset.get(i, 0.0) * 1e3, 3),
            "skew_bound_ms": round(bound.get(i, 0.0) * 1e3, 3)
            if i in bound else None,
            "clock_pairs": sum(len(v) for v in p["pairs"].values()),
            "aligned": bool(aligned),
            "timeline_torn_lines": torn,
        }

    # cross-process flow events: one s/f pair per parent->child link
    # whose endpoints live in different processes.  The flow id is the
    # CHILD's span id (unique per edge); ts nudged inside each slice so
    # Perfetto binds the arrow to the right span.
    for (cpid, ctid, cts, parent_sid, child_sid) in child_links:
        par = sid_index.get(parent_sid)
        if par is None or par[0] == cpid:
            continue
        ppid, ptid, pts, pdur = par
        fid = child_sid or ("p" + parent_sid)
        flows.append({"ph": "s", "cat": "tracemesh", "name": "tm",
                      "id": fid, "pid": ppid, "tid": ptid,
                      "ts": round(pts + min(pdur, 1.0), 3)})
        flows.append({"ph": "f", "bp": "e", "cat": "tracemesh",
                      "name": "tm", "id": fid, "pid": cpid, "tid": ctid,
                      "ts": round(cts + 0.001, 3)})

    events.sort(key=lambda e: e.get("ts", 0))
    merged = {"traceEvents": meta + events + flows,
              "displayTimeUnit": "ms",
              "otherData": {"epoch_wall": epoch,
                            "flow_events": len(flows) // 2,
                            "processes": report}}
    if out_path:
        write_merged(merged, out_path)
    return merged


def _plain(v):
    return isinstance(v, (int, float, str, bool, type(None), list, dict))


def write_merged(merged, out_path):
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(merged, f, default=str)
    os.replace(tmp, out_path)
    return out_path


# --------------------------------------------------------- chain query --

def find_chain(merged, names):
    """Find one trace id whose spans cover ``names`` IN PARENT ORDER:
    ``names[k+1]``'s span must have ``tm_pid`` == ``names[k]``'s span id
    (the connected-chain assertion the online drill gates on).  Returns
    ``{"trace_id", "spans": [{name, pid, sid}]}`` or None."""
    by_trace = {}
    for e in merged.get("traceEvents", []):
        a = e.get("args") or {}
        tid = a.get(TM_TRACE)
        if tid and e.get("name") in names:
            by_trace.setdefault(tid, []).append(
                {"name": e["name"], "pid": e.get("pid"),
                 "sid": a.get(TM_SPAN), "parent": a.get(TM_PARENT)})
    for tid, spans in by_trace.items():
        by_name = {}
        for s in spans:
            by_name.setdefault(s["name"], []).append(s)
        if any(n not in by_name for n in names):
            continue
        # walk: pick a spine where each link's parent id matches
        def walk(k, parent_sid):
            if k == len(names):
                return []
            for s in by_name[names[k]]:
                if parent_sid is not None and s["parent"] != parent_sid:
                    continue
                rest = walk(k + 1, s["sid"])
                if rest is not None:
                    return [s] + rest
            return None
        spine = walk(0, None)
        if spine is not None:
            return {"trace_id": tid,
                    "spans": [{"name": s["name"], "pid": s["pid"],
                               "sid": s["sid"]} for s in spine]}
    return None
