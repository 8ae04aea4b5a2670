"""The serving drills of ``tools/chaos_drill.py``: ``--fleet``, ``--online``
and ``--oom`` (the port's counterparts of the fleet, online and OOM drills
of ``scripts/chaos_drill.py``, with their PASS lines).

``--fleet [--smoke]`` (FleetServe): three ``ServeEngine`` replica
processes behind a ``FleetRouter``; one is SIGKILLed mid-trace under
closed-loop clients.  Zero dropped requests, the victim's traffic
re-routed, every re-routed request within its derived bound, a Watchtower
that fires on the victim only (``replica_dead``, the client-visible
``p99_burn``) while the canary stays green, an incident that names the
victim and the canary's trace, ``autoscale_signal`` citing it, and one
merged trace (``monitor.tracemesh.merge_process_traces``) with the
``fleet.reroute`` instant and a dispatch -> serve chain across processes.
The full drill adds the read-only ShardPS owner for the CTR rows, the
respawn with generation adoption, the alerts resolving, a wrong-weights
rolling swap that the canary catches and the swap back.

Derived bound of the kill window (in place of the reference's fixed
``--max-kill-p99-ms``): a failed attempt waits at most ``attempts x
(deadline + poll + w)`` on the wire — ``attempts`` sends, and the client's
reply loop checks its limit once a poll, waking up to w late, w the
longest oversleep of an identical ``sleep(poll)`` loop that the drill runs
beside the clients — and the attempt that serves is one sibling's service
time.  So a re-routed request with k failed attempts takes at most ``k x
attempts x (deadline + poll + w) + S``, with S the longest successful
attempt measured in the same run.  Each re-routed request is held to its
own bound; the p99 is reported.

``--online [--smoke]`` (OnlineLoop): a trainer process streams files that
appear mid-run and delta-publishes while one live ``ServeEngine`` here
answers under load; every committed version is flipped in with zero
dropped requests and zero recompiles (>= 2 delta flips); a planted
quarantine vetoes its publish interval; a trainer SIGKILLed inside a
publish leaves the last good version serving, its restart collects the
corpse, resumes from the cursor and re-anchors the chain; a rollback; the
killed-and-resumed trainer's finals equal an uninterrupted run's bit for
bit; ``trace_summary``'s flip gates pass on the serve timeline and fail on
a flipless one; publish -> verify -> flip is one trace across processes.

Derived flip bounds (in place of the reference's fixed 5000 ms / 600 s):
a flip's stall runs inside the ``swapper.poll()`` call that made it, so it
is at most one poll period P, the longest measured span from the start of
one poll to the end of the next.  A version v committed at c(v) is flipped
by the first poll that starts after c(v), so its flip lands at most P
after c(v); and c(v) comes before the trainer stamps the next version's
``train_wall`` (or before it exits, for the last one).  So v's freshness
lag is at most I(v) + P, with I(v) that publish interval as measured.
Both bounds hold for leg A's streaming flips: they are checked per flip and
passed to ``trace_summary --check`` over the serve timeline as it stood at
the end of leg A.  Legs B and C wait on purpose (a killed trainer, a
rollback to an old version), so their lags are reported, not gated.

``--oom`` (MemScope): a monitored run with a planted ``ballast`` owner and
a device limit squeezed to just above it dies at the injected
RESOURCE_EXHAUSTED of its 5th dispatch: one ``postmortem.json`` naming the
ballast and the failing plan's ledger, the headroom predictor's warning
before it on the timeline, and ``trace_summary``'s PREDICTED OOM row.

Every process runs on the card unless ``--device cpu`` (the replicas
through ``FleetManager(device=)``, the serving engine and the trainers'
embeddings); shard owners touch no card.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from .chaos_drill import (BATCH, FIELDS, REPO, TIMEOUT_S, VOCAB, _fail,
                          _prom_value, _read_events, _write_files)

# OnlineLoop shapes (the reference's): pub_every is the publish cadence
# (and the checkpoint cadence, so a publish-kill restart resumes AT the
# torn publish's boundary); the quarantine is planted at pub_every + 1 so
# exactly the SECOND publish interval is vetoed; idle is the streaming
# source's drain timeout that ends each trainer once no new files appear
ONLINE = dict(n_files=4, rows=80, pub_every=3, idle=6.0)         # 20 steps
ONLINE_SMOKE = dict(n_files=3, rows=48, pub_every=2, idle=4.0)   # 9 steps
ONLINE_DIM = 4       # serve_ctr table dim: FIELDS ids x 4 = the emb[16] feed
# FleetServe shapes (the reference's): ``deadline`` is the router's
# per-attempt reply budget, the bound of every kill victim's detour.  The
# smoke shape drives dense feeds only (no ShardPS tier, no respawn) and
# never re-probes the corpse (cooloff > the drive); the full shape pulls
# CTR rows from a ShardPS owner and respawns the victim.
FLEET = dict(replicas=3, clients=6, drive_secs=5.0, drive2_secs=3.0,
             deadline=0.6, cooloff=2.0)
FLEET_SMOKE = dict(replicas=3, clients=6, drive_secs=3.0, drive2_secs=0.0,
                   deadline=0.5, cooloff=60.0)
_OOM_BALLAST = None     # the oom plan's planted owner, live for the process


def _say(line):
    print(line)
    sys.stdout.flush()


def _env(device, trace=True):
    env = dict(os.environ)
    env.pop("PADDLE_TPU_CHAOS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if trace:
        env["PADDLE_TPU_TRACE"] = "1"
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    return env


def _owner_env(env):
    """A shard owner touches no card."""
    return dict(env, CUDA_VISIBLE_DEVICES="")


def _drill_cmd(plan, **kw):
    cmd = [sys.executable, "-m", "paddle_tpu_torch.tools.chaos_drill",
           "--worker", "--plan", plan]
    for k, v in kw.items():
        cmd += ["--" + k.replace("_", "-"), str(v)]
    return cmd


# ------------------------------------------------------------- artifacts --

def online_data_file(d, fi, rows):
    """One deterministic drill CTR file, atomically placed (temp + rename,
    so the streaming trainer never reads a half-written file); its content
    is a pure function of (fi, rows)."""
    rng = np.random.RandomState(101 + fi)
    p = os.path.join(d, "part-%05d" % fi)
    tmp = os.path.join(d, ".part-%05d.tmp" % fi)
    with open(tmp, "w") as f:
        for _ in range(rows):
            ids = rng.randint(0, VOCAB, FIELDS)
            lab = 1.0 if ids.sum() % 3 == 0 else 0.0
            f.write("%d %s 1 %.1f\n"
                    % (FIELDS, " ".join(map(str, ids)), lab))
    os.replace(tmp, p)
    return p


def online_artifact(workdir, device):
    """The drills' serving model (serve_bench's smoke model: dense x[12] +
    looked-up emb[16] -> fc(16, relu) -> score[1]), trained a little,
    saved and exported with a symbolic batch dim."""
    import paddle_tpu_torch as fluid

    from . import serve_bench as sb

    return sb.build_artifact(fluid, workdir, np.random.RandomState(0),
                             device=device)


def serve_table(row_range=None, optimizer=None):
    from ..hostps import HostSparseTable

    return HostSparseTable(VOCAB, ONLINE_DIM, optimizer=optimizer, seed=11,
                           name="serve_ctr", row_range=row_range)


# --------------------------------------------------------------- workers --

def online_worker(args):
    """The OnlineLoop trainer: streams the drill's CTR files through a
    ``StreamingSource`` (append-only provider over --data, cursor mode),
    updates a dense tree shaped like the serving artifact's weights plus a
    HostPS table (real pull/push through its optimizer), checkpoints the
    train state (dense + cursor + table) every --every steps and publishes
    through a ``DeltaPublisher`` (quarantine gate over the checkpoint dir)
    every --pub-every steps.  The dense update is a deterministic
    contraction of the batch stream: the drill holds protocol properties
    (bit-exact streaming resume, atomic publish, veto), not model quality."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.ft import chaos
    from paddle_tpu_torch.ft import ckpt as fckpt
    from paddle_tpu_torch.hostps import HostPSEmbedding, HostSGD
    from paddle_tpu_torch.inference import load_exported_model
    from paddle_tpu_torch.online import DeltaPublisher, StreamingSource

    attempt = int(os.environ.get("PADDLE_RESTART_ATTEMPT", "0"))
    mon = monitor.enable(os.path.join(args.out, "attempt-%d" % attempt))
    lr = 0.05
    if args.publish_kill_at and attempt == 0:
        # die INSIDE the Nth publish: after its shards and index, before
        # COMMIT — the torn-publish leg's corpse
        chaos.arm("publish_kill", at=args.publish_kill_at)

    ep = load_exported_model(args.model, device="cpu")
    dense = {n: v.detach().cpu().numpy().copy() for n, v in ep._state.items()}

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        idv = fluid.layers.data("feat_ids", shape=[FIELDS], dtype="int64")
        lbv = fluid.layers.data("label", shape=[1], dtype="float32")
    ds = fluid.DatasetFactory().create_dataset("QueueDataset")
    ds.set_batch_size(BATCH)
    ds.set_use_var([idv, lbv])

    def provider():
        return sorted(os.path.join(args.data, n)
                      for n in os.listdir(args.data)
                      if n.startswith("part-"))

    ds.set_filelist(provider())
    src = StreamingSource(ds, file_provider=provider, poll_secs=0.1,
                          idle_secs=args.idle_secs)
    emb = HostPSEmbedding(serve_table(optimizer=HostSGD()), cache_slots=32,
                          device=args.device)
    pub = DeltaPublisher(args.publish, hostps=[emb],
                         quarantine_dir=args.ckpt)

    step, skip = 0, None
    rs = fckpt.restore_train_state(args.ckpt, dict(dense), hostps=[emb])
    if rs is not None:
        dense = {k: np.asarray(v) for k, v in rs.scope_state.items()}
        step = rs.step
        skip = tuple(rs.cursor) if rs.cursor is not None else None
        mon.timeline.emit("resume", step=step, ckpt=rs.path)

    decay = np.float32(1.0 - 1e-3)
    for cur, feed in src._iter_batches(skip_to=skip, with_cursor=True):
        t0 = time.perf_counter()
        ids = np.asarray(feed["feat_ids"], np.int64).reshape(-1, FIELDS)
        label = np.asarray(feed["label"], np.float32).ravel()
        rows, values, _inv = emb.pull_unique(ids)
        values = values.detach().cpu().numpy()
        grad = (values * np.float32(0.01)
                + np.float32(0.001) * np.float32(label.mean()))
        emb.push(rows, grad[: rows.shape[0]], lr)
        bump = np.float32(1e-4 * (float(label.sum())
                                  + float(ids.sum() % 97) / 97.0))
        dense = {n: v * decay + bump for n, v in dense.items()}
        step += 1
        mon.record_step(step, (time.perf_counter() - t0) * 1e3,
                        batch=label.shape[0])
        if step % args.every == 0:
            # checkpoint BEFORE publish: a kill inside the publish resumes
            # exactly at this boundary
            fckpt.save_train_state(
                args.ckpt, step, scope_state=dict(dense), cursor=cur,
                hostps=[emb], asynchronous=False, keep=4).finish()
        if step % args.pub_every == 0:
            pub.publish(dense, step, cursor=cur, train_wall=time.time())

    probe = np.arange(VOCAB)
    np.savez(os.path.join(args.out, "final_params.npz"), **dense)
    np.savez(os.path.join(args.out, "final_table.npz"),
             table=emb.pull(probe, use_cache=False).detach().cpu().numpy())
    monitor.disable()
    return 0


def fleetps_worker(args):
    """The fleet drill's read-only CTR tier: ONE ShardPS owner serving the
    serve_ctr table's rows over its own wire until the drill drops the
    FLEET_DONE marker."""
    from ..hostps import HostSGD, ShardServer
    from ..parallel.rules import hostps_row_ranges

    table = serve_table(row_range=hostps_row_ranges(1, VOCAB)[0],
                        optimizer=HostSGD())
    srv = ShardServer(table, args.wire, 0, poll=0.01)
    srv.start()
    done = os.path.join(args.wire, "FLEET_DONE")
    while not os.path.exists(done):
        time.sleep(0.2)
    srv.stop()
    return 0


def arm_oom(device):
    """The oom plan: plant a NAMED ballast owner on ``device``, squeeze the
    configured device limit to just above it, and kill the 5th dispatch
    (startup + 4 train steps) with an injected RESOURCE_EXHAUSTED — the
    headroom predictor must warn before the dispatch that dies, and the
    postmortem must name the ballast."""
    import torch

    from ..ft import chaos
    from ..monitor import memscope

    global _OOM_BALLAST
    _OOM_BALLAST = [torch.ones((256, 256), dtype=torch.float32,
                               device=device) for _ in range(4)]
    memscope.register_owner("ballast", lambda: _OOM_BALLAST)
    memscope.configure(bytes_limit=sum(
        b.numel() * b.element_size() for b in _OOM_BALLAST) + 64)
    chaos.arm("oom_step", at=5)


# ---------------------------------------------------------------- fleet --

class AttemptLog:
    """Each request's attempts through a ``FleetRouter``, for the derived
    bound of a kill window (module docstring).  ``install()`` wraps the
    router's ``submit`` and ``_attempt`` on this instance: every request
    records its wall ms and its attempts' (status, ms); the longest
    successful attempt is S.  ``sleeper()`` is the loop that measures w,
    how late a ``sleep(poll)`` wakes on this host: run it beside the
    clients while ``stop`` is clear."""

    def __init__(self, router):
        self.router = router
        self.requests = []           # (wall ms, [(status, ms), ...])
        self.ok_attempt_ms = 0.0
        self.oversleep_ms = 0.0
        self._tl = threading.local()
        self._lock = threading.Lock()

    def install(self):
        submit0, attempt0 = self.router.submit, self.router._attempt

        def attempt(info, payload, expires):
            t0 = time.perf_counter()
            res = attempt0(info, payload, expires)
            ms = (time.perf_counter() - t0) * 1e3
            rec = getattr(self._tl, "attempts", None)
            if rec is not None:
                rec.append((res[0], ms))
            if res[0] == "ok":
                with self._lock:
                    self.ok_attempt_ms = max(self.ok_attempt_ms, ms)
            return res

        def submit(*a, **kw):
            self._tl.attempts = []
            t0 = time.perf_counter()
            try:
                return submit0(*a, **kw)
            finally:
                ms = (time.perf_counter() - t0) * 1e3
                with self._lock:
                    self.requests.append((ms, self._tl.attempts))
                self._tl.attempts = None

        self.router._attempt = attempt
        self.router.submit = submit
        return self

    def sleeper(self, stop):
        poll = self.router.wire.poll
        while not stop.is_set():
            t0 = time.perf_counter()
            time.sleep(poll)
            late = (time.perf_counter() - t0 - poll) * 1e3
            if late > self.oversleep_ms:
                self.oversleep_ms = late

    def rerouted(self, deadline_s):
        """``(records, per_fail_ms, S)``: one record per request with a
        failed attempt — wall ms, failed attempts k, its bound ``k x
        attempts x (deadline + poll + w) + S``, and the ms it added over
        its serving attempt."""
        poll_ms = self.router.wire.poll * 1e3
        per_fail = self.router.attempts * (deadline_s * 1e3 + poll_ms
                                           + self.oversleep_ms)
        sib = self.ok_attempt_ms
        out = []
        with self._lock:
            reqs = list(self.requests)
        for ms, attempts in reqs:
            failed = [a for a in attempts if a[0] != "ok"]
            if failed:
                last = attempts[-1][1] if attempts[-1][0] == "ok" else 0.0
                out.append({"ms": ms, "failed": len(failed),
                            "bound_ms": len(failed) * per_fail + sib,
                            "added_ms": ms - last})
        return out, per_fail, sib


def _merge_traces(dirs, out_path):
    from ..monitor import tracemesh as _tmesh

    procs = []
    for label, d in dirs:
        trace = os.path.join(d, "trace.json")
        if os.path.exists(trace):
            tl = os.path.join(d, "timeline.jsonl")
            procs.append({"label": label, "trace": trace,
                          "timeline": tl if os.path.exists(tl) else None})
    merged = _tmesh.merge_process_traces(procs)
    _tmesh.write_merged(merged, out_path)
    return merged


def run_fleet(args):
    """SIGKILL one of three serving replicas mid-trace: zero drops, every
    re-routed request within its derived bound, precise alerts, the merged
    trace; the full drill respawns and swaps (see the module docstring)."""
    from .. import monitor
    from ..hostps import wire as _w
    from ..inference import load_exported_model
    from ..monitor import tracemesh as _tmesh
    from ..monitor import watchtower as _wtm
    from ..serving import FleetManager, FleetRouter
    from ..serving.canary import CanaryProber
    from ..serving.fleet import autoscale_signal

    shape = FLEET_SMOKE if args.smoke else FLEET
    n_rep = shape["replicas"]
    work = args.workdir or tempfile.mkdtemp(prefix="fleet_drill_")
    os.makedirs(work, exist_ok=True)
    model = os.path.join(work, "model")
    fleet_wire = os.path.join(work, "fleet-wire")
    ps_wire = os.path.join(work, "ps-wire")
    mon_root = os.path.join(work, "monitor")
    router_mon = os.path.join(mon_root, "router")
    for d in (model, fleet_wire, mon_root, router_mon):
        os.makedirs(d, exist_ok=True)
    env = _env(args.device)

    _say("chaos_drill[fl]: building the serving artifact...")
    online_artifact(model, args.device)
    mon = monitor.enable(router_mon, tracing=True)

    feeds = ["x:12:float32", "emb:16:float32"]
    ctr = None
    ps_proc = None
    if not args.smoke:
        os.makedirs(ps_wire, exist_ok=True)
        ps_proc = subprocess.Popen(
            _drill_cmd("fleetps", wire=ps_wire, data=work, ckpt=work,
                       out=work, device="cpu"),
            env=_owner_env(env), cwd=REPO)
        ctr = {"wire_dir": ps_wire, "world": 1, "vocab": VOCAB,
               "dim": ONLINE_DIM, "ids": "ids", "out": "emb"}

    mgr = FleetManager(fleet_wire, model, mon_root, feeds, buckets="2,4,8",
                       workers=8, ctr=ctr, env=env, device=args.device)
    router = None
    victim = 1
    lat, errors = [], []
    stop = threading.Event()
    lock = threading.Lock()
    log = None
    wt_stop = None
    canary = None
    wt_thread = None

    def client(cid, rng):
        while not stop.is_set():
            r = int(rng.choice((2, 4)))
            feed = {"x": rng.rand(r, 12).astype("f4")}
            if ctr is not None:
                feed["ids"] = rng.randint(0, VOCAB, (r, FIELDS)).astype("i8")
            else:
                feed["emb"] = rng.rand(r, 16).astype("f4")
            t0 = time.perf_counter()
            try:
                router.submit(feed)
            except Exception as e:        # FleetGiveUp included: a DROP
                with lock:
                    errors.append(repr(e))
                return
            with lock:
                lat.append((time.perf_counter() - t0) * 1e3)

    def drive(seconds, mid_hook=None):
        stop.clear()
        threads = [threading.Thread(
            target=client, args=(c, np.random.RandomState(50 + c)),
            daemon=True) for c in range(shape["clients"])]
        threads.append(threading.Thread(target=log.sleeper, args=(stop,),
                                        daemon=True))
        for t in threads:
            t.start()
        time.sleep(seconds * 0.5)
        if mid_hook is not None:
            mid_hook()
        time.sleep(seconds * 0.5)
        stop.set()
        for t in threads:
            t.join(timeout=router.request_budget + 35)

    try:
        _say("chaos_drill[fl]: spawning %d replicas on %s (each captures "
             "its own lattice%s)" % (n_rep, args.device, "" if args.smoke
                                     else "; read-only ShardPS CTR"))
        for rid in range(n_rep):
            mgr.spawn(rid)
        mgr.wait_ready(range(n_rep), timeout=240)
        router = FleetRouter(fleet_wire, replicas=range(n_rep),
                             deadline=shape["deadline"], poll=0.004,
                             suspect_cooloff=shape["cooloff"],
                             registry=mon.registry)
        router.connect(timeout=60)
        log = AttemptLog(router).install()

        # -- the live-alerting layer: Watchtower + canary ---------------------
        dl_ms = shape["deadline"] * 1000.0
        wt_rules = [
            {"name": "replica_dead", "kind": "absence",
             "metric": "paddle_tpu_serve_version",
             "stale_s": 2.5, "source": "replica-*"},
            {"name": "p99_burn", "kind": "burn_rate",
             "metric": "fleet.request_slo_ms",
             "op": ">", "value": dl_ms * 0.8, "objective": 0.999,
             "short_s": 1.2, "long_s": 6.0, "factor": 1.0,
             "source": "router"},
            {"name": "canary_fail", "kind": "threshold",
             "metric": "paddle_tpu_canary_ok", "op": "<", "value": 1.0,
             "source": "router"},
        ]

        def _straggler():
            try:
                snap_now = router.snapshot()
            except Exception:
                return None
            sus = [r for r, s in snap_now.items() if s.get("suspect")]
            rid = sus[0] if sus else None
            if rid is None:
                rr = {r: s.get("rerouted_away", 0)
                      for r, s in snap_now.items()}
                if rr and max(rr.values()) > 0:
                    rid = max(rr, key=rr.get)
            if rid is None:
                return None
            return {"rank": rid, "phase": "serve",
                    "rerouted_away": snap_now[rid].get("rerouted_away", 0)}

        wt = _wtm.Watchtower(wt_rules, out_dir=router_mon,
                             timeline=mon.timeline,
                             straggler_provider=_straggler, dedup_s=5.0)
        wt.add_prom_source("router",
                           os.path.join(router_mon, "metrics.prom"))
        for rid in range(n_rep):
            wt.add_prom_source("replica-%d" % rid,
                               os.path.join(mgr.mon_dir(rid), "metrics.prom"))
        wt.add_timeline_source("router",
                               os.path.join(router_mon, "timeline.jsonl"))

        # the canary's known answer, computed here against the artifact
        ref = load_exported_model(model, device=args.device)
        crng = np.random.RandomState(7)
        cx = crng.rand(4, 12).astype("f4")
        if ctr is not None:
            cids = crng.randint(0, VOCAB, (4, FIELDS)).astype("i8")
            cemb = np.asarray(serve_table().pull(cids, materialize=False),
                              "f4").reshape(4, -1)
            cfeed = {"x": cx, "ids": cids}
        else:
            cemb = crng.rand(4, 16).astype("f4")
            cfeed = {"x": cx, "emb": cemb}
        (cwant,) = ref.run({"x": cx, "emb": cemb})
        canary = CanaryProber(router, [(cfeed, cwant)], interval_s=0.5,
                              timeline=mon.timeline, mon_root=mon_root)

        wt_lock = threading.Lock()
        wt_stop = threading.Event()
        wt_fired = []

        def _wt_poll_loop():
            seen = 0
            while not wt_stop.is_set():
                try:
                    router.publish_gauges()
                except Exception:
                    pass
                mon.timeline.flush()
                mon.export_prometheus()
                n_lat = len(lat)
                with wt_lock:
                    for v in lat[seen:n_lat]:
                        wt.observe("router", "fleet.request_slo_ms", v)
                    wt_fired.extend(wt.poll())
                seen = n_lat
                wt_stop.wait(0.25)

        canary.start()
        wt_thread = threading.Thread(target=_wt_poll_loop, name="wt-poll",
                                     daemon=True)
        wt_thread.start()
        _say("chaos_drill[fl]: watchtower armed (%d rules over %d "
             "expositions) + canary probing every %.1fs"
             % (len(wt_rules), n_rep + 1, canary.interval_s))

        def _alerts_now():
            with wt_lock:
                return {(a["rule"], a["source"]): dict(a)
                        for a in wt.alerts()}

        def _wait_alerts(pred, timeout_s):
            deadline_w = time.monotonic() + timeout_s
            while True:
                cur = _alerts_now()
                if pred(cur):
                    return cur
                if time.monotonic() >= deadline_w:
                    return None
                time.sleep(0.2)

        # -- leg 1: drive; SIGKILL the victim mid-trace -------------------
        n_before = [0]

        def _kill():
            n_before[0] = len(lat)
            mgr.kill(victim)
            _say("chaos_drill[fl]: replica %d SIGKILLed mid-trace (%d "
                 "requests already served)" % (victim, n_before[0]))

        _say("chaos_drill[fl]: driving %d closed-loop clients for %.1fs, "
             "kill at the midpoint..." % (shape["clients"],
                                          shape["drive_secs"]))
        drive(shape["drive_secs"], mid_hook=_kill)

        if errors:
            return _fail("dropped requests after the kill (%d): %s"
                         % (len(errors), errors[:3]))
        post_kill = len(lat) - n_before[0]
        if post_kill < shape["clients"]:
            return _fail("the post-kill window served only %d requests — "
                         "the drive never really ran through the death"
                         % post_kill)
        snap = router.publish_gauges()
        rerouted, per_fail, sib = log.rerouted(shape["deadline"])
        if snap[victim]["rerouted_away"] < 1 or not rerouted:
            return _fail("the router never re-routed away from the killed "
                         "replica (snapshot %r)" % snap[victim])
        kill_p99 = float(np.percentile(np.asarray(lat), 99))
        _say("chaos_drill[fl]: zero drops OK — %d served (%d after the "
             "kill), %d re-routed away from replica %d, p99 %.1fms"
             % (len(lat), post_kill, snap[victim]["rerouted_away"], victim,
                kill_p99))
        # each re-routed request against its derived bound
        poll_ms = router.wire.poll * 1e3
        late = log.oversleep_ms
        worst = 0.0
        for r in rerouted:
            worst = max(worst, r["ms"] / r["bound_ms"])
            if r["ms"] > r["bound_ms"]:
                return _fail("a re-routed request took %.1fms, past its "
                             "bound %.1fms (%d failed attempt(s) x %.1fms "
                             "+ the longest sibling service %.1fms)"
                             % (r["ms"], r["bound_ms"], r["failed"],
                                per_fail, sib))
        added = sorted(r["added_ms"] for r in rerouted)
        _say("chaos_drill[fl]: kill-window bound OK — %d re-routed "
             "request(s), added ms %s, each within k x %d x (%.0f + %.0f + "
             "%.1f oversleep) ms + %.1fms (the longest sibling service "
             "measured); worst %.2f of its bound; p99 %.1fms"
             % (len(rerouted), [round(a, 1) for a in added[-5:]],
                router.attempts, shape["deadline"] * 1e3, poll_ms, late,
                sib, worst, kill_p99))

        # -- leg 1b: the kill is ALERTED, precisely -----------------------
        vic_src = "replica-%d" % victim
        if _wait_alerts(lambda a: a.get(("replica_dead", vic_src),
                                        {}).get("state") == "firing",
                        20.0) is None:
            return _fail("replica_dead never fired on the killed replica's "
                         "frozen exposition: %r" % sorted(_alerts_now()))
        with wt_lock:
            fired_rules = {a["rule"] for st, a in wt_fired
                           if st == "firing"}
            dead_srcs = {a["source"] for st, a in wt_fired
                         if st == "firing" and a["rule"] == "replica_dead"}
        allowed = {"replica_dead", "p99_burn"}
        precise = (fired_rules <= allowed and "replica_dead" in fired_rules
                   if args.smoke else fired_rules == allowed)
        if not precise:
            return _fail("alert precision broken: fired %s, wanted %s"
                         % (sorted(fired_rules), sorted(allowed)))
        if dead_srcs != {vic_src}:
            return _fail("replica_dead fired on %s, expected exactly %s"
                         % (sorted(dead_srcs), [vic_src]))
        _say("chaos_drill[fl]: alert precision OK — fired %s on %s only, "
             "canary stayed green through the kill"
             % (sorted(fired_rules), vic_src))

        # -- the incident ledger carries the causal evidence --------------
        inc_path = os.path.join(router_mon, _wtm.Watchtower.INCIDENTS_FILE)
        with open(inc_path) as f:
            recs = [json.loads(line) for line in f if line.strip()]
        dead_inc = [r for r in recs if r.get("rec") == "incident"
                    and r.get("rule") == "replica_dead"]
        if not dead_inc:
            return _fail("incidents.jsonl has no replica_dead incident")
        inc, ev = dead_inc[-1], dead_inc[-1].get("evidence", {})
        if not ev.get("canary_trace_id"):
            return _fail("incident %s lacks the canary trace-id evidence: "
                         "%r" % (inc["id"], ev))
        strag = ev.get("straggler") or {}
        if strag.get("rank") != victim:
            return _fail("incident %s straggler attribution %r does not "
                         "name replica %d" % (inc["id"], strag, victim))
        _say("chaos_drill[fl]: incident ledger OK — %s links canary trace "
             "%s + straggler replica %s (%d re-routes)"
             % (inc["id"], ev["canary_trace_id"], strag["rank"],
                strag.get("rerouted_away", 0)))

        # -- the autoscale signal cites the incident ----------------------
        cited = why = None
        for _ in range(20):
            _d, why, _ml = autoscale_signal(
                router.snapshot(),
                alerts=lambda: [a for a in _alerts_now().values()
                                if a["state"] == "firing"])
            if why.startswith("replacing_suspects:inc-"):
                cited = why.split(":", 1)[1]
                break
            time.sleep(0.3)
        if cited is None:
            return _fail("autoscale_signal never cited a firing incident "
                         "(last reason %r)" % why)
        _say("chaos_drill[fl]: autoscale citation OK — %s" % why)

        # -- leg 2 (full): respawn -> new generation -> router adopts -----
        respawned = False
        if shape["drive2_secs"] > 0:
            rp = _w.ready_path(fleet_wire, victim)
            with open(rp) as f:
                old_pid = f.read()
            mgr.spawn(victim)
            deadline = time.monotonic() + 240
            while True:
                try:
                    with open(rp) as f:
                        if f.read() not in ("", old_pid):
                            break
                except OSError:
                    pass
                if time.monotonic() >= deadline:
                    return _fail("respawned replica %d never re-marked "
                                 "READY" % victim)
                time.sleep(0.2)
            served0 = router.snapshot()[victim]["served"]
            _say("chaos_drill[fl]: replica %d respawned on the same wire "
                 "inbox; driving %.1fs over the adoption..."
                 % (victim, shape["drive2_secs"]))
            drive(shape["drive2_secs"])
            if errors:
                return _fail("dropped requests across the respawn "
                             "adoption: %s" % errors[:3])
            snap2 = router.snapshot()
            if snap2[victim]["served"] <= served0:
                return _fail("the respawned replica never served again "
                             "(snapshot %r)" % snap2[victim])
            restarts = [e for e in _read_events(
                os.path.join(router_mon, "timeline.jsonl"))
                if e.get("ev") == "fleet_replica_restart"
                and e.get("replica") == victim]
            if not restarts:
                return _fail("no fleet_replica_restart event — the new "
                             "generation was never adopted")
            respawned = True
            _say("chaos_drill[fl]: generation adoption OK — replica %d "
                 "served %d more requests after its restart was detected "
                 "%d time(s)" % (victim, snap2[victim]["served"] - served0,
                                 len(restarts)))

            if _wait_alerts(
                    lambda a: a.get(("replica_dead", vic_src),
                                    {}).get("state") == "resolved"
                    and a.get(("p99_burn", "router"),
                              {}).get("state") in (None, "resolved"),
                    15.0) is None:
                return _fail("alerts did not resolve after the respawn: %r"
                             % sorted(_alerts_now().items()))
            with open(inc_path) as f:
                recs2 = [json.loads(line) for line in f if line.strip()]
            if not [r for r in recs2 if r.get("rec") == "resolve"
                    and r.get("id") == inc["id"]]:
                return _fail("the ledger never recorded %s resolving"
                             % inc["id"])
            _say("chaos_drill[fl]: alert resolve OK — the respawned "
                 "exposition cleared replica_dead (%s resolved in the "
                 "ledger), p99 burn cooled" % inc["id"])

            # -- leg 3 (full): a wrong-weights publish is CAUGHT ----------
            with np.load(os.path.join(model, "__params__.npz")) as data:
                bad_state = {n: data[n] for n in data.files}
            for pname, arr in bad_state.items():
                if np.issubdtype(arr.dtype, np.floating):
                    bad_state[pname] = arr + np.float32(0.25)
            bad_path = os.path.join(work, "bad_params.npz")
            np.savez(bad_path, **bad_state)
            router.rolling_swap(2, bad_path, deadline=60.0)
            flip = canary.probe_once()
            if flip["ok"]:
                return _fail("canary still green after the wrong-weights "
                             "swap: %r" % flip)
            if _wait_alerts(lambda a: a.get(("canary_fail", "router"),
                                            {}).get("state") == "firing",
                            10.0) is None:
                return _fail("canary_fail never fired on the wrong-weights "
                             "swap")
            _say("chaos_drill[fl]: canary detection OK — wrong weights "
                 "flipped canary.ok in one probe (%s; trace %s), "
                 "canary_fail firing" % (flip.get("error"),
                                         flip["trace_id"]))
            router.rolling_swap(3, os.path.join(model, "__params__.npz"),
                                deadline=60.0)
            canary.probe_once()
            if _wait_alerts(lambda a: a.get(("canary_fail", "router"),
                                            {}).get("state") == "resolved",
                            10.0) is None:
                return _fail("canary_fail did not resolve after swapping "
                             "the good weights back")
            _say("chaos_drill[fl]: canary rollback OK — good weights "
                 "restored, canary_fail resolved")

        # -- stop the alerting layer before the fleet retires -------------
        wt_stop.set()
        canary.stop()
        wt_thread.join(timeout=10)
        wt_alert_count = len([1 for st, _a in wt_fired if st == "firing"])

        # -- graceful teardown: retire what is still alive ----------------
        if not respawned:
            router.drop_replica(victim)
        retired = {}
        for rid in router.replica_ids():
            retired[rid] = router.retire(rid)
        want = set(range(n_rep)) - (set() if respawned else {victim})
        if sorted(retired) != sorted(want):
            return _fail("retire set mismatch: %r" % sorted(retired))
        for rid in retired:
            rc = mgr.wait(rid, timeout=60)
            if rc != 0:
                return _fail("retired replica %d exited rc=%s" % (rid, rc))
        monitor.disable()

        # -- the re-route is VISIBLE --------------------------------------
        tl_ev = _read_events(os.path.join(router_mon, "timeline.jsonl"))
        if not [e for e in tl_ev if e.get("ev") == "fleet_reroute"
                and e.get("replica") == victim]:
            return _fail("router timeline lacks the fleet_reroute event")
        merged_path = os.path.join(work, "merged_trace.json")
        merged = _merge_traces(
            [("router", router_mon)]
            + [("replica-%d" % r, mgr.mon_dir(r)) for r in range(n_rep)],
            merged_path)
        procs = merged["otherData"]["processes"]
        if len(procs) < n_rep:        # router + the surviving replicas
            return _fail("merged trace covers %d processes, wanted >= %d: "
                         "%r" % (len(procs), n_rep, sorted(procs)))
        if merged["otherData"]["flow_events"] < 1:
            return _fail("merged trace has no cross-process flow arrows — "
                         "dispatch->serve never linked")
        if not [e for e in merged["traceEvents"]
                if e.get("name") == "fleet.reroute"]:
            return _fail("the fleet.reroute instant is missing from the "
                         "merged trace")
        chain = _tmesh.find_chain(
            merged, ["hostps.wire.request", "hostps.wire.serve"])
        if chain is None:
            return _fail("no request->serve span chain in the merged trace")
        if len({s["pid"] for s in chain["spans"]}) < 2:
            return _fail("the request->serve chain stayed inside one "
                         "process: %r" % chain)
        _say("chaos_drill[fl]: merged trace OK — %d processes, %d flow "
             "arrows, fleet.reroute instant + request->serve chain across "
             "pids (%s)" % (len(procs), merged["otherData"]["flow_events"],
                            merged_path))

        rec = {"metric": "fleet_kill", "fleet": True, "unit": "ms",
               "platform": args.device, "replicas": n_rep,
               "completed": len(lat), "dropped": len(errors),
               "rerouted": int(snap[victim]["rerouted_away"]),
               "rerouted_requests": len(rerouted),
               "rerouted_worst_of_bound": round(worst, 4),
               "kill_p99_ms": round(kill_p99, 3),
               "kill_p50_ms": round(float(np.percentile(
                   np.asarray(lat), 50)), 3),
               "respawn_adopted": bool(respawned),
               "alerts_fired": wt_alert_count,
               "alert_rules": sorted(fired_rules),
               "incidents": len(dead_inc),
               "canary_probes": canary.probes_sent,
               "canary_failures": canary.failures}
        _say(json.dumps(rec))
        print("chaos_drill[fl]: PASS")
        return 0
    finally:
        stop.set()
        if wt_stop is not None:
            wt_stop.set()
        if canary is not None:
            try:
                canary.stop()
            except Exception:
                pass
        if wt_thread is not None:
            wt_thread.join(timeout=10)
        try:
            mgr.stop_all(timeout=20)
        except Exception:
            pass
        if ps_proc is not None:
            try:
                with open(os.path.join(ps_wire, "FLEET_DONE"), "w"):
                    pass
                ps_proc.wait(timeout=10)
            except Exception:
                ps_proc.kill()
        try:
            monitor.disable()
        except Exception:
            pass
        if not args.keep and args.workdir is None:
            shutil.rmtree(work, ignore_errors=True)


# --------------------------------------------------------------- online --

def run_online(args):
    """Streaming train -> serve with delta publish, zero-drop hot-swap and
    quarantine-gated rollback, over ONE live ServeEngine in this process
    (legs A-D of the module docstring)."""
    from .. import monitor
    from .. import online as _online
    from ..hostps import HostPSEmbedding
    from ..inference import load_exported_model
    from ..monitor import tracemesh as _tmesh
    from ..online import VersionSwapper
    from ..parallel.checkpoint import save_checkpoint
    from ..serving import BucketLattice, CTRLookup, ServeEngine

    shape = ONLINE_SMOKE if args.smoke else ONLINE
    pub_every = shape["pub_every"]
    quarantine_step = pub_every + 1          # vetoes publish 2*pub_every
    work = args.workdir or tempfile.mkdtemp(prefix="online_drill_")
    os.makedirs(work, exist_ok=True)
    dirs = {}
    for leg in ("a", "b", "ref"):
        for kind in ("data", "ckpt", "pub", "out"):
            d = os.path.join(work, "%s-%s" % (kind, leg))
            os.makedirs(d, exist_ok=True)
            dirs[kind + leg] = d
    model = os.path.join(work, "model")
    os.makedirs(model, exist_ok=True)
    env = _env(args.device)

    def worker_cmd(leg, kill_at=None):
        kw = dict(data=dirs["data" + leg], ckpt=dirs["ckpt" + leg],
                  out=dirs["out" + leg], model=model,
                  publish=dirs["pub" + leg], every=pub_every,
                  pub_every=pub_every, idle_secs=shape["idle"],
                  device=args.device)
        if kill_at is not None:
            kw["publish_kill_at"] = kill_at
        return _drill_cmd("online", **kw)

    online_artifact(model, args.device)

    # leg A's quarantine, planted BEFORE the trainer starts: a committed
    # sentinel artifact at a step inside the second publish interval
    save_checkpoint(dirs["ckpta"], {"note": np.zeros(1, np.float32)},
                    step=quarantine_step, tag="quarantine")

    serve_mon = os.path.join(work, "serve-monitor")
    serve_mon_a = os.path.join(work, "serve-monitor-leg-a")
    smon = monitor.enable(serve_mon, tracing=True)
    ep = load_exported_model(model, device=args.device)
    semb = HostPSEmbedding(serve_table(), cache_slots=64, read_only=True,
                           device=args.device)
    eng = ServeEngine(
        ep, BucketLattice([2, 4, 8]),
        feed_spec={"x": ((12,), "float32"), "emb": ((16,), "float32")},
        lookups=[CTRLookup(semb, "ids", out_name="emb")],
        mode="continuous", queue_capacity=4096, name="serve_online")
    eng.start()
    swapper = VersionSwapper(eng, ep, dirs["puba"], hostps=[semb])

    rng = np.random.RandomState(3)
    state = {"submitted": 0, "completed": 0}
    polls = []                       # (start, end) of every swapper poll

    def burst(n=3):
        reqs = []
        for r in (1, 3, 5)[:n]:
            reqs.append(eng.submit({
                "x": rng.rand(r, 12).astype("f4"),
                "ids": rng.randint(0, VOCAB, size=(r, FIELDS)
                                   ).astype("i8")}))
        state["submitted"] += len(reqs)
        return reqs

    def drain(reqs):
        for q in reqs:
            q.result(timeout=120)
        state["completed"] += len(reqs)

    def poll(sw):
        t0 = time.time()
        ev = sw.poll()
        polls.append((t0, time.time()))
        return ev

    probe_feed = {"x": np.ones((2, 12), "f4") * 0.5,
                  "ids": np.arange(2 * FIELDS).reshape(2, FIELDS
                                                       ).astype("i8")}

    def probe():
        q = eng.submit(dict(probe_feed))
        state["submitted"] += 1
        out = q.result(timeout=120)
        state["completed"] += 1
        return np.asarray(out[0] if isinstance(out, (tuple, list)) else out)

    proc = ref_proc = None
    try:
        # -- leg A: streaming + live flips + quarantine veto --------------
        online_data_file(dirs["dataa"], 0, shape["rows"])
        wlog = open(os.path.join(work, "worker-a.log"), "w")
        proc = subprocess.Popen(worker_cmd("a"), env=env, cwd=REPO,
                                stdout=wlog, stderr=subprocess.STDOUT,
                                text=True)
        probe_before = probe()
        flips = []
        next_file = 1
        deadline = time.time() + 300
        while proc.poll() is None:
            if time.time() > deadline:
                proc.kill()
                return _fail("online leg A: trainer stalled (flips so "
                             "far: %d; see %s)" % (len(flips), wlog.name))
            pend = burst()
            ev = poll(swapper)      # flips at a step boundary; in-flight
            if ev is not None:      # requests complete on the old weights
                flips.append(ev)
            drain(pend)
            if next_file < shape["n_files"] and len(flips) >= next_file:
                # new data lands only after the previous version FLIPPED:
                # every committed version is observed under live load
                online_data_file(dirs["dataa"], next_file, shape["rows"])
                next_file += 1
            time.sleep(0.05)
        trainer_exit = time.time()
        wlog.close()
        if proc.returncode != 0:
            return _fail("online leg A: trainer rc=%s (%s)"
                         % (proc.returncode, wlog.name))
        for _ in range(3):            # catch the final publish
            ev = poll(swapper)
            if ev is None:
                break
            flips.append(ev)
        probe_after = probe()

        delta_flips = sum(1 for e in flips if e.get("kind") == "delta")
        if len(flips) < 3 or delta_flips < 2:
            return _fail("online leg A: %d flips (%d delta), wanted >=3 "
                         "with >=2 deltas: %r"
                         % (len(flips), delta_flips, flips))
        for e in flips:
            pv = e.get("preverified") or {}
            if pv.get("compiled") or pv.get("error"):
                return _fail("online leg A: a flip's pre-verify captured "
                             "a graph: %r" % e)
        if np.array_equal(probe_before, probe_after):
            return _fail("online leg A: serving output identical before "
                         "and after %d flips — the swap installed nothing"
                         % len(flips))

        pubs = _online.committed_publishes(dirs["puba"])
        pub_steps = [m["train_step"] for _v, _p, m in pubs]
        if 2 * pub_every in pub_steps:
            return _fail("online leg A: the quarantined interval's publish "
                         "(step %d) reached the chain: %r"
                         % (2 * pub_every, pub_steps))
        mon_a = os.path.join(dirs["outa"], "attempt-0")
        vetoes = _prom_value(os.path.join(mon_a, "metrics.prom"),
                             "online_publish_vetoed")
        veto_evs = [e for e in _read_events(
            os.path.join(mon_a, "timeline.jsonl"))
            if e.get("ev") == "publish_veto"]
        if not vetoes or not veto_evs:
            return _fail("online leg A: no quarantine-veto evidence "
                         "(counter %r, %d events)" % (vetoes, len(veto_evs)))
        _say("chaos_drill[ol]: quarantine veto OK (planted step %d; "
             "interval step %d never committed; vetoes=%d; chain steps %r)"
             % (quarantine_step, 2 * pub_every, int(vetoes), pub_steps))

        # the derived flip bounds over leg A: P, the longest span from one
        # poll's start to the next poll's end; I(v), v's publish interval
        # (its train_wall to the next version's, or to the trainer's exit)
        period = max((b[1] - a[0] for a, b in zip(polls, polls[1:])),
                     default=0.0)
        walls = {v: float(m["train_wall"]) for v, _p, m in pubs}
        order = sorted(walls)
        interval = {v: ((walls[order[i + 1]] if i + 1 < len(order)
                         else trainer_exit) - walls[v])
                    for i, v in enumerate(order)}
        for e in flips:
            v = e["version"]
            if e["stall_ms"] > period * 1e3:
                return _fail("online leg A: flip to v%d stalled %.1fms, "
                             "past one poll period %.1fms"
                             % (v, e["stall_ms"], period * 1e3))
            lag = e.get("freshness_lag_s")
            if lag is not None and lag > interval[v] + period:
                return _fail("online leg A: v%d's freshness lag %.3fs is "
                             "past its publish interval %.3fs + one poll "
                             "period %.3fs" % (v, lag, interval[v], period))
        _say("chaos_drill[ol]: flip bounds OK (every stall within one poll "
             "period %.1fms; every freshness lag within its publish "
             "interval + that period, worst interval %.3fs)"
             % (period * 1e3, max(interval.values())))
        # the serve timeline as leg A left it, for the ops gate below
        smon.timeline.flush()
        os.makedirs(serve_mon_a, exist_ok=True)
        shutil.copy(os.path.join(serve_mon, "timeline.jsonl"), serve_mon_a)

        # -- leg B: SIGKILL mid-publish, corpse GC, cursor resume ---------
        for fi in range(shape["n_files"]):
            online_data_file(dirs["datab"], fi, shape["rows"])
            online_data_file(dirs["dataref"], fi, shape["rows"])
        ref_log = open(os.path.join(work, "worker-ref.log"), "w")
        ref_proc = subprocess.Popen(worker_cmd("ref"), env=env, cwd=REPO,
                                    stdout=ref_log,
                                    stderr=subprocess.STDOUT, text=True)
        res = subprocess.run(worker_cmd("b", kill_at=2), env=env, cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        if res.returncode != -9:
            return _fail("online leg B: expected SIGKILL inside publish 2 "
                         "(rc -9), got rc=%s\n%s"
                         % (res.returncode, (res.stderr or "")[-2000:]))
        corpse = os.path.join(dirs["pubb"], "publish-2")
        if not os.path.isdir(corpse) \
                or os.path.exists(os.path.join(corpse, "COMMIT")):
            return _fail("online leg B: no torn publish-2 corpse")
        if _online.latest_version(dirs["pubb"]) != 1:
            return _fail("online leg B: latest committed version %r, "
                         "wanted 1 — a torn publish became visible"
                         % _online.latest_version(dirs["pubb"]))
        swapper_b = VersionSwapper(eng, ep, dirs["pubb"], hostps=[semb])
        ev1 = swapper_b.poll()
        if ev1 is None or ev1["version"] != 1:
            return _fail("online leg B: serving could not settle on the "
                         "last good version: %r" % ev1)
        drain(burst())
        env_b1 = dict(env, PADDLE_RESTART_ATTEMPT="1")
        res = subprocess.run(worker_cmd("b"), env=env_b1, cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            return _fail("online leg B: restart rc=%s\n%s"
                         % (res.returncode, (res.stderr or "")[-2000:]))
        resumes = [e for e in _read_events(os.path.join(
            dirs["outb"], "attempt-1", "timeline.jsonl"))
            if e.get("ev") == "resume"]
        if not resumes or resumes[0].get("step") != 2 * pub_every:
            return _fail("online leg B: restart did not resume from the "
                         "committed cursor at step %d: %r"
                         % (2 * pub_every, resumes))
        if os.path.isdir(corpse) \
                and not os.path.exists(os.path.join(corpse, "COMMIT")):
            return _fail("online leg B: the publish-2 corpse survived the "
                         "restart's GC")
        chain = _online.resolve_chain(dirs["pubb"])
        kinds = [m["kind"] for _v, _p, m in chain]
        if chain[0][0] != 2 or kinds[0] != "base":
            return _fail("online leg B: restart did not re-anchor with base "
                         "publish-2 (chain %r)"
                         % [(v, k) for (v, _p, _m), k in zip(chain, kinds)])
        ev2 = swapper_b.poll()
        if ev2 is None or ev2["version"] < 2:
            return _fail("online leg B: swapper did not pick up the "
                         "re-anchored chain: %r" % ev2)
        drain(burst())
        _say("chaos_drill[ol]: torn publish OK (SIGKILL mid-publish left "
             "v1 serving; corpse GC'd; resumed at step %d; re-anchored "
             "base v2 -> flipped to v%d)" % (2 * pub_every, ev2["version"]))

        # -- leg C: rollback through the same flip path -------------------
        pend = burst()
        rb = swapper_b.rollback()
        drain(pend)
        if rb is None or not rb.get("rollback") or rb["version"] != 1:
            return _fail("online leg C: rollback event %r, wanted a "
                         "version-1 re-apply" % rb)
        drain(burst())
        _say("chaos_drill[ol]: rollback OK (v%d -> v1 under load, stall "
             "%.2fms)" % (ev2["version"], rb["stall_ms"]))

        # -- leg D: exact-batch streaming resume bit-parity ---------------
        try:
            ref_rc = ref_proc.wait(timeout=300)
        finally:
            ref_log.close()
        if ref_rc != 0:
            return _fail("online leg D: reference rc=%s (%s)"
                         % (ref_rc, ref_log.name))
        for fname in ("final_params.npz", "final_table.npz"):
            got = np.load(os.path.join(dirs["outb"], fname))
            want = np.load(os.path.join(dirs["outref"], fname))
            if sorted(got.files) != sorted(want.files):
                return _fail("online leg D: %s key mismatch" % fname)
            for k in got.files:
                if not np.array_equal(got[k], want[k]):
                    return _fail("online leg D: %s[%s] differs — the "
                                 "killed+resumed stream diverged from the "
                                 "uninterrupted one" % (fname, k))
        _say("chaos_drill[ol]: streaming resume bit-parity OK "
             "(killed+resumed finals == uninterrupted reference)")

        # -- the zero-drop receipts ---------------------------------------
        summary = eng.stop()
        monitor.disable()
        if summary["completed"] != state["submitted"] \
                or state["completed"] != state["submitted"]:
            return _fail("online: dropped requests — submitted %d, engine "
                         "completed %d, futures resolved %d"
                         % (state["submitted"], summary["completed"],
                            state["completed"]))
        if summary["recompiles"] or summary.get("new_compiled_sigs"):
            return _fail("online: steady state captured a graph "
                         "(recompiles=%s new_sigs=%s)"
                         % (summary["recompiles"],
                            summary.get("new_compiled_sigs")))
        all_flips = flips + [ev1, ev2, rb]
        stall_max = max(e["stall_ms"] for e in all_flips)
        _say("chaos_drill[ol]: zero-drop flips OK (%d flips, %d delta, "
             "%d/%d requests completed, 0 recompiles, max stall %.2fms)"
             % (len(all_flips), delta_flips, summary["completed"],
                state["submitted"], stall_max))

        # -- ops surface: the trace_summary online gates, at the bounds ---
        ts_py = os.path.join(REPO, "scripts", "trace_summary.py")
        stall_gate = "%.3f" % (period * 1e3)
        lag_gate = "%.3f" % (max(interval.values()) + period)
        ts = subprocess.run(
            [sys.executable, ts_py, "--timeline", serve_mon_a, "--check",
             "--max-flip-stall-ms", stall_gate,
             "--max-freshness-lag-secs", lag_gate],
            env=env, capture_output=True, text=True, timeout=120)
        if ts.returncode != 0 \
                or "trace_summary --check: online" not in ts.stdout:
            return _fail("online: trace_summary flip gates did not pass "
                         "with evidence row:\n%s\n%s"
                         % (ts.stdout[-2000:], ts.stderr[-2000:]))
        ts_bad = subprocess.run(
            [sys.executable, ts_py, "--timeline", mon_a, "--check",
             "--max-flip-stall-ms", stall_gate],
            env=env, capture_output=True, text=True, timeout=120)
        if ts_bad.returncode == 0 or "flip" not in ts_bad.stderr:
            return _fail("online: a FLIPLESS timeline passed the flip-stall "
                         "gate — missing measurement must FAIL (rc=%s)\n%s"
                         % (ts_bad.returncode, ts_bad.stderr[-2000:]))
        _say("chaos_drill[ol]: trace_summary gate OK (stall %sms + "
             "freshness %ss derived budgets pass on leg A's serve "
             "timeline; flipless timeline FAILS; legs B-C lags %s s "
             "reported)" % (stall_gate, lag_gate,
                            [e.get("freshness_lag_s")
                             for e in (ev1, ev2, rb)]))

        # -- TraceMesh: publish->verify->flip is ONE connected trace ------
        merged_path = os.path.join(work, "merged_trace.json")
        merged = _merge_traces(
            [("serve", serve_mon), ("trainer-a", mon_a),
             ("trainer-b1", os.path.join(dirs["outb"], "attempt-1"))],
            merged_path)
        if merged["otherData"]["flow_events"] < 1:
            return _fail("online: merged trace has no cross-process flow "
                         "events — the manifest trace context never linked "
                         "trainer to serving")
        chain_tm = _tmesh.find_chain(
            merged, ["online.publish", "online.swap.verify",
                     "online.swap.flip"])
        if chain_tm is None:
            return _fail("online: publish->verify->flip did not appear as "
                         "one connected trace in %s" % merged_path)
        chain_pids = sorted({s["pid"] for s in chain_tm["spans"]})
        if len(chain_pids) < 2:
            return _fail("online: the publish->verify->flip chain stayed "
                         "inside one process: %r" % chain_tm)
        _say("chaos_drill[ol]: TraceMesh chain OK (trace %s: publish->"
             "verify->flip connected across pids %s; %d cross-process flow "
             "arrows in %s)" % (chain_tm["trace_id"][:16], chain_pids,
                                merged["otherData"]["flow_events"],
                                merged_path))

        lag_flips = [e for e in flips
                     if e.get("freshness_lag_s") is not None]
        rec = {"metric": "online_continuous", "online": True, "unit": "ms",
               "platform": args.device,
               "flips": len(all_flips), "delta_flips": delta_flips,
               "publishes": len(pubs), "publish_vetoes": int(vetoes),
               "flip_stall_ms": round(stall_max, 3),
               "flip_stall_bound_ms": float(stall_gate),
               "freshness_lag_s": round(
                   max(e["freshness_lag_s"] for e in lag_flips), 3)
               if lag_flips else None,
               "freshness_lag_bound_s": float(lag_gate),
               "qps": summary["qps"], "p50_ms": summary["p50_ms"],
               "p99_ms": summary["p99_ms"],
               "completed": summary["completed"],
               "recompiles": summary["recompiles"]}
        _say(json.dumps(rec))
        print("chaos_drill[ol]: PASS")
        return 0
    finally:
        for p in (proc, ref_proc):
            if p is not None and p.poll() is None:
                p.kill()
        try:
            eng.stop()
        except Exception:
            pass
        try:
            monitor.disable()
        except Exception:
            pass
        if not args.keep and args.workdir is None:
            shutil.rmtree(work, ignore_errors=True)


# ------------------------------------------------------------------ oom --

def run_oom(args):
    """The MemScope induced-OOM drill: the ``oom`` plan's worker must die
    of the injected RESOURCE_EXHAUSTED, leaving exactly one postmortem that
    names the planted ballast and the failing plan's ledger, with the
    headroom predictor's warning before it on the timeline and the
    PREDICTED OOM row in ``trace_summary``."""
    work = args.workdir or tempfile.mkdtemp(prefix="oom_drill_")
    os.makedirs(work, exist_ok=True)
    data = os.path.join(work, "data")
    os.makedirs(data, exist_ok=True)
    _write_files(data, n_files=2, rows=48)
    out = os.path.join(work, "out")
    ck = os.path.join(work, "ckpt")
    env = _env(args.device, trace=False)
    res = subprocess.run(
        _drill_cmd("oom", data=data, ckpt=ck, out=out, every=1000,
                   device=args.device),
        env=env, cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT_S)
    try:
        if res.returncode == 0:
            return _fail("oom drill: the run survived an injected "
                         "RESOURCE_EXHAUSTED")
        if "RESOURCE_EXHAUSTED" not in (res.stderr or ""):
            return _fail("oom drill: worker died of something other than "
                         "the injected OOM:\n%s" % res.stderr[-2000:])
        mon_dir = os.path.join(out, "attempt-0")
        pms = [n for n in os.listdir(mon_dir) if n.startswith("postmortem")]
        if len(pms) != 1:
            return _fail("oom drill: expected exactly ONE postmortem (the "
                         "dedup contract), found %r" % pms)
        with open(os.path.join(mon_dir, pms[0])) as f:
            rec = json.load(f)
        sec = rec.get("mem_oom") or {}
        if rec.get("reason") != "resource_exhausted":
            return _fail("oom drill: postmortem reason %r"
                         % rec.get("reason"))
        top = (sec.get("owners_top") or [{}])[0].get("owner")
        if top != "ballast":
            return _fail("oom drill: postmortem top owner %r, wanted the "
                         "planted 'ballast'" % top)
        if not sec.get("failing_program") or not sec.get("ledger"):
            return _fail("oom drill: postmortem memory section misses the "
                         "failing program's ledger: %r" % sec)
        events = _read_events(os.path.join(mon_dir, "timeline.jsonl"))
        order = [e["ev"] for e in events
                 if e["ev"] in ("mem_headroom", "postmortem")]
        warned = [e for e in events if e["ev"] == "mem_headroom"
                  and e.get("predicted_oom")]
        if not warned:
            return _fail("oom drill: the headroom predictor never warned")
        if "postmortem" not in order \
                or order.index("mem_headroom") >= order.index("postmortem"):
            return _fail("oom drill: the predictor's warning did not "
                         "precede the dispatch that died")
        ts = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts",
                                          "trace_summary.py"),
             "--timeline", mon_dir],
            env=env, capture_output=True, text=True, timeout=120)
        if "PREDICTED OOM" not in ts.stdout:
            return _fail("oom drill: trace_summary does not surface the "
                         "predicted-OOM row:\n%s" % ts.stdout[-2000:])
        print("chaos_drill --oom: PASS (postmortem names ballast + program "
              "%s; predictor warned %d dispatch(es) early)"
              % (sec["failing_program"], len(warned)))
        return 0
    finally:
        if not args.keep and args.workdir is None:
            shutil.rmtree(work, ignore_errors=True)
