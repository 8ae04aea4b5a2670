"""FleetServe: N ServeEngine replica processes behind a FleetRouter
(counterpart of ``paddle_tpu/serving/fleet.py``, with its structure and
names).

The horizontally-scaled serving tier: the reference's AnalysisPredictor
POOL + ``listen_and_serv`` transport, rebuilt over the port's organs —

- each **replica** is one process running a ``ServeEngine`` over the
  shared exported artifact, draining a wire inbox (hostps/wire.py, pooled
  workers so N requests ride one continuous-batching step) and answering
  ``submit`` / ``stats`` / ``swap`` / ``retire`` ops; every reply
  piggybacks the replica's live queue depth, which is the router's load
  signal;
- **no warm store**: the reference's replicas share one WarmStart
  executable store (the first compiles each lattice point, the rest
  deserialize).  The port has none yet (ROADMAP item 8), so each replica
  captures its own CUDA graphs at start through
  ``ExportedPredictor.ensure_compiled``: its ``precompile_sources`` count
  ``compiled`` for every lattice point, with ``disk`` kept at 0;
- **device**: a replica runs on the card unless started with ``--device
  cpu``; without a card it raises (``FleetManager(device=...)`` passes the
  device through);
- sparse CTR rows live in ShardPS shard-owner processes, NOT per-replica
  table copies: ``FleetCTRView`` is a read-only pull facade that routes
  each id to its owning shard over the wire, so fleet host memory scales
  sub-linearly in replicas.  Its pulls ask the owner for the table's
  read-only pull (``HostSparseTable.pull(materialize=False)``): a cold row
  is served as the initializer's values without being written, so
  serving leaves the owner's table as it was;
- ``FleetManager`` spawns/retires replica processes (the launch.py respawn
  idiom: one Popen per replica, respawn == spawn the same id again) and
  ``autoscale_signal`` turns queue-depth + MemScope-headroom gauges into a
  desired replica count;
- rolling deploys ride ``FleetRouter.rolling_swap`` -> each replica's
  ``engine.request_swap``: replica-by-replica, the tier is never drained.

``python -m paddle_tpu_torch.serving.fleet --wire-dir ... --replica N
--artifact DIR --mon-dir DIR --buckets 2,4,8 --feed x:12:float32 ...
[--device cpu]`` is the replica process entry that ``FleetManager``
spawns.  Only numpy arrays and plain values cross the wire.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

from ..hostps import wire as _wire
from ..monitor.registry import default_registry
from .queue import Draining, ServeError

__all__ = ["FleetCTRView", "FleetManager", "autoscale_signal",
           "replica_main"]

_REPO = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


# ------------------------------------------------- read-only CTR facade --

class FleetCTRView:
    """Read-only serving view over ShardPS shard owners: pulls each id row
    from its owning shard over the wire, holds NO table rows locally.
    Satisfies ``CTRLookup``'s contract (``read_only`` + ``dim`` +
    ``pull``) — the PSLib serving scenario where every replica shares the
    pservers' single copy of the embedding instead of materializing its
    own.

    ``degraded_reads`` is the BROWNOUT knob: ``"block"`` (default) rides
    the wire's full resend/deadline discipline and raises when an owner
    stays gone; ``"init"`` bounds the wait at ``owner_wait_s`` and then
    serves the missing rows as INIT rows (the table's cold-row contract —
    zeros, exactly what an untouched id reads as) instead of blocking the
    whole serving step on a dead shard.  Degraded pulls are counted
    (``serve.degraded_rows``) and stamped (``degraded_recent``) so the
    replica marks its responses ``degraded=true`` — the client learns the
    answer is brownout-quality, the Watchtower degraded-fraction rule
    pages when the fraction matters."""

    read_only = True

    def __init__(self, wire_dir, world, vocab, dim, client_id=None,
                 deadline=None, dtype=np.float32, degraded_reads="block",
                 owner_wait_s=1.0, registry=None):
        from ..parallel.rules import hostps_row_ranges

        if degraded_reads not in ("block", "init"):
            raise ValueError("degraded_reads must be 'block' or 'init'")
        self.wire = _wire.WireClient(
            wire_dir, client_id or ("ctr-view-%d" % os.getpid()),
            deadline=deadline)
        self.world = int(world)
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.dtype = np.dtype(dtype)
        self.degraded_reads = degraded_reads
        self.owner_wait_s = float(owner_wait_s)
        self.registry = registry or default_registry()
        self._degraded_at = 0.0       # monotonic: last brownout pull
        self.degraded_pulls = 0
        self.ranges = hostps_row_ranges(self.world, self.vocab)
        self._los = np.asarray([lo for lo, _ in self.ranges], np.int64)

    def connect(self, timeout=60.0):
        deadline = time.monotonic() + timeout
        for shard in range(self.world):
            rp = _wire.ready_path(self.wire.wire_dir, shard)
            while not os.path.exists(rp):
                if time.monotonic() >= deadline:
                    raise OSError("FleetCTRView: shard %d never became "
                                  "READY within %.0fs" % (shard, timeout))
                time.sleep(0.05)
        return self

    def degraded_recent(self, window_s=5.0):
        """True when a brownout pull happened within ``window_s`` — the
        replica's response-marking window (continuous batching mixes
        requests in one step, so degradation is attributed to the window,
        not per-row)."""
        return (self._degraded_at != 0.0
                and time.monotonic() - self._degraded_at <= window_s)

    def pull(self, ids):
        """HostSparseTable.pull contract (zeros for out-of-vocab ids),
        every in-vocab row fetched from its owning shard — reads only,
        retry-safe by nature (accept_restart: a respawned owner's restored
        rows are as good as the original's for serving).  The owner runs
        its table's read-only pull (``read_only`` in the request): cold
        rows come back as the initializer's values and stay unwritten.

        With ``degraded_reads="init"``, an owner that stays unreachable
        past ``owner_wait_s`` BROWNS OUT instead of blocking: its rows are
        served as init rows (the zeros an untouched id reads as) and the
        pull is counted + stamped degraded."""
        ids = np.asarray(ids)
        flat = ids.reshape(-1).astype(np.int64)
        out = np.zeros((flat.shape[0], self.dim), self.dtype)
        valid = (flat >= 0) & (flat < self.vocab)
        if valid.any():
            vrows = flat[valid]
            owner = np.searchsorted(self._los, vrows, side="right") - 1
            vsel = np.nonzero(valid)[0]
            brownout = self.degraded_reads == "init"
            for shard in np.unique(owner):
                idx = np.nonzero(owner == shard)[0]
                try:
                    res = self.wire.request(
                        int(shard), "pull",
                        {"rows": vrows[idx], "read_only": True},
                        accept_restart=True,
                        # brownout mode bounds the wait itself: one
                        # attempt inside the owner_wait budget, then the
                        # init fallback — never the full resend ladder
                        attempts=1 if brownout else None,
                        deadline=self.owner_wait_s if brownout else None)
                except (_wire.WireTimeout, _wire.ShardDeadError):
                    if not brownout:
                        raise
                    # the dead-owner brownout: these rows stay INIT
                    # (zeros — bit-identical to what a never-pushed id
                    # would have served) and the answer is marked
                    self._degraded_at = time.monotonic()
                    self.degraded_pulls += 1
                    self.registry.counter("serve.degraded_rows").incr(
                        len(idx))
                    self.registry.counter("serve.degraded_pulls").incr()
                    continue
                out[vsel[idx]] = np.asarray(res["values"], self.dtype)
        return out.reshape(ids.shape + (self.dim,))


# ------------------------------------------------------ autoscale signal --

def _cite_incident(alerts):
    """The watchtower hook: ``alerts`` is a list of firing-alert dicts or
    a callable returning one (``Watchtower.firing`` in-process, or
    ``watchtower.firing_from_state(read_state(path))`` cross-process).
    Returns the first citeable incident id, else None — best-effort, the
    signal must never fail on a torn state file."""
    try:
        firing = alerts() if callable(alerts) else alerts
        for a in firing or ():
            if a.get("incident"):
                return str(a["incident"])
    except Exception:
        pass
    return None


def autoscale_signal(snapshot, hbm_frac=None, min_replicas=1,
                     max_replicas=8, high_load=4.0, low_load=0.25,
                     registry=None, alerts=None):
    """Queue-depth + memory-headroom gauges -> desired replica count.

    ``snapshot`` is ``FleetRouter.snapshot()``; ``hbm_frac`` the fleet's
    worst MemScope device-occupancy fraction (``monitor.mem.hbm_frac_max``)
    when known.  Scale UP when the mean per-replica load (queue depth +
    router outstanding) crosses ``high_load`` or memory headroom is nearly
    gone on the current replica set; scale DOWN when the fleet idles below
    ``low_load`` per replica.  Returns ``(desired, reason, mean_load)``
    and publishes the ``fleet.autoscale.*`` gauges the console reads — the
    actuation (FleetManager.spawn / FleetRouter.retire) is the caller's
    policy decision.  ``alerts`` (optional) plugs the watchtower in: a
    ``replacing_suspects`` decision made while an alert is firing cites
    the incident id in its reason (``replacing_suspects:inc-0001``) so
    the autoscale log and the incident ledger tell one story."""
    reg = registry or default_registry()
    n = max(len(snapshot), 1)
    alive = [s for s in snapshot.values() if not s.get("suspect")]
    mean_load = (sum(s["depth"] + s["outstanding"] for s in alive)
                 / max(len(alive), 1))
    desired, reason = n, "steady"
    if len(alive) < n:
        desired, reason = n, "replacing_suspects"
        incident = _cite_incident(alerts)
        if incident:
            reason = "replacing_suspects:%s" % incident
    if mean_load > high_load:
        desired, reason = n + 1, "queue_depth"
    elif hbm_frac is not None and hbm_frac > 0.9:
        desired, reason = n + 1, "memory_headroom"
    elif len(alive) == n and mean_load < low_load and n > min_replicas:
        # idle scale-down ONLY with every replica answering: mean_load is
        # measured over the non-suspect set, so a partial outage reads as
        # ~0 load — retiring a healthy replica then would deepen it
        desired, reason = n - 1, "idle"
    desired = max(min(desired, max_replicas), min_replicas)
    reg.gauge("fleet.autoscale.desired").set(desired)
    reg.gauge("fleet.autoscale.mean_load").set(round(mean_load, 4))
    return desired, reason, mean_load


# ------------------------------------------------------- replica process --

def _parse_feed(specs):
    """``name:shape:dtype`` CLI triples -> the engine's feed_spec dict
    (shape comma-separated, e.g. ``x:12:float32`` or ``tok:seq:int32``)."""
    out = {}
    for spec in specs:
        name, shape, dtype = spec.split(":")
        dims = tuple((d if d == "seq" else int(d))
                     for d in shape.split(",") if d != "")
        out[name] = (dims, dtype)
    return out


class _Replica:
    """One replica process's serving state: engine + wire server + the op
    handler the router speaks to."""

    def __init__(self, args):
        from ..inference import load_exported_model
        from .engine import CTRLookup, ServeEngine
        from .lattice import BucketLattice

        self.args = args
        self.rid = int(args.replica)
        self.registry = default_registry()
        self.predictor = load_exported_model(args.artifact,
                                             device=args.device)
        buckets = [int(b) for b in args.buckets.split(",")]
        seq = ([int(b) for b in args.seq_buckets.split(",")]
               if args.seq_buckets else None)
        self.lattice = BucketLattice(buckets, seq)
        lookups = []
        self.ctr = None
        if args.ctr_wire_dir:
            self.ctr = FleetCTRView(
                args.ctr_wire_dir, args.ctr_world, args.ctr_vocab,
                args.ctr_dim,
                client_id="ctr-r%d-%d" % (self.rid, os.getpid()),
                degraded_reads=args.degraded_reads,
                owner_wait_s=args.owner_wait,
                registry=self.registry,
            ).connect(timeout=args.ready_timeout)
            lookups.append(CTRLookup(self.ctr, args.ctr_ids,
                                     out_name=args.ctr_out))
        t0 = time.perf_counter()
        self.engine = ServeEngine(
            self.predictor, self.lattice,
            feed_spec=_parse_feed(args.feed),
            lookups=lookups, mode=args.mode,
            queue_capacity=args.queue_capacity,
            name="serve").start()
        self.precompile_s = round(time.perf_counter() - t0, 3)
        self.registry.gauge("fleet.replica.id").set(self.rid)
        self.registry.gauge("serve.version").set(1.0)
        self.registry.gauge("serve.draining").set(0.0)
        self._retired = threading.Event()
        self._draining = threading.Event()
        self._retire_summary = None
        self._retire_lock = threading.Lock()
        # drill-armed degradation: sleep per submit (the slow-but-alive
        # replica the breaker exists for).  Set by env at spawn or by the
        # seq'd "chaos" control op at runtime; 0 = healthy.
        try:
            self._slow_ms = float(os.environ.get(
                "PADDLE_TPU_SERVE_SLOW_MS", "0") or 0)
        except ValueError:
            self._slow_ms = 0.0
        self.server = _wire.WireServer(args.wire_dir, self.rid,
                                       self.handle, poll=args.server_poll,
                                       workers=args.workers)

    # -- the op surface the router speaks --------------------------------
    def handle(self, op, payload, client):
        payload = payload or {}
        eng = self.engine
        if op == "submit":
            if self._draining.is_set():
                # lame duck: in-flight work finishes, new admits are
                # refused TYPED — the router re-routes to a sibling
                # without suspecting this replica (draining is health)
                self.registry.counter("serve.drain_refused").incr()
                raise Draining(
                    "replica %d is draining (lame duck) — re-route"
                    % self.rid)
            if self._slow_ms > 0:
                time.sleep(self._slow_ms / 1e3)   # chaos: degraded-alive
            req = eng.submit(payload["feed"],
                             seq_len=payload.get("seq_len"),
                             timeout=self.args.submit_timeout,
                             priority=payload.get("priority"),
                             deadline=payload.get("deadline"))
            outputs = req.result(timeout=self.args.submit_timeout)
            reply = {"outputs": outputs, "depth": len(eng.queue),
                     "inflight": len(eng._inflight),
                     "version": eng.version}
            if self.ctr is not None and self.ctr.degraded_recent():
                # brownout marker: a dead-owner window overlapped this
                # answer — some embedding rows may be init rows
                reply["degraded"] = True
            return reply
        if op == "chaos":
            # drill-only degradation knob (seq'd control op): set the
            # per-submit sleep — the slow-replica leg arms it live and
            # clears it to prove half-open readmission
            self._slow_ms = float(payload.get("slow_ms") or 0)
            return {"replica": self.rid, "slow_ms": self._slow_ms}
        if op == "hello":
            # last_seq: the server's dedup floor for THIS client — the
            # router seeds its control-plane counter from it, so adopting
            # a respawned replica (empty _applied table) restarts at seq 1
            return {"batch_buckets": list(self.lattice.batch_buckets),
                    "max_batch": self.lattice.max_batch,
                    "pid": os.getpid(), "version": eng.version,
                    "replica": self.rid,
                    "last_seq": self.server.last_seq(client)}
        if op == "stats":
            return self.stats()
        if op == "swap":
            return self.swap(payload)
        if op == "retire":
            return self.retire()
        raise ValueError("fleet replica: unknown op %r" % (op,))

    def stats(self):
        eng = self.engine
        q = eng.stats.latency.quantiles()
        wall = eng.stats.wall_s()
        count = eng.stats.latency.count
        out = {"replica": self.rid, "pid": os.getpid(),
               "depth": len(eng.queue), "inflight": len(eng._inflight),
               "completed": count,
               "qps": round(count / wall, 3) if wall > 0 else None,
               "p50_ms": round(q[0.5], 3) if q else None,
               "p99_ms": round(q[0.99], 3) if q else None,
               "recompiles": (eng.detector.recompiles()
                              if eng.detector else 0),
               "precompile_s": self.precompile_s,
               "precompile_sources": eng.precompile_sources,
               "version": eng.version}
        if eng._sig_count0 is not None:
            try:
                out["new_compiled_sigs"] = (
                    self.predictor.compiled_signature_count()
                    - eng._sig_count0)
            except Exception:
                pass
        return out

    def swap(self, payload):
        """The rolling-deploy target: load the published state and flip it
        in through the engine's zero-drop ``request_swap`` boundary."""
        version = payload.get("version")
        data = np.load(payload["state_path"])
        state = {n: data[n] for n in data.files}

        def _apply():
            self.predictor.swap_state(state)
            return {"replica": self.rid}

        event = self.engine.request_swap(
            _apply, version=version, timeout=self.args.submit_timeout)
        # freshness gauges (fleet_top's version/fresh_s columns): the
        # version this replica now serves and when it went live.  Nothing
        # past the flip may raise — an error reply here would leave the
        # seq unrecorded and a retransmit would re-apply an at-most-once
        # swap — so non-numeric versions degrade to 0.0 like the router's
        # own gauge does, and the whole block is best-effort.
        try:
            try:
                v = float(version)
            except (TypeError, ValueError):
                v = 0.0
            self.registry.gauge("serve.version").set(v)
            self.registry.gauge("online.version").set(v)
            self.registry.gauge("online.train_wall").set(
                float(payload.get("train_wall") or time.time()))
        except Exception:
            pass
        return {"replica": self.rid, "event": event}

    def retire(self):
        """Drain + stop the engine; the main loop exits after the reply is
        on the wire.  Idempotent (a retransmitted retire re-answers from
        the wire dedup cache; a second live call returns the same
        summary).

        The lame-duck half of LoadShield rides here: ``_draining`` flips
        FIRST, so every submit arriving after this instant gets the typed
        ``Draining`` refusal (router re-routes, zero drops), while
        everything already queued or in flight is served to completion by
        the drain below."""
        with self._retire_lock:
            if self._retire_summary is None:
                self._draining.set()
                self.registry.gauge("serve.draining").set(1.0)
                self._retire_summary = self.engine.stop(drain=True)
        self._retired.set()
        return {"replica": self.rid, "summary": self._retire_summary}

    # -- lifecycle --------------------------------------------------------
    def serve_forever(self):
        from ..monitor import exporters as _exporters

        self.server.start()
        self.server.mark_ready()
        prom = os.path.join(self.args.mon_dir, "metrics.prom")
        next_export = 0.0
        while not self._retired.is_set():
            now = time.monotonic()
            if now >= next_export:
                # live exposition for fleet_top: quantile gauges + queue
                # depth refresh every export interval, not end-of-run
                next_export = now + self.args.export_every
                try:
                    self.engine.stats.publish_quantiles()
                    _exporters.write_prometheus(prom, self.registry)
                except Exception:
                    pass
            if self.engine.error is not None:
                break
            self._retired.wait(0.2)
        # grace for the retire reply to leave the server before it stops
        time.sleep(max(2 * _wire.default_poll(), 0.05))
        self.server.stop()
        if self._retire_summary is None:
            self._retire_summary = self.engine.stop(drain=True)
        try:
            self.engine.stats.publish_quantiles()
            _exporters.write_prometheus(prom, self.registry)
        except Exception:
            pass
        return self._retire_summary


def replica_main(argv=None):
    ap = argparse.ArgumentParser(
        description="FleetServe replica process (spawned by FleetManager)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the replica serves: the card unless cpu "
                         "is asked for; without a card, cuda raises")
    ap.add_argument("--wire-dir", required=True)
    ap.add_argument("--replica", type=int, required=True)
    ap.add_argument("--artifact", required=True)
    ap.add_argument("--mon-dir", required=True)
    ap.add_argument("--buckets", default="2,4,8")
    ap.add_argument("--seq-buckets", default=None)
    ap.add_argument("--feed", action="append", required=True,
                    help="name:shape:dtype (repeat; shape comma-separated)")
    ap.add_argument("--mode", default="continuous")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--server-poll", type=float, default=0.004)
    ap.add_argument("--queue-capacity", type=int, default=512)
    ap.add_argument("--submit-timeout", type=float, default=60.0)
    ap.add_argument("--ready-timeout", type=float, default=120.0)
    ap.add_argument("--export-every", type=float, default=1.0)
    ap.add_argument("--ctr-wire-dir", default=None)
    ap.add_argument("--ctr-world", type=int, default=1)
    ap.add_argument("--ctr-vocab", type=int, default=0)
    ap.add_argument("--ctr-dim", type=int, default=0)
    ap.add_argument("--ctr-ids", default="ids")
    ap.add_argument("--ctr-out", default="emb")
    ap.add_argument("--degraded-reads", default="block",
                    choices=("block", "init"),
                    help="brownout policy when a ShardPS owner is dead "
                         "past --owner-wait: block (raise) or init "
                         "(serve init rows, mark responses degraded)")
    ap.add_argument("--owner-wait", type=float, default=1.0,
                    help="seconds to wait for a ShardPS owner before the "
                         "degraded-reads policy applies")
    args = ap.parse_args(argv)

    from .. import monitor
    from ..kernels._common import resolve_device

    # refuse before anything starts: no card and no --device cpu raises
    args.device = str(resolve_device(args.device))

    monitor.enable(args.mon_dir)
    rc = 0
    try:
        replica = _Replica(args)
        summary = replica.serve_forever()
        print(json.dumps({"replica": args.replica, "summary": summary}))
        if replica.engine.error is not None:
            rc = 3
    finally:
        monitor.disable()
    return rc


# ------------------------------------------------------------- manager --

class FleetManager:
    """Spawns and retires replica processes — the launch.py respawn idiom
    applied to the serving tier: one Popen per replica id, a respawn is
    ``spawn(rid)`` again (the new process serves the same wire inbox with
    a new generation, which the router detects and adopts), and the
    autoscale actuation is spawn/retire of the next id."""

    def __init__(self, wire_dir, artifact_dir, mon_root, feeds,
                 buckets="2,4,8", seq_buckets=None, workers=8,
                 queue_capacity=512, ctr=None, env=None,
                 python=None, device="cuda"):
        self.wire_dir = wire_dir
        self.artifact_dir = artifact_dir
        self.mon_root = mon_root
        self.feeds = list(feeds)
        self.buckets = buckets
        self.seq_buckets = seq_buckets
        self.workers = int(workers)
        self.queue_capacity = int(queue_capacity)
        self.ctr = dict(ctr) if ctr else None
        self.python = python or sys.executable
        self.device = str(device)
        base = dict(os.environ if env is None else env)
        base["PYTHONPATH"] = (_REPO + os.pathsep + base["PYTHONPATH"]
                              if base.get("PYTHONPATH") else _REPO)
        self.env = base
        self.procs = {}

    def mon_dir(self, rid):
        return os.path.join(self.mon_root, "replica-%d" % int(rid))

    def spawn(self, rid, extra_env=None):
        """Start (or respawn) replica ``rid``.  The wire inbox outlives
        the process, so a respawn resumes draining where the corpse left
        off — clients' resend loops bridge the gap, exactly the ShardPS
        owner-respawn contract.  ``extra_env`` overlays the replica's
        environment (the drills' chaos knobs, e.g.
        ``PADDLE_TPU_SERVE_SLOW_MS``)."""
        rid = int(rid)
        cmd = [self.python, "-m", "paddle_tpu_torch.serving.fleet",
               "--device", self.device,
               "--wire-dir", self.wire_dir, "--replica", str(rid),
               "--artifact", self.artifact_dir,
               "--mon-dir", self.mon_dir(rid),
               "--buckets", self.buckets,
               "--workers", str(self.workers),
               "--queue-capacity", str(self.queue_capacity)]
        if self.seq_buckets:
            cmd += ["--seq-buckets", self.seq_buckets]
        for f in self.feeds:
            cmd += ["--feed", f]
        if self.ctr:
            cmd += ["--ctr-wire-dir", self.ctr["wire_dir"],
                    "--ctr-world", str(self.ctr.get("world", 1)),
                    "--ctr-vocab", str(self.ctr["vocab"]),
                    "--ctr-dim", str(self.ctr["dim"]),
                    "--ctr-ids", self.ctr.get("ids", "ids"),
                    "--ctr-out", self.ctr.get("out", "emb")]
            if self.ctr.get("degraded_reads"):
                cmd += ["--degraded-reads", self.ctr["degraded_reads"]]
            if self.ctr.get("owner_wait") is not None:
                cmd += ["--owner-wait", str(self.ctr["owner_wait"])]
        env = self.env if not extra_env else dict(self.env, **extra_env)
        proc = subprocess.Popen(cmd, env=env, cwd=_REPO)
        self.procs[rid] = proc
        default_registry().counter("fleet.spawns").incr()
        return proc

    def kill(self, rid):
        """SIGKILL a replica (the chaos drill's mid-trace death)."""
        proc = self.procs.get(int(rid))
        if proc is not None and proc.poll() is None:
            proc.kill()
        return proc

    def wait_ready(self, rids, timeout=120.0):
        deadline = time.monotonic() + timeout
        for rid in rids:
            rp = _wire.ready_path(self.wire_dir, int(rid))
            while not os.path.exists(rp):
                proc = self.procs.get(int(rid))
                if proc is not None and proc.poll() is not None:
                    raise ServeError(
                        "fleet replica %d exited rc=%s before READY"
                        % (rid, proc.returncode))
                if time.monotonic() >= deadline:
                    raise ServeError(
                        "fleet replica %d not READY within %.0fs"
                        % (rid, timeout))
                time.sleep(0.05)
        return self

    def apply_autoscale(self, router, desired):
        """Actuate a signal: spawn the next id up, or retire the highest.
        Returns ("spawn"|"retire"|None, rid)."""
        current = router.replica_ids()
        if desired > len(current):
            # next id clears BOTH the procs this manager spawned and the
            # router's live membership: a fleet adopted rather than
            # spawned here (procs empty, replicas 0..N live) must not
            # reuse rid 0 — the stale READY file would pass wait_ready
            # and two engines would drain one wire inbox
            taken = set(self.procs) | set(current)
            rid = (max(taken) + 1) if taken else 0
            self.spawn(rid)
            self.wait_ready([rid])
            router.add_replica(rid)
            return "spawn", rid
        if desired < len(current):
            rid = max(current)
            router.retire(rid)
            self.wait(rid, timeout=30.0)
            return "retire", rid
        return None, None

    def wait(self, rid, timeout=60.0):
        proc = self.procs.get(int(rid))
        if proc is None:
            return None
        try:
            return proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            return proc.wait(timeout=10)

    def stop_all(self, timeout=30.0):
        for rid, proc in list(self.procs.items()):
            if proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + timeout
        for rid, proc in list(self.procs.items()):
            try:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                proc.kill()


if __name__ == "__main__":
    sys.exit(replica_main())
