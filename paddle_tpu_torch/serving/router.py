"""FleetRouter: the serving tier's request dispatcher over the ShardPS wire
(counterpart of ``paddle_tpu/serving/router.py``, a copy on the port's
``hostps/wire.py``, ``monitor.trace`` and ``monitor.registry``: the same
event, span and gauge names, so the port's timelines read the same).

Parity: the reference fronts its AnalysisPredictor pool with an RPC
dispatcher — ``listen_and_serv`` on the serving side, the client stub
picking a free predictor.  Here the pool is N ``ServeEngine`` REPLICA
PROCESSES (serving/fleet.py), each draining a wire inbox
(``hostps/wire.py`` — the same fault-tolerant transport the ShardPS tier
trusts: per-request deadlines, jittered resend, idempotent seq for
mutating ops, generation-change restart detection), and the router is the
client half:

- **routing** is by lattice-bucket fit then load: among the replicas whose
  bucket lattice wastes the least padding on this request's row count, the
  one with the fewest outstanding-plus-queued requests wins (every reply
  piggybacks the replica's live queue depth, so the router's view ages one
  round trip at most);
- **re-route on replica death**: a submit whose wire deadline fires marks
  the replica suspect and retries on a sibling — scoring is pure, so the
  retry is safe even when the dead replica actually served the request
  (the orphaned reply is swept).  A suspect replica is retried after a
  cool-off instead of being abandoned: the manager's respawn brings it
  back with a NEW wire generation, which the router detects (the
  ShardRestartedError path) and adopts — a respawned replica is a fresh
  engine, nothing to replay;
- **control plane** ops (``swap`` — the rolling version flip, ``retire``)
  are seq-numbered per replica, so the wire's at-most-once dedup makes a
  retransmitted deploy command safe;
- the dispatch/reply hot path arms tracing through the same
  one-global-read gate as the wire itself: tracing disabled costs the
  router nothing;
- **LoadShield** (serving/shield.py) rides the same hot path as pure
  bookkeeping: client deadlines propagate on the wire (``expires``) and
  provably-unservable submits are refused up front; past a load watermark
  the lowest priority class sheds first as a typed ``Shed``; every
  re-route/hedge spends a token-bucket RETRY BUDGET (amplification is
  arithmetically capped, a denied retry is a counted giveup); a
  per-replica latency/error-EWMA BREAKER routes around slow-but-alive
  replicas and readmits them — like a lapsed suspect cool-off — via
  exactly ONE half-open probe whose verdict, not the clock, restores
  traffic.  Replies are switched on machine-readable ``code`` (the wire's
  typed reply contract), never on error-message substrings.

Only numpy arrays and plain values cross the wire: a feed is sent as
numpy, and a replica answers with numpy outputs.
"""

import os
import queue as _pyqueue
import threading
import time

import numpy as np

from ..hostps import wire as _wire
from ..monitor import trace as _trace
from ..monitor.registry import default_registry
from .queue import DeadlineExceeded, ServeError, Shed
from .shield import ReplicaBreaker, ShieldConfig

__all__ = ["FleetRouter", "FleetGiveUp", "ReplicaInfo"]

# wire error codes that mean "this replica refuses right now, a sibling
# may serve" — the typed replacement for the old substring sniffing
_PUSHBACK_CODES = frozenset(
    ("backpressure", "queue_full", "draining", "shed", "serve_error"))
_BR_CLOSED = ReplicaBreaker.CLOSED


class FleetGiveUp(ServeError):
    """Every replica refused or timed out past the per-request budget —
    the bounded end of re-routing (the alternative is wedging the
    client)."""


def _emit(ev, **kw):
    """Timeline evidence (fleet_reroute / fleet_replica_suspect /
    fleet_swap) — best-effort, never on the dispatch critical section."""
    try:
        from ..monitor import session as _session

        mon = _session.active()
        if mon is not None:
            mon.timeline.emit(ev, **kw)
    except Exception:
        pass


class ReplicaInfo:
    """The router's view of one replica: identity (hello), load estimate,
    liveness verdict, control-plane seq counter."""

    __slots__ = ("rid", "batch_buckets", "max_batch", "pid", "version",
                 "outstanding", "depth", "inflight", "suspect_until",
                 "next_seq", "served", "rerouted_away", "ctl",
                 "breaker", "probe_inflight")

    def __init__(self, rid):
        self.rid = int(rid)
        self.ctl = threading.Lock()   # serializes control ops per replica
        self.batch_buckets = ()
        self.max_batch = 0
        self.pid = None
        self.version = None
        self.outstanding = 0      # router-side: dispatched, not yet replied
        self.depth = 0            # replica-side queue depth (piggybacked)
        self.inflight = 0         # replica-side engine in-flight rows
        self.suspect_until = 0.0  # monotonic: skip this replica until then
        self.next_seq = 1         # control-plane (swap/retire) seq counter
        self.served = 0
        self.rerouted_away = 0
        self.breaker = None       # ReplicaBreaker, attached by the router
        self.probe_inflight = False  # the ONE half-open probe is out

    def load(self):
        return self.outstanding + self.depth

    def fit_waste(self, rows):
        """Padding rows the replica's lattice wastes on this request's
        FIRST step (a request larger than max_batch spans steps — waste 0,
        any replica fits it equally)."""
        if not self.batch_buckets or rows >= self.max_batch:
            return 0
        for b in self.batch_buckets:
            if b >= rows:
                return b - rows
        return 0


class FleetRouter:
    """Dispatches serving requests across replica processes over the wire.

    ``replicas``: the initial replica ids (wire shard ids).  One
    ``WireClient`` serves every client thread (it is thread-safe and the
    reply box is per-request); ``deadline`` is the per-attempt reply
    budget — a replica that does not answer within it is suspected and
    the request re-routes to a sibling."""

    def __init__(self, wire_dir, replicas=(), client_id=None, deadline=None,
                 poll=None, attempts=1, request_budget=30.0,
                 suspect_cooloff=2.0, registry=None, shield=None):
        self.wire_dir = wire_dir
        self.wire = _wire.WireClient(
            wire_dir, client_id or ("fleet-router-%d" % os.getpid()),
            deadline=deadline, poll=poll)
        self.attempts = max(int(attempts), 1)
        self.request_budget = float(request_budget)
        self.suspect_cooloff = float(suspect_cooloff)
        self.registry = registry or default_registry()
        # LoadShield: inert by default (no watermark, no breaker trip
        # wires, no hedging) — a healthy fleet must behave byte-identically
        # with the shield attached (serve_bench --fleet gates zero sheds /
        # trips / brownouts on a clean run)
        if shield is None:
            shield = ShieldConfig()
        elif isinstance(shield, dict):
            shield = ShieldConfig(**shield)
        self.shield = shield
        self.budget = shield.make_budget()
        self.shed = shield.make_shed()
        # precomputed dispatch-path guard (one attribute load per submit)
        self._shed_armed = self.shed.watermark is not None
        self._ewma_ms = 0.0       # fleet-wide end-to-end service EWMA
        self._dispatched = 0      # submits offered (incl. shed ones)
        self._sheds = 0
        self._degraded = 0        # replies flagged degraded (brownout)
        self._replies = 0
        self._lock = threading.Lock()
        self._rr = 0              # round-robin tiebreaker cursor
        self._replicas = {}
        for rid in replicas:
            info = self._replicas[int(rid)] = ReplicaInfo(rid)
            info.breaker = shield.make_breaker()
        self._rebuild_order()

    # -- membership -------------------------------------------------------
    def _rebuild_order(self):
        # _pick's scan order, rebuilt ONLY on membership change (spawn /
        # retire / adoption): the dispatch hot path is budgeted as pure
        # bookkeeping (monitor_overhead's 0.5%-of-request gate) and must
        # not re-sort the fleet per request
        self._order = tuple(
            (i, rid, self._replicas[rid])
            for i, rid in enumerate(sorted(self._replicas)))
        # running (outstanding + depth) total, maintained by every lock
        # holder that mutates either term — _mean_load reads it WITHOUT
        # the lock, so the shed watermark costs a divide per request, not
        # a second lock acquisition plus a fleet scan
        self._load_sum = sum(info.outstanding + info.depth
                             for _i, _rid, info in self._order)

    def replica_ids(self):
        with self._lock:
            return sorted(self._replicas)

    def add_replica(self, rid, timeout=60.0):
        """Route to one more replica (scale-up / respawn adoption): wait
        for its READY marker, take its hello, open it for dispatch."""
        rid = int(rid)
        with self._lock:
            info = self._replicas.get(rid)
            if info is None:
                info = self._replicas[rid] = ReplicaInfo(rid)
                info.breaker = self.shield.make_breaker()
                self._rebuild_order()
        self._await_ready(rid, timeout)
        self._hello(info)
        return info

    def drop_replica(self, rid):
        """Stop routing to a replica (scale-down: pair with a ``retire``)."""
        with self._lock:
            info = self._replicas.pop(int(rid), None)
            self._rebuild_order()
            return info

    def _await_ready(self, rid, timeout):
        deadline = time.monotonic() + timeout
        rp = _wire.ready_path(self.wire_dir, rid)
        while not os.path.exists(rp):
            if time.monotonic() >= deadline:
                raise FleetGiveUp(
                    "fleet: replica %d never became READY within %.0fs"
                    % (rid, timeout))
            time.sleep(0.05)

    def _hello(self, info):
        res = self.wire.request(info.rid, "hello", {},
                                accept_restart=True)
        with self._lock:
            info.batch_buckets = tuple(res.get("batch_buckets") or ())
            info.max_batch = int(res.get("max_batch") or 0)
            info.pid = res.get("pid")
            info.version = res.get("version")
            # seed the control-plane seq from the SERVER's dedup floor: a
            # respawned replica starts an empty _applied table expecting
            # seq 1 — carrying the pre-crash counter across the generation
            # would make every post-respawn swap/retire a "seq gap" refusal
            info.next_seq = int(res.get("last_seq") or 0) + 1
        return res

    def _adopt_respawn(self, info):
        """Refresh the router's view of a replica whose new generation was
        just committed: the fresh engine's identity (pid/version/lattice)
        AND its seq floor — the dedup table died with the old process, so
        the old ``next_seq`` would trip the server's seq-gap refusal on
        the very next swap/retire.  Best-effort: when the hello itself
        fails (the replica flapped again), fall back to seq 1, which is
        what an empty ``_applied`` table expects."""
        try:
            self._hello(info)
        except (OSError, _wire.WireRemoteError, _wire.ShardDeadError):
            with self._lock:
                info.next_seq = 1

    def connect(self, timeout=60.0):
        """Wait for every initial replica's READY and identity."""
        for rid in self.replica_ids():
            self._await_ready(rid, timeout)
            self._hello(self._replicas[rid])
        self.registry.gauge("fleet.replicas").set(len(self._replicas))
        return self

    # -- routing (the hot path: pure bookkeeping, no I/O) -----------------
    def _pick(self, rows, exclude=()):
        """Best replica for ``rows``: smallest lattice-padding waste, then
        least load (outstanding + piggybacked queue depth), then round
        robin.  Suspect and breaker-open replicas are skipped; once either
        cool-off lapses the replica is owed exactly ONE half-open probe
        request (``probe_inflight``) whose verdict — not the clock —
        restores full traffic.  ``None`` when nobody is eligible."""
        now = time.monotonic()
        best, best_key, probe = None, None, None
        with self._lock:
            order = self._order
            n = len(order) or 1
            self._rr += 1
            rr = self._rr
            for i, rid, info in order:
                if rid in exclude:
                    continue
                if info.suspect_until:
                    # cool-off running: skip.  Lapsed: readmit via ONE
                    # probe, never blindly — a replica that died once gets
                    # full traffic back only on an observed success.
                    if info.suspect_until > now or info.probe_inflight:
                        continue
                    if probe is None:
                        probe = info
                    continue
                br = info.breaker
                if br is not None and br.state != _BR_CLOSED:
                    v = br.admit(now)
                    if v == "probe":
                        if probe is None and not info.probe_inflight:
                            probe = info
                        continue
                    if v is not True:
                        continue
                key = (info.fit_waste(rows), info.load(), (i + rr) % n)
                if best_key is None or key < best_key:
                    best, best_key = info, key
            # an owed probe outranks the healthy best: readmission needs
            # live evidence and this request is the canary
            pick = probe if probe is not None else best
            if pick is not None:
                pick.outstanding += 1
                self._load_sum += 1
                if pick is probe:
                    pick.probe_inflight = True
        return pick

    def _unpick(self, info):
        """Undo a ``_pick`` whose dispatch never happened (retry-budget
        denial): release the slot and, if this pick was the half-open
        probe, re-offer it."""
        with self._lock:
            if info.outstanding:
                info.outstanding -= 1
                self._load_sum -= 1
            info.probe_inflight = False

    def _note_reply(self, info, reply, ok=True, ms=None, alive=None):
        """Fold a reply's piggybacked load/version into the router view.
        ``ms`` (when known) feeds the replica breaker and the fleet-wide
        service EWMA; ``alive=True`` marks a typed refusal — a failure for
        the caller but PROOF OF LIFE for suspicion/breaker purposes."""
        with self._lock:
            if info.outstanding:
                info.outstanding -= 1
                self._load_sum -= 1
            br = info.breaker
            if br is not None and ms is not None:
                br.record(ms, not ok and not alive, time.monotonic())
            if ok or alive:
                info.suspect_until = 0.0
                info.probe_inflight = False
            if not ok:
                return
            if ms is not None:
                # end-to-end service EWMA: queue wait folds in naturally,
                # so this IS the depth-aware floor _service_floor_ms uses
                e = self._ewma_ms
                self._ewma_ms = ms if e == 0.0 else e + 0.2 * (ms - e)
            if isinstance(reply, dict):
                d = int(reply.get("depth") or 0)
                self._load_sum += d - info.depth
                info.depth = d
                info.inflight = int(reply.get("inflight") or 0)
                if reply.get("version") is not None:
                    info.version = reply.get("version")
            info.served += 1
            self._replies += 1

    def _suspect(self, info, why, ms=None):
        with self._lock:
            if info.outstanding:
                info.outstanding -= 1
                self._load_sum -= 1
            info.suspect_until = time.monotonic() + self.suspect_cooloff
            info.probe_inflight = False
            info.rerouted_away += 1
            br = info.breaker
            if br is not None:
                # a timeout is the strongest "degraded" sample there is:
                # charge the full elapsed wall as both latency and error
                br.record(self.wire.deadline * 1e3 if ms is None else ms,
                          True, time.monotonic())
        self.registry.counter("fleet.rerouted").incr()
        if _trace.active_tracer() is not None:
            _trace.instant("fleet.reroute", replica=int(info.rid),
                           why=str(why))
        _emit("fleet_reroute", replica=int(info.rid), why=str(why))

    # -- data plane -------------------------------------------------------
    def _mean_load(self):
        # lock-free on purpose (the per-request shed gate): _load_sum is
        # maintained under the lock by everyone who mutates it, and a
        # torn read here is at worst one request stale — noise against a
        # watermark measured in whole queued requests
        order = self._order
        return (self._load_sum / len(order)) if order else 0.0

    def _service_floor_ms(self):
        """The fastest wall a NEW request can plausibly achieve: half the
        fleet's end-to-end service EWMA (which already folds in replica
        queue wait) plus a term for the least-loaded replica's standing
        piggybacked queue.  ``None`` until there is evidence."""
        ew = self._ewma_ms
        if ew <= 0.0:
            return None
        with self._lock:
            order = self._order
            if not order:
                return None
            min_load = min(info.load() for _i, _rid, info in order)
        return 0.5 * ew + 0.25 * ew * min_load

    def _attempt(self, info, payload, expires):
        """One dispatch to one replica with full shield bookkeeping.
        Returns ``(status, value)``: ``("ok", reply)``, ``("pushback",
        exc)`` (typed refusal — try a sibling), ``("retry", exc_or_None)``
        (timeout / death / restart — re-route), ``("fatal", exc)`` (raise
        to the caller as-is)."""
        reg = self.registry
        reg.counter("fleet.attempts").incr()
        t0 = time.monotonic()
        try:
            reply = self.wire.request(info.rid, "submit", payload,
                                      attempts=self.attempts,
                                      expires=expires)
        except _wire.ShardRestartedError:
            # the replica respawned (new wire generation): a fresh engine
            # holds no router state to replay — adopt the new generation
            # and re-issue (scoring is pure)
            self._note_reply(info, None, ok=False, alive=True)
            self.wire.commit_generation(info.rid)
            self._adopt_respawn(info)
            reg.counter("fleet.replica_restarts").incr()
            _emit("fleet_replica_restart", replica=int(info.rid))
            return ("retry", None)
        except (_wire.WireTimeout, _wire.ShardDeadError) as e:
            # deadline fired (or provably dead): suspect and re-route —
            # the idempotent transport makes the sibling retry safe
            self._suspect(info, type(e).__name__,
                          ms=(time.monotonic() - t0) * 1e3)
            return ("retry", e)
        except _wire.WireRemoteError as e:
            ms = (time.monotonic() - t0) * 1e3
            code = getattr(e, "code", None)
            # every typed refusal is PROOF OF LIFE: the replica answered,
            # fast — clear suspicion, feed the breaker a healthy sample
            self._note_reply(info, None, ok=False, ms=ms, alive=True)
            if code == "deadline":
                # the replica (or its wire inbox) fast-failed an expired
                # request: the client's deadline is spent, nothing to retry
                reg.counter("fleet.deadline_failed").incr()
                return ("fatal", DeadlineExceeded(str(e)))
            if code in _PUSHBACK_CODES:
                reg.counter("fleet.backpressure", code=str(code)).incr()
                return ("pushback", e)
            return ("fatal", e)
        ms = (time.monotonic() - t0) * 1e3
        self._note_reply(info, reply, ms=ms)
        if isinstance(reply, dict) and reply.get("degraded"):
            # brownout: the replica answered from "init" CTR rows because
            # its ShardPS owner is past the wait budget — count it so the
            # watchtower's degraded-fraction rule sees the fleet browning
            self._degraded += 1
            reg.counter("fleet.degraded").incr()
        return ("ok", reply)

    def _attempt_hedged(self, primary, payload, expires, rows, exclude):
        """Budget-gated hedging: dispatch the primary on a worker thread;
        once it is ``hedge_ms`` late, spend ONE retry-budget token on a
        duplicate to a sibling and take whichever verdict lands first.
        The idempotent transport makes the duplicate safe; the budget
        keeps a slow fleet from doubling its own offered load."""
        q = _pyqueue.Queue()

        def run(info, hedge):
            try:
                q.put((hedge, self._attempt(info, payload, expires)))
            except BaseException as e:  # a bug must not wedge submit()
                q.put((hedge, ("fatal", e)))

        threading.Thread(target=run, args=(primary, False),
                         daemon=True).start()
        try:
            return q.get(timeout=self.shield.hedge_ms / 1e3)[1]
        except _pyqueue.Empty:
            pass
        n_out = 1
        if self.budget.try_spend():
            second = self._pick(rows, set(exclude) | {primary.rid})
            if second is None:
                self.budget.refund()
            else:
                n_out = 2
                self.registry.counter("fleet.hedges").incr()
                threading.Thread(target=run, args=(second, True),
                                 daemon=True).start()
        first = None
        for _ in range(n_out):
            try:
                hedge, res = q.get(timeout=max(self.request_budget, 60.0))
            except _pyqueue.Empty:  # defensive: wire deadlines bound this
                break
            if res[0] == "ok":
                if hedge:
                    self.registry.counter("fleet.hedge_wins").incr()
                return res
            if first is None:
                first = res
        return first if first is not None else (
            "retry", None)

    def submit(self, feed, seq_len=None, timeout=None, priority=None,
               deadline=None):
        """Score one request on the fleet; returns the fetch-ordered
        output arrays.  ``deadline`` (RELATIVE seconds) rides the wire as
        an absolute expiry — replicas fast-fail it typed once it passes,
        and the router refuses it up front when it is provably unservable.
        ``priority`` (0=low/1=normal/2=high) feeds the shed watermark.
        Re-routes on replica timeout/death while the retry budget lasts;
        raises typed ``Shed`` / ``DeadlineExceeded`` / ``FleetGiveUp`` —
        never silently drops."""
        payload = {"feed": {str(k): np.asarray(v) for k, v in feed.items()},
                   "seq_len": seq_len}
        prio = 1 if priority is None else int(priority)
        if priority is not None:
            payload["priority"] = prio
        budget = self.request_budget if timeout is None else float(timeout)
        expires = None
        if deadline is not None:
            expires = time.time() + float(deadline)
            payload["deadline"] = expires
            budget = min(budget, float(deadline))
        reg = self.registry
        reg.counter("fleet.dispatched").incr()
        self._dispatched += 1
        # the retry budget's per-primary earn, inlined (the body of
        # RetryBudget.observe — a method call per request is measurable
        # against the 5us dispatch budget; the earn is deliberately
        # lock-free, see the shield module docstring)
        b = self.budget
        t = b.tokens + b.ratio
        b.tokens = t if t < b.cap else b.cap
        # -- shed gate: priority-aware watermark over mean replica load
        # (the armed-only guard keeps the inert default off the hot path)
        if self._shed_armed:
            retry_after = self.shed.verdict(prio, self._mean_load())
            if retry_after is not None:
                self._sheds += 1
                reg.counter("serve.shed.watermark",
                            priority=str(prio)).incr()
                raise Shed(
                    "fleet: shed at priority %d — mean load past the "
                    "watermark; retry after %.0fms" % (prio, retry_after),
                    retry_after_ms=retry_after)
        # -- provably-unservable refusal: cheaper to fail in microseconds
        # than to burn a lattice slot proving the deadline was hopeless
        if expires is not None:
            floor = self._service_floor_ms()
            remain = (expires - time.time()) * 1e3
            if floor is not None and remain < floor:
                self._sheds += 1
                reg.counter("serve.shed.unservable").incr()
                raise DeadlineExceeded(
                    "fleet: unservable — %.0fms remain, the fleet's "
                    "service floor is %.0fms" % (remain, floor))
        t0 = time.monotonic()
        limit = t0 + budget
        rows = next(iter(payload["feed"].values())).shape[0]
        hedge_ms = self.shield.hedge_ms
        exclude = set()
        last_err = None
        first = True
        while time.monotonic() < limit:
            if expires is not None and time.time() > expires:
                reg.counter("fleet.deadline_failed").incr()
                raise DeadlineExceeded(
                    "fleet: client deadline passed mid-re-route (last "
                    "error: %r)" % last_err) from last_err
            info = self._pick(rows, exclude)
            if info is None:
                # everyone is excluded or cooling off this round: reset the
                # exclusions (a suspect may be back) and breathe
                exclude.clear()
                time.sleep(0.02)
                continue
            if first:
                first = False
            elif not self.budget.try_spend():
                # re-dispatch DENIED: the token bucket is dry, so this
                # becomes a counted giveup instead of amplification
                self._unpick(info)
                reg.counter("fleet.retry_budget_denied").incr()
                raise FleetGiveUp(
                    "fleet: retry budget exhausted (last error: %r) — "
                    "typed giveup, not a retry storm" % last_err) \
                    from last_err
            if hedge_ms is not None:
                status, res = self._attempt_hedged(
                    info, payload, expires, rows, exclude)
            else:
                status, res = self._attempt(info, payload, expires)
            if status == "ok":
                # end-to-end request wall INCLUDING re-route retries: the
                # client-visible latency a kill window actually inflates
                # (replica-side p99 stays clean while the victim's requests
                # burn their deadline) — the watchtower burn-rate source
                reg.histogram("fleet.request_ms").observe(
                    (time.monotonic() - t0) * 1000.0)
                return res["outputs"]
            if status == "fatal":
                raise res
            last_err = res if res is not None else last_err
            if status == "pushback":
                exclude.add(info.rid)
                if len(exclude) >= len(self.replica_ids()):
                    exclude.clear()
                    time.sleep(0.05)
            elif res is not None:      # timeout/dead: shun the victim
                exclude.add(info.rid)  # (restart-adopt retries in place)
        raise FleetGiveUp(
            "fleet: request not served within %.1fs (last error: %r)"
            % (budget, last_err)) from last_err

    # -- control plane (seq-numbered: at-most-once per replica) -----------
    def _control(self, info, op, payload, deadline=None):
        # ``ctl`` holds seq allocation AND publication together: two
        # control threads on one replica (a rolling_swap racing a retire)
        # would otherwise publish their seqs out of order and the later
        # one would eat a spurious "seq gap" refusal — ordered per-client
        # application is the wire's contract, so the router honors it
        with info.ctl:
            with self._lock:
                seq = info.next_seq
                info.next_seq += 1
            return self.wire.request(info.rid, op, payload, seq=seq,
                                     deadline=deadline, accept_restart=True)

    def stats(self, rid, deadline=None):
        """One replica's live stats (depth/inflight/summary counters)."""
        info = self._replicas[int(rid)]
        with self._lock:
            info.outstanding += 1   # _note_reply's decrement pairs with it
            self._load_sum += 1
        try:
            res = self.wire.request(info.rid, "stats", {},
                                    deadline=deadline, accept_restart=True)
        except BaseException:
            with self._lock:
                if info.outstanding:
                    info.outstanding -= 1
                    self._load_sum -= 1
            raise
        self._note_reply(info, res)
        return res

    def stats_all(self, deadline=None):
        out = {}
        for rid in self.replica_ids():
            try:
                out[rid] = self.stats(rid, deadline=deadline)
            except (OSError, _wire.ShardRestartedError,
                    _wire.WireRemoteError):
                out[rid] = None
        return out

    def rolling_swap(self, version, state_path, deadline=60.0):
        """The rolling deploy: flip every replica to ``version`` ONE AT A
        TIME over the engine's ``request_swap`` path (PR 16) — in-flight
        requests finish on the old weights, admission never pauses
        fleet-wide, the tier is never drained.  Returns per-replica flip
        events."""
        events = {}
        for rid in self.replica_ids():
            info = self._replicas[rid]
            res = self._control(info, "swap",
                                {"version": version,
                                 "state_path": str(state_path)},
                                deadline=deadline)
            with self._lock:
                info.version = version
            events[rid] = res
            _emit("fleet_swap", replica=int(rid), version=version)
        self.registry.gauge("fleet.version").set(
            float(version) if isinstance(version, (int, float)) else 0.0)
        return events

    def retire(self, rid, deadline=30.0):
        """Graceful scale-down of one replica: drain + stop its engine,
        return the final serve summary, stop routing to it."""
        info = self._replicas[int(rid)]
        res = self._control(info, "retire", {}, deadline=deadline)
        self.drop_replica(rid)
        self.registry.gauge("fleet.replicas").set(len(self._replicas))
        return res

    # -- telemetry --------------------------------------------------------
    def snapshot(self):
        """Per-replica router view (fleet_top's source + the autoscale
        signal's input): load, suspicion, served counts, versions."""
        now = time.monotonic()
        with self._lock:
            return {
                rid: {"outstanding": info.outstanding,
                      "depth": info.depth,
                      "inflight": info.inflight,
                      "suspect": info.suspect_until > now,
                      "served": info.served,
                      "rerouted_away": info.rerouted_away,
                      "version": info.version,
                      "max_batch": info.max_batch,
                      "breaker": (info.breaker.state
                                  if info.breaker is not None else None),
                      "probing": info.probe_inflight}
                for rid, info in self._replicas.items()}

    def shield_snapshot(self):
        """The shield's own books: budget, sheds, breaker trips, brownout
        fraction — chaos_drill's overload receipts read this."""
        with self._lock:
            breakers = {rid: info.breaker.snapshot()
                        for rid, info in self._replicas.items()
                        if info.breaker is not None}
        disp = self._dispatched
        return {"budget": self.budget.snapshot(),
                "sheds": self._sheds,
                "dispatched": disp,
                "shed_frac": (self._sheds / disp) if disp else 0.0,
                "degraded": self._degraded,
                "replies": self._replies,
                "degraded_frac": ((self._degraded / self._replies)
                                  if self._replies else 0.0),
                "service_ewma_ms": round(self._ewma_ms, 2),
                "breakers": breakers}

    def publish_gauges(self):
        """Registry gauges per replica (the exposition fleet_top reads)."""
        snap = self.snapshot()
        for rid, s in snap.items():
            g = self.registry.gauge
            g("fleet.replica.depth", replica=str(rid)).set(s["depth"])
            g("fleet.replica.outstanding",
              replica=str(rid)).set(s["outstanding"])
            g("fleet.replica.suspect",
              replica=str(rid)).set(1 if s["suspect"] else 0)
            g("fleet.replica.breaker_open", replica=str(rid)).set(
                0 if s["breaker"] in (None, "closed") else 1)
        self.registry.gauge("fleet.replicas").set(len(snap))
        sh = self.shield_snapshot()
        self.registry.gauge("fleet.shed_frac").set(sh["shed_frac"])
        self.registry.gauge("fleet.degraded_frac").set(sh["degraded_frac"])
        self.registry.gauge("fleet.retry_tokens").set(
            sh["budget"]["tokens"])
        return snap
