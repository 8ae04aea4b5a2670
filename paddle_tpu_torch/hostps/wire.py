"""ShardPS wire: a fault-tolerant request-reply channel between fleet
processes.

Counterpart of ``paddle_tpu/hostps/wire.py``, a copy.  Only numpy arrays
and plain Python values travel: a pickled torch tensor (above all a CUDA
one) would start CUDA in the shard owner that unpickles it.

Parity: the reference's pserver transport — ``listen_and_serv_op`` +
``grpc_client.cc`` with FLAGS_rpc_deadline / FLAGS_rpc_retry_times and the
communicator's resend-on-timeout — rebuilt over the ONE medium every rank
of this port already shares and already trusts for its COMMIT protocol,
heartbeats, and preemption agreement: the job's shared filesystem.  A
request is an atomically-published file in the target shard's inbox; the
reply is an atomically-published file in the caller's reply box.  No
sockets to rendezvous, no addresses to rediscover after a respawn — a
shard owner that comes back simply starts draining the same inbox, and the
client's resend loop bridges the gap.

Robustness is the design center, not an afterthought:

- **Per-request deadlines.**  Every request waits at most
  ``PADDLE_TPU_PS_DEADLINE_SECS`` (default 2s) for its reply, then raises
  ``WireTimeout`` — an OSError, exactly the class ft/retry.py absorbs.
- **Jittered-exponential resend.**  ``request()`` resends under the
  ``ps_wire`` retry surface (``ft.retry.attempts{surface="ps_wire"}``; a
  drill gate can assert ``giveups == 0`` on the wire without checkpoint
  retries muddying the count).  An ``alive`` probe (the shard owner's
  heartbeat, distributed/heartbeat.py RankLiveness) is consulted between
  resends: a provably-dead peer raises ``ShardDeadError`` immediately —
  counted as ``ft.retry.aborts``, NOT a giveup — so the router can degrade
  instead of burning the backoff budget against a corpse.
- **Idempotent, de-duplicated mutation.**  Mutating ops carry a per-client
  monotonic sequence number; the server applies each (client, seq) at most
  once and answers duplicates from its reply cache
  (``hostps.wire.dup_dropped``).  A retransmit race, a ``ps_dup`` chaos
  injection, or a recovery replay can never double-apply a push.
- **Chaos-drillable.**  The client compiles in ``ps_drop`` (request never
  sent — the deadline/resend path runs), ``ps_delay`` (slow shard), and
  ``ps_dup`` (duplicate send); the server's dequeue passes
  ``ps_shard_kill`` (SIGKILL mid-request — the lost-shard drill).

Message encoding is pickle (processes of ONE job on ONE trust domain —
the same assumption the checkpoint npz/pickle containers already make);
numpy arrays ride through untouched.
"""

import os
import pickle
import tempfile
import threading
import time

from .. import profiler
from ..ft import chaos as _chaos
from ..ft import retry as _retry
from ..monitor import trace as _trace
from ..monitor import tracemesh as _tmesh
from ..monitor.registry import stat_add

__all__ = ["WireTimeout", "WireRemoteError", "ShardDeadError",
           "ShardRestartedError", "WireClient", "WireServer",
           "default_deadline", "default_poll"]


class WireTimeout(OSError):
    """No reply within the per-request deadline — a TRANSIENT the resend
    loop absorbs (an OSError so ft/retry.py's policy applies)."""


class ShardRestartedError(RuntimeError):
    """The replying server's GENERATION differs from the last one this
    client saw: the owner died and came back (possibly faster than any
    timeout fired — a warm respawn answers in under a second).  The reply
    that revealed it is DISCARDED; the router must resync (replay the
    staleness window past the server's restored sequence floor) and then
    re-issue the request.  Detection by generation, never by timing."""


class WireRemoteError(RuntimeError):
    """The shard's handler raised; the error is re-raised client-side.
    Deliberately NOT retried — the request was delivered and answered.

    ``code`` is the handler exception's machine-readable discriminator
    (``reply["code"]``, from the exception class's own ``code`` attr —
    serving rejections like Backpressure/Shed/Draining declare one); the
    router SWITCHES on it instead of string-matching the message."""

    def __init__(self, msg, code=None):
        super().__init__(msg)
        self.code = code


class ShardDeadError(RuntimeError):
    """The target shard is provably dead (heartbeat gone) — retrying is
    pointless; callers degrade (cache-serve, buffer pushes) and wait for
    the launcher to respawn the owner."""


def default_deadline():
    try:
        return float(os.environ.get("PADDLE_TPU_PS_DEADLINE_SECS", "2.0"))
    except ValueError:
        return 2.0


def default_poll():
    try:
        return float(os.environ.get("PADDLE_TPU_PS_POLL_SECS", "0.002"))
    except ValueError:
        return 0.002


def _delay_secs():
    try:
        return float(os.environ.get("PADDLE_TPU_PS_CHAOS_DELAY_SECS", "0.6"))
    except ValueError:
        return 0.6


def _shard_dir(wire_dir, shard):
    return os.path.join(wire_dir, "shard-%d" % int(shard))


def _inbox_dir(wire_dir, shard):
    return os.path.join(_shard_dir(wire_dir, shard), "inbox")


def _reply_dir(wire_dir, client):
    return os.path.join(wire_dir, "reply", str(client))


def ready_path(wire_dir, shard):
    """The shard owner's serving marker: touched AFTER its table is
    restored, removed on clean stop — launch-time clients wait on it."""
    return os.path.join(_shard_dir(wire_dir, shard), "READY")


def _publish(path, payload):
    """Atomic write: a reader never sees a torn message (tmp + rename on
    one filesystem)."""
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".wire-", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(pickle.dumps(payload, protocol=4))
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def _consume(path):
    """Read-and-delete one published message; None when it vanished (a
    concurrent consumer won the race — only the server consumes its inbox,
    so in practice: a retransmit overwrote it, which is fine)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
        os.remove(path)
    except OSError:
        return None
    try:
        return pickle.loads(data)
    except Exception:
        return None        # torn/alien file: never (atomic publish), skip


class WireClient:
    """One process's client half: sends requests into shard inboxes,
    waits on its own reply box.  Thread-safe (the prefetch daemon and the
    training thread may both issue pulls); request ids are process-unique.
    """

    def __init__(self, wire_dir, client_id, deadline=None, poll=None):
        self.wire_dir = wire_dir
        self.client_id = str(client_id)
        self.deadline = default_deadline() if deadline is None else deadline
        self.poll = default_poll() if poll is None else poll
        self._lock = threading.Lock()
        self._req_counter = 0
        # incarnation token in every request id: a RESPAWNED client keeps
        # its stable client_id (the server's seq dedup depends on it) but
        # restarts the counter — without the token, request #N could
        # consume an orphaned reply file its predecessor's request #N
        # left behind and accept a stale, wrong-op result
        self._boot = "%x-%x" % (os.getpid(),
                                int(time.time() * 1e6) & 0xFFFFFFFFFF)
        # generation tracking is TWO-PHASE: `_gen` holds the committed
        # generation (replies must match it); a mismatch lands in
        # `_pending_gen` and raises until the router finishes the restart
        # replay and calls commit_generation — so a CONCURRENT thread's
        # reply from the restored-but-not-yet-replayed server keeps
        # raising too, instead of being accepted as if nothing happened
        self._gen = {}               # shard -> committed generation
        self._pending_gen = {}       # shard -> observed-but-unreplayed gen
        self._sweep_seen = {}        # reply file -> first-seen monotonic
        os.makedirs(_reply_dir(wire_dir, self.client_id), exist_ok=True)

    def _next_req_id(self):
        with self._lock:
            self._req_counter += 1
            n = self._req_counter
        if n % 64 == 0:
            self._sweep_replies()
        return "%s.%s-%010d" % (self.client_id, self._boot, n)

    def _sweep_replies(self):
        """Aging sweep of this client's reply box: a reply that lands
        AFTER its request was abandoned (final timeout) or after its twin
        was already consumed (a resend answered twice) is an orphan
        nothing will ever read — without a sweep a long chaos-heavy run
        grows the directory without bound on the shared mount.

        Aging is by THIS process's monotonic clock across two sweeps (a
        file still present a full horizon after it was first seen is an
        orphan — any live waiter consumes within one deadline), never by
        comparing a local clock against shared-fs mtimes (the repo-wide
        heartbeat discipline: cross-host mtime ages lie)."""
        horizon = max(10 * self.deadline, 60.0)
        d = _reply_dir(self.wire_dir, self.client_id)
        try:
            names = set(os.listdir(d))
        except OSError:
            return
        now = time.monotonic()
        with self._lock:
            for stale in set(self._sweep_seen) - names:
                del self._sweep_seen[stale]           # consumed since
            doomed = []
            for name in names:
                first = self._sweep_seen.setdefault(name, now)
                if now - first > horizon:
                    doomed.append(name)
                    del self._sweep_seen[name]
        for name in doomed:
            try:
                os.remove(os.path.join(d, name))
            except OSError:
                pass

    # -- generation bookkeeping (restart detection) -----------------------
    def generation_stale(self, shard):
        """True while a restart has been OBSERVED but its replay not yet
        committed (the router's resync decides whether it still owes a
        replay after taking the recovery lock)."""
        with self._lock:
            return int(shard) in self._pending_gen

    def commit_generation(self, shard):
        """Adopt the pending generation — called by the router AFTER the
        staleness-window replay completes, at which point the restarted
        server's replies are trustworthy again."""
        with self._lock:
            pg = self._pending_gen.pop(int(shard), None)
            if pg is not None:
                self._gen[int(shard)] = pg

    def _send(self, shard, req_id, record):
        """One physical send, through the chaos points.  All three point
        counters tick on EVERY send (decided up front), so a fired drop
        cannot desync the dup/delay hit numbering — drills arm exact send
        numbers."""
        path = os.path.join(_inbox_dir(self.wire_dir, shard),
                            req_id + ".msg")
        delay = _chaos.maybe_fire("ps_delay")
        drop = _chaos.maybe_fire("ps_drop")
        dup = _chaos.maybe_fire("ps_dup")
        if delay:
            time.sleep(_delay_secs())     # a slow shard's network leg
        if drop:
            stat_add("hostps.wire.dropped")
            return                        # lost on the wire: deadline fires
        _publish(path, record)
        if dup:
            # a retransmit race: same seq, second file — the server's
            # idempotent dedup must apply it once
            _publish(os.path.join(_inbox_dir(self.wire_dir, shard),
                                  req_id + "-dup.msg"), record)
            stat_add("hostps.wire.dup_sent")

    def _await_reply(self, req_id, deadline):
        path = os.path.join(_reply_dir(self.wire_dir, self.client_id),
                            req_id + ".msg")
        limit = time.monotonic() + deadline
        while True:
            if os.path.exists(path):
                rec = _consume(path)
                if rec is not None:
                    return rec
            if time.monotonic() >= limit:
                raise WireTimeout(
                    "ps wire: no reply to %s within %.2fs"
                    % (req_id, deadline))
            time.sleep(self.poll)

    def request(self, shard, op, payload=None, seq=None, attempts=None,
                deadline=None, alive=None, probe=False,
                accept_restart=False, expires=None):
        """Send ``op`` to ``shard`` and return the handler's result.

        ``seq`` marks the request MUTATING (server-side applied at most
        once per (client, seq); resends answered from the reply cache).
        ``alive`` (callable -> bool): liveness probe consulted after every
        timeout — False raises ShardDeadError (``ft.retry.aborts``, no
        giveup).  Exhausting ``attempts`` with a live peer counts ONE
        ``ft.retry.giveups{surface="ps_wire"}`` and re-raises WireTimeout —
        unless ``probe=True`` (an is-it-back-yet poll, EXPECTED to fail:
        no retry bookkeeping at all).

        ``expires`` (absolute ``time.time()`` wall seconds) is DEADLINE
        PROPAGATION: it rides the record — built once, so every retransmit
        carries it — and the server fast-fails a request it dequeues after
        that instant with a typed ``code="deadline"`` reply, WITHOUT
        executing the handler (a queued request whose client already gave
        up must not burn a lattice slot)."""
        n = attempts if attempts is not None else _retry.default_attempts()
        deadline = self.deadline if deadline is None else deadline
        req_id = self._next_req_id()
        record = {"op": op, "payload": payload, "client": self.client_id,
                  "seq": seq, "req": req_id}
        if expires is not None:
            record["expires"] = float(expires)
        # trace context rides the RECORD, which is built once before the
        # resend loop: retransmits share one client span and one context
        # (the server's seq dedup already guarantees one application, so
        # the mesh sees one client span -> one applied server span, no
        # duplicates by construction).  Disabled path: one global read.
        sp = _trace.null_span()
        tctx = None
        if _trace.active_tracer() is not None:
            ctx, targs = _tmesh.link(_tmesh.current())
            tctx = _tmesh.wire_context(ctx, time.time())
            record["tctx"] = tctx
            targs["op"] = str(op)
            targs["shard"] = int(shard)
            sp = _trace.span("hostps.wire.request", **targs)
        # the with-block closes the span on EVERY raise path (timeout
        # giveup, dead shard, generation bump, remote error) — a wire
        # fault can abandon a request but never orphan its span
        with sp:
            t0 = time.perf_counter()
            try:
                for k in range(n):
                    try:
                        self._send(shard, req_id, record)
                        reply = self._await_reply(req_id, deadline)
                        break
                    except WireTimeout:
                        if alive is not None and not alive():
                            _retry.count_abort("ps_wire")
                            stat_add("hostps.wire.dead_detected")
                            raise ShardDeadError(
                                "ps wire: shard %d is not heartbeating; "
                                "degrading instead of retrying" % shard)
                        if k == n - 1:
                            # abandoned: a reply landing later is an
                            # orphan — drop it now if it arrived late
                            try:
                                os.remove(os.path.join(
                                    _reply_dir(self.wire_dir,
                                               self.client_id),
                                    req_id + ".msg"))
                            except OSError:
                                pass
                            if not probe:
                                _retry.count_giveup("ps_wire")
                            raise
                        if not probe:
                            _retry.count_attempt("ps_wire",
                                                 what="ps %s" % op)
            finally:
                profiler.observe("hostps.wire.request_ms",
                                 (time.perf_counter() - t0) * 1e3)
            if tctx is not None:
                pair = _tmesh.clock_pair(tctx, reply.get("tctx"),
                                         time.time())
                if pair is not None:
                    sp.add(tm_clock=pair)
            # generation check FIRST: a restarted owner may answer this
            # very request from a rolled-back state (warm respawns beat
            # every timeout) — the router must replay the staleness window
            # before trusting ANY reply, including this one.  The
            # committed gen is NOT advanced here (two-phase:
            # commit_generation after the replay), so concurrent threads'
            # replies keep raising instead of slipping rolled-back values
            # through mid-replay.
            gen = reply.get("gen")
            if gen is not None:
                with self._lock:
                    prev = self._gen.get(int(shard))
                    if prev is None:
                        self._gen[int(shard)] = gen       # first contact
                    elif gen != prev:
                        self._pending_gen[int(shard)] = gen
                if prev is not None and gen != prev and not accept_restart:
                    stat_add("hostps.wire.restart_detected")
                    raise ShardRestartedError(
                        "ps wire: shard %d restarted (generation %s -> "
                        "%s); resync before accepting replies"
                        % (shard, prev, gen))
            if reply.get("duplicate"):
                stat_add("hostps.wire.dup_acked")
            if not reply.get("ok"):
                raise WireRemoteError(
                    "ps wire: shard %d failed %r: %s"
                    % (shard, op, reply.get("error")),
                    code=reply.get("code"))
            return reply.get("result")


class WireServer:
    """One shard owner's server half: drains its inbox on a daemon thread,
    dispatches to ``handler(op, payload, client)``, publishes replies.

    Mutating requests (``seq`` set) are idempotent: the server tracks the
    last applied seq per client (plus that reply), drops stale/duplicate
    seqs (``hostps.wire.dup_dropped``) and re-answers them — the dedup
    table is part of the shard's checkpointed state (``seq_state``) so a
    respawned owner restored from the last committed checkpoint still
    refuses the replays it already holds.

    ``workers > 1`` dispatches dequeued requests on a thread pool instead
    of inline — the serving-replica shape, where a handler BLOCKS on the
    engine's continuous-batching future and N requests must ride the same
    step.  Seq'd requests are the exception: they always dispatch inline
    on the single drain thread, pooled or not, because ordered per-client
    seq application (read-dedup-then-handle-then-record) is only safe
    serialized — so a fleet replica's control ops (swap/retire) keep the
    at-most-once contract while its data plane overlaps on the workers.
    Pooled servers also suppress a retransmit of a request still being
    handled (same req id — the original's reply answers the waiting
    client) instead of handling it twice (``hostps.wire.inflight_dup``)."""

    def __init__(self, wire_dir, shard, handler, poll=None, workers=None):
        self.wire_dir = wire_dir
        self.shard = int(shard)
        self.handler = handler
        self.poll = default_poll() if poll is None else poll
        self.workers = max(int(workers or 1), 1)
        # incarnation id, carried on every reply: clients detect a respawn
        # by generation change, never by timing (see ShardRestartedError)
        self.generation = "%d-%.6f" % (os.getpid(), time.time())
        self._applied = {}          # client -> (last_seq, last_result)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._pool = []
        self._work = None           # queue.Queue when the pool is live
        self._inflight_reqs = set()  # req ids a pool worker is handling
        os.makedirs(_inbox_dir(wire_dir, self.shard), exist_ok=True)

    # -- dedup state (rides the shard checkpoint) -------------------------
    def seq_state(self):
        with self._lock:
            return {c: int(s) for c, (s, _r) in self._applied.items()}

    def load_seq_state(self, state):
        with self._lock:
            self._applied = {str(c): (int(s), None)
                             for c, s in (state or {}).items()}

    def last_seq(self, client):
        with self._lock:
            return self._applied.get(str(client), (0, None))[0]

    # -- serving ----------------------------------------------------------
    def mark_ready(self):
        with open(ready_path(self.wire_dir, self.shard), "w") as f:
            f.write("%d" % os.getpid())

    def clear_ready(self):
        try:
            os.remove(ready_path(self.wire_dir, self.shard))
        except OSError:
            pass

    def start(self):
        self._stop.clear()
        if self.workers > 1 and not self._pool:
            import queue as _queue

            self._work = _queue.Queue()
            for i in range(self.workers):
                t = threading.Thread(
                    target=self._worker, daemon=True,
                    name="ps-wire-shard-%d-w%d" % (self.shard, i))
                t.start()
                self._pool.append(t)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ps-wire-shard-%d" % self.shard)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._work is not None:
            for _ in self._pool:
                self._work.put(None)
            for t in self._pool:
                t.join(timeout=5)
            self._pool = []
            self._work = None
        self.clear_ready()

    def _run(self):
        while not self._stop.is_set():
            try:
                if not self.serve_once():
                    time.sleep(self.poll)
            except Exception:
                # a poisoned request must not kill the serve loop; the
                # client sees its deadline and resends
                time.sleep(self.poll)

    def serve_once(self):
        """Drain everything currently in the inbox; True when any request
        was handled (the idle loop sleeps otherwise)."""
        inbox = _inbox_dir(self.wire_dir, self.shard)
        try:
            names = sorted(n for n in os.listdir(inbox)
                           if n.endswith(".msg"))
        except OSError:
            return False
        handled = False
        for name in names:
            rec = _consume(os.path.join(inbox, name))
            if rec is None:
                continue
            handled = True
            # the lost-shard drill point: death mid-request, after the
            # message left the inbox — exactly the worst moment
            _chaos.maybe_fire("ps_shard_kill")
            if self._work is None:
                self._dispatch(rec)
                continue
            if rec.get("seq") is not None:
                # seq'd (mutating/control) ops NEVER ride the pool: the
                # dedup table is read-before-handle and written after, so
                # two concurrent seq'd requests on workers could both see
                # a stale last-seq and one would get a spurious "seq gap"
                # refusal.  Inline dispatch on this single drain thread
                # keeps the ordered per-client application the seq
                # contract promises, at pool size 1+ alike; data-plane
                # (unseq'd) requests still overlap on the workers.
                self._dispatch(rec)
                continue
            # pooled dispatch: a retransmit of a request STILL in flight on
            # a worker is dropped here (same req id — the original's reply
            # answers the waiting client; handling it twice would double
            # the engine work for nothing)
            rid = rec.get("req")
            with self._lock:
                if rid in self._inflight_reqs:
                    stat_add("hostps.wire.inflight_dup")
                    continue
                self._inflight_reqs.add(rid)
            self._work.put(rec)
        return handled

    def _worker(self):
        while True:
            rec = self._work.get()
            if rec is None:
                return
            try:
                self._dispatch(rec)
            except Exception:
                pass      # client's deadline + resend covers a lost reply
            finally:
                with self._lock:
                    self._inflight_reqs.discard(rec.get("req"))

    def _dispatch(self, rec):
        # recv wall-clock stamped FIRST: it is the clock pair's t1, and
        # queueing inside the handler must not inflate the skew bound
        t_recv = time.time() if rec.get("tctx") is not None else None
        client, seq = rec.get("client"), rec.get("seq")
        expires = rec.get("expires")
        if expires is not None and seq is None and time.time() > expires:
            # deadline propagation's server half: the client gave up while
            # this request sat in the inbox (or the pool queue) — answer a
            # typed expiry and NEVER run the handler.  Retransmits carry
            # the same ``expires`` (the record is built once), so a resend
            # of an expired request can never execute either.  Seq'd ops
            # are exempt: skipping one would open a permanent seq gap.
            stat_add("hostps.wire.expired")
            self._reply(rec, {"ok": False, "code": "deadline",
                              "error": "DeadlineExceeded: request %s "
                                       "expired %.0fms before dispatch"
                                       % (rec.get("req"),
                                          (time.time() - expires) * 1e3)},
                        t_recv=t_recv)
            return
        if seq is not None:
            with self._lock:
                last, last_result = self._applied.get(client, (0, None))
            if int(seq) <= last:
                stat_add("hostps.wire.dup_dropped")
                # a retransmit answered from the reply cache opens NO
                # second server span — the mesh records an instant so the
                # merged trace shows the dedup, not a phantom application
                _trace.instant("hostps.wire.dup", client=str(client),
                               seq=int(seq))
                self._reply(rec, {"ok": True, "duplicate": True,
                                  "result": last_result}, t_recv=t_recv)
                return
            if int(seq) > last + 1:
                # ORDERED application per client: a seq gap means earlier
                # pushes are still owed (e.g. a respawned owner drained a
                # stale pre-death inbox file before the client's recovery
                # replay ran) — applying out of order would let a replay
                # be dup-dropped and an update vanish.  Refuse; the
                # client's in-order replay/resend closes the gap.
                stat_add("hostps.wire.out_of_order")
                self._reply(rec, {"ok": False, "code": "seq_gap",
                                  "error": "seq gap: got %d, expected %d"
                                           % (int(seq), last + 1)},
                            t_recv=t_recv)
                return
        sp = _trace.null_span()
        if t_recv is not None and _trace.active_tracer() is not None:
            tc = rec["tctx"]
            _ctx, targs = _tmesh.link((tc.get("tid"), tc.get("sid")))
            targs["op"] = str(rec.get("op"))
            targs["client"] = str(client)
            sp = _trace.span("hostps.wire.serve", **targs)
        try:
            with sp:
                result = self.handler(rec.get("op"), rec.get("payload"),
                                      client)
            reply = {"ok": True, "result": result}
        except Exception as e:
            # the typed-code contract: an exception class that declares a
            # stable ``code`` (serving rejections: backpressure/queue_full/
            # shed/draining/deadline...) ships it machine-readable next to
            # the human text; WireRemoteError re-raises it client-side
            reply = {"ok": False,
                     "error": "%s: %s" % (type(e).__name__, e),
                     "code": getattr(type(e), "code", None)}
        if seq is not None and reply["ok"]:
            with self._lock:
                self._applied[client] = (int(seq), reply.get("result"))
        stat_add("hostps.wire.served", op=str(rec.get("op")))
        self._reply(rec, reply, t_recv=t_recv)

    def _reply(self, rec, reply, t_recv=None):
        reply.setdefault("gen", self.generation)
        # clock echo on EVERY reply path (ok/error/duplicate): the pair
        # only needs the server's recv/send walls, not a handled request
        tctx = rec.get("tctx")
        if tctx is not None:
            reply.setdefault("tctx", _tmesh.wire_echo(
                tctx, t_recv if t_recv is not None else time.time(),
                time.time()))
        try:
            _publish(os.path.join(_reply_dir(self.wire_dir, rec["client"]),
                                  rec["req"] + ".msg"), reply)
        except OSError:
            pass      # client's deadline + resend covers a failed reply
