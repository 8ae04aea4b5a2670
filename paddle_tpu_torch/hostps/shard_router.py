"""ShardPS: the live HostPS table, runtime-sharded across fleet processes.

Counterpart of ``paddle_tpu/hostps/shard_router.py``, a copy.  Shard
owners are host-RAM servers and touch no CUDA; a process that holds CUDA
state starts them with ``subprocess`` (a fresh interpreter), never
``fork``.

Parity: the Downpour/PSLib split (``distribute_transpiler`` row-sharding a
table over pservers, ``listen_and_serv`` on the owner, the FleetWrapper
client routing every pull/push by row block).  The elastic checkpoint
makes the row partition (``parallel/rules.hostps_row_range``) a
CHECKPOINT-time concept — savers
wrote their row shard, ``restore_resharded`` reassembled any topology.
This module promotes it to a RUNTIME one:

- each fleet process owns ``hostps_row_range(rank, world, vocab)`` of the
  live table (a ``HostSparseTable(row_range=...)`` — out-of-shard ids now
  raise instead of silently minting rogue replicas);
- a ``ShardServer`` serves the owned rows over the fault-tolerant wire
  (hostps/wire.py): pull / idempotent sequence-numbered push / snapshot /
  adopt / evict / restore;
- a ``ShardRouter`` is the client: a TABLE-SHAPED facade (pull/push/
  snapshot/restore...) that ``HostPSEmbedding`` consumes unchanged — the
  whole HostPS pipeline (hot-row device cache, prefetch double-buffering,
  ``push_in_jit(merge=True)`` device-side dedup) now fronts a table whose
  rows live in other processes' RAM.

Robustness model (the headline):

- **sync apply** (``staleness=0``): every push waits for the owner's ack —
  bit-identical to a single-host HostPS table (the loss-parity gate);
- **GEO bounded-staleness async apply** (``staleness=K``): pushes stream
  from a per-shard sender thread; the trainer blocks only when more than K
  pushes are unacked — the GEO-SGD trade (arXiv:1404.5086 bounded-delay
  async) with the bound enforced, drilled by the staleness-vs-sync
  convergence test;
- **dead-shard degradation**: when the wire times out AND the owner's
  heartbeat is gone (distributed/heartbeat.RankLiveness), the shard is
  marked dead — NOT a retry giveup.  The HBM hot-row cache keeps serving
  its rows read-only; pushes to the dead shard are buffered in the replay
  log; a pull that MISSES the cache blocks (``ps_wait``-attributed,
  bounded by ``PADDLE_TPU_PS_DEAD_WAIT_SECS``) until the launcher respawns
  the owner — which restores its row range from the last committed
  checkpoint (``restore_resharded``) and the router replays the staleness
  window (every logged push past the owner's restored sequence number,
  de-duplicated server-side) before the pull proceeds.  Exactness is
  preserved end to end; ``degraded_reads="init"`` instead serves the
  deterministic row initializer for cold rows without blocking (best-
  effort mode for serving replicas);
- **live repartition**: ``absorb()`` moves a shard's rows into the local
  table at runtime (elastic shrink of the LIVE table, not just the
  checkpoint); ``repartition_tables`` re-balances in-process tables across
  any N -> M world change via the same snapshot/adopt/evict primitives.

Every wire wait on the training thread is attributed to the FleetScope
``ps_wait`` phase, so a slow or dead shard is *named* in trace_summary /
fleet_top instead of just felt.
"""

import collections
import os
import threading
import time
import warnings
import weakref

import numpy as np

from .. import profiler
from ..ft import retry as _retry
from ..monitor.registry import stat_add
from ..parallel.rules import hostps_row_ranges
from .service import HostPSEmbedding
from .table import HostSparseTable
from . import wire as _wire

__all__ = ["ShardServer", "ShardRouter", "ShardedHostPSEmbedding",
           "WireGiveUp", "repartition_tables", "note_shard_owned_bytes"]

# live routers, weakly held: MemScope's host-side accounting sums their
# replay-log bytes (the staleness window is real RAM a dead shard grows)
_LIVE_ROUTERS = weakref.WeakSet()


def note_shard_owned_bytes(shard, table, budget_bytes=None):
    """The LIVE half of the shard table budget: publish this owner's
    current owned-row footprint as ``hostps.shard.owned_bytes{shard=}``
    and, when a ``budget_bytes`` is declared, WARN (+ count) the moment a
    live repartition (``adopt_rows``/``absorb``/``set_row_range``) pushes
    it past the budget that passed at construction — a repartition must
    never silently blow a budget the startup assert blessed.  Returns the
    owned bytes."""
    lo, hi = table.row_range if table.row_range is not None \
        else (0, table.vocab_size)
    owned = (hi - lo) * table.dim * table.dtype.itemsize
    try:
        from ..monitor.registry import default_registry

        default_registry().gauge("hostps.shard.owned_bytes",
                                 shard=str(shard)).set(owned)
    except Exception:
        pass
    if budget_bytes is not None and owned > int(budget_bytes):
        stat_add("hostps.shard.budget_exceeded")
        _emit("ps_budget_exceeded", shard=int(shard), owned_bytes=owned,
              budget_bytes=int(budget_bytes), rows=[int(lo), int(hi)])
        warnings.warn(
            "hostps shard %s: owned rows [%d, %d) now need %d bytes but "
            "the per-process table budget is %d — a live repartition blew "
            "a budget that passed at startup; shard over more processes"
            % (shard, lo, hi, owned, int(budget_bytes)), stacklevel=2)
    return owned


class WireGiveUp(OSError):
    """A dead shard stayed dead past PADDLE_TPU_PS_DEAD_WAIT_SECS — the
    bounded end of graceful degradation (the alternative is wedging)."""


def _dead_wait_secs():
    try:
        return float(os.environ.get("PADDLE_TPU_PS_DEAD_WAIT_SECS", "120"))
    except ValueError:
        return 120.0


def _hb_timeout():
    try:
        return float(os.environ.get("PADDLE_TPU_PS_HB_TIMEOUT", "5.0"))
    except ValueError:
        return 5.0


def _emit(ev, **kw):
    """Timeline evidence (ps_degraded / ps_recovered / ps_repartition) —
    best-effort, never on the failure path's critical section."""
    try:
        from ..monitor import session as _session

        mon = _session.active()
        if mon is not None:
            mon.timeline.emit(ev, **kw)
    except Exception:
        pass


def _phase_add(name, ms):
    try:
        from ..monitor import session as _session

        _session.phase_add(name, ms)
    except Exception:
        pass


# ---------------------------------------------------------------- server --

class ShardServer:
    """One process's shard-owner half: a ``HostSparseTable(row_range=)``
    behind the wire.  ``budget_bytes`` asserts the beyond-one-host premise:
    this process must only ever hold its own row range (the drill configs
    set a budget below the FULL table's footprint)."""

    def __init__(self, table, wire_dir, shard, ckpt_dir=None,
                 budget_bytes=None, poll=None):
        if not isinstance(table, HostSparseTable):
            raise TypeError("ShardServer serves a HostSparseTable")
        self.table = table
        self.wire_dir = wire_dir
        self.shard = int(shard)
        self.ckpt_dir = ckpt_dir
        lo, hi = table.row_range if table.row_range is not None \
            else (0, table.vocab_size)
        self.budget_bytes = None if budget_bytes is None \
            else int(budget_bytes)
        # ONE owned-bytes formula (note_shard_owned_bytes) for the startup
        # assert, the live gauge, and the repartition re-checks below —
        # at construction the over-budget case is a hard raise, not a warn
        owned = note_shard_owned_bytes(self.shard, table, None)
        if self.budget_bytes is not None and owned > self.budget_bytes:
            raise ValueError(
                "ShardServer %d: owned rows [%d, %d) need %d bytes but "
                "the per-process table budget is %d — shard over more "
                "processes" % (self.shard, lo, hi, owned,
                               self.budget_bytes))
        self._shutdown = threading.Event()
        self.server = _wire.WireServer(wire_dir, self.shard, self._handle,
                                       poll=poll)

    # -- lifecycle --------------------------------------------------------
    def start(self, restore=True):
        """Restore the owned row range from the last committed checkpoint
        (a respawned owner picks up exactly where the fleet's last COMMIT
        left it — the staleness window since then is the CLIENTS' replay
        log's job), then serve.  READY is marked only after the restore so
        clients never read pre-restore state."""
        if restore and self.ckpt_dir:
            self.restore_latest()
        self.server.start()
        self.server.mark_ready()
        return self

    def stop(self):
        self.server.stop()

    def serve_until_shutdown(self, poll=0.05):
        """Block until a ``shutdown`` op arrives (the drill's PS-role main
        thread)."""
        while not self._shutdown.wait(poll):
            pass
        self.stop()

    def restore_latest(self):
        """``restore_resharded`` from the newest committed ckpt under
        ``ckpt_dir`` (saver dirs read from the loaded manifests, never a
        glob: an unindexed leftover is not part of the checkpoint), plus
        this shard's wire dedup table from the snapshot meta, so pre-death
        pushes replayed by a client are recognized and dropped."""
        from ..parallel import checkpoint as _base

        path = _base.latest_checkpoint(str(self.ckpt_dir))
        if path is None:
            return None
        indexes = _base._load_indexes(path)
        dirs = []
        for r in sorted(int(i.get("process", 0)) for i in indexes):
            d = os.path.join(path, "hostps", "p%d" % r)
            if os.path.isdir(d):
                dirs.append(d)
        if not dirs:
            return None
        _retry.io_retry(self.table.restore_resharded, dirs, self.table.name,
                        what="hostps shard respawn",
                        surface="hostps_shard")
        self.server.load_seq_state(self._seqs_from(dirs))
        stat_add("hostps.wire.shard_restores")
        return path

    def _seqs_from(self, dirs):
        from .. import io as _io

        for d in dirs:
            try:
                meta = _io.load_sparse_meta(d, self.table.name)["meta"]
            except OSError:
                continue
            seqs = (meta.get("wire_seqs") or {}).get(str(self.shard))
            if seqs:
                return seqs
        return {}

    # -- ops --------------------------------------------------------------
    def _handle(self, op, payload, client):
        payload = payload or {}
        t = self.table
        if op == "pull":
            # ``read_only``: a serving view's pull (serving/fleet.py
            # FleetCTRView) leaves cold rows unwritten
            return {"values": t.pull(np.asarray(payload["rows"], np.int64),
                                     materialize=not payload.get(
                                         "read_only"))}
        if op == "push":
            r, new = t.push(np.asarray(payload["rows"], np.int64),
                            np.asarray(payload["values"], np.float32),
                            float(payload["lr"]))
            return {"rows": r, "new": new}
        if op == "seq":
            return {"last_seq": self.server.last_seq(client),
                    "shard": self.shard}
        if op == "snapshot":
            rows, arrays, meta = t.snapshot(payload.get("lo"),
                                            payload.get("hi"))
            return {"rows": rows, "arrays": arrays, "meta": meta,
                    "seqs": self.server.seq_state()}
        if op == "adopt":
            if payload.get("row_range") is not None:
                t.set_row_range(tuple(payload["row_range"]))
            n = t.adopt_rows(np.asarray(payload["rows"], np.int64),
                             payload["arrays"])
            # live budget re-check: an adopt that widened the row range
            # must update the owned-bytes gauge and warn past the budget
            note_shard_owned_bytes(self.shard, t, self.budget_bytes)
            return {"adopted": n}
        if op == "evict":
            rows = t.evict_rows(int(payload["lo"]), int(payload["hi"]))
            note_shard_owned_bytes(self.shard, t, self.budget_bytes)
            return {"evicted": int(rows.size)}
        if op == "set_range":
            t.set_row_range(payload.get("row_range"))
            note_shard_owned_bytes(self.shard, t, self.budget_bytes)
            return {"ok": True}
        if op == "restore":
            _retry.io_retry(t.restore_resharded,
                            [str(d) for d in payload["dirs"]],
                            payload.get("name") or t.name,
                            what="hostps restore op",
                            surface="hostps_shard")
            self.server.load_seq_state(
                self._seqs_from([str(d) for d in payload["dirs"]]))
            return {"last_seq": self.server.last_seq(client)}
        if op == "shutdown":
            self._shutdown.set()
            return {"ok": True}
        raise ValueError("ShardServer: unknown op %r" % (op,))


# ---------------------------------------------------------------- router --

class _ShardState:
    """Per-remote-shard client state: route bounds, liveness, sequence
    counter, replay log, async in-flight accounting."""

    def __init__(self, shard, lo, hi, liveness):
        self.shard = int(shard)
        self.lo, self.hi = int(lo), int(hi)
        self.liveness = liveness
        self.dead = False
        self.next_seq = 1
        self.log = collections.deque()       # (seq, rows, values, lr)
        self.prev_snapshot_seq = 0           # prune floor (one ckpt lag)
        self.queue = collections.deque()     # async: entries awaiting send
        self.outstanding = 0                 # async: sent, unacked
        self.async_error = None              # sender failure, re-raised
        self.cond = threading.Condition()
        self.recover_lock = threading.Lock()
        self.worker = None


class ShardRouter:
    """Client-side router with a HostSparseTable-shaped surface, so
    ``HostPSEmbedding`` (cache, prefetch, push_in_jit) fronts it unchanged.

    ``local_table`` holds THIS process's row range and is served in-process
    (the loopback shard); every other range goes over the wire.  With
    ``world == 1`` the router degenerates to a pass-through around the
    local table."""

    _table_like = True

    def __init__(self, local_table, world=1, rank=0, wire_dir=None,
                 client_id=None, staleness=None, hb_dir=None,
                 hb_timeout=None, dead_wait_secs=None,
                 degraded_reads="block", name=None, budget_bytes=None):
        if not isinstance(local_table, HostSparseTable):
            raise TypeError("ShardRouter routes around a HostSparseTable")
        self.local_table = local_table
        self.budget_bytes = None if budget_bytes is None \
            else int(budget_bytes)
        self.vocab_size = local_table.vocab_size
        self.dim = local_table.dim
        self.dtype = local_table.dtype
        self.name = name or local_table.name
        self.initializer = local_table.initializer
        self.world = int(world)
        self.rank = int(rank)
        self.ranges = hostps_row_ranges(self.world, self.vocab_size)
        self._los = np.asarray([lo for lo, _ in self.ranges], np.int64)
        if staleness is None:
            try:
                staleness = int(os.environ.get("PADDLE_TPU_PS_STALENESS",
                                               "0"))
            except ValueError:
                staleness = 0
        self.staleness = int(staleness)
        self.degraded_reads = degraded_reads
        if degraded_reads not in ("block", "init"):
            raise ValueError("degraded_reads must be 'block' or 'init'")
        self.dead_wait_secs = (_dead_wait_secs() if dead_wait_secs is None
                               else float(dead_wait_secs))
        # validate the local table against THE partition
        want = self.ranges[self.rank]
        have = local_table.row_range or (0, self.vocab_size)
        if self.world > 1 and tuple(have) != tuple(want):
            raise ValueError(
                "ShardRouter rank %d/%d: local table owns %s but "
                "hostps_row_range says %s — build the local shard from the "
                "sharding authority" % (self.rank, self.world,
                                        tuple(have), tuple(want)))
        self.wire = None
        self._shards = {}
        self._pos_to_state = {}
        if self.world > 1:
            if wire_dir is None:
                raise ValueError("ShardRouter needs wire_dir for world > 1")
            cid = client_id or ("r%d-%d" % (self.rank, os.getpid()))
            self.wire = _wire.WireClient(wire_dir, cid)
            timeout = _hb_timeout() if hb_timeout is None else hb_timeout
            # per-op resend budget: the content-change liveness verdict
            # needs ~hb_timeout of observation from the FIRST failed
            # attempt — a budget shorter than that would count a giveup
            # on a dead peer before the heartbeat can prove it dead
            self._attempts = max(
                _retry.default_attempts(),
                int(timeout / max(self.wire.deadline, 1e-3)) + 3)
            for s, (lo, hi) in enumerate(self.ranges):
                if s == self.rank:
                    continue
                liveness = None
                if hb_dir is not None:
                    from ..distributed.heartbeat import RankLiveness

                    liveness = RankLiveness(hb_dir, s, timeout=timeout)
                self._shards[s] = _ShardState(s, lo, hi, liveness)
            self._pos_to_state = dict(self._shards)
        # pushed-but-unconfirmed rows the embedding must drop from its
        # cache (async pushes, buffered-while-dead pushes): take_stale_rows
        self._stale = []
        # cacheability of the CALLING THREAD's last pull (the service
        # layer reads it right after its table.pull on the same thread);
        # thread-local, so a concurrent prefetch pull serving degraded
        # initializer values can never launder them into the exact cache
        # through another thread's True
        self._tls = threading.local()
        self.on_recover = None      # set by ShardedHostPSEmbedding
        # live owned-bytes gauge for the LOCAL shard (re-checked on absorb)
        note_shard_owned_bytes(self.rank, local_table, self.budget_bytes)
        _LIVE_ROUTERS.add(self)     # MemScope replay-log accounting

    @property
    def last_pull_cacheable(self):
        return getattr(self._tls, "cacheable", True)

    # -- wiring -----------------------------------------------------------
    def connect(self, timeout=60.0):
        """Wait for every remote owner's READY marker and adopt its applied
        sequence floor (a reconnecting client must never reuse a seq the
        server already holds).  Bounded; raises WireGiveUp past timeout."""
        deadline = time.monotonic() + timeout
        for st in self._shards.values():
            rp = _wire.ready_path(self.wire.wire_dir, st.shard)
            while not os.path.exists(rp):
                if time.monotonic() >= deadline:
                    raise WireGiveUp(
                        "ShardRouter: shard %d never became READY within "
                        "%.0fs" % (st.shard, timeout))
                time.sleep(0.05)
            res = self.wire.request(st.shard, "seq", {})
            with st.cond:
                st.next_seq = int(res["last_seq"]) + 1
                st.prev_snapshot_seq = int(res["last_seq"])
        return self

    def _alive(self, st):
        return st.liveness.alive() if st.liveness is not None else True

    def _account_wait(self, secs):
        if secs <= 0:
            return
        profiler.observe("hostps.wire.wait_ms", secs * 1e3)
        if threading.current_thread() is threading.main_thread():
            _phase_add("ps_wait", secs * 1e3)

    # -- degradation / recovery -------------------------------------------
    def _mark_dead(self, st):
        with st.cond:
            if st.dead:
                return
            st.dead = True
        stat_add("hostps.wire.shard_dead_transitions")
        try:
            from ..monitor.registry import default_registry

            default_registry().gauge("hostps.wire.shard_dead",
                                     shard=str(st.shard)).set(1)
        except Exception:
            pass
        _emit("ps_degraded", shard=st.shard, rows=[st.lo, st.hi],
              buffered=len(st.queue))

    def _await_recovery(self, st):
        """Block (bounded) until the dead owner serves again, replay the
        staleness window (logged pushes past the owner's restored seq),
        then clear the dead mark.  Every exact read of a dead shard funnels
        here — the ``ps_wait`` stall a named straggler is made of."""
        stat_add("hostps.wire.dead_waits")
        deadline = time.monotonic() + self.dead_wait_secs
        ready = _wire.ready_path(self.wire.wire_dir, st.shard)
        while True:
            with st.cond:
                if not st.dead:
                    return
            # budget check FIRST: a flapping owner (READY + heartbeating
            # but its replay keeps failing -> continue) must still hit
            # the bounded end of degradation, not wedge forever
            if time.monotonic() >= deadline:
                _retry.count_giveup("ps_wire")
                raise WireGiveUp(
                    "ShardRouter: shard %d stayed dead for %.0fs (budget "
                    "PADDLE_TPU_PS_DEAD_WAIT_SECS)"
                    % (st.shard, self.dead_wait_secs))
            if os.path.exists(ready) and self._alive(st):
                with st.recover_lock:
                    with st.cond:
                        if not st.dead:
                            return
                    try:
                        res = self.wire.request(st.shard, "seq", {},
                                                attempts=1, probe=True,
                                                accept_restart=True)
                    except OSError:
                        res = None
                    if res is not None:
                        # the replay drains the log AND flips dead->alive
                        # atomically with its final empty-check (no push
                        # can be buffered-but-never-replayed in between).
                        # The owner dying AGAIN mid-replay re-enters this
                        # wait loop instead of crashing the caller — that
                        # is the degradation contract (st.dead stays
                        # True); only the budget (WireGiveUp) and a
                        # replay-log gap (RuntimeError) are loud exits.
                        try:
                            self._replay(st, int(res["last_seq"]),
                                         clear_dead=True)
                        except (_wire.ShardDeadError,
                                _wire.ShardRestartedError,
                                _wire.WireRemoteError, OSError):
                            # incl. a THIRD incarnation's seq-gap refusal
                            # mid-replay: re-probe for the new floor
                            continue
                        self.wire.commit_generation(st.shard)
                        try:
                            from ..monitor.registry import default_registry

                            default_registry().gauge(
                                "hostps.wire.shard_dead",
                                shard=str(st.shard)).set(0)
                        except Exception:
                            pass
                        stat_add("hostps.wire.shard_recoveries")
                        _emit("ps_recovered", shard=st.shard)
                        if self.on_recover is not None:
                            self.on_recover(st.lo, st.hi)
                        return
            time.sleep(0.2)

    def _replay(self, st, server_seq, clear_dead=False):
        """Resend every logged push the restored owner is missing, in
        sequence order; the server's dedup drops the ones it already
        applied.  A gap below the log floor means the prune window was
        outrun — fail loudly rather than silently lose updates.

        Loops until the log is DRAINED past the floor: a push buffered by
        another thread while a replay round was on the wire would
        otherwise be skipped forever (its successor would then hit the
        server's seq-gap refusal).  With ``clear_dead`` the final
        empty-check and the dead->alive flip happen under ONE lock hold,
        so no push can slip between them: a concurrent pusher either
        logged before the check (this replay sends it) or observes
        dead=False and sends normally."""
        floor = int(server_seq)
        first = True
        total = 0
        while True:
            with st.cond:
                entries = [e for e in st.log if e[0] > floor]
                if not entries:
                    st.queue.clear()    # all logged pushes just replayed
                    st.outstanding = 0
                    if clear_dead:
                        st.dead = False
                    st.cond.notify_all()
                    break
            if first and entries[0][0] > floor + 1:
                raise RuntimeError(
                    "ShardRouter: shard %d restored to seq %d but the "
                    "replay log starts at seq %d — the staleness window "
                    "outran the checkpoint cadence (save more often or "
                    "keep a deeper log)"
                    % (st.shard, floor, entries[0][0]))
            first = False
            for seq, rows, values, lr in entries:
                # accept_restart: the pending (restarted) generation is
                # exactly who we are replaying TO; it commits only after
                # the whole replay lands (wire.commit_generation)
                self.wire.request(st.shard, "push",
                                  {"rows": rows, "values": values,
                                   "lr": lr},
                                  seq=seq, accept_restart=True,
                                  alive=lambda: self._alive(st))
            total += len(entries)
            floor = entries[-1][0]
        if total:
            stat_add("hostps.wire.replayed", total)

    def _resync(self, st):
        """A FAST restart was detected by generation change (the owner
        died and respawned between two replies, without a single timeout):
        replay the staleness window past its restored sequence floor
        before any further traffic.  State after replay is bit-exact with
        the pre-death table, so the caller simply re-issues its op.

        The recovery lock serializes concurrent detectors; the committed
        generation advances only AFTER the replay lands, so every other
        thread's reply keeps raising ShardRestartedError (and funnels
        here) until the table is whole again."""
        with st.recover_lock:
            if not self.wire.generation_stale(st.shard):
                return          # another thread already replayed this gen
            res = self.wire.request(st.shard, "seq", {},
                                    accept_restart=True,
                                    alive=lambda: self._alive(st))
            self._replay(st, int(res["last_seq"]))
            self.wire.commit_generation(st.shard)
        stat_add("hostps.wire.shard_recoveries")
        _emit("ps_recovered", shard=st.shard, fast_restart=True)

    def _resync_guarded(self, st):
        """_resync for the op-retry loops: the owner dying AGAIN mid-resync
        marks the shard dead (the caller's loop then degrades/waits); any
        other resync failure is retried by the caller's loop or a later
        recovery — never propagated into the training step."""
        try:
            self._resync(st)
        except _wire.ShardDeadError:
            self._mark_dead(st)
        except (_wire.ShardRestartedError, _wire.WireRemoteError, OSError):
            pass

    # -- remote ops --------------------------------------------------------
    def _op(self, st, op, payload, seq=None):
        """One remote op with the full robustness ladder: dead -> wait for
        respawn + replay; timeout-with-dead-heartbeat -> mark dead and
        loop; generation change -> resync (replay) and re-issue;
        timeout-with-live-heartbeat -> the wire's counted giveup."""
        while True:
            with st.cond:
                dead = st.dead
            if dead:
                self._await_recovery(st)
            try:
                return self.wire.request(st.shard, op, payload, seq=seq,
                                         attempts=self._attempts,
                                         alive=lambda: self._alive(st))
            except _wire.ShardDeadError:
                self._mark_dead(st)
            except _wire.ShardRestartedError:
                self._resync_guarded(st)   # loop re-evaluates dead/alive

    def _owner_split(self, rows):
        """{routing position: index-array} over unique valid rows (a
        position indexes ``self.ranges``; after a live repartition the
        position->state map is rebuilt, so positions stay authoritative).
        """
        owner = np.searchsorted(self._los, rows, side="right") - 1
        return {int(s): np.nonzero(owner == s)[0]
                for s in np.unique(owner)}

    def _state_for_pos(self, pos):
        return self._pos_to_state.get(pos)

    # -- table-shaped surface ---------------------------------------------
    def pull(self, ids):
        """HostSparseTable.pull contract (zeros for out-of-vocab ids),
        routed: loopback rows from the local shard, remote rows over the
        wire; a dead shard's rows follow ``degraded_reads``."""
        ids = np.asarray(ids)
        flat = ids.reshape(-1).astype(np.int64)
        valid = (flat >= 0) & (flat < self.vocab_size)
        out = np.zeros((flat.shape[0], self.dim), self.dtype)
        self._tls.cacheable = True
        if valid.any():
            vrows = flat[valid]
            for pos, idx in self._owner_split(vrows).items():
                rows = vrows[idx]
                st = None if pos == self.rank or self.world == 1 \
                    else self._state_for_pos(pos)
                vals = (self.local_table.pull(rows) if st is None
                        else self._remote_pull(st, rows))
                sel = np.nonzero(valid)[0][idx]
                out[sel] = vals
        return out.reshape(ids.shape + (self.dim,))

    def _remote_pull(self, st, rows):
        t0 = time.perf_counter()
        try:
            while True:
                with st.cond:
                    dead = st.dead
                if dead and self.degraded_reads == "init":
                    # best-effort degraded read: the deterministic
                    # initializer's cold value (exact for never-pushed
                    # rows; NOT cacheable — see last_pull_cacheable)
                    stat_add("hostps.wire.degraded_pulls")
                    self._tls.cacheable = False
                    return self.initializer(rows).astype(self.dtype)
                if dead:
                    self._await_recovery(st)
                try:
                    res = self.wire.request(
                        st.shard, "pull", {"rows": rows},
                        attempts=self._attempts,
                        alive=lambda: self._alive(st))
                    return np.asarray(res["values"], self.dtype)
                except _wire.ShardDeadError:
                    self._mark_dead(st)
                except _wire.ShardRestartedError:
                    self._resync_guarded(st)   # loop re-evaluates state
        finally:
            self._account_wait(time.perf_counter() - t0)

    def push(self, rows, values, lr):
        """HostSparseTable.push contract: dedup/merge globally, drop
        sentinel rows, then route each merged row to its owner.  Returns
        ``(rows, new_values)`` for the rows whose post-update value is
        KNOWN here (local + sync-acked); rows pushed async or buffered for
        a dead shard land in ``take_stale_rows()`` so the embedding's
        cache drops them instead of serving stale values."""
        rows = np.asarray(rows).reshape(-1).astype(np.int64)
        values = np.asarray(values, np.float32).reshape(rows.shape[0], -1)
        valid = (rows >= 0) & (rows < self.vocab_size)
        r, inv = np.unique(rows[valid], return_inverse=True)
        if not r.size:
            return r, np.zeros((0, self.dim), self.dtype)
        grad = np.zeros((r.size, self.dim), np.float32)
        np.add.at(grad, inv, values[valid])
        known_r, known_new = [], []
        for pos, idx in self._owner_split(r).items():
            rs, gs = r[idx], grad[idx]
            st = None if pos == self.rank or self.world == 1 \
                else self._state_for_pos(pos)
            if st is None:
                kr, knew = self.local_table.push(rs, gs, lr)
                known_r.append(kr)
                known_new.append(knew)
                continue
            res = self._remote_push(st, rs, gs, lr)
            if res is not None:
                known_r.append(np.asarray(res["rows"], np.int64))
                known_new.append(np.asarray(res["new"], self.dtype))
            else:
                self._stale.append(rs)
        if known_r:
            return (np.concatenate(known_r),
                    np.concatenate(known_new).reshape(-1, self.dim))
        return (np.zeros(0, np.int64), np.zeros((0, self.dim), self.dtype))

    def _remote_push(self, st, rows, grad, lr):
        """Sequence, log, and deliver one shard's merged push.  Returns the
        ack (with post-update values) in sync mode; None when the new
        values are unknown (async in flight, buffered for a dead shard, or
        answered from the server's dedup cache)."""
        with st.cond:
            seq = st.next_seq
            st.next_seq += 1
            st.log.append((seq, rows, grad, float(lr)))
            dead = st.dead
        if dead:
            # the staleness window keeps growing while the owner is down;
            # everything here replays on recovery, in order, deduped
            stat_add("hostps.wire.buffered_pushes")
            return None
        if self.staleness <= 0:
            t0 = time.perf_counter()
            try:
                # unlike a pull, a sync push that finds the owner dead
                # does NOT block for recovery: it is already in the replay
                # log — buffering it IS the degradation (the next exact
                # read will wait out the respawn and replay it first)
                try:
                    return self.wire.request(
                        st.shard, "push",
                        {"rows": rows, "values": grad, "lr": float(lr)},
                        seq=seq, attempts=self._attempts,
                        alive=lambda: self._alive(st))
                except _wire.ShardDeadError:
                    self._mark_dead(st)
                    stat_add("hostps.wire.buffered_pushes")
                    return None
                except _wire.ShardRestartedError:
                    # the resync's replay DELIVERS this very push (it is
                    # in the log); nothing more to send here — and if the
                    # resync itself fails, a later recovery replays it
                    self._resync_guarded(st)
                    return None
            finally:
                self._account_wait(time.perf_counter() - t0)
        # async bounded-staleness: enqueue, enforce the bound
        self._raise_async_error(st)
        self._ensure_worker(st)
        t0 = time.perf_counter()
        with st.cond:
            # the queue carries the ENTRY (not just the seq): the sender
            # must not rescan the replay log per push — O(log) lookups go
            # quadratic over a checkpoint interval
            st.queue.append((seq, rows, grad, float(lr)))
            st.outstanding += 1
            while st.outstanding > self.staleness and not st.dead:
                st.cond.wait(timeout=0.5)
            hw = st.outstanding
        self._account_wait(time.perf_counter() - t0)
        try:
            from ..monitor.registry import default_registry

            default_registry().gauge("hostps.wire.outstanding",
                                     shard=str(st.shard)).set_max(hw)
        except Exception:
            pass
        return None

    def _ensure_worker(self, st):
        if st.worker is not None and st.worker.is_alive():
            return
        st.worker = threading.Thread(
            target=self._sender, args=(st,), daemon=True,
            name="ps-sender-shard-%d" % st.shard)
        st.worker.start()

    def _sender(self, st):
        """Per-shard async sender: drains the queue in seq order; a dead
        shard parks the thread in _await_recovery (whose replay also
        clears the queue — those entries went out with the replay).

        A push that FAILS against a live shard (wire giveup, a server-side
        refusal) is stashed on the shard state and re-raised to the
        trainer at its next push or flush — swallowing it would leave a
        permanent server-side seq gap that silently freezes every later
        update to this shard while checkpoints keep passing."""
        while True:
            with st.cond:
                while not st.queue and not st.dead \
                        and st.async_error is None:
                    st.cond.wait(timeout=0.5)
                if st.async_error is not None:
                    return              # poisoned: trainer must act first
                entry = None if st.dead else st.queue.popleft()
            if entry is None:
                try:
                    self._await_recovery(st)
                except Exception as e:
                    with st.cond:
                        st.async_error = e
                        st.cond.notify_all()
                    return
                continue
            seq, rows, grad, lr = entry
            try:
                self._op(st, "push",
                         {"rows": rows, "values": grad, "lr": lr}, seq=seq)
            except Exception as e:
                with st.cond:
                    st.async_error = e
                    st.outstanding = max(st.outstanding - 1, 0)
                    st.cond.notify_all()
                return
            with st.cond:
                st.outstanding = max(st.outstanding - 1, 0)
                st.cond.notify_all()

    def _raise_async_error(self, st):
        with st.cond:
            e = st.async_error
        if e is not None:
            raise RuntimeError(
                "ShardRouter: the async sender for shard %d failed — an "
                "update may be missing server-side (replay log keeps it; "
                "restore from the last committed checkpoint or restart "
                "the shard to re-sync)" % st.shard) from e

    def take_stale_rows(self):
        """Rows pushed since the last call whose fresh value is not known
        client-side (the embedding's cache must invalidate them)."""
        stale, self._stale = self._stale, []
        if not stale:
            return np.zeros(0, np.int64)
        return np.unique(np.concatenate(stale))

    def flush(self, timeout=None):
        """Drain every in-flight async push (and, for a dead shard, wait
        out its recovery+replay) — the pre-snapshot barrier."""
        deadline = None if timeout is None \
            else time.monotonic() + float(timeout)
        for st in self._shards.values():
            with st.cond:
                while st.queue or st.outstanding > 0:
                    if st.dead:
                        break
                    if deadline is not None \
                            and time.monotonic() >= deadline:
                        raise WireGiveUp(
                            "ShardRouter.flush: shard %d still has %d "
                            "unacked pushes" % (st.shard, st.outstanding))
                    st.cond.wait(timeout=0.2)
                dead = st.dead
            if dead:
                self._await_recovery(st)
            self._raise_async_error(st)
        return self

    # -- checkpoint surface (table-shaped) --------------------------------
    def snapshot(self, lo=None, hi=None):
        """A CONSISTENT merged snapshot across every live shard: flush the
        async window, then collect each owner's rows.  The merged meta
        carries every shard's wire dedup table (``wire_seqs``) so a
        respawned owner restored from this snapshot recognizes replays.
        Also advances the replay-log prune floor by one checkpoint lag
        (the previous snapshot's seq is the deepest any committed restore
        can land)."""
        self.flush()
        all_rows = [np.zeros(0, np.int64)]
        parts = []
        lrows, larrays, meta = self.local_table.snapshot(lo, hi)
        all_rows.append(lrows)
        parts.append((lrows, larrays))
        wire_seqs = {}
        for st in sorted(self._shards.values(), key=lambda s: s.shard):
            res = self._op(st, "snapshot", {"lo": lo, "hi": hi})
            rrows = np.asarray(res["rows"], np.int64)
            all_rows.append(rrows)
            parts.append((rrows, res["arrays"]))
            wire_seqs[str(st.shard)] = res["seqs"]
            with st.cond:
                my_seq = int((res["seqs"] or {}).get(
                    self.wire.client_id, 0)) if self.wire else 0
                floor = st.prev_snapshot_seq
                while st.log and st.log[0][0] <= floor:
                    st.log.popleft()
                st.prev_snapshot_seq = my_seq
        rows = np.concatenate(all_rows)
        order = np.argsort(rows, kind="stable")
        # every shard shares one optimizer config, so every part carries
        # the same array keys (param + the applier's slots)
        arrays = {k: np.concatenate(
            [np.zeros((0,) + np.asarray(larrays[k]).shape[1:],
                      np.asarray(larrays[k]).dtype)]
            + [np.asarray(a[k]) for _, a in parts])[order]
            for k in larrays}
        rows = rows[order]
        meta = dict(meta)
        meta["row_range"] = [0, self.vocab_size]
        meta["wire_seqs"] = wire_seqs
        meta["shard_world"] = self.world
        return rows, arrays, meta

    def save(self, dirname, name=None):
        from .. import io as _io

        rows, arrays, meta = self.snapshot()
        return _io.save_sparse_shards(dirname, name or self.name, rows,
                                      arrays, meta=meta)

    def restore(self, dirname, name=None):
        return self.restore_resharded([dirname], name)

    def restore_resharded(self, shard_dirs, name=None):
        """Restore EVERY live shard from saver dirs: the local range
        directly, each remote range via its owner's ``restore`` op (the
        owner re-slices by its own row_range).  Client seq state re-bases
        on each owner's restored floor and the replay logs reset — the
        restored checkpoint IS the new ground truth."""
        name = name or self.name
        self.local_table.restore_resharded([str(d) for d in shard_dirs],
                                           name)
        for st in sorted(self._shards.values(), key=lambda s: s.shard):
            res = self._op(st, "restore",
                           {"dirs": [str(d) for d in shard_dirs],
                            "name": name})
            with st.cond:
                st.log.clear()
                st.queue.clear()
                st.outstanding = 0
                st.next_seq = int(res["last_seq"]) + 1
                st.prev_snapshot_seq = int(res["last_seq"])
                st.cond.notify_all()
        return self

    # -- live repartition --------------------------------------------------
    def absorb(self, shard):
        """Elastic SHRINK of the live table: take over ``shard``'s rows
        in-process (snapshot over the wire -> adopt locally -> evict on
        the old owner), widen the local row range, and drop the route.
        The absorbed range must be adjacent to the local one (contiguous
        ranges stay contiguous — the hostps_row_range invariant)."""
        st = self._shards.get(int(shard))
        if st is None:
            raise ValueError("ShardRouter.absorb: no remote shard %r"
                             % (shard,))
        llo, lhi = self.local_table.row_range or (0, self.vocab_size)
        if st.hi != llo and st.lo != lhi:
            raise ValueError(
                "ShardRouter.absorb: shard %d rows [%d, %d) are not "
                "adjacent to local [%d, %d)" % (st.shard, st.lo, st.hi,
                                                llo, lhi))
        self.flush()
        res = self._op(st, "snapshot", {"lo": st.lo, "hi": st.hi})
        new_lo, new_hi = min(llo, st.lo), max(lhi, st.hi)
        self.local_table.set_row_range((new_lo, new_hi))
        self.local_table.adopt_rows(np.asarray(res["rows"], np.int64),
                                    res["arrays"])
        try:
            self._op(st, "evict", {"lo": st.lo, "hi": st.hi})
        except OSError:
            pass        # the old owner may already be gone; rows are ours
        del self._shards[st.shard]
        # collapse the routing table: local rank now owns the union; the
        # remaining shards keep their ranges (ranges stay disjoint+covering)
        self._rebuild_ranges(absorbed=(st.shard, new_lo, new_hi))
        # live budget re-check: the absorb just widened the local range —
        # a budget that passed at startup must warn NOW if it no longer
        # holds, not OOM the host later
        note_shard_owned_bytes(self.rank, self.local_table,
                               self.budget_bytes)
        stat_add("hostps.wire.repartitions")
        _emit("ps_repartition", kind="absorb", shard=st.shard,
              local_rows=[new_lo, new_hi], world=len(self._shards) + 1)
        return int(np.asarray(res["rows"]).size)

    def _rebuild_ranges(self, absorbed):
        _shard, lo, hi = absorbed
        ranges = [(s.lo, s.hi) for s in self._shards.values()]
        ranges.append((lo, hi))
        ranges.sort()
        self.world = len(ranges)
        self.ranges = ranges
        self._los = np.asarray([l for l, _ in ranges], np.int64)
        # ownership index of the local range within the new table
        self.rank = ranges.index((lo, hi))
        # remote states keyed by shard id; _owner_split returns positions
        # in self.ranges — rebuild the position -> state map
        by_pos = {}
        for st in self._shards.values():
            by_pos[ranges.index((st.lo, st.hi))] = st
        self._pos_to_state = by_pos

    def shutdown_shard(self, shard):
        """Ask a (still-routed or absorbed) owner to exit its serve loop
        (clean drill teardown)."""
        if self.wire is None:
            return
        try:
            self.wire.request(int(shard), "shutdown", {}, attempts=2,
                              probe=True, accept_restart=True)
        except OSError:
            pass


class ShardedHostPSEmbedding(HostPSEmbedding):
    """``HostPSEmbedding`` over a ``ShardRouter``: the full HostPS pipeline
    (hot-row device cache, prefetch double-buffering, SelectedRows push,
    push_in_jit) in front of a runtime-sharded table.  Adds the two cache
    disciplines sharding needs: rows whose freshest value is remote-only
    (async/buffered pushes) are INVALIDATED rather than served stale, and
    a recovered shard's rows drop wholesale (the replayed owner is the
    ground truth)."""

    def __init__(self, router, cache_slots=0, device=None, name=None):
        if not isinstance(router, ShardRouter):
            raise TypeError("ShardedHostPSEmbedding wraps a ShardRouter")
        super().__init__(router, cache_slots=cache_slots, device=device,
                         name=name or router.name)
        router.on_recover = self._on_shard_recover

    @property
    def router(self):
        return self.table

    def _on_shard_recover(self, lo, hi):
        if self.cache is None:
            return
        with self._lock:
            self._push_version += 1          # in-flight inserts are stale
            cached = self.cache._row_of_slot
            live = cached[(cached >= lo) & (cached < hi)]
            if live.size:
                self.cache.invalidate(live)

    def _after_push(self, r, new):
        # the sharded cache discipline, under the base push's lock: rows
        # whose fresh value is remote-only (async in flight, buffered for
        # a dead shard) must be DROPPED, never served stale
        stale = self.table.take_stale_rows()
        if stale.size:
            if self.cache is not None:
                self.cache.invalidate(stale)
            profiler.incr("hostps.push_rows", int(stale.size))


# ------------------------------------------------ in-process repartition --

def repartition_tables(tables, new_world, make_table):
    """Re-balance live in-process tables across a world-size change —
    the N -> M building block (snapshot -> adopt -> evict -> set_range)
    the wire-level ``absorb`` specializes.  ``tables`` are the N current
    owners (ascending rank, ranges = hostps_row_ranges(N, V));
    ``make_table(rank, lo, hi)`` builds (or reuses) the M new owners.
    Returns the new tables; every live row's param/moments move verbatim.
    """
    if not tables:
        raise ValueError("repartition_tables: no source tables")
    vocab = tables[0].vocab_size
    new_ranges = hostps_row_ranges(int(new_world), vocab)
    snaps = [t.snapshot() for t in tables]
    out = []
    # evict the SOURCES first (their state is safe in `snaps`): a
    # make_table that REUSES a source table would otherwise have its
    # just-adopted rows wiped by a post-adopt evict pass
    for t in tables:
        lo, hi = t.row_range or (0, vocab)
        t.evict_rows(lo, hi)
    for rank, (lo, hi) in enumerate(new_ranges):
        t = make_table(rank, lo, hi)
        t.set_row_range((lo, hi))
        for rows, arrays, _meta in snaps:
            keep = (rows >= lo) & (rows < hi)
            if keep.any():
                t.adopt_rows(rows[keep],
                             {k: np.asarray(v)[keep]
                              for k, v in arrays.items()})
        out.append(t)
    return out
