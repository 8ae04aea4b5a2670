"""Worker failure detection: heartbeats + clean-exit marks (counterpart of
``paddle_tpu/distributed/heartbeat.py``, a copy on the port's monitor:
``monitor/fleetscope.py`` and its default registry).

Parity: operators/distributed/heart_beat_monitor.h:54-104 — the reference
pserver runs a monitor thread over per-worker heartbeat timestamps, marks
untimely workers lost, and trainers call Executor::Close() ->
RPCClient::SendComplete (framework/executor.cc:110-118) so barriers don't
hang on cleanly-exited trainers.

As in the JAX package there is no pserver process, so the heartbeat medium
is the job's shared filesystem (the same place checkpoints land): every
worker touches hb-<rank> on an interval and writes done-<rank> on clean
exit; any process (typically rank 0 or the launcher) can run a
HeartBeatMonitor over the directory.  Recovery is restart: the launcher's
``--elastic_retries`` relaunches dead workers.
"""

import os
import threading
import time

__all__ = ["WorkerHeartbeat", "HeartBeatMonitor", "RankLiveness",
           "clear_stale_ranks",
           "UNINITED", "RUNNING", "COMPLETED", "LOST"]

UNINITED = "UNINITED"
RUNNING = "RUNNING"
COMPLETED = "COMPLETED"
LOST = "LOST"

# numeric encoding for the per-rank fleet.worker_state gauge (a Prometheus
# gauge holds a number; alerting rules compare against these)
_STATE_CODE = {UNINITED: 0, RUNNING: 1, COMPLETED: 2, LOST: 3}

# Executor.close() marks the current worker complete through this hook
# (the SendComplete analogue); set by WorkerHeartbeat.start()
_current = None


def _hb_path(dirname, rank):
    return os.path.join(dirname, "hb-%d" % rank)


def _done_path(dirname, rank):
    return os.path.join(dirname, "done-%d" % rank)


def clear_stale_ranks(dirname, world):
    """Remove ``hb-<r>``/``done-<r>`` files for ranks >= `world` — the
    heartbeat corpses an ELASTIC SHRINK leaves behind (the JAX launcher's
    --elastic_shrink relaunches the fleet at a smaller world size; the
    removed ranks' last beats would otherwise make fleet_top render ghost
    workers forever and trip ``fleet.lost_workers`` on every monitor that
    still scans them).  Called from rank 0's heartbeat re-arm on (re)start;
    concurrent callers are harmless (missing files are skipped).  Returns
    the removed ranks (sorted, deduped)."""
    removed = set()
    try:
        names = os.listdir(dirname)
    except OSError:
        return []
    for name in names:
        for prefix in ("hb-", "done-"):
            if not name.startswith(prefix):
                continue
            try:
                r = int(name[len(prefix):])
            except ValueError:
                continue
            if r >= int(world):
                try:
                    os.remove(os.path.join(dirname, name))
                    removed.add(r)
                except OSError:
                    pass
    return sorted(removed)


class WorkerHeartbeat:
    """Worker side: touch hb-<rank> every `interval` seconds from a daemon
    thread; complete() writes done-<rank> and stops (clean exit).

    agree_dir: the checkpoint directory whose preemption agreement rounds
    (the JAX package's ``ft/agree.py``) this worker would join; the port
    has no ``ft/agree.py`` yet, so a directory raises (ROADMAP Queue 1
    item 6)."""

    def __init__(self, dirname, rank, interval=1.0, agree_dir=None,
                 world=None):
        if agree_dir is not None:
            raise NotImplementedError(
                "WorkerHeartbeat(agree_dir=...): the preemption agreement "
                "rounds of ft/agree.py wait (ROADMAP Queue 1 item 6, fault "
                "tolerance)")
        self.dirname = dirname
        self.rank = int(rank)
        self.interval = interval
        self.agree_dir = agree_dir
        # current fleet size (for the elastic-shrink corpse sweep below);
        # None = read the launcher's PADDLE_TRAINERS_NUM contract at start()
        self.world = None if world is None else int(world)
        self._stop = threading.Event()
        self._thread = None
        os.makedirs(dirname, exist_ok=True)

    def start(self):
        global _current
        # re-arm on (re)start: an elastically-respawned worker inherits its
        # corpse's files.  A stale done-mark would report COMPLETED forever
        # (the monitor short-circuits on it, hiding a genuinely dead
        # respawn), so it is removed; the stale hb file needs no removal —
        # _beat() below overwrites it, and the content (seq, wallclock,
        # pid, restart attempt) always differs from the corpse's last beat,
        # which is what the monitor's content-change liveness keys on.
        try:
            os.remove(_done_path(self.dirname, self.rank))
        except OSError:
            pass
        # elastic-shrink corpse sweep (rank 0 only — one sweeper per fleet
        # incarnation): a relaunch at a SMALLER world size inherits the
        # removed ranks' hb/done files; nothing will ever beat them again,
        # so they would render as ghost workers in fleet_top and trip
        # fleet.lost_workers on every monitor scan forever
        world = self.world
        if world is None:
            try:
                world = int(os.environ.get("PADDLE_TRAINERS_NUM", "0"))
            except ValueError:
                world = 0
        if world and self.rank == 0:
            cleared = clear_stale_ranks(self.dirname, world)
            if cleared:
                import sys

                sys.stderr.write(
                    "[heartbeat] elastic shrink to world=%d: cleared stale "
                    "beat/done files for removed ranks %s\n"
                    % (world, cleared))
        self._beat()

        def run():
            while not self._stop.wait(self.interval):
                try:
                    self._beat()
                except OSError:
                    # transient fs error must not kill the beat thread (a
                    # dead thread would falsely mark this worker LOST)
                    pass

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        _current = self
        return self

    def _beat(self):
        # pid + restart attempt ride along so a respawned worker's very
        # first beat differs from the corpse's last even if seq and the
        # clock happen to collide (the monitor compares CONTENT, not mtime)
        self._seq = getattr(self, "_seq", 0) + 1
        with open(_hb_path(self.dirname, self.rank), "w") as f:
            f.write("%d %f %d %s" % (
                self._seq, time.time(), os.getpid(),
                os.environ.get("PADDLE_RESTART_ATTEMPT", "0")))

    def complete(self):
        """Clean exit (Executor::Close -> SendComplete parity)."""
        global _current
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        with open(_done_path(self.dirname, self.rank), "w") as f:
            f.write("%f" % time.time())
        if _current is self:
            _current = None


def notify_complete():
    """Called by Executor.close(); no-op when no heartbeat is running."""
    if _current is not None:
        _current.complete()


class RankLiveness:
    """One-rank liveness probe for in-band consumers (the JAX package's
    ShardPS wire router asks "is the shard owner I'm timing out against
    provably dead?" between resends, ``hostps/shard_router.py``).

    Same discipline as HeartBeatMonitor._scan: liveness = "the beat
    CONTENT changed within ``timeout`` seconds by MY clock" (never a
    cross-host mtime comparison), a done-mark means cleanly exited (not
    serving), and a missing beat file means not provably alive.  Stateful —
    keep one instance per watched rank."""

    def __init__(self, dirname, rank, timeout=5.0):
        self.dirname = dirname
        self.rank = int(rank)
        self.timeout = float(timeout)
        self._last = None            # (content, monotonic first-seen)

    def alive(self):
        if self.dirname is None:
            return True              # no heartbeat medium: assume alive
        try:
            if os.path.exists(_done_path(self.dirname, self.rank)):
                return False         # clean exit: not serving anymore
            with open(_hb_path(self.dirname, self.rank)) as f:
                content = f.read()
        except OSError:
            return False             # no beat (yet / anymore)
        now = time.monotonic()
        if self._last is None or self._last[0] != content:
            self._last = (content, now)
        return (now - self._last[1]) <= self.timeout


class HeartBeatMonitor:
    """Monitor side (heart_beat_monitor.h:54 LodgeHeartbeat/CheckBegin):
    scans the heartbeat dir on an interval; a worker whose last beat is
    older than `timeout` and has no done-mark is LOST.

    monitor_dirs (optional, rank order): each worker's monitor out_dir —
    arms a FleetScope scanner (monitor/fleetscope.py) that tails the
    ranks' step timelines alongside the liveness scan and exports
    ``fleet.straggler{rank}`` / ``fleet.step_skew_ms`` gauges plus
    ``straggler`` timeline events, so the process watching for dead
    workers is the same one attributing slow ones."""

    def __init__(self, dirname, n_workers, timeout=10.0, interval=1.0,
                 monitor_dirs=None):
        self.dirname = dirname
        self.n_workers = int(n_workers)
        self.timeout = timeout
        self.interval = interval
        self._stop = threading.Event()
        self._thread = None
        self._status = {r: UNINITED for r in range(self.n_workers)}
        self._lock = threading.Lock()
        self._fleetscope = None
        if monitor_dirs:
            from ..monitor import fleetscope as _fleetscope

            self._fleetscope = _fleetscope.FleetScope(monitor_dirs)

    def start(self):
        self._scan()

        def run():
            while not self._stop.wait(self.interval):
                try:
                    self._scan()
                except OSError:
                    pass   # transient fs error must not kill the monitor

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _read_beat(self, rank):
        try:
            with open(_hb_path(self.dirname, rank)) as f:
                return f.read()
        except OSError:
            return None

    def _scan(self):
        # Liveness = "the beat CONTENT changed recently by MY clock", not a
        # comparison of my clock against the file's mtime: network
        # filesystems serve stale attributes and hosts disagree on time, so
        # cross-clock mtime age would flag healthy workers.  _last_change
        # maps rank -> (content, monotonic time content was first seen).
        now = time.monotonic()
        if not hasattr(self, "_last_change"):
            self._last_change = {}
        with self._lock:
            for r in range(self.n_workers):
                if os.path.exists(_done_path(self.dirname, r)):
                    self._status[r] = COMPLETED
                    continue
                content = self._read_beat(r)
                if content is None:
                    # never seen: stays UNINITED until first beat
                    if self._status[r] == RUNNING:
                        self._status[r] = LOST
                    continue
                prev = self._last_change.get(r)
                if prev is None or prev[0] != content:
                    self._last_change[r] = (content, now)
                age = now - self._last_change[r][1]
                self._status[r] = RUNNING if age <= self.timeout else LOST
            status = dict(self._status)
        self._export_stats(status)

    def _export_stats(self, status):
        """Fleet health as monitor gauges: every scan refreshes
        ``fleet.worker_state{rank=r}`` (coded UNINITED=0 RUNNING=1
        COMPLETED=2 LOST=3), ``fleet.workers{state=s}`` counts, and
        ``fleet.lost_workers`` — so worker_status()/lost_workers() land in
        the Prometheus exposition (and the fleet rollup,
        monitor.merge_prometheus_files) instead of only in log lines.  A
        newly-LOST rank also hits the timeline when a session is active."""
        from .. import monitor as _monitor

        reg = _monitor.default_registry()
        counts = dict.fromkeys((UNINITED, RUNNING, COMPLETED, LOST), 0)
        for r, s in status.items():
            counts[s] += 1
            reg.gauge("fleet.worker_state", rank=str(r)).set(_STATE_CODE[s])
        for s, c in counts.items():
            reg.gauge("fleet.workers", state=s).set(c)
        reg.gauge("fleet.lost_workers").set(counts[LOST])
        lost = frozenset(r for r, s in status.items() if s == LOST)
        mon = _monitor.active()
        if lost != getattr(self, "_prev_lost", frozenset()):
            self._prev_lost = lost
            if mon is not None and lost:
                mon.timeline.emit("fleet_lost", ranks=sorted(lost))
        if self._fleetscope is not None:
            # straggler attribution rides the liveness scan: joins the
            # ranks' step timelines, exports fleet.straggler{rank} gauges
            # and a `straggler` event when the attribution changes
            try:
                self._fleetscope.scan(
                    registry=reg,
                    timeline=mon.timeline if mon is not None else None)
            except Exception:
                pass    # attribution must never kill the liveness scan

    def worker_status(self):
        self._scan()
        with self._lock:
            return dict(self._status)

    def lost_workers(self):
        return [r for r, s in self.worker_status().items() if s == LOST]

    def all_completed(self):
        return all(s == COMPLETED for s in self.worker_status().values())
