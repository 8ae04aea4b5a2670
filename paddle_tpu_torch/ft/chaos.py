"""Deterministic fault injection for fault-tolerance drills.

Parity motivation: the reference proves its PS fault story with injected
faults (pserver kill/retry unit tests around checkpoint_notify and the
communicator's resend loops); here the same discipline is a set of named
injection points compiled into the production code paths, armed either
programmatically (tests) or from the environment (``scripts/chaos_drill.py``
subprocess workers), and DETERMINISTIC: every point keeps a per-process hit
counter and fires on exact hit numbers, never on timers or randomness, so a
drill's kill-at-step-k is the same k on every run.

Injection points (each named where it is compiled in):

- ``feed_worker``      — feed-pipe worker raises mid-stream
                         (feed_pipe.DeviceFeedPipe._worker, one hit/batch)
- ``hostps_prefetch``  — HostPS prefetch daemon dies; the error surfaces on
                         the consuming pull (hostps/service.py prefetch)
- ``ckpt_commit``      — checkpoint write crashes AFTER the shard files are
                         staged but BEFORE COMMIT (parallel/checkpoint.py) —
                         the torn-checkpoint case the commit protocol exists
                         for
- ``sigterm_step``     — SIGTERM delivered to this very process at a step
                         boundary (ft/guard.py, one hit/step) — the
                         preemption drill
- ``kill_step``        — SIGKILL delivered to this very process at a step
                         boundary (ft/guard.py) — death WITHOUT a
                         checkpoint, the lost-rank / whole-fleet-crash
                         drill (nothing runs after it: no save, no flush,
                         no exit handler — exactly what a hardware loss
                         looks like to the survivors)
- ``io_error``         — transient OSError inside a retry-wrapped IO
                         operation (ft/retry.py, one hit per attempted op);
                         armed with ``times=N`` it fails N attempts and then
                         succeeds, exercising the backoff path end to end
- ``nan_batch``        — the k-th ``Executor.run`` feed gets one NaN
                         (executor.py poisons via
                         monitor/sentinel.poison_feed) — the TrainSentinel
                         tripwire drill: instead of raising, the point
                         RETURNS True and the call site applies the payload
- ``ps_drop``          — the ShardPS wire client drops this request on the
                         floor (hostps/wire.py: the file is never written,
                         so the reply deadline fires and the resend path
                         runs) — returns True, caller applies
- ``ps_delay``         — the wire client sleeps before sending (a slow
                         shard: the request lands late, ``ps_wait`` grows,
                         the deadline may fire) — returns True
- ``ps_dup``           — the wire client sends the request TWICE under one
                         sequence number (a retransmit race); the server's
                         idempotent dedup must apply it once — returns True
- ``ps_shard_kill``    — SIGKILL the ShardPS shard-owner process while it
                         is handling a request (hostps/shard_router.py
                         serve loop, one hit per dequeued request) — the
                         lost-shard drill: clients must degrade, the
                         launcher respawns the owner, which restores its
                         row range from the last committed checkpoint
- ``publish_kill``     — SIGKILL the publishing process between a delta
                         publish's shard files landing and its COMMIT
                         (parallel/checkpoint.py, fired only for
                         ``dirname=`` publishes so hits count PUBLISHES) —
                         the online drill's torn-publish window: serving
                         must stay on the last COMMITTED version and the
                         publisher's own GC must reclaim the corpse
- ``oom_step``         — the k-th ``Executor.run`` dispatch dies with a
                         synthetic RESOURCE_EXHAUSTED
                         (monitor/memscope.InjectedOOMError) — the MemScope
                         OOM-postmortem drill: like ``nan_batch`` the point
                         RETURNS True and the executor raises the payload,
                         so the flight dump + headroom evidence are
                         testable on a backend that cannot really OOM

Arming: ``arm("sigterm_step", at=5)`` fires on the 5th hit;
``arm("io_error", at=1, times=2)`` fires on hits 1 and 2.  The env form
``PADDLE_TPU_CHAOS="sigterm_step@5;io_error@1x2"`` arms the same way and is
read once per process (subprocess drills inherit it).

RANK TARGETING (multi-process drills): ``arm("kill_step", at=6, rank=1)``
fires only in the process whose fleet rank (``PADDLE_TRAINER_ID``) is 1;
the env form is a ``:r<K>`` suffix — ``PADDLE_TPU_CHAOS=
"sigterm_step@8:r0;sigterm_step@9:r1"`` arms DIFFERENT boundaries per rank
(the skewed-preemption drill), and every launcher worker can inherit ONE
spec.  A point may carry one arming per rank plus one rankless arming; the
hit counter is shared per point per process (hits are local — each process
counts its own passes).

Faults raise ``ChaosError`` (a RuntimeError — deliberately NOT an OSError,
so the retry layer never absorbs an injected crash) except ``io_error``,
which raises ``ChaosIOError`` (an OSError — exactly the class the retry
layer exists to absorb), ``sigterm_step``, which sends a real SIGTERM, and
``kill_step``, which SIGKILLs the process outright.

The port's copy of the JAX package's ``ft/chaos.py``: stdlib only, so the
copy needs no change beyond its package.
"""

import os
import signal
import threading
import time

__all__ = ["ChaosError", "ChaosIOError", "arm", "disarm", "maybe_fire",
           "hits", "armed", "load_env"]


class ChaosError(RuntimeError):
    """An injected crash.  RuntimeError, not OSError: retry wrappers must
    surface it, not absorb it."""


class ChaosIOError(OSError):
    """An injected TRANSIENT IO failure — the class ft/retry.py retries."""


_lock = threading.Lock()
_armed = {}          # point -> [{"at": int, "times": int, "rank": int|None}]
_hits = {}           # point -> int (total passes through the point)
_env_loaded = False


def _my_rank():
    """Fleet rank for rank-targeted armings: the launcher's env contract
    (read live — cheap, and tests mutate it)."""
    try:
        return int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)
    except ValueError:
        return 0


def _arm_locked(point, at, times, rank, await_path=None):
    cfgs = _armed.setdefault(point, [])
    cfgs[:] = [c for c in cfgs if c["rank"] != rank]
    cfgs.append({"at": int(at), "times": int(times), "rank": rank,
                 "await_path": await_path})


def _load_env_locked():
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    spec = os.environ.get("PADDLE_TPU_CHAOS", "").strip()
    if not spec:
        return
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        point, _, when = part.partition("@")
        at = when or "1"
        rank = None
        if ":" in at:
            at, _, r = at.partition(":")
            rank = int(r.lstrip("r"))
        times = 1
        if "x" in at:
            at, _, t = at.partition("x")
            times = int(t)
        _arm_locked(point.strip(), int(at or 1), times, rank)


def load_env():
    """(Re)read PADDLE_TPU_CHAOS — tests that mutate the env call this."""
    global _env_loaded
    with _lock:
        _env_loaded = False
        _armed.clear()
        _hits.clear()
        _load_env_locked()


def arm(point, at=1, times=1, rank=None, await_path=None):
    """Fire `point` on hit numbers [at, at+times) (1-based).  rank=K limits
    the arming to the process with fleet rank K (PADDLE_TRAINER_ID) —
    re-arming the same (point, rank) replaces it; other ranks' armings for
    the point are kept.  await_path=P makes the firing hit BLOCK (up to
    ~120s) until the file P exists before acting — the drill hook for
    ordering an injected death against checkpoint progress on another
    rank (e.g. "SIGKILL only after ckpt-N committed"); timing drills must
    be deterministic, not lucky."""
    with _lock:
        _load_env_locked()
        _arm_locked(point, at, times,
                    None if rank is None else int(rank),
                    await_path=await_path)
        _hits.setdefault(point, 0)


def disarm(point=None):
    """Disarm one point (or all) and reset its hit counter."""
    with _lock:
        _load_env_locked()
        if point is None:
            _armed.clear()
            _hits.clear()
        else:
            _armed.pop(point, None)
            _hits.pop(point, None)


def hits(point):
    with _lock:
        return _hits.get(point, 0)


def armed(point):
    with _lock:
        _load_env_locked()
        return point in _armed


def maybe_fire(point):
    """One pass through injection point `point`: bump its counter and act
    when armed for this hit number.  The disarmed fast path is one lock
    acquire + dict miss.  Non-acting points (``nan_batch``) return True on
    fire — the CALLER applies the payload; every other outcome returns
    None."""
    with _lock:
        _load_env_locked()
        if not _armed:
            return
        cfgs = _armed.get(point)
        if not cfgs:
            return
        n = _hits.get(point, 0) + 1
        _hits[point] = n
        rank = _my_rank()
        matched = [c for c in cfgs
                   if (c["rank"] is None or c["rank"] == rank)
                   and c["at"] <= n < c["at"] + c["times"]]
        if not matched:
            return
        await_path = next((c["await_path"] for c in matched
                           if c.get("await_path")), None)
    # acting outside the lock: the SIGTERM handler / exception unwinding may
    # re-enter chaos-instrumented code
    if await_path is not None:
        # fire-order gate: block (bounded) until the path exists, so a
        # drill can pin an injected death AFTER another rank's progress
        deadline = time.monotonic() + 120.0
        while not os.path.exists(await_path) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
    try:
        from ..monitor.registry import stat_add

        stat_add("ft.chaos.fired", point=point)
    except Exception:
        pass
    if point in ("nan_batch", "ps_drop", "ps_delay", "ps_dup", "oom_step"):
        return True          # the call site applies the payload
    if point == "sigterm_step":
        os.kill(os.getpid(), signal.SIGTERM)
        return
    if point in ("kill_step", "ps_shard_kill", "publish_kill"):
        os.kill(os.getpid(), signal.SIGKILL)
        return
    if point == "io_error":
        raise ChaosIOError("chaos: injected transient IO failure at %r "
                           "(hit %d)" % (point, n))
    raise ChaosError("chaos: injected fault at %r (hit %d)" % (point, n))
