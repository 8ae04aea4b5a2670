"""Cross-rank step agreement for preemption saves (the multi-host half of
FaultGuard).

The problem: a preemption notice (SIGTERM) reaches each rank's step loop
at whichever boundary that rank checks next, so ranks one boundary apart
would stage DIFFERENT ``ckpt-<step>`` directories — the COMMIT barrier
then times out and the fleet loses its final checkpoint exactly when it
needs one.  The fix is a tiny agreement
protocol: every rank broadcasts the step it observed, the fleet agrees on
``max(observed steps)``, and every rank trains forward to that boundary
before staging — so all ranks stage the SAME ``ckpt-<step>`` and COMMIT
succeeds.

Medium: the job's shared filesystem (the same medium the COMMIT barrier and
the heartbeat files already use).  ``torch.distributed`` collectives are
deliberately NOT the transport — a preempting fleet is exactly when a
collective may never complete (a rank can die mid-round), and a rank that
has already left the process group cannot answer one.  A round lives
under ``<ckpt_dir>/.preempt/round-a<attempt>/``:

  step-r<K>.json   rank K's observed step (+ pid / attempt / wallclock),
                   written ONCE, atomically (tmp + os.replace)
  ABORT            a respawned rank found this round mid-flight and killed
                   it — pollers must fall back, never join a stale round

Resolution: a rank publishes its observed step, then polls until all
``world`` rank files are present — the agreed step is ``max`` over them
(every rank computes the same max over the same immutable files; no
coordinator).  Ranks behind the max keep training to the agreed boundary.

Fallback (collectives-unavailable / lost-rank path): when the round does not
resolve within ``PADDLE_TPU_PREEMPT_AGREE_SECS``, each rank falls back to
save-at-next-multiple-of-K (``PADDLE_TPU_PREEMPT_QUANTUM``): deterministic
per rank, and ranks whose observed steps share a quantum window converge on
the same boundary without any communication (skew of one boundary only
mis-aligns when it straddles a multiple of K — probability ~1/K — and THAT
residue is what the COMMIT-barrier degradation path absorbs).

Telemetry: resolving (or falling back) sets the ``ft.preempt.agreed_step``
gauge and bumps ``ft.preempt.rounds{mode=}``; the guard emits a
``preempt_agree`` timeline event with the mode and the per-rank steps seen,
so drills can read the boundary skew straight off the timeline.

The port's copy of the JAX package's ``ft/agree.py`` (stdlib only): the
fleet identity is the launcher's ``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINERS_NUM`` contract, which ``distributed/launch.py`` exports;
the JAX branch on ``jax.process_count()`` has no counterpart.
"""

import json
import os
import time

__all__ = ["StepAgreement", "fleet_rank", "fleet_world", "agree_secs",
           "preempt_quantum", "next_quantum_step", "round_open",
           "abort_stale_rounds", "restart_attempt"]

_ROUNDS = ".preempt"


# -- fleet identity -----------------------------------------------------------

def restart_attempt():
    """The elastic launcher's spawn-generation counter (0 outside it)."""
    try:
        return int(os.environ.get("PADDLE_RESTART_ATTEMPT", "0") or 0)
    except ValueError:
        return 0


def _env_int(name, default):
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def fleet_world():
    """Number of training processes sharing the checkpoint directory: the
    launcher's ``PADDLE_TRAINERS_NUM`` contract (1 outside a fleet)."""
    return max(_env_int("PADDLE_TRAINERS_NUM", 1), 1)


def fleet_rank():
    """This process's rank in fleet_world(): ``PADDLE_TRAINER_ID``."""
    return _env_int("PADDLE_TRAINER_ID", 0)


# -- knobs --------------------------------------------------------------------

def agree_secs():
    """Budget a rank waits for the whole fleet to publish its observed step
    before falling back to the quantum rule
    (``PADDLE_TPU_PREEMPT_AGREE_SECS``, default 30)."""
    try:
        return float(os.environ.get("PADDLE_TPU_PREEMPT_AGREE_SECS", "30"))
    except ValueError:
        return 30.0


def preempt_quantum():
    """K for the save-at-next-multiple-of-K fallback
    (``PADDLE_TPU_PREEMPT_QUANTUM``, default 10)."""
    return max(_env_int("PADDLE_TPU_PREEMPT_QUANTUM", 10), 1)


def next_quantum_step(step, quantum=None):
    """Next multiple of K STRICTLY greater than `step` (a rank already at a
    multiple still trains to the next one, so a one-boundary skew only
    mis-aligns when it straddles a multiple)."""
    q = preempt_quantum() if quantum is None else max(int(quantum), 1)
    return (int(step) // q + 1) * q


# -- round filesystem layout --------------------------------------------------

def _round_dir(directory, attempt=None):
    a = restart_attempt() if attempt is None else int(attempt)
    return os.path.join(str(directory), _ROUNDS, "round-a%d" % a)


def round_open(directory, attempt=None):
    """True when any rank has opened this attempt's agreement round — the
    cheap discovery probe non-signalled ranks run at step boundaries (one
    isdir stat), so ONE rank's SIGTERM preempts the whole fleet."""
    return os.path.isdir(_round_dir(directory, attempt))


def _set_gauge(step, mode):
    try:
        from ..monitor.registry import default_registry

        reg = default_registry()
        reg.gauge("ft.preempt.agreed_step").set(int(step))
        reg.counter("ft.preempt.rounds", mode=mode).incr()
    except Exception:
        pass                    # telemetry must never fail the protocol


class StepAgreement:
    """One preemption round from one rank's point of view."""

    def __init__(self, directory, rank=None, world=None, attempt=None):
        self.directory = str(directory)
        self.rank = fleet_rank() if rank is None else int(rank)
        self.world = fleet_world() if world is None else int(world)
        self.attempt = restart_attempt() if attempt is None else int(attempt)
        self.round_dir = _round_dir(directory, self.attempt)
        self.mode = None              # "agreed" | "fallback" after resolve
        self.steps_seen = {}          # rank -> published step (diagnostics)
        self._published = None

    # -- publish ------------------------------------------------------------
    def _my_path(self):
        return os.path.join(self.round_dir, "step-r%d.json" % self.rank)

    def publish(self, step):
        """Broadcast this rank's observed boundary (idempotent; the first
        published step wins — a round records where each rank OBSERVED the
        preemption, not where it ended up)."""
        if self._published is not None:
            return self._published
        os.makedirs(self.round_dir, exist_ok=True)
        tmp = self._my_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"rank": self.rank, "step": int(step),
                       "pid": os.getpid(), "attempt": self.attempt,
                       "t": time.time()}, f)
        os.replace(tmp, self._my_path())
        self._published = int(step)
        return self._published

    # -- poll / resolve ------------------------------------------------------
    def _read_round(self):
        steps = {}
        aborted = False
        try:
            names = os.listdir(self.round_dir)
        except OSError:
            return steps, aborted
        for name in names:
            if name == "ABORT":
                aborted = True
                continue
            if not (name.startswith("step-r") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.round_dir, name)) as f:
                    rec = json.load(f)
                steps[int(rec["rank"])] = int(rec["step"])
            except (OSError, ValueError, KeyError):
                continue          # mid-write / torn file: next poll sees it
        return steps, aborted

    def poll(self):
        """One non-blocking look at the round.  Returns the agreed step when
        every rank has published, None while pending.  Raises RoundAborted
        when a respawn killed the round."""
        steps, aborted = self._read_round()
        self.steps_seen = steps
        if aborted:
            raise RoundAborted(self.round_dir)
        if len(steps) >= self.world:
            agreed = max(steps.values())
            self.mode = "agreed"
            _set_gauge(agreed, "agreed")
            return agreed
        return None

    def resolve(self, observed_step, timeout=None, poll_interval=0.05):
        """Publish `observed_step` and block until the fleet agrees or the
        budget expires.  Returns (agreed_step, mode): mode "agreed" when all
        ranks published (agreed = max), "fallback" when the round timed out
        or was aborted (agreed = next multiple of the preemption quantum
        after `observed_step` — deterministic, no communication)."""
        self.publish(observed_step)
        deadline = time.monotonic() + (agree_secs() if timeout is None
                                       else float(timeout))
        while True:
            try:
                agreed = self.poll()
            except RoundAborted:
                break
            if agreed is not None:
                return agreed, self.mode
            if time.monotonic() >= deadline:
                break
            time.sleep(poll_interval)
        agreed = next_quantum_step(observed_step)
        self.mode = "fallback"
        _set_gauge(agreed, "fallback")
        return agreed, self.mode

    def abort(self):
        """Mark the round dead (respawned ranks must never join it)."""
        try:
            os.makedirs(self.round_dir, exist_ok=True)
            tmp = os.path.join(self.round_dir, "ABORT.tmp")
            with open(tmp, "w") as f:
                f.write("%d %d" % (os.getpid(), self.rank))
            os.replace(tmp, os.path.join(self.round_dir, "ABORT"))
        except OSError:
            pass


class RoundAborted(RuntimeError):
    """The agreement round was aborted (a respawn found it stale)."""


def abort_stale_rounds(directory, rank=None):
    """Respawn-time cleanup (called from TrainGuard.maybe_resume and the
    heartbeat re-arm): every agreement round on disk predates this
    incarnation — joining one would publish a STALE step into a round other
    ranks may still be polling, so each is marked ABORT first (pollers fall
    back deterministically) and then removed if it belongs to an older
    attempt.  Returns the last fully-resolved round's agreed step (or None)
    so the caller can re-export the ``ft.preempt.agreed_step`` gauge."""
    import shutil

    root = os.path.join(str(directory), _ROUNDS)
    if not os.path.isdir(root):
        return None
    me = restart_attempt()
    last_agreed = None
    rounds = []
    for name in os.listdir(root):
        if not name.startswith("round-a"):
            continue
        try:
            rounds.append((int(name[len("round-a"):]), name))
        except ValueError:
            continue
    # numeric attempt order ("round-a10" sorts lexically before "round-a2"):
    # last_agreed must come from the NEWEST resolved round
    for attempt, name in sorted(rounds):
        ag = StepAgreement(directory, rank=rank, attempt=attempt)
        steps, _aborted = ag._read_round()
        if len(steps) >= ag.world and steps:
            last_agreed = max(steps.values())
        if attempt < me:
            # a previous attempt's round: no rank of THIS incarnation may
            # join it.  ABORT first (a surviving old-incarnation poller
            # falls back deterministically instead of waiting on a ghost),
            # then reclaim the dir.
            ag.abort()
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
        else:
            # same-attempt round (manual restart without the launcher's
            # attempt bump): drop only OUR stale step file — publishing a
            # pre-crash step into a live round is exactly the bug this
            # cleanup exists to prevent — and leave the peers' round alone
            mine = os.path.join(root, name, "step-r%d.json" % ag.rank)
            try:
                with open(mine) as f:
                    if int(json.load(f).get("pid", -1)) != os.getpid():
                        os.remove(mine)
            except (OSError, ValueError):
                pass
    if last_agreed is not None:
        _set_gauge(last_agreed, "rearm")
    return last_agreed
