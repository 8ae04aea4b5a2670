"""TrainGuard: auto-checkpoint + exact-batch resume + preemption handling
for every training entry point (the ft layer's trainer-side half).

Parity: the reference's Downpour trainer resumes a killed worker from the
pserver snapshot + pass cursor, and its launcher respawns it; here the
guard owns the same lifecycle around the step loop:

- boundary saves per CheckpointPolicy (ft/policy.py), async by default;
  every snapshot is taken AFTER the executor / in-flight window drains, so
  no queued update is mid-flight and the state is exactly post-step-k;
- ``resume=True`` restores the latest committed unified checkpoint
  (ft/ckpt.py) into the scope / HostPS tables / RNG streams / executor
  seed counter and returns the dataset cursor for exact-batch fast-forward;
- SIGTERM (preemption notice) is handled at a step boundary: final
  synchronous checkpoint, a ``preempted`` timeline event, a flight-recorder
  postmortem, then ``SystemExit(PREEMPTED_RC)`` — the distinct rc
  ``distributed/launch.py`` elastic mode restarts WITHOUT burning a retry
  (preemptions are routine, not failures).

MULTI-RANK PREEMPTION (the agreed-boundary protocol, ft/agree.py): in a
fleet, ranks observe SIGTERM at whichever boundary each checks next — one
boundary apart, they would stage different ``ckpt-<step>`` dirs and the
COMMIT barrier would time out.  So on a fleet (world > 1) the boundary hook
runs the agreement protocol instead of saving immediately:

1. the first rank to observe SIGTERM opens an agreement round in the
   checkpoint directory and publishes its observed step; every OTHER rank
   discovers the open round at its next boundary (one stat) and joins —
   a single rank's SIGTERM preempts the whole fleet;
2. each rank blocks briefly until all ``world`` ranks have published
   (budget ``PADDLE_TPU_PREEMPT_AGREE_SECS``); the agreed save step is
   ``max`` over the published steps — every rank behind the max keeps
   TRAINING to that boundary, so all ranks stage the SAME ``ckpt-<step>``
   and COMMIT succeeds;
3. if the round cannot resolve (a rank died, or no shared agreement medium)
   each rank falls back to save-at-next-multiple-of-K
   (``PADDLE_TPU_PREEMPT_QUANTUM``) — deterministic, communication-free;
4. if a rank is genuinely lost, the staged save's COMMIT barrier times out
   and DEGRADES (parallel/checkpoint.py BarrierTimeout: staged dirs
   reclaimed, ``ft.barrier.timeouts`` + ``fleet_lost`` emitted, previous
   committed checkpoint stays authoritative) — the guard still exits with
   ``PREEMPTED_RC``; correctness holds, resume falls back one checkpoint.

Wall-clock cadence (``every_secs``) in a fleet is rank-0-led: clocks skew,
so rank 0 picks the boundary (next quantum multiple) and publishes it as a
cadence marker every rank reads at its boundaries — all ranks then save at
the SAME step.  Step cadence (``every_steps``) is already deterministic and
needs no coordination.

``LoopGuard`` extends the same state machine to raw step loops
(parallel/train.py TrainLoop): the checkpointed state is a tree of tensors
saved straight through parallel/checkpoint.py, with its specs and mesh,
instead of a program scope.

The port's counterpart of ``paddle_tpu/ft/guard.py``.  A snapshot waits
for the executor's (or the loop's) in-flight window and, on a card, for
the current stream, so no queued update is mid-flight when the state is
copied to host memory.
"""

import os
import signal
import sys
import threading
import time
import warnings

from . import PREEMPTED_RC            # single source: ft/__init__.py
from . import agree as _agree
from . import chaos as _chaos
from . import ckpt as _ckpt

__all__ = ["TrainGuard", "LoopGuard", "PREEMPTED_RC"]


def _poll_every_steps():
    """How often (in boundaries) a non-signalled rank probes for an open
    agreement round (``PADDLE_TPU_PREEMPT_POLL_STEPS``, default 1 = every
    boundary; raise it when the checkpoint dir is a slow network mount,
    0 disables discovery — only directly-signalled ranks join rounds)."""
    try:
        return max(int(os.environ.get(
            "PADDLE_TPU_PREEMPT_POLL_STEPS", "1")), 0)
    except ValueError:
        return 1


class BoundaryGuard:
    """The fault-tolerance state machine every training entry point shares:
    step-boundary chaos points, preemption (single-rank immediate /
    multi-rank agreed-boundary), cadence saves, barrier-timeout degradation.
    Subclasses provide the state capture:

      _write_state(asynchronous) -> writer with .finish()/.asynchronous
      _drain()                      block until no update is in flight
    """

    def __init__(self, policy):
        self.policy = policy
        self.rank = _agree.fleet_rank()
        self.world = _agree.fleet_world()
        self._writer = None          # in-flight async state writer
        self._preempt = threading.Event()
        self._prev_handler = None
        self._installed = False
        self._step = 0
        self._agreement = None       # StepAgreement once a round is joined
        self._agreed_step = None
        self._poll_every = _poll_every_steps()
        self._cadence_done = 0       # last rank-0-led cadence target handled

    # -- subclass hooks ---------------------------------------------------
    def _write_state(self, asynchronous):
        raise NotImplementedError

    def _drain(self):
        pass

    # -- signals ----------------------------------------------------------
    def install_signal(self):
        """Arm the SIGTERM preemption handler (main thread only — elsewhere
        the platform's notice must be delivered another way)."""
        def _on_term(signum, frame):
            self._preempt.set()

        try:
            self._prev_handler = signal.signal(signal.SIGTERM, _on_term)
            self._installed = True
        except ValueError:           # not the main thread
            warnings.warn(
                "TrainGuard: not on the main thread — SIGTERM preemption "
                "handling disabled for this run")

    def restore_signal(self):
        if self._installed:
            try:
                signal.signal(signal.SIGTERM, self._prev_handler)
            except ValueError:
                pass
            self._installed = False

    def request_preempt(self):
        """Programmatic preemption notice (what the SIGTERM handler does)."""
        self._preempt.set()

    @property
    def preempt_requested(self):
        return self._preempt.is_set()

    # -- boundary hooks ---------------------------------------------------
    def after_step(self, step, cursor=None):
        """Called once per trained step.  Order: the chaos kill/sigterm
        drill points first (a drill-delivered signal is observed at THIS
        boundary), then the preemption protocol, then cadence saves."""
        self._step = step
        self._note_cursor(cursor)
        _chaos.maybe_fire("kill_step")
        _chaos.maybe_fire("sigterm_step")
        if self.world > 1:
            self._boundary_multi(step)
        elif self._preempt.is_set():
            self._preempt_exit()
        # no cadence save once preemption is pending: the agreed-boundary
        # save covers it, and in a degraded fleet (lost rank) every extra
        # staged save would burn a full COMMIT-barrier budget first
        if not self._preempt.is_set() and self._cadence_due(step):
            self._cadence_save()

    def _note_cursor(self, cursor):
        pass

    # -- multi-rank preemption --------------------------------------------
    def _boundary_multi(self, step):
        """The agreed-boundary protocol at one step boundary.  May exit the
        process (PREEMPTED_RC); returning means: keep training."""
        if self._agreed_step is None:
            joined = self._preempt.is_set() or (
                self._poll_every > 0 and step % self._poll_every == 0
                and _agree.round_open(self.policy.dirname))
            if not joined:
                return
            self._preempt.set()
            ag = self._agreement = _agree.StepAgreement(self.policy.dirname)
            agreed, mode = ag.resolve(step)
            self._agreed_step = agreed
            mon = self._mon()
            if mon is not None:
                mon.timeline.emit(
                    "preempt_agree", observed=step, agreed=agreed,
                    mode=mode, rank=self.rank,
                    steps={str(r): s for r, s in
                           sorted(ag.steps_seen.items())})
                mon.timeline.flush()   # the process exits soon — don't
                                       # lose the agreement evidence
        if step >= self._agreed_step:
            self._preempt_exit()
        # behind the agreed boundary: keep training up to it

    # -- cadence ----------------------------------------------------------
    def _cadence_due(self, step):
        if self.world == 1:
            return self.policy.should_save(step)
        # fleet: the step half is deterministic — act on it locally; the
        # wall-clock half is rank-0-led through the cadence marker
        if self.policy.step_due(step):
            return True
        if self.policy.every_secs is None:
            return False
        target = self._cadence_target(step)
        return target is not None and step == target

    def _cadence_marker(self):
        return os.path.join(str(self.policy.dirname), ".cadence-step")

    def _cadence_target(self, step):
        """Rank-0-led wall-clock cadence: rank 0's timer picks the NEXT
        quantum boundary and publishes it; every rank saves when it reaches
        exactly that step.  Published targets are always quantum multiples,
        so boundaries off the quantum grid skip the marker read entirely
        (no per-step shared-fs IO in the hot loop).  A rank already past a
        marker it never saw in time counts a miss instead of staging a
        mismatched step."""
        if step % _agree.preempt_quantum() != 0:
            return None
        marker = self._cadence_marker()
        try:
            with open(marker) as f:
                target = int(f.read().strip() or 0)
        except (OSError, ValueError):
            target = 0
        if target <= self._cadence_done and self.rank == 0 \
                and self.policy.time_due():
            # previous target satisfied (or none yet): publish the next
            # boundary.  Never overwrite a still-PENDING target — rank 0
            # republishing at the very boundary the marker names would
            # chase its own marker forever and no one would ever save
            target = _agree.next_quantum_step(step)
            try:
                tmp = marker + ".tmp"
                with open(tmp, "w") as f:
                    f.write("%d" % target)
                os.replace(tmp, marker)
            except OSError:
                return None
        if target <= self._cadence_done:
            return None
        if step > target:
            # published boundary already behind this rank (severe drift or
            # a stale marker from a previous incarnation): never stage a
            # step the others didn't — count it and move on
            self._cadence_done = target
            try:
                from ..monitor.registry import stat_add

                stat_add("ft.cadence.missed")
            except Exception:
                pass
            return None
        return target

    def _cadence_save(self):
        from ..parallel.checkpoint import BarrierTimeout

        self._cadence_done = max(self._cadence_done, self._step)
        try:
            self.save(asynchronous=self.policy.asynchronous)
        except BarrierTimeout as e:
            # degradation, not death: the previous committed checkpoint is
            # authoritative (counters/events already emitted by the
            # checkpoint layer); training continues — heartbeats and the
            # launcher own declaring the fleet dead
            self.policy.note_saved(self._step)
            warnings.warn("cadence checkpoint degraded: %s" % e)

    # -- save / flush ------------------------------------------------------
    def save(self, asynchronous=None):
        """Checkpoint the current boundary state.  Waits out (and surfaces
        errors from) any previous in-flight async save first — overlapping
        writers would race retention/GC, and a silently failed checkpoint
        is worse than a failed step."""
        t0 = time.perf_counter()
        self.flush()
        self._drain()              # no update mid-flight past here
        writer = self._write_state(
            asynchronous=(self.policy.asynchronous
                          if asynchronous is None else asynchronous))
        if hasattr(writer, "block_ms"):
            writer.block_ms = (time.perf_counter() - t0) * 1e3
        self.policy.note_saved(self._step)
        if writer.asynchronous:
            self._writer = writer
        else:
            writer.finish()
        return writer

    def flush(self):
        """Block on the in-flight async writer (if any), surfacing its
        error and emitting its telemetry.  A BarrierTimeout is the
        DEGRADED outcome, not an error to die on — it is re-raised so save
        paths can react, but finish()/preempt paths absorb it."""
        w, self._writer = self._writer, None
        if w is not None:
            w.finish()

    def finish(self):
        """Clean run end: drain the writer and disarm the handler.  (No
        implicit final save — the caller owns end-of-run persistence.)  A
        barrier-degraded async save surfaces as a warning here, never as a
        crash of a COMPLETED run."""
        from ..parallel.checkpoint import BarrierTimeout

        try:
            try:
                self.flush()
            except BarrierTimeout as e:
                warnings.warn("final checkpoint degraded: %s" % e)
        finally:
            self.restore_signal()

    # -- preemption -------------------------------------------------------
    def _mon(self):
        from .. import monitor as _monitor

        return _monitor.active()

    def _preempt_exit(self):
        """The SIGTERM boundary path: final sync checkpoint, `preempted`
        timeline event, flight-recorder postmortem, distinct exit rc.  A
        COMMIT-barrier timeout (lost rank) degrades: no new checkpoint,
        previous committed one stays authoritative, SAME preemption rc —
        the restart is still free."""
        from ..parallel.checkpoint import BarrierTimeout

        ckpt_path = None
        degraded = False
        try:
            if self.policy.save_on_preempt:
                try:
                    self.save(asynchronous=False)
                    ckpt_path = os.path.join(self.policy.dirname,
                                             "ckpt-%d" % self._step)
                except BarrierTimeout as e:
                    degraded = True
                    warnings.warn("preemption checkpoint degraded: %s" % e)
                except Exception as e:
                    # any OTHER final-save failure (e.g. a peer's barrier
                    # timeout reclaimed the dir this rank was publishing
                    # into) must not turn a routine preemption into a
                    # crash rc — the previous committed checkpoint is
                    # authoritative either way, and the restart stays free
                    degraded = True
                    warnings.warn("preemption checkpoint failed: %r" % e)
        finally:
            mon = self._mon()
            if mon is not None:
                ev = {"step": self._step, "ckpt": ckpt_path,
                      "rc": PREEMPTED_RC}
                if self._agreed_step is not None:
                    ev["agreed"] = self._agreed_step
                    ev["agree_mode"] = getattr(
                        self._agreement, "mode", None)
                if degraded:
                    ev["degraded"] = True
                mon.timeline.emit("preempted", **ev)
                mon.timeline.flush()
                if getattr(mon, "flight", None) is not None:
                    try:
                        mon.flight.dump(exc=None, reason="preempted")
                    except Exception:
                        pass
            self.restore_signal()
        sys.exit(PREEMPTED_RC)


class TrainGuard(BoundaryGuard):
    """One train_from_dataset run's fault-tolerance state machine: the
    BoundaryGuard protocol over the program scope + HostPS tables + dataset
    cursor + RNG streams (the unified TrainState, ft/ckpt.py)."""

    def __init__(self, policy, executor, scope, program=None):
        super().__init__(policy)
        self.executor = executor
        self.scope = scope
        self.program = program
        self._last_cursor = None

    # -- scope <-> checkpoint --------------------------------------------
    def _persistable_names(self):
        from ..framework import default_main_program

        program = self.program or default_main_program()
        # a CompiledProgram (with_data_parallel, tensor parallelism) lists
        # the vars of the program it wraps
        program = getattr(program, "_program", program)
        return sorted(v.name for v in program.list_vars()
                      if v.persistable and self.scope.has_var(v.name))


    def _note_cursor(self, cursor):
        self._last_cursor = cursor

    # -- resume -----------------------------------------------------------
    def maybe_resume(self):
        """Restore the latest committed checkpoint when the policy asks for
        it.  Returns (cursor, step): the dataset fast-forward point (None =
        from the top) and the restored step counter.  Also the respawn
        hook: any agreement round on disk predates this incarnation and is
        aborted so no rank ever joins one with a stale step."""
        if not self.policy.resume:
            return None, 0
        if self.world > 1:
            _agree.abort_stale_rounds(self.policy.dirname, rank=self.rank)
        rs = _ckpt.restore_train_state(
            self.policy.dirname,
            _ckpt.scope_targets(self.scope, self._persistable_names()),
            hostps=self.policy.hostps)
        if rs is None:
            return None, 0           # first attempt: nothing committed yet
        # each var back in the scope's current layout (this world's rows
        # and splits, whatever world saved it)
        _ckpt.restore_into_scope(self.scope, rs.scope_state)
        if rs.exec_step is not None:
            # the executor's seed counter: step-derived RNG (dropout etc.)
            # replays exactly as the uninterrupted run would have drawn it
            self.executor._step = rs.exec_step
        self._step = rs.step
        self._last_cursor = rs.cursor
        self._cadence_done = rs.step     # stale cadence markers are history
        self.policy.note_saved(rs.step)  # cadence restarts from here
        mon = self._mon()
        if mon is not None:
            # saver_world/world are the elastic-resume evidence: a
            # topology-changed resume shows saver_world != world (the
            # trace_summary "resharded resume" row reads exactly this)
            mon.timeline.emit("resume", step=rs.step, ckpt=rs.path,
                              cursor=list(rs.cursor) if rs.cursor else None,
                              saver_world=rs.saver_world, world=rs.world,
                              resharded=rs.resharded)
            # flushed now: a rank killed WITHOUT warning (the chaos
            # kill_step drill, real hardware loss) must still leave its
            # resume evidence on disk for the postmortem
            mon.timeline.flush()
        return rs.cursor, rs.step

    # -- state capture ----------------------------------------------------
    def _drain(self):
        self.executor.drain()
        _sync_card(getattr(self.executor, "device", "cpu"))

    def _write_state(self, asynchronous):
        return _ckpt.save_train_state(
            self.policy.dirname, self._step,
            scope_state=_ckpt.scope_blocks(self.scope,
                                           self._persistable_names()),
            cursor=self._last_cursor,
            exec_step=self.executor._step,
            hostps=self.policy.hostps,
            asynchronous=asynchronous,
            keep=self.policy.keep)


class LoopGuard(BoundaryGuard):
    """The BoundaryGuard protocol for raw step loops (parallel/train.py
    TrainLoop): state is whatever tree ``state_fn()`` returns at a
    boundary, saved through parallel/checkpoint.py's shard/COMMIT protocol
    with the step in the manifest; ``specs``/``mesh`` give each leaf's
    placement (this rank's blocks of a ZeRO, tp or pp state).  No dataset
    cursor / scope / RNG capture — functional loops re-derive their input
    stream deterministically and fast-forward by step count (TrainLoop.run
    does exactly that).  A HostPS step loop names its tables in
    ``policy.hostps``: they are snapshotted at the same boundary into the
    checkpoint's ``hostps/p<K>/`` subtree (``ft.ckpt.hostps_extras``, CRC'd
    with the manifest) and restored with the state.  The reference's loop
    checkpoint carries no HostPS table; ``hostps=None`` keeps that."""

    def __init__(self, policy, state_fn, drain=None, specs=None, mesh=None):
        super().__init__(policy)
        self._state_fn = state_fn
        self._drain_fn = drain
        self._specs = specs
        self._mesh = mesh

    def _drain(self):
        if self._drain_fn is not None:
            self._drain_fn()

    def _tree_specs(self):
        if self._specs is None:
            return None, None
        from ..parallel.rules import P

        return {"state": self._specs, "meta": {"step": P()}}, self._mesh

    def _write_state(self, asynchronous):
        import numpy as np

        from ..parallel import checkpoint as _base

        t0 = time.perf_counter()
        tree = {"state": self._state_fn(),
                "meta": {"step": np.int64(self._step)}}
        specs, mesh = self._tree_specs()
        extras, hp_bytes = (None, 0) if self.policy.hostps is None else \
            _ckpt.hostps_extras(self.policy.hostps, self.rank)
        writer = _base.save_checkpoint(
            self.policy.dirname, tree, step=self._step,
            asynchronous=asynchronous, keep=self.policy.keep,
            specs=specs, mesh=mesh, extras=extras)
        # same telemetry contract as the trainer-side saves: wrapping in
        # TrainStateWriter gives loop checkpoints the ft.ckpt.{saves,bytes,
        # secs} counters and per-save `ckpt` timeline events
        out = _ckpt.TrainStateWriter(
            writer, self._step,
            _base.written_nbytes(tree, specs, mesh) + hp_bytes, t0,
            asynchronous)
        if not asynchronous:
            writer.wait()
        return out

    def maybe_resume(self, state_template):
        """Restore the latest committed loop checkpoint into the structure
        of `state_template` (each leaf this rank's block under the loop's
        specs).  Returns (state, step) — (template, 0) when nothing is
        committed yet."""
        import numpy as np

        from ..parallel import checkpoint as _base

        if not self.policy.resume:
            return state_template, 0
        if self.world > 1:
            _agree.abort_stale_rounds(self.policy.dirname, rank=self.rank)
        path = _base.latest_checkpoint(str(self.policy.dirname))
        if path is None:
            return state_template, 0
        # loop checkpoints are topology-portable the same way the unified
        # ones are: the base re-sharder reassembles from the saver's layout
        # manifests and re-slices onto this rank's placement (manifests
        # loaded once, shared between the topology probe and the restore)
        indexes = _base._load_indexes(path)
        topo = _base.checkpoint_topology(path, indexes=indexes)
        resharded = topo["world"] != self.world
        specs, mesh = self._tree_specs()
        tree, step = _base.restore_checkpoint(
            path, {"state": state_template, "meta": {"step": np.int64(0)}},
            indexes=indexes, specs=specs, mesh=mesh)
        if self.policy.hostps is not None:
            _base.verify_checkpoint_files(
                path, only=lambda rel: rel.startswith("hostps/"))
            _ckpt.restore_hostps(path, indexes, self.policy.hostps,
                                 resharded, "p%d" % self.rank)
        if resharded:
            from ..monitor.registry import stat_add

            stat_add("ft.ckpt.reshards")
        self._step = step
        self._cadence_done = step
        self.policy.note_saved(step)
        mon = self._mon()
        if mon is not None:
            mon.timeline.emit("resume", step=step, ckpt=path, cursor=None,
                              saver_world=topo["world"], world=self.world,
                              resharded=resharded)
            mon.timeline.flush()
        return tree["state"], step


def _sync_card(device):
    """Wait for the current stream of ``device`` when it is a card."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
