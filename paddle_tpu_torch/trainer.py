"""Dataset/trainer path (parity: SURVEY.md §3.5 — Executor.train_from_dataset
→ TrainerFactory → MultiTrainer threads × DeviceWorker::TrainFiles;
counterpart of the JAX package's ``trainer.py``).

The reference spins N Hogwild CPU threads each running the op graph against
a shared scope (device_worker.h:151).  Here the dataset's file readers
stream batches (dataset.py, through the native C++ datafeed), a
``feed_pipe.DeviceFeedPipe`` stages each batch on the card off the training
thread, and one executor step on the card consumes them — N reader threads
feed one device pipe.  Fetches stay lazy (tensors on the card); the
executor's in-flight window bounds how far the host runs ahead.

A data-parallel program (fleet- or transpiler-tagged, or a
``with_data_parallel`` CompiledProgram) runs through ``Executor.run`` as the
reference's trainer passes it: every rank reads the global batch from the
dataset, the pipe stages this rank's rows (``Executor.feed_converter``),
and fetches come back gathered to the global batch, so ``fetch_list``,
``debug`` printing and the fetch handler see what one device would.

``checkpoint=ft.CheckpointPolicy(...)`` runs the loop under FaultGuard
(``ft/guard.py`` TrainGuard): auto-checkpoints at step boundaries, exact-
batch resume through the dataset's cursor mode, SIGTERM → checkpoint and
``PREEMPTED_RC``.  Under data parallelism every rank reads the global
batch, so the cursor is the global one.

HostPS prefetch hooks (``hostps/service.py`` ``register_prefetch_hook``):
when any is registered, the NEXT batch's raw host feed is announced to them
while the current step runs — by the feed pipe as it hands batch k over, or
by the inline one-batch lookahead ``_iter_with_prefetch`` when the pipe is
off — under ``checkpoint=`` and under data parallelism alike.
"""

import sys
import threading
import time

import numpy as np

from . import feed_pipe
from .monitor import trace as _trace

__all__ = ["FetchHandler"]


class FetchHandler:
    """Background scalar monitoring during train_from_dataset (parity:
    executor.py:397 FetchHandler + its monitor thread): every period_secs a
    daemon thread snapshots the requested persistable vars from the scope
    and calls handler(fetch_dict) with numpy values.  Subclass and override
    handler() (the reference's contract)."""

    def __init__(self, var_dict, period_secs=60):
        # var_dict: {display_name: Variable-or-name}
        self.var_dict = var_dict
        self.period_secs = period_secs

    def handler(self, fetch_dict):
        print({k: (np.asarray(v).tolist() if v is not None else None)
               for k, v in fetch_dict.items()})


class _FetchMonitor:
    def __init__(self, handler, scope):
        self.h = handler
        self.scope = scope
        self._stop = threading.Event()
        self._lock = threading.Lock()   # handler never runs reentrantly
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _snapshot(self):
        # the first fire can race startup: a requested var may not be
        # materialized in the scope yet.  A monitor thread must never kill
        # training over that — report None for the missing name and count
        # the miss as a monitor warning stat instead of letting the
        # exception escape the thread.
        out = {}
        for name, v in self.h.var_dict.items():
            try:
                out[name] = self.scope.find_tensor_as_numpy(
                    v if isinstance(v, str) else v.name)
            except Exception:
                out[name] = None
            if out[name] is None:
                from .monitor import stat_add

                stat_add("monitor.fetch_handler.missing_var")
        return out

    def _fire(self):
        with self._lock:
            self.h.handler(self._snapshot())

    def _run(self):
        while not self._stop.wait(self.h.period_secs):
            self._fire()

    def start(self):
        self._thread.start()

    def stop(self, run_final=True):
        self._stop.set()
        self._thread.join(timeout=5)
        if run_final:
            # final snapshot so short runs still report once (the reference
            # flushes the handler on Stop); skipped when training raised so
            # user handler errors never mask the real exception
            self._fire()


def _iter_with_prefetch(batches):
    """One-batch lookahead over a feed iterator: batch k+1 is announced to
    the HostPS prefetch hooks (hostps/service.py) BEFORE batch k is yielded
    to the executor, so the prefetch thread pulls step k+1's host-RAM rows
    while step k runs — the trainer-side half of the Downpour pipeline
    (device_worker.h:180 DownpourWorker's PullSparse-ahead)."""
    from .hostps import service as hostps_service

    it = iter(batches)
    try:
        cur = next(it)
    except StopIteration:
        return
    for nxt in it:
        hostps_service.notify_next_batch(nxt)
        yield cur
        cur = nxt
    yield cur


def _run_from_dataset(executor, program=None, dataset=None, scope=None, thread=0,
                      debug=False, fetch_list=None, fetch_info=None,
                      print_period=100, fetch_handler=None, train=True,
                      checkpoint=None):
    from .framework import default_main_program
    from .scope import global_scope

    program = program or default_main_program()
    if dataset is None:
        raise ValueError("train_from_dataset requires a dataset")
    fetch_list = fetch_list or []

    # FaultGuard (ft/guard.py): auto-checkpoint + exact-batch resume +
    # SIGTERM preemption handling, driven by a ft.CheckpointPolicy.  Resume
    # happens BEFORE the iterator is built so the dataset fast-forwards to
    # the saved (file_idx, batch_idx) cursor.  On a fleet (world > 1) the
    # boundary hook runs the agreed-boundary preemption protocol
    # (ft/agree.py): ranks SIGTERM'd at skewed boundaries converge on ONE
    # max-step ckpt-<step> before exiting, and maybe_resume() aborts any
    # stale agreement round a previous incarnation left behind.
    guard = None
    start_cursor = None
    resumed_step = 0
    if checkpoint is not None and not train:
        raise ValueError(
            "checkpoint= (ft.CheckpointPolicy) applies to training only — "
            "infer_from_dataset has no state to checkpoint or resume")
    if checkpoint is not None:
        from .ft.guard import TrainGuard

        guard = TrainGuard(checkpoint, executor,
                           scope if scope is not None else global_scope(),
                           program=program)
        start_cursor, resumed_step = guard.maybe_resume()
        guard.install_signal()
    monitor = None
    if fetch_handler is not None:
        monitor = _FetchMonitor(fetch_handler,
                                scope if scope is not None else global_scope())
        monitor.start()
    from . import monitor as run_monitor

    mon = run_monitor.active()
    t_run = time.perf_counter()
    if mon is not None:
        mon.timeline.emit("run_start", train=train)
        # model-health run bracket (monitor/sentinel.py): the sentinel's
        # steps/s window restarts so a resumed or back-to-back run never
        # rates across the gap; detection itself rides Executor.run
        if train and getattr(mon, "sentinel", None) is not None:
            mon.sentinel.on_run_start(train=train)
    step = resumed_step
    steps_this_run = 0
    ok = False
    pipe = None
    cursors = None
    try:
        with _trace.span("trainer.run_from_dataset", train=train):
            # thread<=0 falls back to the dataset's set_thread()
            # (executor.py:1093 contract: "thread ... if not set, use
            # dataset thread_num")
            if guard is not None:
                import collections

                # cursor-tracked source: the dataset yields (cursor, feed);
                # cursors ride a FIFO beside the (order-preserving) feed
                # pipe so the training thread can pair each consumed batch
                # with its (file_idx, batch_idx) without teaching the pipe
                # about cursors
                raw_batches = dataset._iter_batches(
                    num_threads=thread or None, skip_to=start_cursor,
                    with_cursor=True)
                cursors = collections.deque()

                def _cursor_tap(it=raw_batches, q=cursors):
                    for cur, feed in it:
                        q.append(cur)
                        yield feed

                batches = _cursor_tap()
            else:
                batches = dataset._iter_batches(num_threads=thread or None)
            from .hostps import service as hostps_service

            notify = (hostps_service.notify_next_batch
                      if hostps_service.has_prefetch_hooks() else None)
            if feed_pipe.pipe_enabled():
                # Pipelined device feed (feed_pipe.DeviceFeedPipe): a
                # background stage converts batch k+1 and starts its copy
                # to the card while step k runs, and each take announces
                # the NEXT staged batch's raw host feed to the HostPS
                # prefetch hooks (one ahead, the inline lookahead's
                # contract).  PADDLE_TPU_FEED_PIPE=0 restores the inline
                # path.
                pipe = feed_pipe.DeviceFeedPipe(
                    batches, convert=executor.feed_converter(program),
                    notify=notify,
                    depth=getattr(dataset, "queue_num", None),
                    name="train_feed_pipe")
                batches = pipe
            elif notify is not None:
                batches = _iter_with_prefetch(batches)
            for feed in batches:
                cur = cursors.popleft() if cursors is not None else None
                # lazy fetches: the tensors stay on the card, so steady-state
                # steps never block on their own results — the executor's
                # in-flight window (K steps) bounds host run-ahead
                with _trace.span("train.step", step=step):
                    res = executor.run(program, feed=feed,
                                       fetch_list=fetch_list,
                                       scope=scope, return_numpy=False)
                if debug and fetch_list and step % print_period == 0:
                    info = fetch_info or [v if isinstance(v, str) else v.name
                                          for v in fetch_list]
                    print("step %d: %s" % (step, {
                        k: r.detach().cpu().numpy().tolist()
                        for k, r in zip(info, res)}))
                step += 1
                steps_this_run += 1
                if guard is not None:
                    # boundary hook: preemption exit and cadence saves both
                    # happen HERE — after step `step` retired its dispatch,
                    # with `cur` the cursor of the batch it trained
                    guard.after_step(step, cur)
            executor.drain()   # run seconds below measure COMPLETED steps
            if guard is not None:
                guard.finish()
            ok = True
    except BaseException as e:
        # crash flight recorder: a run dying mid-step dumps its evidence
        # (recent spans incl. the pipe thread, timeline tail, registry)
        # BEFORE the exception propagates — the caller may catch it and the
        # process may live on, but the postmortem persists.  SystemExit is
        # a deliberate departure, not a crash — the guard's preemption path
        # already dumped its own `preempted` postmortem
        if mon is not None and getattr(mon, "flight", None) is not None \
                and not isinstance(e, SystemExit):
            try:
                mon.flight.dump(exc=sys.exc_info(),
                                reason="train_from_dataset")
            except Exception:
                pass
        raise
    finally:
        if guard is not None:
            guard.restore_signal()   # idempotent; finish() ran on ok paths
        if pipe is not None:
            pipe.close()
        if mon is not None:
            mon.timeline.emit("run_end", train=train, steps=steps_this_run,
                              ok=ok,
                              seconds=round(time.perf_counter() - t_run, 4))
            mon.timeline.flush()
        if monitor is not None:
            monitor.stop(run_final=ok)
    return None
