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

Two hooks of the reference wait for later items and raise, naming them:
``checkpoint=`` (FaultGuard's auto-checkpoint and exact-batch resume,
ROADMAP Queue 1 item 6) and the HostPS prefetch hooks (item 7).
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


def _hostps_unported():
    return NotImplementedError(
        "HostPS prefetch hooks (the one-batch lookahead that announces the "
        "next feed to the host parameter server) wait for ROADMAP Queue 1 "
        "item 7")


def _iter_with_prefetch(batches):
    """One-batch lookahead over a feed iterator for the HostPS prefetch
    hooks (JAX ``trainer.py``); the port has no HostPS yet."""
    raise _hostps_unported()


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
    if checkpoint is not None and not train:
        raise ValueError(
            "checkpoint= (ft.CheckpointPolicy) applies to training only — "
            "infer_from_dataset has no state to checkpoint or resume")
    if checkpoint is not None:
        raise NotImplementedError(
            "train_from_dataset(checkpoint=...): FaultGuard's auto-checkpoint "
            "and exact-batch resume wait for ROADMAP Queue 1 item 6 (fault "
            "tolerance)")
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
        # steps/s window restarts so a back-to-back run never rates across
        # the gap; detection itself rides Executor.run
        if train and getattr(mon, "sentinel", None) is not None:
            mon.sentinel.on_run_start(train=train)
    step = 0
    ok = False
    pipe = None
    try:
        with _trace.span("trainer.run_from_dataset", train=train):
            # thread<=0 falls back to the dataset's set_thread()
            # (executor.py:1093 contract: "thread ... if not set, use
            # dataset thread_num")
            batches = dataset._iter_batches(num_threads=thread or None)
            if feed_pipe.pipe_enabled():
                # Pipelined device feed (feed_pipe.DeviceFeedPipe): a
                # background stage converts batch k+1 and starts its copy
                # to the card while step k runs.  PADDLE_TPU_FEED_PIPE=0
                # restores the inline path.
                pipe = feed_pipe.DeviceFeedPipe(
                    batches, convert=executor.feed_converter(program),
                    depth=getattr(dataset, "queue_num", None),
                    name="train_feed_pipe")
                batches = pipe
            for feed in batches:
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
            executor.drain()   # run seconds below measure COMPLETED steps
            ok = True
    except BaseException:
        # crash flight recorder: a run dying mid-step dumps its evidence
        # (recent spans incl. the pipe thread, timeline tail, registry)
        # BEFORE the exception propagates — the caller may catch it and the
        # process may live on, but the postmortem persists
        if mon is not None and getattr(mon, "flight", None) is not None:
            try:
                mon.flight.dump(exc=sys.exc_info(),
                                reason="train_from_dataset")
            except Exception:
                pass
        raise
    finally:
        if pipe is not None:
            pipe.close()
        if mon is not None:
            mon.timeline.emit("run_end", train=train, steps=step, ok=ok,
                              seconds=round(time.perf_counter() - t_run, 4))
            mon.timeline.flush()
        if monitor is not None:
            monitor.stop(run_final=ok)
    return None
