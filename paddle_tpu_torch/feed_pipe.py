"""Pipelined device feed + bounded async dispatch (the latency-hiding layer;
counterpart of the JAX package's ``feed_pipe.py``).

Parity surface: operators/reader/buffered_reader.cc — the reference hides
host input cost behind device compute with a double-buffered reader whose
worker threads stage the NEXT batch's tensors (and start their host→device
copies) while the current batch trains.  Here the same discipline is a
single reusable stage:

- ``DeviceFeedPipe`` — a bounded background thread that pulls raw feed
  dicts from a source iterator, runs the feed conversion OFF the training
  thread, and hands device-resident batches to the consumer in source
  order.  On a card the conversion (``PinnedStager``) copies each value
  into a pinned host buffer and from there to the device with
  ``non_blocking=True`` on a side CUDA stream, then records an event; the
  consumer's stream waits on that event when it takes the batch.  While
  step k runs on the card, batch k+1 converts and its copy is in flight —
  the training thread's per-step feed cost collapses to a queue pop.
- ``InFlightWindow`` — the depth governor for the OTHER side of the step:
  lazy fetches (``return_numpy=False``) let the host run ahead of the
  card; the window bounds outstanding steps to K (default 2) by waiting on
  a CUDA event recorded after each step's outputs.

Two hazards of the card's asynchrony are handled where they arise:

1. a pinned staging buffer is reused only after the event of the copy
   that last read it has completed (``PinnedStager``), so a batch is never
   overwritten while its copy is in flight;
2. a device tensor allocated on the side stream and read on the compute
   stream is marked with ``record_stream`` when it is taken, so the caching
   allocator does not hand its memory to the next batch's copy while the
   step still reads it.

Both stages export their health through the monitor registry when a session
is active (``monitor.pipe.*`` gauges/histograms and per-batch ``pipe``
timeline events), so the step timeline shows where time hides: feed_stall_ms
(consumer waited on the pipe — input bound), put_wait_ms (producer waited on
the consumer — device bound, the healthy state), overlap_ms (conversion time
the pipe hid behind compute), fetch_wait_ms (governor waits).

Worker exceptions propagate to the training thread with the ORIGINAL
traceback (the worker frame included), never as a bare queue timeout or a
spurious StopIteration.
"""

import os
import queue as _queue
import threading
import time

import numpy as np
import torch

from .dtypes import convert_dtype
from .ft import chaos as _chaos
from .monitor import memscope as _memscope
from .monitor import trace as _trace

__all__ = ["DeviceFeedPipe", "InFlightWindow", "PinnedStager",
           "make_feed_convert", "make_placer", "pipe_enabled",
           "default_depth", "default_inflight"]


def pipe_enabled(default=True):
    """PADDLE_TPU_FEED_PIPE=0 disables the background feed stage globally
    (the A/B escape hatch)."""
    v = os.environ.get("PADDLE_TPU_FEED_PIPE")
    if v is None:
        return default
    return v.strip().lower() not in ("0", "false", "off")


def default_depth():
    """Pipe capacity (staged batches) — PADDLE_TPU_FEED_PIPE_DEPTH, min 2
    (a 1-deep pipe cannot overlap: the producer would always hand off
    synchronously)."""
    try:
        return max(int(os.environ.get("PADDLE_TPU_FEED_PIPE_DEPTH", "2")), 2)
    except ValueError:
        return 2


def default_inflight():
    """Outstanding-dispatch bound — PADDLE_TPU_MAX_INFLIGHT, default 2."""
    try:
        return max(int(os.environ.get("PADDLE_TPU_MAX_INFLIGHT", "2")), 1)
    except ValueError:
        return 2


class _Staged:
    """A converted batch whose host→device copies were enqueued on a side
    stream: ``event`` completes when they have."""

    __slots__ = ("feed", "event")

    def __init__(self, feed, event):
        self.feed = feed
        self.event = event


def _handoff(item):
    """The consumer's side of a staged batch: its current stream waits on
    the copies' event, and each device tensor is marked as used on that
    stream (hazard 2 of the module docstring).  Other items pass as they
    are."""
    if not isinstance(item, _Staged):
        return item
    for v in item.feed.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            stream = torch.cuda.current_stream(v.device)
            stream.wait_event(item.event)
            v.record_stream(stream)
    return item.feed


class PinnedStager:
    """Host→device staging for one card: each numpy value is written into a
    reusable pinned buffer and copied to the device with
    ``non_blocking=True`` on a side stream; returns a ``_Staged`` batch.

    Buffers form a ring of ``slots`` batches.  Before a slot is written
    again, the event of the copy that last read it is waited on (hazard 1
    of the module docstring); with ``slots`` above the pipe's depth that
    copy finished long ago and the wait is free.  Call from one thread."""

    def __init__(self, device, slots=4):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.slots = max(int(slots), 2)
        self._ring = [({}, None) for _ in range(self.slots)]
        self._next = 0

    def __call__(self, arrays):
        i = self._next
        self._next = (i + 1) % self.slots
        bufs, ev = self._ring[i]
        if ev is not None:
            ev.synchronize()            # that slot's last copy has read it
        feed = {}
        with torch.cuda.stream(self.stream):
            for k, v in arrays.items():
                if isinstance(v, torch.Tensor):
                    feed[k] = v.to(self.device, non_blocking=True)
                    continue
                src = torch.from_numpy(np.ascontiguousarray(v))
                buf = bufs.get(k)
                if (buf is None or buf.shape != src.shape
                        or buf.dtype != src.dtype):
                    buf = bufs[k] = torch.empty(src.shape, dtype=src.dtype,
                                                pin_memory=True)
                buf.copy_(src)
                feed[k] = buf.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self._ring[i] = (bufs, ev)
        return _Staged(feed, ev)


def make_placer(device, slots=4):
    """``placer(dict of numpy) -> batch on device``: a ``PinnedStager`` on
    a card; ``torch.from_numpy`` on the CPU (no copy to make)."""
    device = torch.device(device)
    if device.type == "cuda":
        return PinnedStager(device, slots)

    def placer(out):
        return {k: (v if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.ascontiguousarray(v)))
                for k, v in out.items()}

    return placer


def make_feed_convert(dtype_of, placer):
    """THE staging-conversion rule, shared by every pipe feeder
    (Executor.feed_converter, DataLoader's worker): coerce each feed value
    to its declared numpy dtype, then hand the dict to ``placer`` to start
    the device copy.  ``dtype_of(name)`` returns the numpy dtype or None
    (undeclared names, and bfloat16 declarations numpy cannot hold, pass
    through); a tensor already of the declared dtype passes through, so
    ``Executor.run`` takes the staged tensors as they are."""

    def convert(feed):
        if not isinstance(feed, dict):
            return feed
        out = {}
        for k, v in feed.items():
            dt = dtype_of(k)
            if isinstance(v, torch.Tensor):
                out[k] = v if dt is None else v.to(convert_dtype(dt))
                continue
            out[k] = np.asarray(v, dtype=dt)
        return placer(out)

    return convert


def _staged_tensors(pipe):
    """The device tensors currently STAGED in a pipe's queue — the MemScope
    ``feed_pipe`` owner (batches whose copy started but whose step has not
    consumed them).  Snapshot-read, never locked: attribution is a sampler,
    a torn view costs one batch of accuracy at worst."""
    out = []
    try:
        entries = list(pipe._q.queue)
    except Exception:
        return out
    for e in entries:
        if not (isinstance(e, tuple) and len(e) == 4):
            continue
        item = e[1]
        if isinstance(item, _Staged):
            item = item.feed
        if isinstance(item, dict):
            out.extend(v for v in item.values()
                       if isinstance(v, torch.Tensor))
    return out


def _registry():
    """The monitor session when one is active, else None — every stat write
    below is gated on this so the disabled path stays one attribute read
    (the monitor's hot-path contract)."""
    from . import monitor

    return monitor.active()


class DeviceFeedPipe:
    """Bounded background feed stage over a batch iterator.

    ``convert`` runs on the worker thread (numpy coercion and the staged
    copy to the card); ``notify`` fires with the RAW host batch of the NEXT
    item each time the consumer takes one — exactly ONE batch ahead, the
    HostPS prefetch contract.  Iterate the pipe like the source;
    ``close()`` (or abandoning the iterator) shuts the worker down without
    wedging it on a full queue.
    """

    _SENTINEL = object()

    def __init__(self, source, convert=None, notify=None, depth=None,
                 name="feed_pipe"):
        self._source = source
        self._convert = convert
        self._notify = notify
        self.depth = depth if depth and depth >= 2 else default_depth()
        self.name = name
        self._q = _queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._err = []
        self._seq = 0
        # one-ahead announcement state: batch s is announced exactly when
        # batch s-1 has been TAKEN and batch s is STAGED, whichever side
        # completes the condition last (consumer take or worker put) —
        # seq 0 is never announced (it is consumed immediately)
        self._ann_lock = threading.Lock()
        self._announced = 0            # highest seq handed to notify()
        self._taken = -1               # highest seq the consumer took
        self._last_ret = None          # perf_counter of the previous get()
        self._thread = threading.Thread(
            target=self._worker, daemon=True, name=name)
        self._started = False
        # MemScope owner registration (weakref — dies with the pipe): the
        # staged batches this pipe holds classify as "feed_pipe" in the
        # live-buffer attribution instead of unattributed
        _memscope.track("feed_pipe", self, _staged_tensors)

    # -- producer ----------------------------------------------------------
    def _put(self, item):
        """Blocking put that observes close(): a consumer that abandoned the
        iterator must not leave the worker wedged on a full queue."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except _queue.Full:
                continue
        return False

    def _worker(self):
        seq = 0
        try:
            for raw in self._source:
                if self._stop.is_set():
                    return
                # chaos drill point: a worker-thread death here must reach
                # the training thread as THIS exception with THIS traceback
                # (ft/chaos.py; disarmed it is a dict miss)
                _chaos.maybe_fire("feed_worker")
                t0 = time.perf_counter()
                with _trace.span("pipe.convert", seq=seq):
                    item = raw if self._convert is None else self._convert(raw)
                convert_ms = (time.perf_counter() - t0) * 1e3
                t1 = time.perf_counter()
                # raw rides along only when someone will announce it (the
                # consumer's one-ahead notify wants host numpy, pre-convert)
                entry = (seq, item, convert_ms,
                         raw if self._notify is not None else None)
                seq += 1
                with _trace.span("pipe.put_wait"):
                    ok = self._put(entry)
                if not ok:
                    return
                # the consumer may already be waiting on this batch's
                # predecessor's successor (empty-queue take): catch up
                self._maybe_announce(entry[0], entry[3])
                put_wait_ms = (time.perf_counter() - t1) * 1e3
                mon = _registry()
                if mon is not None:
                    mon.registry.histogram(
                        "monitor.pipe.convert_ms").observe(convert_ms)
                    mon.registry.histogram(
                        "monitor.pipe.put_wait_ms").observe(put_wait_ms)
        except BaseException as e:       # delivered in order to the consumer
            self._err.append(e)
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(self._SENTINEL, timeout=0.2)
                    break
                except _queue.Full:
                    continue

    # -- one-ahead announcement --------------------------------------------
    def _maybe_announce(self, seq, raw):
        """Announce batch ``seq`` iff it is at most one past the newest
        taken batch and not yet announced — called from the consumer (the
        just-taken entry, then the peeked head) AND from the worker (after
        a put, in case the consumer outran the queue).  Never more than one
        ahead."""
        if raw is None or self._notify is None:
            return
        with self._ann_lock:
            if seq > self._taken + 1 or seq <= self._announced:
                return
            self._announced = seq
        self._notify(raw)

    def _announce_next(self):
        try:
            nxt = self._q.queue[0]     # CPython deque peek: GIL-atomic
        except IndexError:
            return
        if nxt is self._SENTINEL:
            return
        seq, _item, _ms, raw = nxt
        self._maybe_announce(seq, raw)

    # -- consumer ----------------------------------------------------------
    def __iter__(self):
        try:
            while True:
                item = self._get()
                if item is self._SENTINEL:
                    break
                yield item
        finally:
            self.close()
        self._reraise()

    def _get(self):
        if not self._started:
            self._started = True
            self._thread.start()
        t0 = time.perf_counter()
        with _trace.span("pipe.take"):
            got = self._q.get()
        now = time.perf_counter()
        if got is self._SENTINEL:
            return self._SENTINEL
        seq, item, convert_ms, raw = got
        item = _handoff(item)
        if self._notify is not None:
            with self._ann_lock:
                self._taken = seq
            self._maybe_announce(seq, raw)   # catch-up if the early fire lost
            self._announce_next()
        stall_ms = (now - t0) * 1e3
        gap_ms = None if self._last_ret is None else (now - self._last_ret) * 1e3
        self._last_ret = now
        self._seq += 1
        mon = _registry()
        if mon is not None:
            depth = self._q.qsize()
            overlap_ms = max(convert_ms - stall_ms, 0.0)
            reg = mon.registry
            reg.counter("monitor.pipe.batches").incr()
            reg.gauge("monitor.pipe.depth").set(depth)
            reg.histogram("monitor.pipe.feed_stall_ms").observe(stall_ms)
            # FleetScope phase ledger: the consumer (training thread)
            # waited this long on the pipe — input-bound time
            mon.phase_add("feed_stall", stall_ms)
            reg.histogram("monitor.pipe.overlap_ms").observe(overlap_ms)
            ev = {"seq": self._seq - 1, "stall_ms": round(stall_ms, 4),
                  "convert_ms": round(convert_ms, 4),
                  "overlap_ms": round(overlap_ms, 4), "depth": depth}
            if gap_ms is not None:
                # consumer-side wall time since the previous batch left the
                # pipe: the feed-stall fraction's denominator
                # (scripts/trace_summary.py --max-feed-stall-frac)
                ev["gap_ms"] = round(gap_ms, 4)
            mon.timeline.emit("pipe", **ev)
        return item

    def _reraise(self):
        if self._err:
            e = self._err[0]
            # the exception object still carries the worker-thread frames;
            # re-raising it here extends — not replaces — that traceback, so
            # the training thread sees the generator's real crash site
            raise e

    def close(self):
        """Stop the worker and drain the queue so a producer blocked on a
        full queue can observe the stop and exit."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except _queue.Empty:
            pass


def _cuda_device_of(token):
    """The card the tensors of ``token`` (a tensor, or a list or tuple of
    them) lie on, or None when none lies on a card."""
    if isinstance(token, torch.Tensor):
        return token.device if token.is_cuda else None
    if isinstance(token, (list, tuple)):
        for t in token:
            dev = _cuda_device_of(t)
            if dev is not None:
                return dev
    return None


class InFlightWindow:
    """Bounds outstanding steps to ``k``.

    ``admit(token)`` takes a step's OUTPUT (a tensor or a fetch list) and
    records a CUDA event on the current stream of the card it lies on; once
    more than ``k`` steps are outstanding the oldest event is waited on
    (``event.synchronize()``, the counterpart of ``jax.block_until_ready``).
    CPU outputs are complete when they exist and admit nothing to wait on.
    The wait cost lands in ``monitor.pipe.fetch_wait_ms`` — nonzero means
    the host reached the window bound, i.e. dispatch runs ahead of the card
    (the intended steady state).
    """

    def __init__(self, k=None):
        self.k = k if k is not None else default_inflight()
        self._window = []

    def admit(self, token):
        dev = _cuda_device_of(token)
        ev = None
        if dev is not None:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
        self._window.append(ev)
        while len(self._window) > self.k:
            self._wait(self._window.pop(0))

    def _wait(self, ev):
        t0 = time.perf_counter()
        if ev is not None:
            with _trace.span("inflight.wait"):
                ev.synchronize()
        mon = _registry()
        if mon is not None:
            wait_ms = (time.perf_counter() - t0) * 1e3
            mon.registry.histogram("monitor.pipe.fetch_wait_ms").observe(
                wait_ms)
            # FleetScope phase ledger: window-bound wait on a step OUTPUT
            # (host ran ahead of the card — the healthy steady state)
            mon.phase_add("fetch", wait_ms)

    def drain(self):
        """Wait for every outstanding step (end-of-run barrier, so run wall
        times measure completed work, not queued work)."""
        while self._window:
            self._wait(self._window.pop(0))

    def __len__(self):
        return len(self._window)
