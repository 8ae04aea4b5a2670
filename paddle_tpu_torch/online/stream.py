"""StreamingSource: an unbounded, cursor-resumable front for a dataset
(counterpart of ``paddle_tpu/online/stream.py``, a copy over the port's
``dataset.py`` cursor iteration).

Parity surface: the reference's online-learning ingestion — an
async_executor / PSLib trainer that keeps consuming a Dataset whose file
list GROWS while training runs (the "join new data" loop of a streaming
CTR job).  Here the same contract is a thin wrapper that makes any
cursor-capable dataset (dataset.py ``_iter_batches(skip_to=,
with_cursor=True)``) behave as an endless feed for
``Executor.train_from_dataset``:

- the inner dataset is iterated in CURSOR mode (single-threaded by that
  mode's contract), so every yielded batch carries its ``(file_index,
  batch_index)`` watermark and a restart resumes BIT-EXACT from the last
  committed cursor — the same cursor the CheckpointPolicy guard already
  persists in the unified TrainState;
- when the inner pass drains, the file list is refreshed from a
  ``file_provider`` callable and iteration re-enters ``skip_to`` the
  watermark: files already consumed are never reopened, new files stream
  seamlessly.  The provider's list must be APPEND-ONLY (the old list is a
  prefix of the new one) and visible files must be immutable — both are
  what makes the cursor meaningful across refreshes, so violations raise
  instead of silently re-batching history;
- between refreshes the source poll-sleeps (bounded buffer: nothing is
  read ahead of the train loop beyond the trainer's own pipe depth);
  ``stop()``, ``max_batches`` and ``idle_secs`` bound the stream for
  drills and tests.

Everything else (proto_desc, use_vars, queue_num, prefetch_id_slots, ...)
delegates to the wrapped dataset, so the wrapper IS dataset-shaped for
``train_from_dataset``.
"""

import threading
import time

__all__ = ["StreamingSource"]


class StreamingSource(object):
    """Wrap ``dataset`` as an endless cursor-carrying batch stream.

    file_provider: callable -> iterable of file paths; polled between
        inner passes.  Must be append-only (see module docstring).  When
        None the source is a bounded stream: it ends once the dataset's
        current file list drains.
    poll_secs:  sleep between dry polls of the provider.
    idle_secs:  end the stream after this long with no new batches AND no
        new files (None = poll forever, until ``stop()``).
    max_batches: end the stream after yielding this many batches.
    """

    def __init__(self, dataset, file_provider=None, poll_secs=0.2,
                 idle_secs=None, max_batches=None):
        self._dataset = dataset
        self._provider = file_provider
        self.poll_secs = float(poll_secs)
        self.idle_secs = None if idle_secs is None else float(idle_secs)
        self.max_batches = None if max_batches is None else int(max_batches)
        self._stopped = threading.Event()
        self._wm_lock = threading.Lock()
        self._wm = {"cursor": None, "wall": None, "batches": 0}

    # dataset-shaped: everything train_from_dataset reads off a dataset
    # (proto_desc, use_vars, queue_num, batch_size, prefetch_id_slots...)
    # comes from the wrapped one
    def __getattr__(self, name):
        try:
            ds = object.__getattribute__(self, "_dataset")
        except AttributeError:
            raise AttributeError(name)
        return getattr(ds, name)

    @property
    def watermark(self):
        """{"cursor": (fi, bi) | None, "wall": unix time of the last yield,
        "batches": total yielded} — the publish manifest's freshness
        anchor."""
        with self._wm_lock:
            return dict(self._wm)

    def stop(self):
        """End the stream at the next batch boundary (thread-safe)."""
        self._stopped.set()

    def _refresh_files(self):
        """Poll the provider; grow the inner dataset's file list.  Returns
        True when new files appeared.  Append-only is enforced: consumed
        cursors index into this list by position."""
        if self._provider is None:
            return False
        new = [str(f) for f in self._provider()]
        old = list(self._dataset.filelist)
        if new[:len(old)] != old:
            raise RuntimeError(
                "StreamingSource: the file list must grow append-only "
                "(old list is no longer a prefix: %d old files, new head "
                "%r...) — a mutated or reordered list would make every "
                "committed cursor point at different data" %
                (len(old), new[:3]))
        if len(new) == len(old):
            return False
        self._dataset.set_filelist(new)
        return True

    def _iter_batches(self, num_threads=None, skip_to=None,
                      with_cursor=False):
        """The train_from_dataset hook.  Always iterates the inner dataset
        in cursor mode (num_threads is moot there — cursor iteration is
        single-threaded by dataset.py's contract); strips cursors when the
        caller did not ask for them."""
        del num_threads
        cursor = None if skip_to is None \
            else (int(skip_to[0]), int(skip_to[1]))
        yielded = 0
        idle_since = None
        while not self._stopped.is_set():
            grew = self._refresh_files()
            progressed = False
            for cur, feed in self._dataset._iter_batches(
                    skip_to=cursor, with_cursor=True):
                progressed = True
                cursor = cur
                with self._wm_lock:
                    self._wm = {"cursor": cur, "wall": time.time(),
                                "batches": self._wm["batches"] + 1}
                yielded += 1
                yield (cur, feed) if with_cursor else feed
                if self._stopped.is_set():
                    return
                if self.max_batches is not None \
                        and yielded >= self.max_batches:
                    return
            if progressed:
                idle_since = None
                continue            # drained: look for new files right away
            if self._provider is None:
                return              # static file list: a bounded stream
            if not grew:
                if self.idle_secs is not None:
                    if idle_since is None:
                        idle_since = time.monotonic()
                    elif time.monotonic() - idle_since >= self.idle_secs:
                        return
                self._stopped.wait(self.poll_secs)
