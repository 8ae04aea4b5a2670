"""Dataset layer — the `train_from_dataset` data path (counterpart of the
JAX package's ``dataset.py``).

Parity surface: python/paddle/fluid/dataset.py:22 (DatasetFactory :40,
DatasetBase :64, InMemoryDataset :276, QueueDataset :646) over the C++
pipeline framework/data_set.h:41 + framework/data_feed.h:61
(MultiSlotDataFeed) + framework/channel.h.

The reference parses MultiSlot text files in C++ reader threads into a
channel drained by Hogwild CPU workers.  Here the same C++ parser/channel
is the port's build of ``runtime/datafeed.cc`` (g++ + ctypes; the
pure-Python parser under ``PADDLE_TPU_NO_NATIVE=1``), and the drained
batches feed one executor step on the card: N reader threads feed one
device pipe (``trainer.py``).  Batches are host numpy arrays; the pipe or
the executor moves them to the device.

MultiSlot line format (data_feed.cc contract): for each used slot, an
integer count followed by that many values, whitespace separated.  Sparse
(int64) slots are padded/truncated to the slot's declared shape; float slots
are dense and expected to match.
"""

import atexit
import ctypes
import os
import shutil
import subprocess
import tempfile

import numpy as np

from .dtypes import numpy_dtype

__all__ = ["DatasetFactory", "DatasetBase", "InMemoryDataset", "QueueDataset"]


class DatasetFactory:
    """Parity: dataset.py:22."""

    def create_dataset(self, datafeed_class="QueueDataset"):
        try:
            cls = {"QueueDataset": QueueDataset,
                   "InMemoryDataset": InMemoryDataset}[datafeed_class]
        except KeyError:
            raise ValueError(
                "datafeed class %s does not exist" % datafeed_class)
        return cls()


def _slot_of_var(var):
    """Map a feed Variable to (name, ctype, pad_len) — the Slot proto
    analogue (data_feed.proto Slot: name/type/is_dense/shape)."""
    dt = numpy_dtype(var.dtype)
    shape = list(var.shape or [1])
    if shape and int(shape[0]) == -1:  # dynamic batch dim from layers.data
        shape = shape[1:] or [1]
    shape = [abs(int(d)) for d in shape]
    pad_len = int(np.prod(shape)) if shape else 1
    ctype = "u" if dt.kind in "iu" else "f"
    return var.name, ctype, pad_len, shape


def _parse_line_py(line, slots):
    """Python fallback of runtime/datafeed.cc parse_line (same semantics:
    pad/truncate int slots, drop malformed lines)."""
    toks = line.split()
    pos = 0
    out = []
    try:
        for _, ctype, pad_len, _ in slots:
            n = int(toks[pos]); pos += 1
            if n < 0:
                return None
            vals = toks[pos:pos + n]
            if len(vals) != n:
                return None
            pos += n
            if ctype == "u":
                arr = np.zeros(pad_len, np.int64)
                m = min(n, pad_len)
                arr[:m] = [int(v) for v in vals[:m]]
            else:
                arr = np.zeros(pad_len, np.float32)
                m = min(n, pad_len)
                arr[:m] = [float(v) for v in vals[:m]]
            out.append(arr)
    except (ValueError, IndexError):
        return None
    return out


def _open_retry(path, mode="r"):
    """Dataset file opens go through the ft retry policy: a file list on a
    network mount opens flakily under load, and a transient failure must
    cost a jittered retry, not the whole pass (ft/retry.py)."""
    from .ft import retry as _retry

    return _retry.open_retry(path, mode)


class DatasetBase:
    """Parity: dataset.py:64."""

    def __init__(self):
        self.proto_desc = {"batch_size": 32, "pipe_command": "cat",
                           "thread_num": 1}
        self.filelist = []
        self.use_vars = []
        self.queue_num = None
        self._piped = None  # (cmd, filelist) -> materialized files cache

    # -- configuration (dataset.py:77-238) ------------------------------
    def set_pipe_command(self, pipe_command):
        self.proto_desc["pipe_command"] = pipe_command

    def set_batch_size(self, batch_size):
        self.proto_desc["batch_size"] = batch_size

    def set_thread(self, thread_num):
        self.proto_desc["thread_num"] = thread_num

    def set_queue_num(self, queue_num):
        """Parity: dataset.py:330 InMemoryDataset.set_queue_num (reader
        channel count).  Here one executor step drains one device pipe, so
        the knob maps to the DeviceFeedPipe depth train_from_dataset stages
        ahead of the step (trainer.py; default 2, or
        PADDLE_TPU_FEED_PIPE_DEPTH)."""
        self.queue_num = int(queue_num)

    def set_filelist(self, filelist):
        self.filelist = list(filelist)

    def set_use_var(self, var_list):
        self.use_vars = list(var_list)

    def set_hdfs_config(self, fs_name, fs_ugi):
        # no HDFS client in this package; the file list must be local
        # (or fuse-mounted) paths
        self._hdfs = (fs_name, fs_ugi)

    def desc(self):
        """Parity: dataset.py:253 — human-readable description of the
        DataFeedDesc analogue."""
        d = dict(self.proto_desc)
        d["slots"] = [
            {"name": n, "type": t, "shape": s}
            for n, t, _, s in self._slots()
        ]
        return repr(d)

    def prefetch_id_slots(self):
        """Names of the integer (sparse id) slots of this dataset — the
        feeds a HostPS prefetch hook should watch.  Wire-up:
        `svc.attach_prefetch_slot(ds.prefetch_id_slots()[0])` registers a
        hook, and train_from_dataset's one-batch lookahead (trainer.py
        _iter_with_prefetch) then announces each NEXT feed so the host-RAM
        rows are pulled while the current step runs."""
        return [n for n, ctype, _, _ in self._slots() if ctype == "u"]

    # -- internals ------------------------------------------------------
    def _slots(self):
        if not self.use_vars:
            raise ValueError("set_use_var must be called before reading")
        return [_slot_of_var(v) for v in self.use_vars]

    def _schema_str(self, slots):
        return ";".join("%s:%d" % (t, l) for _, t, l, _ in slots)

    def _effective_files(self):
        """Run pipe_command over each file when it is not a pass-through
        (dataset.py pipe_command contract: each line of each file is piped
        through the command before slot parsing).  The piped copies are
        materialized ONCE per (command, filelist) and removed at interpreter
        exit or when the config changes — multi-epoch iteration must not
        rewrite the dataset into /tmp each pass."""
        cmd = self.proto_desc.get("pipe_command") or "cat"
        if cmd.strip() == "cat":
            return self.filelist
        key = (cmd, tuple(self.filelist))
        if self._piped is not None:
            old_key, files, tmpdir = self._piped
            if old_key == key:
                return files
            shutil.rmtree(tmpdir, ignore_errors=True)
            self._piped = None
        tmpdir = tempfile.mkdtemp(prefix="paddle_tpu_df_")
        atexit.register(shutil.rmtree, tmpdir, ignore_errors=True)
        out = []
        for i, f in enumerate(self.filelist):
            dst = os.path.join(tmpdir, "piped.%d" % i)
            with open(f, "rb") as fin, open(dst, "wb") as fout:
                subprocess.run(cmd, shell=True, stdin=fin, stdout=fout,
                               check=True)
            out.append(dst)
        self._piped = (key, out, tmpdir)
        return out

    def _native_lib(self):
        from . import runtime

        lib = runtime.load("datafeed")
        if lib is not None and not getattr(lib, "_df_typed", False):
            lib.df_open.restype = ctypes.c_void_p
            lib.df_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                    ctypes.c_int, ctypes.c_char_p,
                                    ctypes.c_int]
            lib.df_next_batch.restype = ctypes.c_int
            lib.df_next_batch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_void_p)]
            lib.df_close.argtypes = [ctypes.c_void_p]
            lib.df_load.restype = ctypes.c_void_p
            lib.df_load.argtypes = lib.df_open.argtypes
            lib.df_rows.restype = ctypes.c_long
            lib.df_rows.argtypes = [ctypes.c_void_p]
            lib.df_fetch.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_long),
                                     ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_void_p)]
            lib.df_free.argtypes = [ctypes.c_void_p]
            lib._df_typed = True
        return lib

    def _batch_arrays(self, slots, n):
        bufs = []
        for _, ctype, pad_len, shape in slots:
            dt = np.int64 if ctype == "u" else np.float32
            bufs.append(np.zeros((n, pad_len), dt))
        return bufs

    def _feed_dict(self, slots, bufs, n):
        feed = {}
        for (name, ctype, pad_len, shape), buf in zip(slots, bufs):
            arr = buf[:n]
            feed[name] = arr.reshape([n] + shape)
        return feed


class QueueDataset(DatasetBase):
    """Streaming dataset (parity: dataset.py:646): files are read by worker
    threads into a bounded channel and consumed in arrival order; nothing is
    kept in memory."""

    def local_shuffle(self):
        raise NotImplementedError(
            "QueueDataset streams in file order; use InMemoryDataset for "
            "local_shuffle (dataset.py:680 raises the same)")

    def global_shuffle(self, fleet=None):
        raise NotImplementedError(
            "QueueDataset cannot global_shuffle; use InMemoryDataset "
            "(dataset.py:702 raises the same)")

    def _iter_batches(self, num_threads=None, skip_to=None, with_cursor=False):
        slots = self._slots()
        batch = self.proto_desc["batch_size"]
        files = self._effective_files()
        if not num_threads:  # reference: thread<=0 falls back to set_thread
            num_threads = self.proto_desc["thread_num"]
        if with_cursor or skip_to is not None:
            # resumable-cursor mode (ft/ exact-batch resume): deterministic
            # single-threaded per-file iteration — every batch carries a
            # (file_idx, batch_idx) cursor and batches never span file
            # boundaries (each file's tail yields a short batch), so
            # skip_to=(f, b) can skip files 0..f-1 WITHOUT opening them and
            # replay only file f up to batch b.  The multi-threaded native
            # path interleaves records nondeterministically and therefore
            # cannot promise the same batch twice; checkpoint/resume runs
            # trade its throughput for replayability.
            yield from self._iter_batches_cursor(slots, batch, files,
                                                 skip_to, with_cursor)
            return
        lib = self._native_lib()
        if lib is not None:
            cfiles = (ctypes.c_char_p * len(files))(
                *[f.encode() for f in files])
            sess = lib.df_open(cfiles, len(files),
                               self._schema_str(slots).encode(),
                               int(num_threads))
            try:
                while True:
                    bufs = self._batch_arrays(slots, batch)
                    ptrs = (ctypes.c_void_p * len(bufs))(
                        *[b.ctypes.data_as(ctypes.c_void_p) for b in bufs])
                    n = lib.df_next_batch(sess, batch, ptrs)
                    if n == 0:
                        return
                    yield self._feed_dict(slots, bufs, n)
            finally:
                lib.df_close(sess)
        else:
            rows = []
            for f in files:
                with _open_retry(f) as fh:
                    for line in fh:
                        if not line.strip():
                            continue
                        rec = _parse_line_py(line, slots)
                        if rec is None:
                            continue
                        rows.append(rec)
                        if len(rows) == batch:
                            yield self._assemble(slots, rows)
                            rows = []
            if rows:
                yield self._assemble(slots, rows)

    def _iter_batches_cursor(self, slots, batch, files, skip_to, with_cursor):
        """Deterministic cursor iteration: yields ((file_idx, batch_idx),
        feed) — or bare feeds when with_cursor is False — for every batch
        STRICTLY AFTER `skip_to` (the cursor of the last batch a resumed run
        already trained; None = from the top)."""
        start = (-1, -1) if skip_to is None else (int(skip_to[0]),
                                                  int(skip_to[1]))
        for fi, f in enumerate(files):
            if fi < start[0]:
                continue         # whole file already consumed: never opened
            bi = 0
            rows = []
            with _open_retry(f) as fh:
                for line in fh:
                    if not line.strip():
                        continue
                    rec = _parse_line_py(line, slots)
                    if rec is None:
                        continue
                    rows.append(rec)
                    if len(rows) == batch:
                        if (fi, bi) > start:
                            feed = self._assemble(slots, rows)
                            yield ((fi, bi), feed) if with_cursor else feed
                        rows = []
                        bi += 1
            if rows and (fi, bi) > start:
                feed = self._assemble(slots, rows)
                yield ((fi, bi), feed) if with_cursor else feed

    def _assemble(self, slots, rows):
        bufs = [np.stack([r[i] for r in rows]) for i in range(len(slots))]
        return self._feed_dict(slots, bufs, len(rows))


class InMemoryDataset(DatasetBase):
    """Parity: dataset.py:276 — load_into_memory + local/global shuffle.

    Records are parsed once into the native in-memory store
    (runtime/datafeed.cc DF_Data); shuffling and worker partitioning are
    index-level operations with batches gathered natively (df_fetch)."""

    def __init__(self):
        super().__init__()
        self._data = None          # native handle or python list
        self._lib = None
        self._order = None         # np.int64 row order after shuffles
        self._seed = 0

    def load_into_memory(self):
        if self._data is not None:
            self.release_memory()  # don't leak the previous native DF_Data
        slots = self._slots()
        files = self._effective_files()
        self._lib = self._native_lib()
        if self._lib is not None:
            cfiles = (ctypes.c_char_p * len(files))(
                *[f.encode() for f in files])
            self._data = self._lib.df_load(
                cfiles, len(files), self._schema_str(slots).encode(),
                int(self.proto_desc["thread_num"]))
            n = self._lib.df_rows(self._data)
        else:
            self._data = []
            for f in files:
                with _open_retry(f) as fh:
                    for line in fh:
                        if not line.strip():
                            continue
                        rec = _parse_line_py(line, slots)
                        if rec is not None:
                            self._data.append(rec)
            n = len(self._data)
        self._order = np.arange(n, dtype=np.int64)

    def preload_into_memory(self, thread_num=None):
        if thread_num:
            self.set_thread(thread_num)
        self.load_into_memory()

    def wait_preload_done(self):
        pass

    def local_shuffle(self):
        """Parity: dataset.py:488."""
        if self._order is None:
            raise RuntimeError("call load_into_memory() first")
        rng = np.random.RandomState(self._seed)
        self._seed += 1
        rng.shuffle(self._order)

    def global_shuffle(self, fleet=None, thread_num=12):
        """Parity: dataset.py:504 — reference routes records through the PS
        fleet so each worker ends with a random disjoint partition.  Here:
        deterministic hash-partition of rows across fleet workers, then a
        local shuffle of this worker's partition (same end state, no RPC:
        every worker loads the same filelist and keeps rows hashed to it)."""
        if self._order is None:
            raise RuntimeError("call load_into_memory() first")
        n_workers, idx = 1, 0
        if fleet is not None:
            n_workers = fleet.worker_num()
            idx = fleet.worker_index()
        if n_workers > 1:
            # splitmix-style row hash: cheap, stable across workers
            h = (self._order.astype(np.uint64)
                 * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(33)
            self._order = self._order[h % np.uint64(n_workers)
                                      == np.uint64(idx)]
        self.local_shuffle()

    def release_memory(self):
        """Parity: dataset.py:549."""
        if self._data is not None and self._lib is not None:
            self._lib.df_free(self._data)
        self._data = None
        self._order = None

    def get_memory_data_size(self, fleet=None):
        return 0 if self._order is None else int(len(self._order))

    def get_shuffle_data_size(self, fleet=None):
        return self.get_memory_data_size(fleet)

    def _iter_batches(self, num_threads=1, skip_to=None, with_cursor=False):
        """In-memory iteration is deterministic already (the `_order`
        array), so cursor mode changes NOTHING about batch composition:
        the cursor is simply ``(0, batch_idx)`` over `_order` and
        ``skip_to`` jumps straight to the following batch (O(1) — no
        replay).  Resume contract: re-create the dataset and replay any
        shuffles identically (local_shuffle's seed sequence is
        deterministic) before iterating with skip_to."""
        if self._order is None:
            raise RuntimeError(
                "InMemoryDataset: call load_into_memory() before "
                "train_from_dataset (dataset.py:431 contract)")
        slots = self._slots()
        batch = self.proto_desc["batch_size"]
        first = 0 if skip_to is None else (int(skip_to[1]) + 1) * batch
        for start in range(first, len(self._order), batch):
            idx = self._order[start:start + batch]
            n = len(idx)
            if self._lib is not None:
                bufs = self._batch_arrays(slots, n)
                ptrs = (ctypes.c_void_p * len(bufs))(
                    *[b.ctypes.data_as(ctypes.c_void_p) for b in bufs])
                cidx = idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long))
                self._lib.df_fetch(self._data, cidx, n, ptrs)
            else:
                rows = [self._data[i] for i in idx]
                bufs = [np.stack([r[i] for r in rows])
                        for i in range(len(slots))]
            feed = self._feed_dict(slots, bufs, n)
            yield ((0, start // batch), feed) if with_cursor else feed
