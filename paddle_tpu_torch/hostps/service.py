"""HostPS pull/push pipeline.

Counterpart of ``paddle_tpu/hostps/service.py``.  Parity: FleetWrapper's
trainer-side client (fleet/fleet_wrapper.h:76 PullSparseVarsSync, :103
PushSparseVarsWithLabelAsync) over the Downpour sparse service:

- pull: host-side dedup of the batch's ids, hot rows served by a device
  gather from the HotRowCache, cold rows gathered from the host-RAM table
  (init-on-first-pull) and copied up from pinned staging;
- prefetch: a daemon thread runs the NEXT batch's pull while the current
  step computes — the reference's prefetch of remote rows
  (distributed_lookup_table_op.cc);
- push: SelectedRows gradients flow back with duplicates merged and the
  sentinel row dropped, the host applier (optimizer.py) does the
  server-side update, and updated rows write through the cache;
- ``push_in_jit``: JAX pushes from inside a jitted step through an ordered
  ``io_callback``.  Torch has no such callback, so the port's version runs
  eagerly, after backward, in step order, exactly once per call; with
  ``merge=True`` it first sums duplicate rows on the device with the
  segment-sum kernel (``kernels/segment_update.py`` ``dedup_segment_sum``:
  its CUDA kernel on a CUDA tensor, its plain version only on a CPU
  tensor), then makes ONE device-to-host copy and one ``table.push``;
- checkpoint: save/restore of table + moment shards via io.py.

The prefetch thread's device work (the cache gather, the miss rows' copy
from pinned staging, the scatter into the pull's buffer) runs on the CUDA
stream that was current where ``prefetch`` was called, so it is ordered
with the caller's own work on the cache's slot buffer; its host work (the
dedup and the host-table gather) overlaps the step.  The reference hands
back whatever the thread read, which may predate a push that landed while
it ran.  The port keeps the reference's rule that such a pull is never
CACHED (``_push_version``) and also logs every push made while a prefetch
is pending; the consuming pull writes those pushes' rows over the
prefetched values, so a prefetched pull returns exactly what a synchronous
pull at the same point would.  A restore, an install or a shard recovery
in the meantime (a version bump with no logged push) discards the
prefetch and the consumer pulls afresh.

Pull/push latency and row counts are observable through the profiler
counter API ("hostps.pull_ms", "hostps.push_ms", "hostps.push_rows",
"hostps.prefetch.hit"/".waste", "hostps.cache.hit"/".miss"/".evict").
"""

import threading
import time
import weakref

import numpy as np
import torch

from .. import profiler
from ..ft import chaos as _chaos
from ..ft import retry as _retry
from ..kernels import segment_update as _segment_update
from ..kernels._common import resolve_device
from ..monitor import trace as _trace
from .cache import HotRowCache, bucket_size, host_to_device
from .table import HostSparseTable

__all__ = ["HostPSEmbedding", "register_prefetch_hook",
           "unregister_prefetch_hook", "has_prefetch_hooks",
           "notify_next_batch", "live_embeddings"]


# every constructed HostPSEmbedding, weakly held: the unified TrainState
# checkpoint (ft/ckpt.py) defaults to snapshotting ALL live tables so a
# resumed run gets its sparse rows back without extra wiring
_LIVE_EMBEDDINGS = weakref.WeakSet()


def live_embeddings():
    """The live HostPSEmbedding handles, name-sorted (ft/ckpt.py's default
    unified-checkpoint table set)."""
    return sorted(_LIVE_EMBEDDINGS, key=lambda e: e.name)


# -- prefetch hook registry (fed by trainer.py's one-batch lookahead) --------

_PREFETCH_HOOKS = []


def register_prefetch_hook(fn):
    """fn(feed_dict) is called with the NEXT batch's feed while the current
    step runs: ``feed_pipe.DeviceFeedPipe`` announces the staged batch
    k+1's raw host-numpy feed as it hands batch k to the trainer (the
    inline one-batch lookahead in trainer.py is the fallback when the pipe
    is off) — exactly ONE batch ahead, which is what the two pending pull
    slots below are sized for.  Typical hook: the closure of
    ``HostPSEmbedding.attach_prefetch_slot``."""
    _PREFETCH_HOOKS.append(fn)
    return fn


def unregister_prefetch_hook(fn):
    try:
        _PREFETCH_HOOKS.remove(fn)
    except ValueError:
        pass


def has_prefetch_hooks():
    return bool(_PREFETCH_HOOKS)


def notify_next_batch(feed):
    if _PREFETCH_HOOKS:
        profiler.incr("hostps.prefetch.announce")
    for fn in list(_PREFETCH_HOOKS):
        fn(feed)


def _host(x):
    """``x`` (a tensor on any device, or array-like) as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class HostPSEmbedding:
    """Model-facing handle for one host-RAM sparse table.

    pull(ids) behaves like `table[ids]` (a lookup), pull_unique(ids) returns
    the deduped rows + inverse map for train steps that differentiate w.r.t.
    the gathered rows (the SelectedRows contract: grads per unique row).
    ``device=None`` is the card (``kernels/_common.resolve_device``); the
    CPU is used only when named.
    """

    def __init__(self, table, cache_slots=0, device=None, name=None,
                 read_only=False):
        # table-SHAPED backends are accepted too: the ShardPS router
        # (hostps/shard_router.py ShardRouter, _table_like=True) fronts a
        # runtime-sharded table through this very pipeline
        if not (isinstance(table, HostSparseTable)
                or getattr(table, "_table_like", False)):
            raise TypeError("HostPSEmbedding wraps a HostSparseTable "
                            "(or a table-shaped router)")
        # read_only: the PSLib SERVING scenario — pulls route through
        # table.pull(materialize=False) so the table stays byte-for-byte
        # untouched (cold rows served straight from the deterministic
        # initializer), and every push surface raises.  The hot-row cache
        # still works; with no push path there is no write-through to go
        # stale.
        if read_only and not isinstance(table, HostSparseTable):
            raise ValueError("read_only serving mode needs a local "
                             "HostSparseTable (the ShardPS router has its "
                             "own degraded-read discipline)")
        self.read_only = bool(read_only)
        self.table = table
        self.name = name or table.name
        self.vocab_size = table.vocab_size
        self.dim = table.dim
        self._device = resolve_device(device)
        self._tdtype = torch.from_numpy(np.zeros(0, table.dtype)).dtype
        self.cache = (HotRowCache(cache_slots, table.dim,
                                  dtype=self._tdtype, device=self._device)
                      if cache_slots else None)
        # guards the cache (lookup/insert/update), the push sequencing and
        # the pending prefetches; the host-table gather runs OUTSIDE it
        # (the table has its own row lock) so an in-flight prefetch never
        # serializes the training thread's push.  _push_version detects a
        # push that landed between a pull's cache lookup and its insert:
        # the freshly pulled rows are then NOT cached.
        self._lock = threading.RLock()
        self._push_version = 0
        # pending prefetches keyed by ids digest.  Two slots, not one: the
        # train_from_dataset lookahead announces batch k+2 BEFORE the step
        # consuming batch k+1 runs, so the k+1 prefetch must survive the
        # k+2 announcement.  Oldest entry drops on overflow.
        self._pending = {}                 # key -> (thread, holder)
        self._pending_cap = 2
        self._hooks = []
        _LIVE_EMBEDDINGS.add(self)

    # -- pull ------------------------------------------------------------
    @staticmethod
    def _ids_key(ids):
        ids = _host(ids)
        return (ids.shape, ids.tobytes())

    def pull_unique(self, ids, use_cache=True):
        """Dedup + gather: returns (rows [P] np.int64, values [P+1, dim]
        tensor on the device, inv np.int64) where P is the unique-valid
        count rounded up to a power-of-two bucket (cache.bucket_size).
        rows[:n] are the unique valid ids, the tail is -1 padding (push
        drops it); values[i] belongs to rows[i], pad/zero rows are zeros;
        ids == rows[inv] for valid ids and out-of-range ids map to
        inv == P (the appended zero row), so callers can gather blindly."""
        t0 = time.perf_counter()
        with _trace.span("hostps.pull") as sp:
            out = self._take_pending(self._ids_key(ids))
            if out is not None:
                profiler.incr("hostps.prefetch.hit")
                sp.add(prefetched=True)
            else:
                out = self._pull_unique_sync(ids, use_cache)
        profiler.observe("hostps.pull_ms", (time.perf_counter() - t0) * 1e3)
        return out

    def _scatter_host(self, values, positions, host_vals):
        """values[positions] = host_vals ([M, dim] numpy), one copy up."""
        if not positions.shape[0]:
            return
        pos = host_to_device(np.asarray(positions, np.int64), self._device)
        v = host_to_device(np.asarray(host_vals), self._device, self._tdtype)
        values.index_copy_(0, pos, v)

    def _pull_unique_sync(self, ids, use_cache=True):
        ids = _host(ids)
        flat = ids.reshape(-1).astype(np.int64)
        valid = (flat >= 0) & (flat < self.vocab_size)
        real, inv_valid = np.unique(flat[valid], return_inverse=True)
        n = real.shape[0]
        p = bucket_size(n)
        rows = np.full(p, -1, np.int64)
        rows[:n] = real
        inv = np.full(flat.shape[0], p, np.int64)   # invalid ids -> zero row
        inv[valid] = inv_valid.reshape(-1)
        with torch.no_grad():
            values = torch.zeros((p + 1, self.dim), dtype=self._tdtype,
                                 device=self._device)
            if self.cache is not None and use_cache and n:
                with self._lock:
                    # lookup + hit gather under one lock: the gather is
                    # issued before any later insert can remap a hit slot,
                    # and both run on one stream in issue order
                    v0 = self._push_version
                    slots, hit = self.cache.lookup(real)
                    pos_hit = np.nonzero(hit)[0]
                    if pos_hit.size:
                        values.index_copy_(
                            0, host_to_device(pos_hit, self._device),
                            self.cache.gather(slots[hit]))
                # the expensive legs — host-RAM gather + the copy up — run
                # unlocked (table.pull is row-locked internally)
                pos_miss = np.nonzero(~hit)[0]
                miss_vals = self._table_pull(real[~hit])       # [M, dim]
                self._scatter_host(values, pos_miss, miss_vals)
                if pos_miss.size:
                    with self._lock:
                        # last_pull_cacheable: a ShardPS router serving a
                        # dead shard's rows from the degraded initializer
                        # marks the pull non-cacheable — best-effort values
                        # must never enter the exact write-through cache
                        if self._push_version == v0 and getattr(
                                self.table, "last_pull_cacheable", True):
                            self.cache.insert(real[~hit], miss_vals)
            elif n:
                self._scatter_host(values, np.arange(n),
                                   self._table_pull(real))
        return rows, values, inv.reshape(ids.shape)

    def _table_pull(self, rows):
        """Host-table gather, honoring serving mode: a read-only embedding
        pulls without materializing cold rows (the table stays unwritten)."""
        if self.read_only:
            return self.table.pull(rows, materialize=False)
        return self.table.pull(rows)

    def pull(self, ids, use_cache=True):
        """Lookup semantics: [*ids.shape, dim] device values (zeros for
        out-of-range ids)."""
        rows, values, inv = self.pull_unique(ids, use_cache)
        return values[host_to_device(inv, self._device)]

    # -- prefetch ----------------------------------------------------------
    def prefetch(self, ids, use_cache=True):
        """Start pulling `ids` on a daemon thread; the matching pull_unique/
        pull call consumes the result.  Up to two prefetches stay pending
        (double buffering that survives the trainer's one-batch-ahead
        announcement pattern); the oldest unconsumed one drops on
        overflow."""
        key = self._ids_key(ids)
        ids = np.array(_host(ids), copy=True)
        stream = (torch.cuda.current_stream(self._device)
                  if self._device.type == "cuda" else None)
        holder = {"t_start": time.perf_counter(), "stream": stream,
                  "log": []}

        def run():
            try:
                # chaos drill point: the prefetch daemon dying here must
                # surface on the CONSUMING pull, never vanish silently
                _chaos.maybe_fire("hostps_prefetch")
                # the span lives on the prefetch daemon's OWN thread track:
                # the trace shows the pull overlapping the step
                with _trace.span("hostps.prefetch", table=self.name):
                    if stream is None:
                        holder["result"] = self._pull_unique_sync(
                            ids, use_cache)
                    else:
                        with torch.cuda.device(self._device), \
                                torch.cuda.stream(stream):
                            holder["result"] = self._pull_unique_sync(
                                ids, use_cache)
            except BaseException as e:  # surface on the consuming pull
                holder["error"] = e
            finally:
                holder["t_done"] = time.perf_counter()

        t = threading.Thread(target=run, daemon=True,
                             name="hostps-prefetch")
        with self._lock:
            if key in self._pending:
                return                      # already in flight
            while len(self._pending) >= self._pending_cap:
                self._pending.pop(next(iter(self._pending)))
                profiler.incr("hostps.prefetch.waste")
            holder["v0"] = self._push_version
            self._pending[key] = (t, holder)
        t.start()

    def _take_pending(self, key):
        with self._lock:
            pending = self._pending.pop(key, None)
        if pending is None:
            return None
        t, holder = pending
        t0 = time.perf_counter()
        with _trace.span("hostps.prefetch_wait"):
            t.join()
        now = time.perf_counter()
        # prefetch-thread lag telemetry: wait_ms is how long the TRAINING
        # thread stalled on an unfinished prefetch; idle_ms how long a
        # finished result sat unconsumed (headroom)
        profiler.observe("hostps.prefetch.wait_ms", (now - t0) * 1e3)
        if "t_done" in holder:
            profiler.observe("hostps.prefetch.idle_ms",
                             max(now - holder["t_done"], 0.0) * 1e3)
            profiler.observe("hostps.prefetch.pull_ms",
                             (holder["t_done"] - holder["t_start"]) * 1e3)
        if "error" in holder:
            raise holder["error"]
        result = holder.get("result")
        if result is None:
            return None
        if holder["stream"] is not None:
            cur = torch.cuda.current_stream(self._device)
            if cur != holder["stream"]:
                cur.wait_stream(holder["stream"])
                result[1].record_stream(cur)
        with self._lock:
            if self._push_version - holder["v0"] != len(holder["log"]):
                # a restore / install / shard recovery moved rows wholesale
                # while this prefetch was pending: pull afresh
                profiler.incr("hostps.prefetch.stale")
                return None
            self._apply_push_log(result, holder["log"])
        return result

    def _apply_push_log(self, result, log):
        """Write the rows of the pushes logged while a prefetch was pending
        over its values, oldest first, so the last push of a row wins."""
        rows, values, _ = result
        n = int(np.count_nonzero(rows >= 0))
        real = rows[:n]
        for r, new in log:
            if not n or not r.size:
                continue
            pos = np.minimum(np.searchsorted(real, r), n - 1)
            ok = real[pos] == r
            if ok.any():
                self._scatter_host(values, pos[ok], np.asarray(new)[ok])

    def attach_prefetch_slot(self, slot_name):
        """Register a train_from_dataset prefetch hook that pulls this
        table's rows for feed[slot_name] one batch ahead (dataset.py
        prefetch_id_slots names the candidate slots).  Returns the hook so
        callers can unregister_prefetch_hook it."""

        def hook(feed):
            if slot_name in feed:
                self.prefetch(feed[slot_name])

        self._hooks.append(hook)
        return register_prefetch_hook(hook)

    def detach_prefetch_hooks(self):
        """Unregister every hook this embedding attached (end-of-training
        cleanup; the global registry may serve other tables)."""
        for hook in self._hooks:
            unregister_prefetch_hook(hook)
        self._hooks.clear()

    # -- push ------------------------------------------------------------
    def _refuse_read_only(self, what):
        if self.read_only:
            raise RuntimeError(
                "HostPSEmbedding %r is read-only (serving mode): %s — "
                "train-side writes belong to a training replica"
                % (self.name, what))

    def push(self, rows, values, lr):
        """Server-side update for a SelectedRows-style grad: duplicates are
        merged, sentinel rows (>= vocab_size, the merge_rows pad) dropped,
        the host applier updates param+moments, and updated rows write
        through the cache so subsequent hits stay exact.  ``rows`` and
        ``values`` may be numpy arrays or tensors on any device."""
        self._refuse_read_only("there is no push path and no moment updates")
        rows, values = _host(rows), _host(values)
        t0 = time.perf_counter()
        with _trace.span("hostps.push"), self._lock:
            self._push_version += 1
            r, new = self.table.push(rows, values, lr)
            if self.cache is not None and r.size:
                self.cache.update(r, new)
            for _, holder in self._pending.values():
                holder["log"].append((r, new))
            self._after_push(r, new)
        profiler.observe("hostps.push_ms", (time.perf_counter() - t0) * 1e3)
        profiler.incr("hostps.push_rows", int(r.size))
        return r.size

    def _after_push(self, r, new):
        """Subclass hook, called under the embedding lock right after the
        cache write-through (ShardedHostPSEmbedding drops rows whose fresh
        value is remote-only).  Default: nothing."""

    def push_selected_rows(self, grad, lr):
        """grad: sparse.SelectedRows (possibly merged, sentinel-padded)."""
        return self.push(grad.rows, grad.values, lr)

    def push_in_jit(self, rows, values, lr, merge=False):
        """The reference's push from inside a jitted step, run eagerly after
        backward: exactly one host update per call, in call order.
        ``rows`` [N] and ``values`` [N, dim] are per-occurrence (or
        per-unique-row) gradients, usually on the card.

        ``merge=True`` dedupes ON THE DEVICE first through the segment-sum
        kernel (``kernels/segment_update.dedup_segment_sum``): duplicate
        row gradients are summed before they cross to the host, so the
        host applier's own merge (table.push np.unique + np.add.at) passes
        over already-unique rows — the PSLib dedup-before-push discipline.
        Slots that are not the first of their row carry the id
        ``vocab_size`` and zero values, and ``table.push`` drops them.  The
        kernel keeps row ids in 32 bits, so the vocabulary must be below
        2**31.  The merged rows and values come back in ONE device-to-host
        copy."""
        # refuse at the call: the reference refuses at trace time
        self._refuse_read_only("push_in_jit has no meaning here")
        if not merge:
            return self.push(rows, values, lr)
        if self.vocab_size >= 2 ** 31:
            raise ValueError(
                "push_in_jit(merge=True): vocab %d does not fit the segment "
                "kernel's 32-bit row ids" % self.vocab_size)
        values = torch.as_tensor(values)
        rows = torch.as_tensor(rows, device=values.device).long().reshape(-1)
        vals2 = values.reshape(rows.shape[0], -1).float().contiguous()
        mrows, mvals = _segment_update.dedup_segment_sum(
            rows, vals2, self.vocab_size)
        host_rows, host_vals = _fetch_rows_values(mrows, mvals)
        return self.push(host_rows, host_vals, lr)

    # -- checkpoint ------------------------------------------------------
    def save(self, dirname, name=None):
        # shard IO rides the ft retry policy: checkpoint filesystems fail
        # transiently as a matter of course (ft/retry.py counts the tries)
        return _retry.io_retry(self.table.save, dirname, name or self.name,
                               what="hostps save", surface="hostps_shard")

    def restore(self, dirname, name=None):
        with self._lock:
            self._push_version += 1
            _retry.io_retry(self.table.restore, dirname,
                            name or self.name, what="hostps restore",
                            surface="hostps_shard")
            self._refresh_cache()
        return self

    def restore_resharded(self, shard_dirs, name=None):
        """Elastic restore across saver topologies: merge every saver
        process's sparse shards and re-slice by this table's row range
        (HostSparseTable.restore_resharded — the ft/ckpt.py resume path
        when fleet_world changed since the save)."""
        with self._lock:
            self._push_version += 1
            _retry.io_retry(self.table.restore_resharded, shard_dirs,
                            name or self.name,
                            what="hostps resharded restore",
                            surface="hostps_shard")
            self._refresh_cache()
        return self

    def install_rows(self, rows, arrays, forget=None):
        """Install published rows VERBATIM (param + moment slots) — the
        online VersionSwapper's delta-apply surface.  Allowed in read-only
        serving mode: a version install replaces state wholesale from a
        COMMITTED publish, it is not a training-side push.  ``forget``
        names rows to return to the initializer first (``table.forget_rows``:
        rows an earlier install put there that this version does not hold).
        Runs under the embedding lock, bumps the push version so an
        in-flight prefetch's result is not cached or served stale, and
        refreshes every cached row."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        with self._lock:
            self._push_version += 1
            if forget is not None:
                self.table.forget_rows(forget)
            n = self.table.adopt_rows(rows, arrays)
            self._refresh_cache()
        profiler.incr("hostps.install_rows", int(n))
        return n

    def _refresh_cache(self):
        # cached rows may predate the checkpoint: refresh write-through
        if self.cache is not None:
            cached = self.cache._row_of_slot
            live = cached[cached >= 0]
            if live.size:
                self.cache.update(live, self._table_pull(live))


def _fetch_rows_values(rows, values):
    """(rows int64 [N], values f32 [N, D]) tensors -> numpy, in ONE
    device-to-host copy of their bytes packed side by side."""
    if rows.device.type == "cpu":
        return rows.numpy(), values.numpy()
    n = rows.shape[0]
    rbytes = n * 8
    packed = torch.empty(rbytes + values.numel() * 4, dtype=torch.uint8,
                         device=rows.device)
    packed[:rbytes].copy_(rows.contiguous().view(torch.uint8))
    packed[rbytes:].copy_(values.contiguous().view(torch.uint8).reshape(-1))
    host = torch.empty(packed.shape[0], dtype=torch.uint8, pin_memory=True)
    host.copy_(packed)
    raw = host.numpy()
    return (raw[:rbytes].view(np.int64).copy(),
            raw[rbytes:].view(np.float32).reshape(values.shape).copy())
