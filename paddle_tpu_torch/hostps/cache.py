"""Hot-row device cache for the host-RAM sparse service.

Counterpart of ``paddle_tpu/hostps/cache.py``.  The reference's PSLib
trainers keep per-thread pull caches so hot CTR ids skip the pserver RPC
(fleet_wrapper pull dedup); here the cache is a [num_slots, dim] tensor on
the embedding's device plus a host-side row -> slot map with LRU stamps.
A pull serves hit rows by a device gather (no host round trip) and only the
miss rows cross from host RAM; pushes write through, so cached rows stay
bit for bit equal to the host table.

The slot buffer is allocated once and never reallocated.  JAX pads every
gather and scatter to a power-of-two bucket and lets ``mode="fill"`` /
``mode="drop"`` discard the pad lanes; torch has neither mode, and an
out-of-range index in ``index_put_`` on a card is a device assert that ends
the process.  Eager torch compiles nothing per shape, so the port indexes
with the exact slot lists instead: no pad lane exists and every index is in
range by construction (none is clamped).

Hit/miss/eviction counts flow through the profiler counter API
(``profiler.incr``) under "hostps.cache.*", and the occupancy, hit-rate,
row-age and hot-row-skew gauges into the monitor registry, as in the
reference.
"""

import numpy as np
import torch

from .. import profiler
from ..kernels._common import resolve_device
from ..monitor.registry import default_registry as monitor_registry

__all__ = ["HotRowCache", "bucket_size", "host_to_device"]


def bucket_size(n, floor=8):
    """Round a varying row count up to a power-of-two bucket (the
    reference's stable-shape rule; the port keeps it for ``pull_unique``'s
    output shapes, which callers see)."""
    b = int(floor)
    while b < n:
        b <<= 1
    return b


def host_to_device(array, device, dtype=None):
    """A numpy array as a tensor on ``device``.  To a card the copy goes
    through pinned staging with ``non_blocking=True`` on the current stream
    (the caching host allocator keeps the pinned block until the copy has
    run), so the calling thread never waits for the stream to drain."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class HotRowCache:
    def __init__(self, num_slots, dim, dtype=torch.float32, device=None,
                 name="hostps.cache"):
        if num_slots <= 0:
            raise ValueError("HotRowCache needs num_slots > 0")
        self.num_slots = int(num_slots)
        self.dim = int(dim)
        self.name = name
        self._device = resolve_device(device)
        self._values = torch.zeros((self.num_slots, self.dim), dtype=dtype,
                                   device=self._device)
        self._row_of_slot = np.full(self.num_slots, -1, np.int64)
        self._slot_of_row = {}            # int row -> slot
        self._stamp = np.zeros(self.num_slots, np.int64)  # LRU clock marks
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # per-slot lifetime hit counts, feeding the fleet-console gauges:
        # row AGE (ticks since a cached row was last touched) and hot-row
        # SKEW (what share of all hits the top-1% hottest slots took).  The
        # distribution walk is O(num_slots), so it runs every
        # ``_gauge_every`` lookups (every lookup on small caches)
        self._hits_per_slot = np.zeros(self.num_slots, np.int64)
        self._gauge_every = max(1, self.num_slots // 8192)

    @property
    def nbytes(self):
        """Device bytes of the slot buffer (MemScope's ``hostps_cache``)."""
        return self._values.numel() * self._values.element_size()

    @property
    def hit_rate(self):
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    @property
    def occupancy(self):
        """Fraction of slots holding a live row."""
        return len(self._slot_of_row) / self.num_slots

    def _slots_of(self, rows):
        return np.fromiter((self._slot_of_row.get(int(r), -1) for r in rows),
                           np.int64, count=rows.shape[0])

    def lookup(self, rows):
        """rows: UNIQUE int row ids [N].  Returns (slots [N] int64, hit [N]
        bool) with slot == -1 on miss.  Hits are stamped with the current
        tick so this batch's hot rows cannot be evicted by its own
        inserts."""
        rows = np.asarray(rows, np.int64)
        self._tick += 1
        slots = self._slots_of(rows)
        hit = slots >= 0
        self._stamp[slots[hit]] = self._tick
        self._hits_per_slot[slots[hit]] += 1
        nh, nm = int(hit.sum()), int(rows.shape[0] - hit.sum())
        self.hits += nh
        self.misses += nm
        profiler.incr(self.name + ".hit", nh)
        profiler.incr(self.name + ".miss", nm)
        reg = monitor_registry()
        reg.gauge(self.name + ".occupancy").set(self.occupancy)
        reg.gauge(self.name + ".hit_rate").set(self.hit_rate)
        if self._tick % self._gauge_every == 0:
            self._distribution_gauges(reg)
        return slots, hit

    def _distribution_gauges(self, reg):
        """Row-age and hot-row-skew gauges: ``row_age_p50``/``row_age_max``
        in lookup ticks over live slots, ``hot_row_skew`` = the hit share of
        the top-1% hottest slots (1.0 = all traffic on 1% of slots; ~0.01 =
        uniform)."""
        live = np.nonzero(self._row_of_slot >= 0)[0]
        if live.size:
            ages = self._tick - self._stamp[live]
            reg.gauge(self.name + ".row_age_p50").set(
                float(np.median(ages)))
            reg.gauge(self.name + ".row_age_max").set(float(ages.max()))
        total = int(self._hits_per_slot.sum())
        if total:
            k = max(1, self.num_slots // 100)
            top = int(np.partition(self._hits_per_slot, -k)[-k:].sum())
            reg.gauge(self.name + ".hot_row_skew").set(top / total)

    def insert(self, rows, values):
        """Cache miss rows with their freshly pulled host values [M, dim]
        (numpy).  Evicts LRU slots, never ones stamped by this tick's
        lookup.  If the working set exceeds capacity, only the first
        spare-slot-many rows are cached (the rest stay host-only)."""
        rows = np.asarray(rows, np.int64)
        if not rows.size:
            return
        # O(num_slots) victim pick: the m least-recently-stamped slots
        # outside this tick; order within the set does not matter
        cand = np.nonzero(self._stamp != self._tick)[0]
        m = min(rows.shape[0], cand.shape[0])
        if m and cand.shape[0] > m:
            victims = cand[np.argpartition(self._stamp[cand], m - 1)[:m]]
        else:
            victims = cand[:m]
        k = victims.shape[0]
        if not k:
            return
        rows, values = rows[:k], np.asarray(values)[:k]
        for s, r in zip(victims, rows):
            old = self._row_of_slot[s]
            if old >= 0:
                del self._slot_of_row[int(old)]
                self.evictions += 1
                profiler.incr(self.name + ".evict")
            self._row_of_slot[s] = r
            self._slot_of_row[int(r)] = int(s)
            self._stamp[s] = self._tick
            # the slot's hit history belonged to the evicted row
            self._hits_per_slot[s] = 0
        monitor_registry().gauge(self.name + ".occupancy").set(self.occupancy)
        self._scatter(victims, values)

    def gather(self, slots):
        """Device gather of cached rows: [K] slot ids -> [K, dim]."""
        idx = host_to_device(np.asarray(slots, np.int64), self._device)
        return self._values[idx]

    def invalidate(self, rows):
        """Drop `rows` from the cache (their slots free for reuse; the
        device values stay until overwritten — unmapped slots are never
        gathered).  The ShardPS router uses this when a row's freshest
        value lives only on a remote shard.  Returns how many rows were
        actually dropped."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        dropped = 0
        for r in rows:
            s = self._slot_of_row.pop(int(r), None)
            if s is None:
                continue
            self._row_of_slot[s] = -1
            self._stamp[s] = 0
            self._hits_per_slot[s] = 0
            dropped += 1
        if dropped:
            profiler.incr(self.name + ".invalidate", dropped)
            monitor_registry().gauge(
                self.name + ".occupancy").set(self.occupancy)
        return dropped

    def update(self, rows, values):
        """Write-through after a push: rows present in the cache get their
        new host values scattered into their slots; absent rows are
        ignored."""
        rows = np.asarray(rows, np.int64)
        slots = self._slots_of(rows)
        present = slots >= 0
        if present.any():
            self._scatter(slots[present], np.asarray(values)[present])

    def _scatter(self, slots, values):
        """``_values[slots] = values``: the slots are distinct and in range,
        so one ``index_copy_`` writes each exactly once."""
        slots = np.asarray(slots, np.int64)
        if not slots.size:
            return
        idx = host_to_device(slots, self._device)
        v = host_to_device(np.asarray(values).reshape(slots.shape[0], -1),
                           self._device, self._values.dtype)
        self._values.index_copy_(0, idx, v)
