"""Host-RAM sparse table with init-on-first-pull semantics.

Counterpart of ``paddle_tpu/hostps/table.py``, a copy (numpy only):
a port table and a JAX table built with one seed hold the same bits.

Parity: the PSLib/Downpour sparse table (fleet/fleet_wrapper.h:55 — sparse
CTR tables too big for accelerator memory live in host/pserver RAM;
PullSparseVarsSync :76 creates missing rows server-side on first pull).

Beyond-HBM by construction: the backing arrays come from np.zeros (calloc),
so a 100-GiB-vocab table costs virtual address space until a row's page is
first touched — resident memory grows with the rows the workload actually
pulls, the same economics as the reference's accessor-table pserver.
Init-on-first-pull: a row's values are materialized by the initializer the
first time any pull references it; the default initializer is counter-based
(splitmix64 → Box-Muller), so a row's init depends only on (seed, row,
column) — never on pull order, the prefetch thread, or checkpoint-restart.

Out-of-range ids follow the SelectedRows sentinel contract (sparse.py
merge_rows pads with row == height): pull returns zeros for them, push
drops them.
"""

import threading

import numpy as np

from .optimizer import HostSGD

__all__ = ["HostSparseTable", "default_row_initializer"]

_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _splitmix64(x):
    """Vectorized splitmix64 finalizer over uint64 arrays (wrapping uint64
    arithmetic is the algorithm, not an error)."""
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15))
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def _hash_uniform(idx, salt):
    """uint64 index array -> float64 uniform in (0, 1]."""
    z = _splitmix64(idx ^ np.uint64(salt))
    return ((z >> np.uint64(11)).astype(np.float64) + 1.0) * (2.0 ** -53)


def default_row_initializer(dim, scale=None, seed=0, dtype=np.float32):
    """N(0, scale^2) per element via counter-based hashing (deterministic in
    (seed, row, col)); scale defaults to 1/sqrt(dim), matching
    parallel/embedding.py init_sharded_table's default."""
    dim = int(dim)
    scale = float(scale) if scale is not None else 1.0 / np.sqrt(dim)
    s1 = np.uint64(_splitmix64(np.uint64(2 * seed + 1)))
    s2 = np.uint64(_splitmix64(np.uint64(2 * seed + 2)))

    def init(rows):
        rows = np.asarray(rows, np.uint64)
        idx = rows[:, None] * np.uint64(dim) + np.arange(dim, dtype=np.uint64)
        u1 = _hash_uniform(idx, s1)
        u2 = _hash_uniform(idx, s2)
        normal = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)
        return (normal * scale).astype(dtype)

    return init


class HostSparseTable:
    """A [vocab_size, dim] sparse parameter table in host RAM, with per-row
    optimizer state (moment slots sized by the applier's slot_shapes).

    Thread-safe: pull/push take an RLock so the service's prefetch thread
    and the training thread's push interleave without torn rows.
    """

    def __init__(self, vocab_size, dim, optimizer=None, initializer=None,
                 seed=0, dtype=np.float32, name="host_table",
                 row_range=None):
        self.vocab_size = int(vocab_size)
        self.dim = int(dim)
        self.dtype = np.dtype(dtype)
        self.name = name
        # which rows of the GLOBAL vocab this table instance owns — None =
        # all of them (the single-host replica layout).  A range-partitioned
        # fleet sets this from the sharding authority
        # (parallel/rules.hostps_row_range); the elastic checkpoint
        # re-sharder (ft/ckpt.py) filters merged saver shards by it, and it
        # rides the snapshot meta so a resumer knows what a saver covered.
        self.row_range = self._validate_row_range(row_range)
        self.optimizer = optimizer or HostSGD()
        self.initializer = initializer or default_row_initializer(
            dim, seed=seed, dtype=self.dtype)
        self._param = np.zeros((self.vocab_size, self.dim), self.dtype)
        self._live = np.zeros(self.vocab_size, bool)
        # rows whose persisted state changed since the last snapshot_delta
        # (init, push, adopt) — the DeltaPublisher's hot-row set.  A bool
        # mask, not a set: marking is a vectorized store on the push path
        self._touched = np.zeros(self.vocab_size, bool)
        self._slots = {
            s: np.zeros((self.vocab_size,) + tuple(shape), np.float32)
            for s, shape in self.optimizer.slot_shapes(self.dim).items()
        }
        self._lock = threading.RLock()

    # -- introspection ---------------------------------------------------
    @property
    def rows_initialized(self):
        return int(np.count_nonzero(self._live))

    @property
    def nbytes_virtual(self):
        """Reserved (not resident) bytes: param + live mask + moment slots."""
        return (self._param.nbytes + self._live.nbytes
                + sum(a.nbytes for a in self._slots.values()))

    @property
    def nbytes_resident(self):
        """ESTIMATED resident bytes: initialized rows x per-row footprint
        (param row + moment rows) + the live mask.  calloc economics mean
        untouched rows cost address space only — this is the number the
        MemScope host-side accounting reports per table (the reference's
        AllocatorFacade ``Allocated`` stat, per accessor table)."""
        row_bytes = self._param.itemsize * self.dim + sum(
            a.itemsize * int(np.prod(a.shape[1:], dtype=np.int64))
            for a in self._slots.values())
        return self.rows_initialized * row_bytes + self._live.nbytes

    def _validate_row_range(self, row_range):
        """THE [lo, hi) shard-validity rule, shared by the constructor and
        ``set_row_range`` so the partition contract lives in one place."""
        if row_range is None:
            return None
        lo, hi = int(row_range[0]), int(row_range[1])
        if not (0 <= lo < hi <= self.vocab_size):
            raise ValueError(
                "HostSparseTable %r: row_range [%d, %d) is not a valid "
                "shard of vocab %d (need 0 <= lo < hi <= vocab)"
                % (self.name, lo, hi, self.vocab_size))
        return (lo, hi)

    # -- pull / push -----------------------------------------------------
    def _check_owned(self, rows, op):
        """Raise loudly when a VALID vocab id falls outside this shard's
        ``row_range`` — a routing bug (the shard router sent a row to the
        wrong owner), never a workload property.  Silently init-on-first-
        pulling past the shard boundary would mint a divergent replica of
        a row another shard owns.  Sentinel/out-of-vocab ids are filtered
        by the callers before this check (they keep the SelectedRows
        zero/drop contract)."""
        if self.row_range is None or not rows.size:
            return
        lo, hi = self.row_range
        bad = rows[(rows < lo) | (rows >= hi)]
        if bad.size:
            raise ValueError(
                "HostSparseTable %r owns rows [%d, %d) of vocab %d but a "
                "%s referenced row(s) %s — ids must be routed to their "
                "owner shard (parallel/rules.hostps_row_range)"
                % (self.name, lo, hi, self.vocab_size, op,
                   np.unique(bad)[:8].tolist()))

    def _ensure_rows(self, rows):
        """rows: unique valid int64 [K].  Materialize uninitialized ones."""
        fresh = rows[~self._live[rows]]
        if fresh.size:
            self._param[fresh] = self.initializer(fresh)
            self._live[fresh] = True
            self._touched[fresh] = True

    def pull(self, ids, materialize=True):
        """Gather rows for `ids` (any integer shape) -> [*ids.shape, dim]
        numpy.  First reference to a row runs the initializer; ids outside
        [0, vocab_size) return zeros (the merge_rows sentinel contract);
        valid ids outside a range-partitioned table's ``row_range`` raise
        (see _check_owned).

        ``materialize=False`` is the READ-ONLY pull (the PSLib serving
        scenario, service.py ``read_only=True``): rows the training side
        never initialized are served by running the initializer INTO THE
        OUTPUT without touching the table — the counter-based initializer
        depends only on (seed, row, col), so the values are bit-identical
        to what init-on-first-pull would have persisted, and the table's
        param / moments / live mask stay byte-for-byte unchanged."""
        ids = np.asarray(ids)
        flat = ids.reshape(-1).astype(np.int64)
        valid = (flat >= 0) & (flat < self.vocab_size)
        out = np.zeros((flat.shape[0], self.dim), self.dtype)
        with self._lock:
            vrows = np.unique(flat[valid])
            self._check_owned(vrows, "pull")
            if materialize:
                self._ensure_rows(vrows)
                out[valid] = self._param[flat[valid]]
            else:
                vals = self._param[flat[valid]]
                cold = ~self._live[flat[valid]]
                if cold.any():
                    fresh = np.unique(flat[valid][cold])
                    init = self.initializer(fresh)
                    vals[cold] = init[np.searchsorted(fresh,
                                                      flat[valid][cold])]
                out[valid] = vals
        return out.reshape(ids.shape + (self.dim,))

    def push(self, rows, values, lr):
        """Apply a SelectedRows-style gradient: duplicates merged (summed),
        sentinel/out-of-range rows dropped, then the host applier updates
        param + moment rows in place.  Returns (unique_rows, new_values) so
        callers (the service) can write-through their HBM cache."""
        rows = np.asarray(rows).reshape(-1).astype(np.int64)
        values = np.asarray(values, np.float32).reshape(rows.shape[0], -1)
        valid = (rows >= 0) & (rows < self.vocab_size)
        r, inv = np.unique(rows[valid], return_inverse=True)
        self._check_owned(r, "push")
        if not r.size:
            return r, np.zeros((0, self.dim), self.dtype)
        grad = np.zeros((r.size, self.dim), np.float32)
        np.add.at(grad, inv, values[valid])
        with self._lock:
            # a push to a never-pulled row initializes it first (the pull
            # normally precedes, but the async pipeline must not corrupt)
            self._ensure_rows(r)
            param = self._param[r].astype(np.float32)
            slots = {s: a[r] for s, a in self._slots.items()}
            self.optimizer.apply(param, grad, slots, float(lr))
            new = param.astype(self.dtype)
            self._param[r] = new
            for s, a in self._slots.items():
                a[r] = slots[s]
            self._touched[r] = True
        return r, new

    # -- checkpoint (io.py sparse shard container) -----------------------
    def snapshot(self, lo=None, hi=None):
        """Consistent in-memory copy of the initialized rows + moment slots,
        taken under the table lock: ``(rows, {array: values}, meta)``.  The
        unified TrainState checkpoint (ft/ckpt.py) extracts this at the
        step boundary SYNCHRONOUSLY and defers only the file IO — a table
        drifting a few pushes past the dense state would break exact
        resume.  (Fancy indexing copies, so the returned arrays are immune
        to concurrent pushes.)  ``lo``/``hi`` restrict the copy to live
        rows in ``[lo, hi)`` — the shard router's repartition uses this to
        lift exactly the rows whose ownership is moving."""
        with self._lock:
            live = self._live
            if lo is not None or hi is not None:
                live = np.zeros_like(self._live)
                live[lo:hi] = self._live[lo:hi]
            rows = np.nonzero(live)[0].astype(np.int64)
            arrays = {"param": self._param[rows]}
            for s, a in self._slots.items():
                arrays["slot_" + s] = a[rows]
            meta = {"vocab_size": self.vocab_size, "dim": self.dim,
                    "dtype": self.dtype.name,
                    "optimizer": self.optimizer.name,
                    "row_range": (list(self.row_range)
                                  if self.row_range is not None
                                  else [0, self.vocab_size])}
        return rows, arrays, meta

    @property
    def touched_rows_pending(self):
        """How many live rows changed since the last ``snapshot_delta`` —
        the size of the next delta publish."""
        with self._lock:
            return int(np.count_nonzero(self._touched & self._live))

    def snapshot_base(self):
        """``snapshot()`` of every live row that ALSO consumes the pending
        touched set (cleared under the same lock hold) — a base publish
        carries the whole table, so the first delta after it must ship
        only post-base touches."""
        with self._lock:
            rows = np.nonzero(self._live)[0].astype(np.int64)
            arrays = {"param": self._param[rows]}
            for s, a in self._slots.items():
                arrays["slot_" + s] = a[rows]
            meta = {"vocab_size": self.vocab_size, "dim": self.dim,
                    "dtype": self.dtype.name,
                    "optimizer": self.optimizer.name,
                    "row_range": (list(self.row_range)
                                  if self.row_range is not None
                                  else [0, self.vocab_size])}
            self._touched[:] = False
        return rows, arrays, meta

    def snapshot_delta(self):
        """Consistent copy of ONLY the rows whose persisted state changed
        since the previous ``snapshot_delta`` (init-on-first-pull, push,
        adopt) — the DeltaPublisher's per-interval hot-row set.  Same
        ``(rows, arrays, meta)`` shape as ``snapshot`` so the delta rides
        the identical sparse-shard container; the touched flags are CLEARED
        under the same lock hold (a push landing after this call belongs to
        the NEXT delta).  If the publish that consumes this snapshot fails,
        the caller must hand the rows back via ``mark_rows_touched`` or
        they silently drop out of the chain."""
        with self._lock:
            rows = np.nonzero(self._touched & self._live)[0].astype(np.int64)
            arrays = {"param": self._param[rows]}
            for s, a in self._slots.items():
                arrays["slot_" + s] = a[rows]
            meta = {"vocab_size": self.vocab_size, "dim": self.dim,
                    "dtype": self.dtype.name,
                    "optimizer": self.optimizer.name,
                    "row_range": (list(self.row_range)
                                  if self.row_range is not None
                                  else [0, self.vocab_size]),
                    "delta": True}
            self._touched[:] = False
        return rows, arrays, meta

    def mark_rows_touched(self, rows):
        """Re-arm rows for the next delta (the failed-publish undo for
        ``snapshot_delta`` — an over-approximation is always safe; a
        dropped row is not)."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        if rows.size:
            with self._lock:
                self._touched[rows] = True
        return int(rows.size)

    def save(self, dirname, name=None):
        """Snapshot initialized rows + moment slots through io.py's chunked
        sparse-shard container (multi-GiB tables stream block-by-block)."""
        from .. import io

        rows, arrays, meta = self.snapshot()
        return io.save_sparse_shards(dirname, name or self.name, rows,
                                     arrays, meta=meta)

    def restore(self, dirname, name=None):
        """Load a save() snapshot: restored rows become live with their
        exact param + moment state; rows absent from the snapshot are reset
        to uninitialized (and will init-on-first-pull as usual) — an
        in-process rollback lands on exactly the state a process-restart
        restore would, so rows touched after the save don't leak through.

        The one-saver special case of ``restore_resharded`` (full row
        filter) — one load path, same-world and elastic."""
        return self.restore_resharded([dirname], name)

    def restore_resharded(self, shard_dirs, name=None):
        """Elastic restore: rebuild this table from the sparse shards of
        ANY number of saver processes (``shard_dirs``, ascending saver
        rank), keeping only rows inside this table's ``row_range``.

        This is the HostPS half of topology-portable checkpoints
        (ft/ckpt.py): a fleet that saved on N processes resumes on M by
        merging every saver's row shards and re-slicing them by the NEW
        world's row ranges (parallel/rules.hostps_row_range).  Replica
        tables (row_range=None) take the union; on overlap the
        highest-numbered saver wins — deterministic, and exact whenever
        replicas agree (they do for data-parallel replicas saved at one
        step boundary).  Row/moment state restores exactly; rows no saver
        held reset to init-on-first-pull."""
        from .. import io

        name = name or self.name
        lo, hi = self.row_range if self.row_range is not None \
            else (0, self.vocab_size)
        # validate-only pass: each saver's row_range meta is deliberately
        # ignored — this table's OWN range filters the merged rows below
        for d in shard_dirs:
            meta = io.load_sparse_meta(d, name)["meta"]
            if (meta.get("vocab_size"), meta.get("dim")) != (self.vocab_size,
                                                             self.dim):
                raise ValueError(
                    "hostps elastic restore: checkpoint table %r in %s is "
                    "[%s x %s], this table is [%d x %d]"
                    % (name, d, meta.get("vocab_size"), meta.get("dim"),
                       self.vocab_size, self.dim))
        with self._lock:
            self._param = np.zeros((self.vocab_size, self.dim), self.dtype)
            self._live = np.zeros(self.vocab_size, bool)
            for s in self._slots:
                self._slots[s] = np.zeros_like(self._slots[s])
            self._touched = np.zeros(self.vocab_size, bool)
            for d in shard_dirs:        # ascending rank: last writer wins
                for rows, arrays in io.load_sparse_shards(d, name):
                    keep = (rows >= lo) & (rows < hi)
                    if not keep.any():
                        continue
                    r = rows[keep]
                    self._param[r] = arrays["param"][keep].astype(self.dtype)
                    self._live[r] = True
                    self._touched[r] = True
                    for s, a in self._slots.items():
                        key = "slot_" + s
                        if key in arrays:
                            a[r] = arrays[key][keep]
        return self

    # -- live repartition (ShardPS elastic shrink/grow) -------------------
    def set_row_range(self, row_range):
        """Re-declare which global rows this table owns — the LIVE half of
        an elastic repartition (hostps/shard_router.py repartition moves
        the row data with ``adopt_rows``/``evict_rows`` and then updates
        each owner's range here; the checkpoint-time half is
        ``restore_resharded``).  Validated like the constructor."""
        row_range = self._validate_row_range(row_range)
        with self._lock:
            self.row_range = row_range
        return self

    def adopt_rows(self, rows, arrays):
        """Install rows VERBATIM (param + moment slots + liveness) from
        another shard's snapshot — the receiving half of a live
        repartition.  ``arrays`` is the snapshot dict ({"param", "slot_*"})
        for exactly ``rows``.  Rows must lie inside this table's (possibly
        just-widened) ``row_range``."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        if not rows.size:
            return 0
        with self._lock:
            self._check_owned(rows, "adopt")
            self._param[rows] = np.asarray(
                arrays["param"]).astype(self.dtype)
            self._live[rows] = True
            self._touched[rows] = True
            for s, a in self._slots.items():
                key = "slot_" + s
                if key in arrays:
                    a[rows] = arrays[key]
        return int(rows.size)

    def forget_rows(self, rows):
        """Return ``rows`` to the never-initialized state (param, moment
        slots, liveness and touched flag cleared), so a pull serves them
        from the initializer again.  The online rollback's undo of rows a
        later version installed that the target version never held.
        Returns how many of them were live."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        if not rows.size:
            return 0
        with self._lock:
            self._check_owned(rows, "forget")
            n = int(np.count_nonzero(self._live[rows]))
            self._param[rows] = 0
            self._live[rows] = False
            self._touched[rows] = False
            for a in self._slots.values():
                a[rows] = 0
        return n

    def evict_rows(self, lo, hi):
        """Forget rows ``[lo, hi)`` (the giving half of a live
        repartition): their param/moments/liveness reset so a stale copy
        can never serve after ownership moved.  Returns the evicted live
        row ids."""
        with self._lock:
            rows = np.nonzero(self._live[lo:hi])[0] + int(lo)
            self._param[lo:hi] = 0
            self._live[lo:hi] = False
            self._touched[lo:hi] = False
            for a in self._slots.values():
                a[lo:hi] = 0
        return rows
