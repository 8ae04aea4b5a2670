"""Unified TrainState checkpoint: ONE manifest for everything a resumed run
needs to be bit-identical to a never-interrupted one.

Parity: the reference scatters resumable state across surfaces —
``save_persistables`` for dense params/slots, ``checkpoint_notify`` for the
pserver's sparse tables, and the Downpour trainer's pass/file cursor.  Here
all of it rides parallel/checkpoint.py's shard/COMMIT protocol as one
committed directory:

- dense parameters + optimizer slots: the program's persistable scope vars
  (device->host snapshotted synchronously, written sharded + CRC'd);
- HostPS sparse shards: every table's live rows + moment slots, snapshotted
  under the table lock at the SAME step boundary (the file IO may be async,
  the memory snapshot is not — a sparse table drifting a few pushes past
  the dense state would break exact resume).  Each process's tables land
  under its OWN ``hostps/p<K>/`` subdir (host-RAM tables are per-process
  state; a shared relpath would let the last publisher win);
- the dataset cursor ``(file_idx, batch_idx)`` of the last trained batch;
- Python and numpy global RNG streams — PER PROCESS (``rng/p<K>/...``:
  the streams differ across ranks, and a shared leaf would hand every
  rank the last writer's stream on restore) — plus the executor's
  step-derived seed counter (jittered dropout etc. replays identically);
- the trainer step counter.

Layout inside ``ckpt-<step>/`` (on top of the base protocol's files):
  shards-p<K>.npz       the state pytree: scope/<var>, rng/p<K>/*, meta/*
  hostps/p<K>/<table>.sparse.{meta,NNNNN.npz}   per registered table
  COMMIT                written last (base protocol)

The port's counterpart of ``paddle_tpu/ft/ckpt.py``.  A scope var the
port's ``Scope`` holds as this rank's block (a kReduce row block or a
tensor-parallel split) is saved as a ``parallel.checkpoint.LocalBlock``
with its global slice (``scope_blocks``), never gathered; on restore the
blocks are re-sliced for the scope's CURRENT layout (``restore_into_scope``).
The executor derives each run's dropout generator from the program's seed
and its run counter (``exec_step``), so restoring the counter replays the
draws and no torch generator state is saved.  HostPS tables
(``hostps.HostPSEmbedding``, ``ShardedHostPSEmbedding`` or a bare
``HostSparseTable``) are written in the reference's sparse-shard format, so
either package restores a TrainState the other wrote.
"""

import os
import random
import time

import numpy as np
import torch

from . import retry as _retry

__all__ = ["save_train_state", "restore_train_state", "latest_checkpoint",
           "hostps_extras", "restore_hostps",
           "RestoredState", "TrainStateWriter", "pack_rng", "apply_rng",
           "rng_template", "scope_blocks", "scope_targets",
           "restore_into_scope"]


def latest_checkpoint(directory):
    from ..parallel import checkpoint as _base

    return _base.latest_checkpoint(directory)


# -- RNG stream (de)hydration ------------------------------------------------

def pack_rng():
    """Python + numpy global RNG state as flat numpy leaves (checkpoint-
    friendly: fixed shapes, no pickles)."""
    pv, pstate, pgauss = random.getstate()
    nname, nkeys, npos, nhas, ncached = np.random.get_state()
    if nname != "MT19937":          # exotic global bit generator: skip
        return {"absent": np.int64(1)}
    return {
        "absent": np.int64(0),
        "py_state": np.asarray(pstate, np.uint64),
        "py_meta": np.asarray(
            [pv, 0 if pgauss is None else 1], np.int64),
        "py_gauss": np.float64(0.0 if pgauss is None else pgauss),
        "np_keys": np.asarray(nkeys, np.uint32),
        "np_meta": np.asarray([npos, nhas], np.int64),
        "np_cached": np.float64(ncached),
    }


def rng_template(full=True):
    """A zero tree with pack_rng()'s structure (the restore target).
    full=False gives the ``absent`` form — for reading checkpoints saved
    with rng=False or from an exotic global bit generator."""
    if not full:
        return {"absent": np.int64(1)}
    t = pack_rng()
    if int(t["absent"]):
        return t
    return {k: np.zeros_like(v) for k, v in t.items()}


def apply_rng(tree):
    """Install a pack_rng() tree into the global RNG streams."""
    if int(np.asarray(tree["absent"])):
        return
    pmeta = np.asarray(tree["py_meta"])
    pstate = tuple(int(x) for x in np.asarray(tree["py_state"]))
    pgauss = float(np.asarray(tree["py_gauss"])) if int(pmeta[1]) else None
    random.setstate((int(pmeta[0]), pstate, pgauss))
    nmeta = np.asarray(tree["np_meta"])
    np.random.set_state((
        "MT19937", np.asarray(tree["np_keys"], np.uint32),
        int(nmeta[0]), int(nmeta[1]),
        float(np.asarray(tree["np_cached"]))))


def _cursor_leaf(cursor):
    if cursor is None:
        return np.asarray([-1, -1], np.int64)
    return np.asarray([int(cursor[0]), int(cursor[1])], np.int64)


def _leaf_cursor(arr):
    a = np.asarray(arr)
    if int(a[0]) < 0 and int(a[1]) < 0:
        return None
    return (int(a[0]), int(a[1]))


def _hostps_list(hostps):
    """Normalize to a name->embedding/table list; None = every live
    HostPSEmbedding (hostps/service.py weak registry)."""
    if hostps is None:
        from ..hostps import service as _svc

        hostps = _svc.live_embeddings()
    out = []
    seen = set()
    for h in hostps:
        name = getattr(h, "name", None) or "host_table"
        if name in seen:
            raise ValueError(
                "unified checkpoint: two HostPS tables named %r — give "
                "tables distinct names" % name)
        seen.add(name)
        out.append((name, h))
    return sorted(out, key=lambda nh: nh[0])


def hostps_extras(hostps, proc):
    """Snapshot the HostPS tables NOW (under each table's lock, at this
    step boundary) and return ``(extras, nbytes)``: ``extras(stage_dir)``
    writes them under ``hostps/p<proc>/`` on the checkpoint writer (None
    when there is no table).  Shared by the unified TrainState save and
    ``LoopGuard``'s loop checkpoints."""
    snaps = []
    nbytes = 0
    for name, h in _hostps_list(hostps):
        table = getattr(h, "table", h)
        rows, arrays, meta = table.snapshot()
        snaps.append((name, rows, arrays, meta))
        nbytes += rows.nbytes + sum(a.nbytes for a in arrays.values())
    if not snaps:
        return None, 0

    def extras(stage_dir):
        from .. import io as _io

        # per-process subdir: each rank's host-RAM tables are its own
        # state; a shared relpath would collide in the published dir
        # (last os.replace wins) and fail every other rank's CRC
        sub = os.path.join(stage_dir, "hostps", "p%d" % proc)
        for name, rows, arrays, meta in snaps:
            _retry.io_retry(_io.save_sparse_shards, sub, name, rows,
                            arrays, meta=meta, what="hostps shards",
                            surface="hostps_shard")

    return extras, nbytes


def _leaf_nbytes(v):
    """Bytes a leaf puts in this process's shard file."""
    from ..parallel.checkpoint import LocalBlock

    if isinstance(v, LocalBlock):
        if not v.write:
            return 0
        v = v.data
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    return int(np.asarray(v).nbytes)


# -- scope <-> blocks ----------------------------------------------------------

def _group_place(group):
    """(rank in group, group holds world rank 0) for a scope var's group
    (None: the world's)."""
    import torch.distributed as dist

    if group is None:
        group = dist.group.WORLD
    ranks = dist.get_process_group_ranks(group)
    return ranks.index(dist.get_rank()), 0 in ranks


def scope_blocks(scope, names):
    """{name: value} of ``names`` for a TrainState, each var as the scope
    holds it: a whole var as its tensor, a kReduce row block (``Scope.set(
    ..., row_shards=n)``) or a tensor-parallel block (``split=(dim, n,
    group)``) as a ``LocalBlock`` with its global slice.  A block is
    written by the ranks of the group that holds world rank 0 (the other
    groups hold the same slices), and a whole var of a data-parallel world
    by world rank 0 alone; nothing is gathered."""
    import torch.distributed as dist

    from ..parallel.checkpoint import LocalBlock

    world = dist.is_initialized() and dist.get_world_size() > 1
    out = {}
    for n in names:
        v = scope.find_var(n)
        owner = scope._owner(n)
        rows = owner._row_shards.get(n) if owner is not None else None
        split = owner._splits.get(n) if owner is not None else None
        if rows is None and split is None:
            out[n] = (v if not world or dist.get_rank() == 0
                      else LocalBlock(v, tuple(v.shape),
                                      [[0, d] for d in v.shape], write=False))
            continue
        dim, parts, group = ((0,) + rows) if rows is not None else split
        k, write = _group_place(group)
        shape = list(v.shape)
        size = shape[dim]
        shape[dim] = size * parts
        slices = [[0, d] for d in shape]
        slices[dim] = [k * size, (k + 1) * size]
        out[n] = LocalBlock(v, shape, slices, write=write)
    return out


def scope_targets(scope, names):
    """Restore targets for ``names``: the scope's CURRENT layout of each var
    (a ``LocalBlock`` for a block, the tensor for a whole var), so a
    checkpoint from any world re-slices into this one."""
    from ..parallel.checkpoint import LocalBlock

    blocks = scope_blocks(scope, names)
    return {n: (LocalBlock(b.data, b.shape, b.slices)
                if isinstance(b, LocalBlock) else b)
            for n, b in blocks.items()}


def restore_into_scope(scope, values):
    """Put restored values back, keeping each var's row and split metadata —
    the current world's, which ``scope_targets`` sliced them for."""
    for n, v in values.items():
        owner = scope._owner(n) or scope
        rows = owner._row_shards.get(n)
        split = owner._splits.get(n)
        owner.var(n)
        owner.set(n, v, row_shards=rows[0] if rows else 1,
                  rows_group=rows[1] if rows else None, split=split)


class TrainStateWriter:
    """Wraps the base CheckpointWriter with the ft telemetry contract:
    ``wait()``/``finish()`` blocks until durable, then (once) bumps
    ``ft.ckpt.{saves,bytes,secs}`` and emits a ``ckpt`` timeline event.
    Set ``block_ms`` (the train thread's blocking cost) BEFORE the first
    finish() so the overhead accounting includes it — the guard does; the
    synchronous save path defers its telemetry to finish() for exactly
    this reason (a sync save is ALL blocking cost, the one the <5% budget
    most needs to see)."""

    def __init__(self, writer, step, nbytes, t_start, asynchronous,
                 block_ms=None):
        self._writer = writer
        self.step = int(step)
        self.nbytes = int(nbytes)
        self.asynchronous = asynchronous
        self.block_ms = block_ms        # train-thread time (guard fills in)
        self._t_start = t_start
        self._done = False

    def wait(self):
        self._writer.wait()     # raises the writer's error, if any
        if self._done:
            return self
        self._done = True
        secs = time.perf_counter() - self._t_start
        try:
            from .. import monitor as _monitor

            reg = _monitor.default_registry()
            reg.counter("ft.ckpt.saves").incr()
            reg.counter("ft.ckpt.bytes").incr(self.nbytes)
            reg.histogram("ft.ckpt.secs").observe(secs)
            mon = _monitor.active()
            if mon is not None:
                ev = {"step": self.step, "bytes": self.nbytes,
                      "secs": round(secs, 4), "async": self.asynchronous}
                if self.block_ms is not None:
                    ev["block_ms"] = round(self.block_ms, 4)
                mon.timeline.emit("ckpt", **ev)
        except Exception:
            pass                 # telemetry must never fail a checkpoint
        # the reference's WarmStart hook (warm.py notify_commit: a committed
        # checkpoint pre-compiles the next incarnation's executables) has
        # no counterpart until ROADMAP Queue 1 item 8
        return self

    finish = wait


def save_train_state(directory, step, scope_state=None, cursor=None,
                     exec_step=None, hostps=None, asynchronous=True,
                     keep=None, rng=True):
    """Write the unified TrainState as ``ckpt-<step>``.

    scope_state: {var_name: value} — dense params + optimizer slots (live
    tensors are fine: they are copied to host before this returns, so the
    caller may keep training immediately; a ``LocalBlock`` value is this
    rank's block of the var, ``scope_blocks``).
    cursor: (file_idx, batch_idx) of the LAST TRAINED batch, or None.
    exec_step: the executor's per-run seed counter (Executor._step).
    hostps: tables to include (None = all live HostPSEmbeddings).  Their
    rows/slots are copied out under the table lock NOW; only file IO runs
    on the writer thread.

    Returns a TrainStateWriter (call .wait()/.finish() for durability +
    telemetry; sync saves may still call it — idempotent)."""
    from ..parallel import checkpoint as _base
    from . import agree as _agree

    t0 = time.perf_counter()
    proc = _agree.fleet_rank()
    tree = {
        "scope": dict(scope_state or {}),
        # rng is keyed by process: every rank's streams differ, and a
        # shared leaf path would restore as last-index-wins
        "rng": {"p%d" % proc:
                pack_rng() if rng else {"absent": np.int64(1)}},
        "meta": {
            "step": np.int64(step),
            "cursor": _cursor_leaf(cursor),
            "exec_step": np.int64(-1 if exec_step is None else exec_step),
        },
    }
    nbytes = sum(_leaf_nbytes(v) for v in tree["scope"].values())

    extras, hp_bytes = hostps_extras(hostps, proc)
    nbytes += hp_bytes
    writer = _base.save_checkpoint(directory, tree, step=int(step),
                                   asynchronous=asynchronous, keep=keep,
                                   extras=extras)
    out = TrainStateWriter(writer, step, nbytes, t0, asynchronous)
    if not asynchronous:
        # surface IO errors NOW, but leave the telemetry emit to finish():
        # the caller hasn't measured block_ms yet, and a sync save's whole
        # cost is train-thread blocking — emitting early would hide it
        writer.wait()
    return out


class RestoredState:
    """What restore_train_state hands back.  ``saver_world``/``world``
    record the save-time vs resume-time fleet size; ``resharded`` is True
    when they differ (the elastic shrink/grow path re-assembled this state
    from a different topology's shards)."""

    def __init__(self, scope_state, step, cursor, exec_step, path,
                 saver_world=1, world=1, resharded=False):
        self.scope_state = scope_state
        self.step = step
        self.cursor = cursor
        self.exec_step = exec_step
        self.path = path
        self.saver_world = saver_world
        self.world = world
        self.resharded = resharded


def restore_train_state(directory, scope_target, hostps=None, verify=True,
                        rng=True):
    """Restore the latest committed unified checkpoint under `directory`
    (or an explicit ``ckpt-<step>`` path).

    TOPOLOGY-PORTABLE: the checkpoint may have been saved by a DIFFERENT
    fleet size (elastic shrink/grow).  Dense leaves reassemble from every
    saver's layout manifest and re-slice for the current placement
    (parallel/checkpoint.py restore_checkpoint); HostPS sparse tables merge
    every saver rank's row shards and repartition them by the current
    world's row ranges (parallel/rules.hostps_row_range via
    HostSparseTable.restore_resharded); a rank whose per-process RNG stream
    was never saved (grown past the saver world) keeps its fresh streams —
    the one documented non-bit-exact residue of a grow.
    ``RestoredState.resharded`` + the ``ft.ckpt.reshards`` counter record
    that a cross-topology resume happened.

    scope_target: {var_name: current_value} — the dense state's current
    layout (a tensor comes back on its device and dtype, a ``LocalBlock``
    as that block of the saved var).  Must cover exactly the names that
    were saved — a drifted program fails loudly.
    hostps: tables to restore into (None = all live HostPSEmbeddings; each
    must carry the same name it was saved under).

    Returns RestoredState (None when no committed checkpoint exists)."""
    import warnings

    from ..parallel import checkpoint as _base
    from . import agree as _agree

    path = directory
    if not os.path.exists(os.path.join(str(directory), "COMMIT")):
        path = _base.latest_checkpoint(str(directory))
        if path is None:
            return None
    proc = _agree.fleet_rank()
    world = _agree.fleet_world()
    rng_key = "p%d" % proc
    indexes = _base._load_indexes(path)
    saver_world = int(indexes[0].get("process_count", 1))
    resharded = saver_world != world
    saved_leaves = {p for idx in indexes for p in idx["leaves"]}
    # the target's rng subtree must match what was SAVED (rng=False or an
    # exotic bit generator wrote only the `absent` marker); each process
    # restores ITS OWN stream.  A rank the saver topology never had (grown
    # world) has NO saved stream at all: it keeps its fresh streams.
    have_my_rng = any(p.startswith("rng/%s/" % rng_key)
                      for p in saved_leaves)
    saved_full_rng = ("rng/%s/py_state" % rng_key) in saved_leaves
    # loud drift check: a saved dense var the target does not cover would
    # otherwise keep its fresh-init value and SILENTLY break bit-parity
    # (restore only assembles leaves the target asks for)
    saved_scope = {p[len("scope/"):] for p in saved_leaves
                   if p.startswith("scope/")}
    uncovered_scope = saved_scope - set(scope_target or {})
    if uncovered_scope:
        raise RuntimeError(
            "unified checkpoint %s holds scope vars %s that the restore "
            "target does not cover — the program drifted since the save "
            "(run the same startup/program build before resuming)"
            % (path, sorted(uncovered_scope)[:8]))
    target = {
        "scope": dict(scope_target or {}),
        "rng": ({rng_key: rng_template(full=saved_full_rng)}
                if have_my_rng else {}),
        "meta": {"step": np.int64(0),
                 "cursor": np.zeros(2, np.int64),
                 "exec_step": np.int64(0)},
    }
    if verify:
        # the base restore CRC-checks the shard files itself; this pass
        # covers only the REST of the manifest (extra staged files) so a
        # multi-GB dense shard is never read and hashed twice
        _base.verify_checkpoint_files(
            path, only=lambda rel: not rel.startswith("shards-p"))
    tree, step = _base.restore_checkpoint(path, target, verify=verify,
                                          indexes=indexes)
    if rng:
        if have_my_rng:
            apply_rng(tree["rng"][rng_key])
        else:
            # grown rank: no saved stream to install.  Bit-parity caveat —
            # anything this rank draws from the host RNGs after resume
            # differs from a never-interrupted world-M run.
            warnings.warn(
                "elastic resume: checkpoint %s (saved on %d process(es)) "
                "holds no RNG stream for rank %d of %d — this rank keeps "
                "fresh host RNG streams" % (path, saver_world, proc, world))
            from ..monitor.registry import stat_add

            stat_add("ft.ckpt.rng_reseeded")
    restore_hostps(path, indexes, hostps, resharded, rng_key)
    if resharded:
        from ..monitor.registry import stat_add

        stat_add("ft.ckpt.reshards")
    exec_step = int(np.asarray(tree["meta"]["exec_step"]))
    return RestoredState(
        scope_state=tree["scope"],
        step=int(np.asarray(tree["meta"]["step"])),
        cursor=_leaf_cursor(tree["meta"]["cursor"]),
        exec_step=None if exec_step < 0 else exec_step,
        path=path,
        saver_world=saver_world, world=world, resharded=resharded)


def restore_hostps(path, indexes, hostps, resharded, rng_key):
    """Load the ``hostps/p<K>/`` subtree of the committed checkpoint
    ``path`` (manifests ``indexes``) into the offered tables: same
    topology, each rank (``rng_key`` = ``p<rank>``) its own saver's tables;
    across a ``fleet_world`` change, every saver's shards merged and
    re-sliced by each table's row range."""
    tables = _hostps_list(hostps)
    hp_root = os.path.join(path, "hostps")
    # every saver rank's sparse-shard subdir, ascending rank (the merge
    # order restore_resharded's last-writer-wins contract depends on).
    # Ranks come from the LOADED MANIFESTS, never a directory glob: an
    # unindexed hostps/p<K>/ left by some other incarnation is not part of
    # this checkpoint (its files were never CRC'd into any index) and must
    # not leak rows into the merge.
    saver_dirs = []
    for r in sorted(int(i.get("process", 0)) for i in indexes):
        d = os.path.join(hp_root, "p%d" % r)
        if os.path.isdir(d):
            saver_dirs.append(d)

    def _names_in(d):
        try:
            return {n[:-len(".sparse.meta")] for n in os.listdir(d)
                    if n.endswith(".sparse.meta")}
        except OSError:
            return set()

    if not resharded:
        # same topology: each rank restores exactly ITS OWN saver's tables
        hp_dir = os.path.join(hp_root, rng_key)
        per_table_dirs = {name: [hp_dir] for name in _names_in(hp_dir)}
    else:
        # elastic reshard: merge EVERY saver rank's shards; the table's
        # row_range (rules.hostps_row_range for sharded fleets, full for
        # replicas) decides which merged rows this rank keeps
        per_table_dirs = {}
        for d in saver_dirs:
            for name in _names_in(d):
                per_table_dirs.setdefault(name, []).append(d)
    uncovered = set(per_table_dirs) - {name for name, _ in tables}
    if uncovered:
        raise RuntimeError(
            "unified checkpoint %s holds HostPS tables %s but no live "
            "table/embedding with those names was offered for restore — "
            "create the HostPS embeddings (same names) before resuming"
            % (path, sorted(uncovered)))
    for name, h in tables:
        dirs = per_table_dirs.get(name)
        if not dirs:
            continue         # table created after the save: nothing to load
        if not resharded:
            if hasattr(h, "table"):
                h.restore(dirs[0], name)   # HostPSEmbedding retries inside
            else:
                _retry.io_retry(h.restore, dirs[0], name,
                                what="hostps restore",
                                surface="hostps_shard")
        elif hasattr(h, "table"):
            h.restore_resharded(dirs, name)
        else:
            _retry.io_retry(h.restore_resharded, dirs, name,
                            what="hostps resharded restore",
                            surface="hostps_shard")
