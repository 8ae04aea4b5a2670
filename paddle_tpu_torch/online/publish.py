"""DeltaPublisher: the train->serve delta-checkpoint chain (counterpart of
``paddle_tpu/online/publish.py``, over the port's ``parallel.checkpoint``
and ``io`` sparse shards).  The chain's files are the reference's byte
layout, so a chain written by either package resolves in the other.

Parity surface: the reference's online-learning publish loop — PSLib's
save_delta / save_base cadence, where a streaming trainer periodically
ships a model the serving fleet can load without stopping.  Here each
publish is a first-class checkpoint riding parallel/checkpoint.py's
staging/CRC/index/barrier/COMMIT protocol (``save_checkpoint`` with
``dirname="publish-<n>"``), so a publish is atomic, torn publishes are
invisible, and multi-rank savers barrier exactly like training saves.

Chain format (all under one publish directory):

  publish-<n>/shards-p<K>.npz     dense weights (FULL tree, every publish)
  publish-<n>/index-p<K>.json     per-rank layout manifest + file CRCs
  publish-<n>/manifest.json       version, kind (base|delta), base_version,
                                  train_step, cursor, train_wall (rank 0)
  publish-<n>/hostps/p<K>/        sparse rows: the WHOLE live table for a
                                  base, only rows TOUCHED since the last
                                  publish for a delta
                                  (table.py snapshot_delta)
  publish-<n>/COMMIT              written last; only committed versions
                                  exist as far as readers are concerned

Replay contract: dense state comes from the target publish alone (it is
complete every time — dense is small); sparse state is the newest base at
or below the target plus every delta after it, applied in version order,
last write wins.  Versions within a chain are contiguous: a quarantine
veto consumes no version number and a torn publish's corpse is GC'd (and
its number reused) by the next publisher incarnation.

Rollback gate: before snapshotting, the publisher scans the TrainSentinel
quarantine directory (monitor/sentinel.py ``ckpt-<step>-quarantine``
artifacts).  A committed quarantine inside the publish interval VETOES the
publish — a diverged model never reaches the serving chain.  The sentinel's
quarantine policy reverts and skips the poisoned batch, so later intervals
(whose state no longer derives from the divergence) publish normally.

A fresh publisher instance always starts with a BASE: touched-row state
does not survive a trainer restart, and a base re-anchors the chain so
replay never depends on rows a dead incarnation forgot to ship.
"""

import json
import os
import shutil
import time

import numpy as np

from ..ft import agree as _agree
from ..monitor import trace as _trace
from ..monitor import tracemesh as _tmesh
from ..parallel.checkpoint import restore_checkpoint, save_checkpoint

__all__ = ["DeltaPublisher", "committed_publishes", "latest_version",
           "resolve_chain", "load_chain_rows", "load_publish_rows"]

MANIFEST = "manifest.json"


def _emit(event, **payload):
    try:
        from .. import monitor as _monitor

        mon = _monitor.active()
        if mon is not None:
            mon.timeline.emit(event, **payload)
            mon.timeline.flush()
    except Exception:
        pass


def _stat_add(name, value=1, **labels):
    try:
        from ..monitor.registry import stat_add

        stat_add(name, value, **labels)
    except Exception:
        pass


def _gauge_set(name, value):
    try:
        from ..monitor.registry import default_registry

        default_registry().gauge(name).set(value)
    except Exception:
        pass


def committed_publishes(directory):
    """Sorted ``[(version, path, manifest)]`` of every COMMITTED publish.
    Uncommitted directories (a torn publish) and committed ones with an
    unreadable manifest are skipped — readers only ever see completed,
    self-describing versions."""
    out = []
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if not name.startswith("publish-"):
            continue
        path = os.path.join(directory, name)
        if not os.path.exists(os.path.join(path, "COMMIT")):
            continue
        try:
            version = int(name.split("-", 1)[1])
        except ValueError:
            continue
        try:
            with open(os.path.join(path, MANIFEST)) as f:
                man = json.load(f)
        except (OSError, ValueError):
            continue
        out.append((version, path, man))
    out.sort()
    return out


def latest_version(directory):
    """Newest committed version number, or None."""
    pubs = committed_publishes(directory)
    return pubs[-1][0] if pubs else None


def resolve_chain(directory, upto=None):
    """The replay chain for version ``upto`` (default: newest committed):
    ``[(version, path, manifest)]`` from the governing base through the
    target, contiguous and base-consistent (RuntimeError otherwise — a
    gapped or cross-base chain must never be half-applied).  None when
    nothing is committed at or below ``upto``."""
    pubs = committed_publishes(directory)
    if upto is not None:
        pubs = [p for p in pubs if p[0] <= int(upto)]
    if not pubs:
        return None
    base_i = None
    for i in range(len(pubs) - 1, -1, -1):
        if pubs[i][2].get("kind") == "base":
            base_i = i
            break
    if base_i is None:
        raise RuntimeError(
            "publish chain in %r has no committed base at or below "
            "version %s — deltas alone cannot be replayed"
            % (directory, pubs[-1][0]))
    chain = pubs[base_i:]
    base_v = chain[0][0]
    prev = None
    for v, _path, man in chain:
        if prev is not None and v != prev + 1:
            raise RuntimeError(
                "publish chain gap in %r: publish-%d follows publish-%d "
                "(replay would silently skip a delta)"
                % (directory, v, prev))
        if man.get("kind") == "delta" \
                and int(man.get("base_version", -1)) != base_v:
            raise RuntimeError(
                "publish-%d claims base %s but the chain's base is %d"
                % (v, man.get("base_version"), base_v))
        prev = v
    return chain


def load_publish_rows(path, name):
    """Merged sparse rows for table ``name`` from ONE publish directory:
    every saver rank's ``hostps/p<K>/`` shards, ascending rank, later rank
    wins on overlap (the same contract as table.restore_resharded).
    Returns ``(rows, arrays)`` or None when the publish holds no shards
    for the table."""
    from .. import io as _io

    root = os.path.join(path, "hostps")
    if not os.path.isdir(root):
        return None
    ranks = []
    for nm in os.listdir(root):
        if nm.startswith("p"):
            try:
                ranks.append(int(nm[1:]))
            except ValueError:
                continue
    rows_l, arrays_l = [], []
    for rank in sorted(ranks):
        sub = os.path.join(root, "p%d" % rank)
        try:
            _io.load_sparse_meta(sub, name)
        except (OSError, IOError):
            continue
        for rows, arrays in _io.load_sparse_shards(sub, name):
            if np.asarray(rows).size:
                rows_l.append(np.asarray(rows, np.int64))
                arrays_l.append({k: np.asarray(v)
                                 for k, v in arrays.items()})
    if not rows_l:
        return None
    return _merge_last_wins(rows_l, arrays_l)


def _merge_last_wins(rows_l, arrays_l):
    rows = np.concatenate(rows_l)
    keys = set(arrays_l[0])
    arrays = {k: np.concatenate([a[k] for a in arrays_l])
              for k in keys}
    # keep the LAST occurrence of each row id: np.unique over the
    # reversed ids yields first-occurrence-in-reverse == last-in-order
    uniq, idx = np.unique(rows[::-1], return_index=True)
    pick = (rows.size - 1) - idx
    return uniq, {k: v[pick] for k, v in arrays.items()}


def load_chain_rows(chain, name):
    """Replay a resolved chain's sparse rows for table ``name``: base rows
    first, then each delta in version order, last write wins.  Returns
    ``(rows, arrays)`` or None when no publish in the chain shipped the
    table."""
    rows_l, arrays_l = [], []
    for _v, path, _man in chain:
        got = load_publish_rows(path, name)
        if got is not None:
            rows_l.append(got[0])
            arrays_l.append(got[1])
    if not rows_l:
        return None
    return _merge_last_wins(rows_l, arrays_l)


def load_chain_dense(chain, template):
    """Dense state for a resolved chain: restored straight from the target
    publish (dense rides FULL in every publish).  ``template`` is a tree
    of numpy arrays or tensors naming what the caller wants back (a tensor
    leaf comes back on its device and dtype; extra leaves in the publish
    are ignored; missing ones KeyError loudly)."""
    state, _step = restore_checkpoint(chain[-1][1], template)
    return state


class DeltaPublisher(object):
    """Periodic base+delta publishes of (dense state, HostPS tables).

    directory:      the publish-chain directory (one per model).
    hostps:         HostPSEmbedding / HostSparseTable handles whose
                    touched rows ride each publish.
    quarantine_dir: the TrainSentinel quarantine directory to scan for the
                    rollback gate (None disables the veto).
    keep_bases:     retention — committed chains older than the newest N
                    bases are pruned after each new base (rank 0 only).
    """

    def __init__(self, directory, hostps=None, quarantine_dir=None,
                 keep_bases=2):
        self.directory = str(directory)
        self.hostps = list(hostps or [])
        self.quarantine_dir = quarantine_dir
        self.keep_bases = int(keep_bases)
        os.makedirs(self.directory, exist_ok=True)
        if _agree.fleet_rank() == 0:
            self.gc_corpses()
        pubs = committed_publishes(self.directory)
        self._next_version = (pubs[-1][0] + 1) if pubs else 1
        # a fresh incarnation always re-anchors with a base (see module
        # docstring); the veto window starts after whatever the previous
        # incarnation last shipped
        self._base_version = None
        self._veto_floor = int(pubs[-1][2].get("train_step", -1)) \
            if pubs else -1
        self.last_version = pubs[-1][0] if pubs else None

    # -- rollback gate ---------------------------------------------------
    def _quarantined_steps(self):
        qd = self.quarantine_dir
        if not qd or not os.path.isdir(qd):
            return []
        steps = []
        for name in os.listdir(qd):
            if not (name.startswith("ckpt-")
                    and name.endswith("-quarantine")):
                continue
            if not os.path.exists(os.path.join(qd, name, "COMMIT")):
                continue
            try:
                steps.append(int(name.split("-")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(steps)

    # -- corpse GC -------------------------------------------------------
    def gc_corpses(self):
        """Reclaim torn publishes: ``publish-*`` without COMMIT and
        stale ``.tmp-ckpt-*`` staging dirs in the publish directory.  The
        ckpt corpse GC deliberately ignores this namespace — the publisher
        owns it.  Runs at publisher construction (rank 0), i.e. after any
        crash and before the version number is chosen, so a corpse's
        number is reused by the re-anchoring base."""
        n = 0
        if not os.path.isdir(self.directory):
            return 0
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if not os.path.isdir(path):
                continue
            if name.startswith("publish-") \
                    and not os.path.exists(os.path.join(path, "COMMIT")):
                shutil.rmtree(path, ignore_errors=True)
                n += 1
            elif name.startswith(".tmp-ckpt-"):
                shutil.rmtree(path, ignore_errors=True)
                n += 1
        if n:
            _stat_add("online.publish.gc", n)
        return n

    # -- publish ---------------------------------------------------------
    def publish(self, state, step, cursor=None, train_wall=None):
        """Publish one version: the dense ``state`` pytree (full, every
        time) plus every attached table's touched rows (full live set for
        the incarnation's first publish — the base).  Returns the committed
        version number, or None when the quarantine gate vetoed.

        On any failure the touched-row flags are re-marked so the rows
        ride the NEXT publish instead of silently dropping out of the
        delta stream."""
        step = int(step)
        vetoed = [q for q in self._quarantined_steps()
                  if self._veto_floor < q <= step]
        if vetoed:
            # the publish interval contains a quarantined (diverged) step:
            # nothing from it may reach serving.  Advance the floor so the
            # NEXT interval (post-revert state) publishes normally.
            self._veto_floor = max(vetoed)
            _stat_add("online.publish.vetoed")
            _emit("publish_veto", train_step=step, quarantined=vetoed,
                  directory=self.directory)
            return None

        version = self._next_version
        kind = "base" if self._base_version is None else "delta"
        rank = _agree.fleet_rank()
        t0 = time.perf_counter()

        # the publish roots the cross-process online trace: its context
        # rides the MANIFEST, so the serving replica's verify/flip spans
        # (another process, another tracer) join the same trace id and
        # trace_merge shows publish->verify->flip as ONE connected chain
        tmctx = None
        sp = _trace.null_span()
        if _trace.active_tracer() is not None:
            tmctx, targs = _tmesh.link(_tmesh.current())
            targs["version"] = version
            targs["kind"] = kind
            sp = _trace.span("online.publish", **targs)
        with sp:
            deltas = []   # (name, rows, arrays, meta, table)
            for handle in self.hostps:
                table = getattr(handle, "table", handle)
                if kind == "base":
                    rows, arrays, meta = table.snapshot_base()
                else:
                    rows, arrays, meta = table.snapshot_delta()
                deltas.append((table.name, rows, arrays, meta, table))

            man = {"version": version, "kind": kind,
                   "base_version": self._base_version
                   if kind == "delta" else version,
                   "train_step": step,
                   "cursor": list(cursor) if cursor is not None else None,
                   "train_wall": float(train_wall if train_wall is not None
                                       else time.time()),
                   "published_wall": time.time(),
                   "saver_world": _agree.fleet_world(),
                   "tables": {name: int(rows.size)
                              for name, rows, _a, _m, _t in deltas}}
            if tmctx is not None:
                man["tctx"] = {"tid": tmctx[0], "sid": tmctx[1]}

            def extras(stage_dir):
                from .. import io as _io

                if rank == 0:
                    with open(os.path.join(stage_dir, MANIFEST), "w") as f:
                        json.dump(man, f, sort_keys=True)
                for name, rows, arrays, meta, _table in deltas:
                    sub = os.path.join(stage_dir, "hostps", "p%d" % rank)
                    os.makedirs(sub, exist_ok=True)
                    _io.save_sparse_shards(sub, name, rows, arrays,
                                           meta=meta)

            try:
                save_checkpoint(self.directory, {"dense": state},
                                step=version, asynchronous=False,
                                extras=extras,
                                dirname="publish-%d" % version)
            except BaseException:
                # the rows go back into the pending set — the next
                # (retried) publish must carry them or the stream tears
                for _name, rows, _arrays, _meta, table in deltas:
                    table.mark_rows_touched(rows)
                raise

            if self._base_version is None:
                self._base_version = version
            self._next_version = version + 1
            self._veto_floor = step
            self.last_version = version
            publish_ms = (time.perf_counter() - t0) * 1e3
            _stat_add("online.publish.count", kind=kind)
            _gauge_set("online.version", version)
            _gauge_set("online.train_wall", man["train_wall"])
            _emit("publish", version=version, kind=kind, train_step=step,
                  publish_ms=round(publish_ms, 3),
                  rows={n: int(r.size) for n, r, _a, _m, _t in deltas})
        if kind == "base" and rank == 0:
            self.prune()
        return version

    def prune(self):
        """Retention: keep the newest ``keep_bases`` chains (a chain =
        a base plus its deltas); everything older is removed."""
        if self.keep_bases <= 0:
            return
        pubs = committed_publishes(self.directory)
        bases = [v for v, _p, m in pubs if m.get("kind") == "base"]
        if len(bases) <= self.keep_bases:
            return
        floor = sorted(bases)[-self.keep_bases]
        for v, path, _man in pubs:
            if v < floor:
                shutil.rmtree(path, ignore_errors=True)
