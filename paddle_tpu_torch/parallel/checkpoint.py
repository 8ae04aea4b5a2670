"""Sharded + async checkpointing of training state pytrees.

Parity surface: the reference's save/load op family
(framework/save_load_util.cc, operators/save_combine_op.cc;
python/paddle/fluid/io.py:523 save_persistables) and the `checkpoint_notify`
PS snapshot (operators/distributed_ops/checkpoint_notify_op.cc); the
counterpart of ``paddle_tpu/parallel/checkpoint.py``, with its on-disk
format.  The reference serializes whole tensors from one process; here the
state is a tree of torch tensors (nested dicts and lists) of which each
rank holds only its own block (dp/tp/pp splits, ZeRO optimizer shards —
parallel/zero.py), so the checkpoint is written the orbax/tensorstore way:

- every process writes ONE data file holding exactly its replica-0 blocks
  (no gather, no duplicated replicas), plus a per-process index of which
  slices of each GLOBAL leaf those blocks cover;
- restore assembles leaves from whichever files cover them and slices this
  rank's block for the current placement;
- the async path copies the tensors to host memory before
  ``save_checkpoint`` returns, then does file IO on a background thread so
  the train loop keeps stepping (the "checkpoint_notify"-style
  non-blocking snapshot).

Where the JAX leaf knows its sharding, a port leaf is only this rank's
block, so the layout comes from outside it: ``specs=`` (a tree of
``rules.PartitionSpec`` matching the state) with ``mesh=`` (``mesh.py``),
or ``authority=`` (a ``rules.ShardingAuthority`` with a mesh), give each
block's global shape and absolute slice (``train._spec_axes`` /
``train._local_slice``); a ``LocalBlock`` leaf carries its own.  With none
of them a leaf is whole — the one-rank case, and what every process of a
launcher fleet writes for a plain tensor or array (the reference's numpy
leaves).  A leaf replicated over a mesh axis is written only by the rank
at coordinate 0 of every axis its spec does not name (the reference keeps
``replica_id == 0``).  bfloat16, which numpy lacks, is stored as its 2-byte
bit pattern with ``dtype: "bfloat16"`` in the manifest; restore also reads
the ``|V2`` arrays the JAX package writes for an ``ml_dtypes`` bfloat16
leaf.

Durability protocol (the preemption-safe commit discipline ft/ builds on):

- every per-process file is STAGED in a hidden tmpdir
  (``<dir>/.tmp-ckpt-<step>-p<K>/``) and published into ``ckpt-<step>/``
  with ``os.replace`` — an atomic rename, so the visible directory never
  holds a half-written file;
- the per-process index records a CRC32 for every staged file; restore
  verifies before trusting bytes (bit rot / torn NFS writes fail loudly);
- ``COMMIT`` is written LAST, by process 0, after a shared-filesystem
  barrier on every process's index (budget:
  ``PADDLE_TPU_CKPT_BARRIER_SECS``, default 120) — ``latest_checkpoint``
  only ever returns committed directories, so a crash at ANY earlier point
  leaves the previous checkpoint as latest;
- uncommitted ``ckpt-*`` corpses (a mid-write crash's leftovers) are GC'd
  at the start of the next save, and ``keep=N`` retention prunes old
  committed checkpoints after each successful COMMIT.  Both GCs are
  RANK-0-ONLY (concurrent savers must never delete each other's staged
  files); staging-dir corpses are per-rank (each rank reclaims only its own
  ``.tmp-ckpt-*-p<K>``), and in a multi-rank fleet uncommitted directories
  younger than the barrier budget are left alone — they may be a peer's
  in-flight save at a skewed step, not a corpse;
- a COMMIT-barrier timeout (a genuinely lost rank) DEGRADES instead of
  wedging the job: rank 0 logs which ranks went missing and the step each
  rank staged (boundary-skew diagnostics), bumps ``ft.barrier.timeouts``,
  emits a ``fleet_lost`` timeline event, removes the uncommitted directory
  immediately (no corpse for the next save to trip over), and raises
  ``BarrierTimeout`` — the previous committed checkpoint remains
  authoritative;
- file writes go through ft/retry.py's jittered backoff (transient
  filesystem errors are absorbed and counted, never fatal on first touch),
  and the ``ckpt_commit`` chaos point (ft/chaos.py) fires between shard
  publish and COMMIT — exactly the torn-checkpoint window drills must hit.

Layout of a checkpoint directory:
  <dir>/ckpt-<step>/index-p<K>.json   per-process shard index (+ file CRCs)
  <dir>/ckpt-<step>/shards-p<K>.npz   per-process shard data
  <dir>/ckpt-<step>/...               extra files (ft/ckpt.py: hostps/ etc.)
  <dir>/ckpt-<step>/COMMIT            written last: marks the ckpt complete
"""

import json
import os
import shutil
import threading
import time
import zlib

import numpy as np
import torch

from ..ft import agree as _agree
from ..ft import chaos as _chaos
from ..ft import retry as _retry
from ..monitor import trace as _trace


def _phase_add(name, ms):
    """FleetScope phase attribution (monitor/fleetscope.py taxonomy):
    checkpoint staging cost lands in ``ckpt``, the COMMIT shard-barrier
    poll in ``barrier_wait`` — THE multi-host skew signal.  One global read
    when no session is active."""
    from ..monitor.session import phase_add

    phase_add(name, ms)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_checkpoint",
           "CheckpointWriter", "verify_checkpoint_files", "barrier_secs",
           "BarrierTimeout", "checkpoint_topology", "LocalBlock",
           "written_nbytes"]


class BarrierTimeout(TimeoutError):
    """The COMMIT barrier expired: some rank never published its index.
    The checkpoint did NOT commit; the previous committed one is still
    latest.  Callers on a degradation path (the preemption guard, cadence
    saves) catch THIS — a real TimeoutError from elsewhere still crashes."""


def barrier_secs():
    """COMMIT-barrier budget: how long process 0 waits for every process's
    index before declaring the checkpoint torn
    (``PADDLE_TPU_CKPT_BARRIER_SECS``, default 120)."""
    try:
        return float(os.environ.get("PADDLE_TPU_CKPT_BARRIER_SECS", "120"))
    except ValueError:
        return 120.0


def _leaf_paths(tree):
    """Flatten with '/'-joined string paths (stable leaf addressing) — the
    SAME addressing the sharding rules match against (parallel/rules.py
    leaf_paths is the single definition), so a partition rule written for a
    param also names its checkpoint manifest entry."""
    from . import rules as _rules

    return _rules.leaf_paths(tree)


def _index_crc(index):
    """CRC32 of the manifest's canonical JSON (sans the crc field itself).
    The shard FILES were already CRC-covered; this covers the LAYOUT — a
    torn or bit-rotted index would otherwise reassemble leaves from wrong
    slices silently, which for a topology-portable checkpoint (the index
    is the re-sharder's only source of truth) is corruption, not noise."""
    scrubbed = {k: v for k, v in index.items() if k != "index_crc"}
    blob = json.dumps(scrubbed, sort_keys=True).encode("utf-8")
    return zlib.crc32(blob) & 0xFFFFFFFF


class LocalBlock:
    """A leaf given as this rank's block of a global leaf: ``data`` (a
    tensor or array), the global ``shape``, the absolute ``slices``
    (``[[start, stop], ...]`` a dim) and ``write`` — whether this rank is
    the replica that writes the block (False: another rank holds the same
    slice).  On restore a ``LocalBlock`` target receives its slice of the
    reassembled leaf, on ``data``'s device and dtype."""

    def __init__(self, data, shape, slices, write=True):
        self.data = data
        self.shape = tuple(int(d) for d in shape)
        self.slices = [[int(a), int(b)] for a, b in slices]
        self.write = bool(write)

    def __repr__(self):
        return "LocalBlock(shape=%s, slices=%s, write=%s)" % (
            self.shape, self.slices, self.write)


def _dtype_name(leaf):
    """The manifest's dtype string: numpy's name, ``bfloat16`` for a bf16
    tensor."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16"
        return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _host_copy(x):
    """A host copy of ``x`` that the caller's later in-place updates cannot
    reach: a tensor copied to host memory synchronously (the copy waits for
    the work queued before it on the current stream, so no update in
    flight is half-seen), a bf16 tensor as its int16 bit pattern, an array
    or a scalar copied."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.to("cpu", copy=True).contiguous().numpy()
    return np.array(x, copy=True)


def _spec_placement(shape, spec, mesh):
    """(global shape, absolute slices, write) of this rank's block of shape
    ``shape`` under ``spec`` on ``mesh`` — the inverse of
    ``train._local_slice``, which cuts a dim over its axes in order."""
    from .train import _spec_axes

    shape = [int(d) for d in shape]
    named = {a for _, a in _spec_axes(spec)}
    glob = list(shape)
    by_dim = {}
    for d, a in _spec_axes(spec):
        n = mesh.shape[a]
        if n > 1:
            glob[d] *= n
            by_dim.setdefault(d, []).append(a)
    slices = [[0, g] for g in glob]
    for d, axes in by_dim.items():
        size, start = glob[d], 0
        for a in axes:
            size //= mesh.shape[a]
            start += mesh.coords[a] * size
        slices[d] = [start, start + size]
    write = all(mesh.coords[a] == 0 for a, n in mesh.shape.items()
                if n > 1 and a not in named)
    return glob, slices, write


def _leaf_specs(paths, leaves, specs, mesh, authority):
    """One (spec, mesh) per leaf, or None per leaf when the layout is
    whole."""
    if authority is not None:
        m = authority._require_mesh()
        return [(authority.spec(p, v), m) for p, v in zip(paths, leaves)]
    if specs is None:
        return [None] * len(paths)
    if mesh is None:
        raise ValueError("specs= needs mesh=")
    spaths, sleaves, _ = _leaf_paths(specs)
    by_path = dict(zip(spaths, sleaves))
    missing = [p for p in paths if p not in by_path]
    if missing:
        raise KeyError("specs do not cover leaves %s" % missing[:8])
    return [(by_path[p], mesh) for p in paths]


def written_nbytes(state, specs=None, mesh=None, authority=None):
    """Bytes of ``state`` that this process writes under the placement
    ``save_checkpoint`` would use (replicas another rank writes excluded)."""
    paths, leaves, _ = _leaf_paths(state)
    total = 0
    for leaf, placement in zip(leaves, _leaf_specs(paths, leaves, specs,
                                                   mesh, authority)):
        if isinstance(leaf, LocalBlock):
            if not leaf.write:
                continue
            leaf = leaf.data
        elif placement is not None and not _spec_placement(
                getattr(leaf, "shape", np.shape(leaf)), *placement)[2]:
            continue
        total += (leaf.numel() * leaf.element_size()
                  if isinstance(leaf, torch.Tensor)
                  else int(np.asarray(leaf).nbytes))
    return total


def _collect_local_shards(leaf, placement=None):
    """(global shape, dtype, [(slice_json, np_array)]) of this process's
    unique shards of a leaf: none when another replica writes it."""
    if isinstance(leaf, LocalBlock):
        shards = [(leaf.slices, _host_copy(leaf.data))] if leaf.write else []
        return list(leaf.shape), _dtype_name(leaf.data), shards
    dtype = _dtype_name(leaf)
    shape = [int(d) for d in getattr(leaf, "shape", np.shape(leaf))]
    if placement is None:
        return shape, dtype, [([[0, d] for d in shape], _host_copy(leaf))]
    glob, slices, write = _spec_placement(shape, *placement)
    return glob, dtype, ([(slices, _host_copy(leaf))] if write else [])


def _crc32_file(path, chunk=1 << 22):
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                return crc & 0xFFFFFFFF
            crc = zlib.crc32(buf, crc)


# async saves currently staging/publishing: their step numbers must never be
# GC'd as corpses by a save that starts while they are in flight
_IN_FLIGHT = set()
_IN_FLIGHT_LOCK = threading.Lock()


def _gc_stale_stages(directory, proc, current_step):
    """Per-rank staging-corpse GC: every rank reclaims ONLY its own
    ``.tmp-ckpt-<step>-p<proc>`` leftovers (a peer's tmpdir at a different
    step may be that rank's save in flight — deleting it would tear a
    checkpoint mid-publish)."""
    with _IN_FLIGHT_LOCK:
        live = set(_IN_FLIGHT) | {current_step}
    suffix = "-p%d" % proc
    for name in os.listdir(directory):
        if not (name.startswith(".tmp-ckpt-") and name.endswith(suffix)):
            continue
        try:
            step = int(name.split("-")[2])
        except (IndexError, ValueError):
            step = None
        if step not in live:
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)


def _gc_uncommitted(directory, current_step, nproc):
    """Rank-0-only: remove uncommitted ``ckpt-*`` corpse directories,
    excluding the save in progress, any other in-flight async save, and —
    in a multi-rank fleet — any directory younger than the barrier budget
    (a peer preempted one boundary away may be publishing into a skewed
    ``ckpt-<step>`` RIGHT NOW; only an untouched-for-a-full-barrier dir is
    provably a corpse)."""
    with _IN_FLIGHT_LOCK:
        live = set(_IN_FLIGHT) | {current_step}
    now = time.time()
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        if not (name.startswith("ckpt-") and os.path.isdir(path)):
            continue
        try:
            step = int(name.split("-", 1)[1])
        except ValueError:
            continue
        if step in live or os.path.exists(os.path.join(path, "COMMIT")):
            continue
        if nproc > 1:
            try:
                age = now - os.path.getmtime(path)
            except OSError:
                continue
            if age < barrier_secs():
                continue
        shutil.rmtree(path, ignore_errors=True)


def _apply_retention(directory, keep):
    """Keep only the newest `keep` COMMITTED checkpoints.  Rank-0-only (it
    runs after COMMIT, inside the proc-0 branch): concurrent per-rank
    retention passes could each see a different committed set mid-save and
    delete a checkpoint a peer still counts as retained."""
    if not keep or keep <= 0:
        return
    committed = []
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        if not (name.startswith("ckpt-")
                and os.path.exists(os.path.join(path, "COMMIT"))):
            continue
        try:
            committed.append((int(name.split("-", 1)[1]), path))
        except ValueError:
            continue
    committed.sort()
    for _, path in committed[:-keep]:
        shutil.rmtree(path, ignore_errors=True)


def _purge_stale_topology(ckdir, nproc):
    """Before publishing into a ckpt dir, remove every per-rank artifact a
    PREVIOUS (larger) fleet incarnation left there for ranks the current
    world does not have: ``index-p<K>.json``, ``shards-p<K>.npz`` and the
    ``hostps/p<K>/`` sparse-shard subtree for K >= nproc.

    Without this, an elastic shrink can permanently wedge or corrupt a
    step: a pre-shrink peer that published into an uncommitted
    ``ckpt-<S>`` and died (too young for corpse GC) leaves files no
    current rank will ever overwrite; when the shrunken fleet later SAVES
    at the same step S, its COMMIT would ride along with the stale index
    (every later ``_load_indexes`` then rejects the checkpoint: index
    count != process_count) and the stale hostps shards (unindexed, so
    never CRC-checked).  Restricted to ranks BEYOND the current world so
    it can never race a live peer's publish: current ranks only ever
    write ``p<K<nproc>`` and overwrite their own stale files via
    ``os.replace``; a stale SAME-rank index from a different world is
    instead ignored by the COMMIT barrier (process_count filter) until
    its owner republishes.  Concurrent sweepers are harmless (missing
    files skip)."""
    victims = set()
    try:
        for name in os.listdir(ckdir):
            for prefix, suffix in (("index-p", ".json"),
                                   ("shards-p", ".npz")):
                if name.startswith(prefix) and name.endswith(suffix):
                    try:
                        rank = int(name[len(prefix):-len(suffix)])
                    except ValueError:
                        break
                    if rank >= nproc:
                        victims.add(rank)
                    break
    except OSError:
        return
    hp_root = os.path.join(ckdir, "hostps")
    try:
        for name in os.listdir(hp_root):
            if name.startswith("p"):
                try:
                    rank = int(name[1:])
                except ValueError:
                    continue
                if rank >= nproc:
                    victims.add(rank)
    except OSError:
        pass
    for rank in victims:
        for victim in ("index-p%d.json" % rank, "shards-p%d.npz" % rank):
            try:
                os.remove(os.path.join(ckdir, victim))
            except OSError:
                pass
        shutil.rmtree(os.path.join(hp_root, "p%d" % rank),
                      ignore_errors=True)


def _staged_steps_by_rank(directory):
    """{rank: sorted steps} of everything each rank has staged or published
    without a COMMIT — the boundary-skew evidence a barrier timeout logs
    (two ranks one boundary apart show up here as {0: [10], 1: [11]})."""
    staged = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return staged
    for name in names:
        path = os.path.join(directory, name)
        if name.startswith(".tmp-ckpt-"):
            parts = name[len(".tmp-ckpt-"):].rsplit("-p", 1)
            try:
                staged.setdefault(int(parts[1]), set()).add(int(parts[0]))
            except (IndexError, ValueError):
                continue
        elif name.startswith("ckpt-") and os.path.isdir(path) \
                and not os.path.exists(os.path.join(path, "COMMIT")):
            try:
                step = int(name.split("-", 1)[1])
            except ValueError:
                continue
            for sub in os.listdir(path):
                if sub.startswith("index-p") and sub.endswith(".json"):
                    try:
                        staged.setdefault(
                            int(sub[len("index-p"):-len(".json")]),
                            set()).add(step)
                    except ValueError:
                        continue
    return {r: sorted(s) for r, s in sorted(staged.items())}


def _staged_worlds(ckdir):
    """{rank: process_count} each already-published index in the torn dir
    believes the fleet is — a mismatch against the current world is the
    ELASTIC skew diagnosis (a peer from a pre-shrink/pre-grow incarnation
    staged into this directory)."""
    worlds = {}
    try:
        names = os.listdir(ckdir)
    except OSError:
        return worlds
    for name in names:
        if not (name.startswith("index-p") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(ckdir, name)) as f:
                idx = json.load(f)
            worlds[int(idx["process"])] = int(idx["process_count"])
        except (OSError, ValueError, KeyError):
            continue
    return worlds


def _barrier_timeout(directory, ckdir, step, present, nproc):
    """The COMMIT barrier expired: degrade instead of wedging.  Count it,
    surface the EXPECTED vs OBSERVED world size, name the missing ranks
    and the step every rank staged (the skew diagnosis — boundary skew AND
    topology skew, a stale-world peer's index), emit ``fleet_lost``,
    reclaim the uncommitted directory immediately, and raise
    BarrierTimeout — the previous committed checkpoint stays
    authoritative."""
    import sys

    missing = sorted(set(range(nproc)) - set(present))
    staged = _staged_steps_by_rank(directory)
    worlds = _staged_worlds(ckdir)
    skewed_worlds = {r: w for r, w in worlds.items() if w != nproc}
    msg = ("checkpoint COMMIT barrier: expected world size %d, observed %d "
           "rank index(es) %s in %s after %.0fs "
           "(PADDLE_TPU_CKPT_BARRIER_SECS); MISSING ranks %s; staged steps "
           "by rank: %s%s — previous committed checkpoint remains latest"
           % (nproc, len(present), sorted(present), ckdir, barrier_secs(),
              missing, staged,
              "; TOPOLOGY SKEW — staged indexes from a different world "
              "size: %s" % skewed_worlds if skewed_worlds else ""))
    try:
        from ..monitor.registry import stat_add

        stat_add("ft.barrier.timeouts")
    except Exception:
        pass
    try:
        from .. import monitor as _monitor

        mon = _monitor.active()
        if mon is not None:
            ev = {"ranks": missing, "reason": "ckpt_barrier",
                  "step": int(step), "expected_world": int(nproc),
                  "observed_world": len(present), "missing": missing,
                  "staged": {str(r): s for r, s in staged.items()}}
            if skewed_worlds:
                ev["staged_worlds"] = {str(r): w
                                       for r, w in skewed_worlds.items()}
            mon.timeline.emit("fleet_lost", **ev)
            mon.timeline.flush()
    except Exception:
        pass
    sys.stderr.write("[ckpt] %s\n" % msg)
    shutil.rmtree(ckdir, ignore_errors=True)
    raise BarrierTimeout(msg)


class CheckpointWriter:
    """Handle for an in-flight (possibly async) checkpoint write."""

    def __init__(self, thread=None):
        self._thread = thread
        self._error = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            raise self._error
        return self


def save_checkpoint(directory, state, step=0, asynchronous=False, keep=None,
                    extras=None, tag=None, dirname=None, specs=None, mesh=None,
                    authority=None):
    """Write `state` (a tree of tensors / numpy / ``LocalBlock``) as
    ckpt-<step>.

    Returns a CheckpointWriter; call .wait() to block until the files are
    durable (the synchronous path has already waited).  Device->host copies
    happen before this returns either way — the async part is only file IO,
    so the caller may immediately keep mutating (updating in place) the
    live state.

    specs/mesh, authority: the placement of each leaf (module docstring);
    none of them: every leaf is whole.

    keep: prune committed checkpoints beyond the newest N after COMMIT.
    extras: ``callable(stage_dir)`` run in the writer BEFORE publish/COMMIT —
    extra files it stages (e.g. ft/ckpt.py's HostPS sparse shards) are CRC'd
    into this process's index and ride the same commit protocol.
    tag: commit as ``ckpt-<step>-<tag>`` instead — a DEBUG artifact (the
    sentinel's quarantine dumps) riding the same shard/COMMIT/CRC protocol
    but invisible to ``latest_checkpoint``, retention, and the corpse GC
    (their step parse skips non-numeric suffixes), so resume never picks
    one up and retention never reaps the evidence.
    dirname: publish into ``<directory>/<dirname>`` VERBATIM instead of the
    ``ckpt-<step>`` naming — the online DeltaPublisher's ``publish-<n>``
    chain rides the identical staging/CRC/barrier/COMMIT protocol while
    staying invisible to ``latest_checkpoint``, retention, and the ckpt
    corpse GC (all three match only ``ckpt-*`` names; the OWNER of such a
    directory owns its corpse GC).  Must be a single path component that
    does not collide with the ``ckpt-``/``.tmp-ckpt-``/``COMMIT``
    namespaces.  Overrides ``tag``.
    """
    # fleet identity: the launcher's PADDLE_TRAINER_* contract — the
    # shard/COMMIT barrier sees every process sharing the directory
    proc = _agree.fleet_rank()
    t_prep = time.perf_counter()
    os.makedirs(directory, exist_ok=True)
    suffix = "-%s" % tag if tag else ""
    if dirname is not None:
        if (os.path.basename(dirname) != dirname or not dirname
                or dirname.startswith((".", "ckpt-", "COMMIT"))):
            raise ValueError(
                "save_checkpoint dirname=%r must be a plain directory name "
                "outside the ckpt-*/.tmp-* namespaces" % (dirname,))
        suffix = "-%s" % dirname
        ckdir = os.path.join(directory, dirname)
    else:
        ckdir = os.path.join(directory, "ckpt-%d%s" % (step, suffix))
    stage = os.path.join(directory,
                         ".tmp-ckpt-%d%s-p%d" % (step, suffix, proc))

    paths, leaves, _ = _leaf_paths(state)
    placements = _leaf_specs(paths, leaves, specs, mesh, authority)
    # "layout": the manifest revision.  2 = topology-portable: every leaf
    # records its GLOBAL shape + the slice each shard holds, and the index
    # itself is CRC-covered — a resumer at ANY world size reassembles
    # leaves from these manifests and re-slices for its own mesh.
    index = {"step": int(step), "process": proc,
             "process_count": _agree.fleet_world(), "layout": 2,
             "leaves": {}}
    payload = {}
    for path, leaf, placement in zip(paths, leaves, placements):
        shape, dtype, shards = _collect_local_shards(leaf, placement)
        entries = []
        for si, (sl_json, arr) in enumerate(shards):
            key = "%s@%d" % (path, si)
            payload[key] = arr
            entries.append({"key": key, "slices": sl_json})
        index["leaves"][path] = {"shape": shape, "dtype": dtype,
                                 "shards": entries}

    nproc = _agree.fleet_world()
    with _IN_FLIGHT_LOCK:
        _IN_FLIGHT.add(step)

    def _write():
        t_w0 = time.perf_counter()
        barrier_ms = 0.0
        try:
            _gc_stale_stages(directory, proc, step)
            if proc == 0:
                _gc_uncommitted(directory, step, nproc)
            shutil.rmtree(stage, ignore_errors=True)
            os.makedirs(stage, exist_ok=True)

            shards_name = "shards-p%d.npz" % proc

            def _write_shards():
                with open(os.path.join(stage, shards_name), "wb") as f:
                    np.savez(f, **payload)

            _retry.io_retry(_write_shards, what="ckpt shards",
                            surface="ckpt_io")
            if extras is not None:
                extras(stage)
            # CRC every staged file into the index — restore refuses bytes
            # that don't match (the save_load_util version-header check,
            # upgraded to content integrity)
            files = {}
            for root, _dirs, names in os.walk(stage):
                for name in names:
                    full = os.path.join(root, name)
                    rel = os.path.relpath(full, stage)
                    files[rel] = _crc32_file(full)
            index["files"] = files
            index["index_crc"] = _index_crc(index)
            index_name = "index-p%d.json" % proc

            def _write_index():
                with open(os.path.join(stage, index_name), "w") as f:
                    json.dump(index, f)

            _retry.io_retry(_write_index, what="ckpt index",
                            surface="ckpt_io")

            # publish: atomic per-file rename out of the staging dir; the
            # index goes LAST so a crash mid-publish never leaves an index
            # that references unpublished files
            os.makedirs(ckdir, exist_ok=True)
            # elastic hygiene: a pre-shrink incarnation's indexes must not
            # ride into THIS world's COMMIT (see _purge_stale_topology)
            _purge_stale_topology(ckdir, nproc)
            publish = sorted(files) + [index_name]
            for rel in publish:
                dst = os.path.join(ckdir, rel)
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                _retry.io_retry(os.replace, os.path.join(stage, rel), dst,
                                what="ckpt publish", surface="ckpt_io")
            shutil.rmtree(stage, ignore_errors=True)

            # COMMIT is written by process 0 only after EVERY process's index
            # is visible (shared-filesystem barrier) — a ckpt must never be
            # marked complete while shards are missing
            if proc == 0:
                deadline = time.time() + barrier_secs()
                # an index only counts toward the barrier if it was
                # written BY THIS WORLD: a stale same-rank index from a
                # pre-resize incarnation (process_count mismatch) must
                # not let a mixed-topology checkpoint COMMIT — its
                # owner's fresh publish overwrites it, and until then
                # that rank simply isn't here yet.  Once confirmed, a
                # rank stays confirmed (publish is an atomic os.replace
                # and no writer regresses within one save), so each
                # index is parsed at most once across the poll loop.
                present = set()
                t_bar = time.perf_counter()
                try:
                    with _trace.span("ckpt.barrier_wait", step=step,
                                     world=nproc):
                        while True:
                            for k in range(nproc):
                                if k in present:
                                    continue
                                ipath = os.path.join(
                                    ckdir, "index-p%d.json" % k)
                                try:
                                    with open(ipath) as f:
                                        if int(json.load(f).get(
                                                "process_count",
                                                -1)) == nproc:
                                            present.add(k)
                                except (OSError, ValueError):
                                    continue   # absent or mid-replace
                            if len(present) == nproc:
                                break
                            if time.time() > deadline:
                                _barrier_timeout(directory, ckdir, step,
                                                 sorted(present), nproc)
                            time.sleep(0.2)
                finally:
                    # the timeout path pays the FULL budget — exactly the
                    # wait the fleet attribution must see
                    barrier_ms = (time.perf_counter() - t_bar) * 1e3
                    _phase_add("barrier_wait", barrier_ms)
                _chaos.maybe_fire("ckpt_commit")
                if dirname is not None:
                    # the online drill's mid-publish SIGKILL window: shards
                    # are visible, COMMIT is not — exactly the corpse the
                    # publisher's own GC must reclaim.  Gated on dirname so
                    # hit counting tracks PUBLISHES, not every ckpt save.
                    _chaos.maybe_fire("publish_kill")

                def _write_commit():
                    tmp = os.path.join(ckdir, "COMMIT.tmp")
                    with open(tmp, "w") as f:
                        f.write("%d" % step)
                    os.replace(tmp, os.path.join(ckdir, "COMMIT"))

                _retry.io_retry(_write_commit, what="ckpt commit",
                            surface="ckpt_io")
                _apply_retention(directory, keep)
        except BaseException as e:  # surfaced on wait()
            # a failed save's staging dir is junk NOW — reclaiming it here
            # (not at the next save's corpse GC) keeps the directory clean
            # for the resume scan and makes drill assertions deterministic
            shutil.rmtree(stage, ignore_errors=True)
            writer._error = e
        finally:
            # staging/publish cost, barrier wait carved out into its own
            # phase above (a failed save still consumed the time)
            _phase_add("ckpt", max(
                (time.perf_counter() - t_w0) * 1e3 - barrier_ms, 0.0))
            with _IN_FLIGHT_LOCK:
                _IN_FLIGHT.discard(step)

    _phase_add("ckpt", (time.perf_counter() - t_prep) * 1e3)
    writer = CheckpointWriter()
    if asynchronous:
        t = threading.Thread(target=_write, daemon=True,
                             name="ckpt-writer-%d" % step)
        writer._thread = t
        t.start()
    else:
        _write()
        writer.wait()   # sync path: surface IO errors immediately
    return writer


def latest_checkpoint(directory):
    """Highest committed ckpt-<step> path, or None."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        if not name.startswith("ckpt-"):
            continue
        path = os.path.join(directory, name)
        if not os.path.exists(os.path.join(path, "COMMIT")):
            continue
        try:
            s = int(name.split("-", 1)[1])
        except ValueError:
            continue
        if s > best_step:
            best, best_step = path, s
    return best


def _load_indexes(ckpt_path):
    indexes = []
    for name in sorted(os.listdir(ckpt_path)):
        if name.startswith("index-p") and name.endswith(".json"):
            with open(os.path.join(ckpt_path, name)) as f:
                idx = json.load(f)
            # layout-manifest integrity: the index IS the re-sharder's map
            # of which bytes land where — refuse a corrupt one outright
            # (pre-CRC manifests, no "index_crc", verify vacuously)
            want = idx.get("index_crc")
            if want is not None and _index_crc(idx) != int(want):
                raise RuntimeError(
                    "corrupt checkpoint %s: layout manifest %r fails its "
                    "CRC (expected %08x, got %08x)"
                    % (ckpt_path, name, int(want), _index_crc(idx)))
            indexes.append(idx)
    if not indexes:
        raise FileNotFoundError("no index files in %s" % ckpt_path)
    expect = indexes[0]["process_count"]
    if len(indexes) != expect:
        raise RuntimeError(
            "incomplete checkpoint: %d of %d process indexes present"
            % (len(indexes), expect))
    return indexes


def checkpoint_topology(ckpt_path, indexes=None):
    """The SAVER's topology, straight from the layout manifests:
    ``{"world": N, "ranks": [...], "step": s, "layout": v}``.  What the
    elastic re-sharder (ft/ckpt.py) compares against the CURRENT fleet to
    decide whether a resume must repartition.  ``indexes``: pass manifests
    already loaded via ``_load_indexes`` to skip re-reading them."""
    if indexes is None:
        indexes = _load_indexes(ckpt_path)
    return {
        "world": int(indexes[0].get("process_count", 1)),
        "ranks": sorted(int(i.get("process", 0)) for i in indexes),
        "step": int(indexes[0].get("step", 0)),
        "layout": int(indexes[0].get("layout", 1)),
    }


def verify_checkpoint_files(ckpt_path, only=None):
    """Recompute the CRC32 of every file recorded in the per-process
    indexes (optionally restricted to relpaths for which ``only(rel)`` is
    true) and raise RuntimeError naming the first corrupt one.  Pre-CRC
    checkpoints (no "files" map) verify vacuously."""
    for idx in _load_indexes(ckpt_path):
        for rel, crc in (idx.get("files") or {}).items():
            if only is not None and not only(rel):
                continue
            full = os.path.join(ckpt_path, rel)
            if not os.path.exists(full):
                raise RuntimeError(
                    "corrupt checkpoint %s: indexed file %r is missing"
                    % (ckpt_path, rel))
            got = _crc32_file(full)
            if got != int(crc):
                raise RuntimeError(
                    "corrupt checkpoint %s: CRC mismatch for %r "
                    "(expected %08x, got %08x)"
                    % (ckpt_path, rel, int(crc), got))
    return True


def _bits16(arr):
    """A stored bfloat16 block as uint16 bits: the port's int16 pattern or
    the ``|V2`` array the JAX package's ``ml_dtypes`` leaf becomes."""
    arr = np.asarray(arr)
    if arr.dtype.itemsize != 2:
        raise RuntimeError("a bfloat16 block stored as %s" % arr.dtype)
    return arr.view(np.uint16)


def _as_leaf(arr, bf16, like):
    """A restored numpy block as the target leaf's kind: a tensor on
    ``like``'s device and dtype when ``like`` is a tensor; else numpy (a
    bfloat16 leaf as a CPU bfloat16 tensor, numpy having none)."""
    if not bf16 and not isinstance(like, torch.Tensor):
        return arr
    # a C-ordered copy that keeps a 0-d leaf 0-d (ascontiguousarray would
    # make it 1-d)
    t = torch.from_numpy(np.array(arr, order="C", copy=True))
    if bf16:
        t = t.view(torch.int16).view(torch.bfloat16)
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


def restore_checkpoint(ckpt_path, target, verify=True, authority=None,
                       indexes=None, specs=None, mesh=None):
    """Restore a ckpt-<step> directory into the structure of `target`.

    THE RE-SHARDER: each leaf is reassembled into its GLOBAL array from
    whichever saver processes' manifests cover it (any saver topology —
    the slices in the layout manifest are absolute coordinates), then
    re-sliced for the CURRENT placement.  Save on N processes, restore on
    M: the saved layout never constrains the restored one.

    target: a tree matching the saved structure.  A tensor leaf comes back
    on its device and dtype; a ``LocalBlock`` leaf as its slice of the
    global leaf on its ``data``'s device and dtype; other leaves as numpy
    (a bfloat16 one as a CPU bfloat16 tensor).  Returns (state, step).

    specs/mesh, authority: the CURRENT placement (a tree of PartitionSpec
    matching the target with a mesh, or a rules.ShardingAuthority with a
    mesh, whose rule tree derives each leaf's spec by its path): each leaf
    comes back as this rank's block under its spec.  With neither, leaves
    come back whole (a ``LocalBlock`` target names its own block).

    verify: recompute each shard file's CRC32 against the index before
    trusting its bytes (RuntimeError on mismatch); the layout manifests
    themselves are always CRC-verified on load.

    indexes: manifests already loaded via ``_load_indexes`` (skips the
    re-read; a resume path that inspected the topology first passes them
    through)."""
    from .rules import _map_paths
    from .train import _local_slice

    if indexes is None:
        indexes = _load_indexes(ckpt_path)
    if verify:
        verify_checkpoint_files(
            ckpt_path, only=lambda rel: rel.startswith("shards-p"))

    data = {}
    try:
        for idx in indexes:
            z = np.load(
                os.path.join(ckpt_path, "shards-p%d.npz" % idx["process"]))
            data[idx["process"]] = z

        paths, leaves, _ = _leaf_paths(target)
        placements = _leaf_specs(paths, leaves, specs, mesh, authority)
        out = {}
        for path, leaf, placement in zip(paths, leaves, placements):
            meta = None
            for idx in indexes:
                if path in idx["leaves"]:
                    meta = idx["leaves"][path]
                    break
            if meta is None:
                raise KeyError("checkpoint is missing leaf %r" % path)
            bf16 = meta["dtype"] == "bfloat16"
            full = np.zeros(tuple(meta["shape"]),
                            np.uint16 if bf16 else np.dtype(meta["dtype"]))
            filled = np.zeros(tuple(meta["shape"]), bool) \
                if meta["shape"] else None
            for idx in indexes:
                entry = idx["leaves"].get(path)
                if entry is None:
                    continue
                for sh in entry["shards"]:
                    sl = tuple(slice(a, b) for a, b in sh["slices"])
                    block = data[idx["process"]][sh["key"]]
                    full[sl] = _bits16(block) if bf16 else block
                    if filled is not None:
                        filled[sl] = True
            if filled is not None and not filled.all():
                raise RuntimeError("leaf %r has uncovered regions in "
                                   "checkpoint" % path)
            if isinstance(leaf, LocalBlock):
                if list(leaf.shape) != list(meta["shape"]):
                    raise ValueError(
                        "leaf %r: the target block is of a %s leaf, the "
                        "checkpoint's is %s" % (path, list(leaf.shape),
                                                meta["shape"]))
                full = full[tuple(slice(a, b) for a, b in leaf.slices)]
                leaf = leaf.data
            elif placement is not None:
                # placement from the spec (or the rule tree), not the saved
                # layout — the elastic-resume contract
                full = _local_slice(full, *placement)
            out[path] = _as_leaf(full, bf16, leaf)
    finally:
        # NpzFile keeps its zip handle open until closed — a restore that
        # leaks them exhausts fds over many elastic restarts
        for z in data.values():
            z.close()
    step = indexes[0].get("step", 0)
    return _map_paths(lambda p, _: out[p], target), step
