"""VersionSwapper: apply a publish chain to a LIVE ServeEngine replica
(counterpart of ``paddle_tpu/online/swap.py``).

The zero-drop hot-swap half of the online loop.  A serving replica runs an
ExportedPredictor (on the card its CUDA graphs read the weights from
buffers that ``swap_state`` overwrites in place, so a graph is keyed on the
feed signature only) plus read-only HostPS embeddings.  Swapping a version
therefore never captures:

1. ``resolve_chain`` picks the newest committed base <= target plus its
   deltas; dense state restores from the target publish (full every time),
   sparse rows replay base->deltas last-wins — all OFF the serving path,
   while the old version keeps answering;
2. the bucket lattice is pre-verified (``predictor.ensure_compiled`` per
   lattice point — the engine captured every point at start, so each must
   come back "cached"; the count of each source rides the flip event);
3. ``engine.request_swap`` hands the apply closure to the serve loop,
   which flips AT A STEP BOUNDARY: in-flight requests complete on the old
   weights, admission pauses (requests queue, none are dropped), the
   closure installs the dense dict (``predictor.swap_state``) and the
   sparse rows (``embedding.install_rows`` — allowed in read_only mode:
   a version install is not a training push), and serving resumes on the
   new version.  The stall is bounded by one batch's latency and
   phase-attributed in the ``serve_flip`` timeline event.

Rollback: ``rollback()`` re-applies the previous good version through the
same flip path — the swap mechanism IS the rollback mechanism.

After every flip the serving tables hold exactly the target chain's rows:
rows an earlier flip installed that the target chain does not hold go
back to the table's initializer (``install_rows(forget=)``).  The
reference leaves them at the later version's values, so after its
rollback a row first trained after the target version still serves that
later value; here a rollback serves the target version's rows.
"""

import time

import numpy as np
import torch

from . import publish as _publish
from ..monitor import trace as _trace
from ..monitor import tracemesh as _tmesh

__all__ = ["VersionSwapper"]


def _gauge_set(name, value):
    try:
        from ..monitor.registry import default_registry

        default_registry().gauge(name).set(value)
    except Exception:
        pass


class VersionSwapper(object):
    """Drive one ServeEngine replica along a publish chain.

    engine:     the live ServeEngine (its loop applies the flip).
    predictor:  the ExportedPredictor the engine's model closes over.
    directory:  the DeltaPublisher chain directory.
    hostps:     serving-side HostPSEmbedding handles (read_only) whose
                tables receive the published sparse rows, matched by
                table name.
    """

    def __init__(self, engine, predictor, directory, hostps=None):
        self.engine = engine
        self.predictor = predictor
        self.directory = str(directory)
        self.hostps = list(hostps or [])
        self.version = None
        self.history = []            # good versions, in apply order
        self.last_event = None
        # table name -> the rows this swapper's flips put in that table
        self._installed = {}

    def poll(self):
        """Apply the newest committed version if it is newer than the one
        being served.  Returns the flip event dict, or None when already
        fresh (the serving loop calls this on a timer)."""
        v = _publish.latest_version(self.directory)
        if v is None or (self.version is not None and v <= self.version):
            return None
        return self.apply(v)

    def rollback(self):
        """Re-apply the previous good version (the quarantine/late-veto
        escape hatch).  Returns the flip event, or None when there is no
        earlier version to fall back to."""
        if len(self.history) < 2:
            return None
        target = self.history[-2]
        ev = self.apply(target, _rollback=True)
        self.history.pop()
        return ev

    def apply(self, version, _rollback=False):
        """Replay the chain for ``version`` and flip the engine onto it
        without dropping a request.  Returns the engine's flip event
        (version, stall_ms, apply_ms, train_step, freshness_lag_s...)."""
        chain = _publish.resolve_chain(self.directory, upto=version)
        if chain is None or chain[-1][0] != int(version):
            raise ValueError(
                "no committed publish chain ends at version %r in %r"
                % (version, self.directory))
        man = chain[-1][2]

        # the manifest's trace context (stamped by the publishing trainer,
        # another process) parents this replica's verify span — and the
        # scope below parents the engine's flip span under verify, so the
        # whole publish->verify->flip chain shares one trace id
        tman = man.get("tctx")
        parent = ((tman.get("tid"), tman.get("sid"))
                  if isinstance(tman, dict) and tman.get("sid") else None)
        ctx = None
        sp = _trace.null_span()
        if _trace.active_tracer() is not None:
            ctx, targs = _tmesh.link(parent)
            targs["version"] = int(version)
            sp = _trace.span("online.swap.verify", **targs)
        with sp:
            # dense: template shaped exactly like the predictor's live
            # state, on the host — extra published leaves are ignored,
            # missing ones fail loudly
            template = {"dense": {n: torch.empty_like(v, device="cpu")
                                  for n, v in
                                  self.predictor._state.items()}}
            new_state = _publish.load_chain_dense(chain, template)["dense"]

            installs = []
            for emb in self.hostps:
                table = getattr(emb, "table", emb)
                got = _publish.load_chain_rows(chain, table.name)
                rows = (got[0] if got is not None
                        else np.zeros(0, np.int64))
                stale = np.setdiff1d(
                    self._installed.get(table.name, np.zeros(0, np.int64)),
                    rows)
                if got is not None or stale.size:
                    installs.append((emb, table.name, rows,
                                     got[1] if got is not None else {},
                                     stale))

            # pre-verify the lattice through WarmStart while the old
            # version serves: same avals => "cached"/"disk"; a fresh
            # compile means the publish is not call-compatible and must
            # not reach the flip
            compiled = self._preverify()

        def _apply():
            self.predictor.swap_state(new_state)
            rows = forgotten = 0
            for emb, name, r, arrays, stale in installs:
                rows += int(emb.install_rows(r, arrays, forget=stale))
                forgotten += int(stale.size)
                self._installed[name] = r
            lag = time.time() - float(man["train_wall"])
            return {"train_step": int(man["train_step"]),
                    "kind": man.get("kind"),
                    "chain_len": len(chain),
                    "rows_installed": rows,
                    "rows_forgotten": forgotten,
                    "rollback": bool(_rollback),
                    "freshness_lag_s": round(lag, 3)}

        with _tmesh.scope(ctx):
            event = self.engine.request_swap(_apply, version=int(version))
        self.version = int(version)
        if not _rollback:
            self.history.append(self.version)
        self.last_event = event
        event["preverified"] = compiled
        _gauge_set("online.version", self.version)
        _gauge_set("online.train_wall", float(man["train_wall"]))
        _gauge_set("online.freshness_lag_s",
                   event.get("freshness_lag_s", 0.0))
        _gauge_set("online.flip_stall_ms", event.get("stall_ms", 0.0))
        return event

    def _preverify(self):
        """ensure_compiled every engine lattice point (the feed signatures
        do not depend on the weights — swap_state enforces their shapes and
        dtypes), so the flip can never be the first time a bucket is
        captured.  Returns {source: count}."""
        lattice = getattr(self.engine, "lattice", None)
        if lattice is None or not hasattr(self.engine, "_point_shapes"):
            return {}
        counts = {}
        for bucket, seq in lattice.points():
            spec = self.engine._point_shapes(bucket, seq)
            try:
                src, _ = self.predictor.ensure_compiled(spec)
            except Exception:
                src = "error"
            counts[src] = counts.get(src, 0) + 1
        return counts
