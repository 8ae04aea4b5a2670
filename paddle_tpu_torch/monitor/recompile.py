"""Recompile detector — the classic TPU perf footgun, made loud.

The executor compiles a program once per cache key (program version, feed
shapes/dtypes, fetch names, state set, sharding config — executor.py) and
every later run hits the cache.  A key that keeps changing — ragged batch
sizes, a program rebuilt per step, a fetch list constructed in the loop —
recompiles silently: each miss costs seconds of XLA time and the step loop
never reaches steady state.  The reference had nothing here either (you
found out from conspicuously slow trainers); this detector logs every
compile-cache miss with the DIFF of its key against the previous key of the
same program, counts compiles per program in the StatRegistry
("monitor.compile" / "monitor.recompile"), and warns once when one program
recompiles ``warn_after`` times.

The port's copy of the JAX package's ``monitor/recompile.py``: stdlib only,
so the copy needs no change beyond its package.
"""

import collections
import threading
import warnings

__all__ = ["RecompileDetector", "RecompileStorm"]


class RecompileStorm(RuntimeError):
    """Strict-mode trip: a program recompiled past its budget.  Serving is
    the canonical user (serving/engine.py): every dispatchable shape is
    pre-compiled at server start, so ANY recompile under load is a lost
    latency budget — the detector raises (naming the drifted key
    component) instead of warning.  Carries ``ident`` and ``diff``."""

    def __init__(self, msg, ident=None, diff=()):
        super().__init__(msg)
        self.ident = ident
        self.diff = list(diff)

# bounds for an always-on session: a pathological shape-churn job (the very
# thing the detector exists to catch) must not make the detector itself the
# memory leak — event history is a ring, per-ident state an LRU
_MAX_EVENTS = 1024
_MAX_IDENTS = 4096


class RecompileDetector:
    def __init__(self, registry, timeline=None, warn_after=3, strict=False):
        self.registry = registry
        self.timeline = timeline
        self.warn_after = int(warn_after)
        # strict: once a program's recompiles exceed ``warn_after``, EVERY
        # offending record_compile raises RecompileStorm (no warn-once
        # dedup — each recompile under a strict gate is its own failure).
        # The counters/timeline still record the event first, so the trip
        # leaves evidence behind the exception.
        self.strict = bool(strict)
        self._lock = threading.Lock()
        # ident -> last key parts (insertion-ordered for LRU trimming)
        self._last_parts = collections.OrderedDict()
        self._n_compiles = {}          # ident -> compile count
        self._warned = set()
        self.events = collections.deque(maxlen=_MAX_EVENTS)  # recent events
        self.total_compiles = 0        # lifetime, survives the ring
        self.total_recompiles = 0

    def record_compile(self, ident, parts):
        """Call on a genuine compile-cache miss (never on a hit).

        ident: stable program identity (same program object -> same ident);
        parts: {component_name: comparable value} — the cache key split into
        named components so the diff can say WHAT changed.
        Returns the event dict (also appended to the timeline).
        """
        with self._lock:
            prev = self._last_parts.get(ident)
            n = self._n_compiles.get(ident, 0) + 1
            self._n_compiles[ident] = n
            self._last_parts[ident] = dict(parts)
            self._last_parts.move_to_end(ident)
            while len(self._last_parts) > _MAX_IDENTS:
                old, _ = self._last_parts.popitem(last=False)
                self._n_compiles.pop(old, None)
                self._warned.discard(old)
            recompile = prev is not None
            self.total_compiles += 1
            if recompile:
                self.total_recompiles += 1
            diff = []
            if recompile:
                keys = set(prev) | set(parts)
                diff = sorted(k for k in keys
                              if prev.get(k) != parts.get(k))
            ev = {"ident": ident, "recompile": recompile, "diff": diff,
                  "n_compiles": n}
            self.events.append(ev)
            over_budget = recompile and n - 1 >= self.warn_after
            should_warn = (over_budget and not self.strict
                           and ident not in self._warned)
            if should_warn:
                self._warned.add(ident)
        self.registry.counter("monitor.compile").incr()
        if recompile:
            self.registry.counter("monitor.recompile").incr()
        if self.timeline is not None:
            self.timeline.emit("compile", **ev)
        msg = ("program %r recompiled %d times (last key change: %s) — "
               "each miss pays full XLA compilation; stabilize the feed "
               "shapes/fetch list (pad batches to a bucket) or rebuild the "
               "program outside the step loop" % (ident, n - 1,
                                                  ", ".join(diff) or "?"))
        if self.strict and over_budget:
            # strict is a GATE, not advice: the event above is the
            # evidence, this is the verdict
            raise RecompileStorm(msg, ident=ident, diff=diff)
        if should_warn:
            warnings.warn(msg, stacklevel=3)
        return ev

    def record_warm(self, ident, parts, deserialize_ms=None):
        """A WarmStart disk hit (warm.py): the program did NOT compile —
        deserializing a persisted executable is the whole point — so this
        must never count as compile churn.  The key parts still become the
        ident's baseline so a LATER key drift diffs against them (a warm
        hit followed by ragged shapes is still a named recompile), and the
        timeline records the hit distinctly (``cached="disk"``)."""
        with self._lock:
            self._last_parts[ident] = dict(parts)
            self._last_parts.move_to_end(ident)
            while len(self._last_parts) > _MAX_IDENTS:
                old, _ = self._last_parts.popitem(last=False)
                self._n_compiles.pop(old, None)
                self._warned.discard(old)
            self._n_compiles.setdefault(ident, 0)
            ev = {"ident": ident, "recompile": False, "diff": [],
                  "cached": "disk"}
            if deserialize_ms is not None:
                ev["deserialize_ms"] = round(deserialize_ms, 3)
            self.events.append(ev)
        if self.timeline is not None:
            self.timeline.emit("compile", **ev)
        return ev

    def recompiles(self, ident=None):
        """Total recompile count (first compiles excluded), optionally for
        one program."""
        with self._lock:
            if ident is not None:
                return max(self._n_compiles.get(ident, 0) - 1, 0)
            return self.total_recompiles
