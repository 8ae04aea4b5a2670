"""MemScope: full-stack memory attribution (the counterpart of the JAX
package's ``monitor/memscope.py``).

It answers the three questions a production OOM asks, as the reference
does, with these differences on the card:

1. **Which program needed the bytes** — a per-plan memory ledger
   (``argument_bytes`` / ``output_bytes`` / ``temp_bytes``) in the
   ``monitor.mem.program.*{program=}`` gauges and ``mem_program`` timeline
   events, ident-joined to the step events.  The executor's ``_Plan`` has
   no ``Compiled.memory_analysis()``, so a plan's ledger is MEASURED on its
   first run, the plan-cache miss that stands for the reference's compile
   (``LedgerProbe``): ``reset_peak_memory_stats`` before the run and the
   peak over the baseline after it give ``temp_bytes + output_bytes``; the
   sizes of the state and the feed give ``argument_bytes``; the event's
   ``source`` is ``"compile"``.  On the CPU, with no allocator stats, the
   ledger has no ``temp_bytes``.  **A new plan's headroom is therefore
   checked from its second dispatch, where the reference checks it before
   the first.**

2. **Who was holding the rest** — owner attribution.  torch has no
   ``jax.live_arrays()``, so the walk goes the other way: over the
   registered owners (every scope an executor ran with, as ``scope``, and
   ``register_owner`` / ``track`` providers), each storage counted once.
   The card's total comes from ``torch.cuda.memory_allocated``, and what no
   owner names is reported as ``unattributed``.

3. **Could we have known before dispatch** — the headroom predictor: a
   plan's temp+output requirement against ``bytes_limit - bytes_in_use``
   per device (the cards in use, else the CPU), from the card's
   ``torch.cuda.mem_get_info`` (its total, and its total less its free
   bytes); a predicted shortfall emits a
   ``mem_headroom`` warning event + ``monitor.mem.predicted_oom`` counter,
   and the opt-in refuse mode (``PADDLE_TPU_MEMSCOPE_REFUSE=1`` /
   ``configure(refuse=True)``) raises ``MemoryBudgetError`` instead of
   dispatching.  A configured ``bytes_limit`` (``configure()`` /
   ``PADDLE_TPU_MEMSCOPE_LIMIT``) overrides the card's total, and arms the
   predictor on the CPU against the owners' bytes there (flagged
   ``estimated``).

A ``torch.cuda.OutOfMemoryError`` (or the injected ``oom_step`` chaos
fault) caught at the executor's dispatch becomes a flight postmortem with
the ``mem_oom`` section: the failing plan's ledger, the headroom math, the
top owners and the watermark tail.
"""

import os
import threading
import warnings
import weakref

__all__ = [
    "MemoryBudgetError", "InjectedOOMError", "LedgerProbe",
    "configure", "reset", "refuse_enabled",
    "register_owner", "unregister_owner", "track", "note_scope",
    "attribution", "headroom", "hbm_frac", "min_device_bytes_limit",
    "host_accounting",
    "record_program", "ledgers", "model_bytes", "predict_dispatch",
    "is_resource_exhausted", "oom_extra", "note_oom",
]


class MemoryBudgetError(RuntimeError):
    """Refuse-mode admission: the predictor says this program's temp+output
    requirement exceeds the device headroom — refused BEFORE dispatch."""


class InjectedOOMError(RuntimeError):
    """The deterministic ``oom_step`` chaos fault (ft/chaos.py): a synthetic
    RESOURCE_EXHAUSTED raised at the dispatch boundary, so the whole OOM
    postmortem path is drillable without running out of memory."""


_LOCK = threading.Lock()

# configured overrides: bytes_limit arms the predictor without allocator
# stats (and caps the card's); refuse turns the predicted-OOM warning into
# an admission refusal (MemoryBudgetError)
_CONFIG = {"bytes_limit": None, "refuse": None}


def configure(bytes_limit=None, refuse=None):
    """Override the per-device byte limit (None keeps the card's own
    total) and/or the refuse mode."""
    with _LOCK:
        if bytes_limit is not None:
            _CONFIG["bytes_limit"] = int(bytes_limit)
        if refuse is not None:
            _CONFIG["refuse"] = bool(refuse)


def _configured_limit():
    with _LOCK:
        v = _CONFIG["bytes_limit"]
    if v is not None:
        return v
    env = os.environ.get("PADDLE_TPU_MEMSCOPE_LIMIT", "").strip()
    if env:
        try:
            return int(float(env))
        except ValueError:
            pass
    return None


def refuse_enabled():
    with _LOCK:
        v = _CONFIG["refuse"]
    if v is not None:
        return v
    return os.environ.get("PADDLE_TPU_MEMSCOPE_REFUSE", "").strip() in (
        "1", "true", "on")


def reset():
    """Drop every registration / ledger / config override (test isolation)."""
    with _LOCK:
        _CONFIG["bytes_limit"] = None
        _CONFIG["refuse"] = None
        _OWNERS.clear()
        _TRACKED[:] = []
        _SCOPES.clear()
        _LEDGERS.clear()
        _LEDGER_ORDER[:] = []
        _HEADROOM_SEEN.clear()


# ------------------------------------------------------------- ownership --

# explicit providers: owner -> callable yielding the tensors that owner holds
_OWNERS = {}
# weakref-tracked objects: (owner, weakref(obj), extract); dead refs prune
# on walk
_TRACKED = []
# every scope a monitored executor ran with (owner "scope")
_SCOPES = weakref.WeakSet()


def register_owner(name, provider):
    """``provider()`` returns the tensors the subsystem currently holds."""
    with _LOCK:
        _OWNERS[str(name)] = provider
    return provider


def unregister_owner(name):
    with _LOCK:
        _OWNERS.pop(str(name), None)


def track(name, obj, extract):
    """Weakref registration: ``extract(obj)`` yields the tensors ``obj``
    holds; the entry dies with the object."""
    with _LOCK:
        _TRACKED.append((str(name), weakref.ref(obj), extract))


def note_scope(scope):
    """The executor's hook: ``scope``'s tensors are owner ``scope``."""
    with _LOCK:
        _SCOPES.add(scope)


def _iter_owned():
    """(owner, tensor) pairs from every registration plus the scopes.
    Every leg is best-effort: attribution must never take a run down.  The
    HostPS hot-row caches are owner ``hostps_cache``; the reference's warm
    twins wait for the warm store (ROADMAP Queue 1 item 8)."""
    with _LOCK:
        owners = list(_OWNERS.items())
        tracked = list(_TRACKED)
        scopes = list(_SCOPES)
    for name, provider in owners:
        try:
            for a in provider() or ():
                yield name, a
        except Exception:
            continue
    dead = []
    for entry in tracked:
        name, ref, extract = entry
        obj = ref()
        if obj is None:
            dead.append(entry)
            continue
        try:
            for a in extract(obj) or ():
                yield name, a
        except Exception:
            continue
    if dead:
        with _LOCK:
            for entry in dead:
                if entry in _TRACKED:
                    _TRACKED.remove(entry)
    from ..scope import global_scope

    for scope in [global_scope()] + scopes:
        for v in list(scope._vars.values()):
            if v is not None:
                yield "scope", v
    # HostPS hot-row cache slot buffers (one [slots, dim] tensor per cached
    # table)
    from ..hostps import service as _svc

    for emb in _svc.live_embeddings():
        cache = getattr(emb, "cache", None)
        if cache is not None:
            yield "hostps_cache", cache._values


def _cuda_devices():
    """Indices of the cards this process has initialised."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return []
    return list(range(torch.cuda.device_count()))


def attribution():
    """Classify the owners' tensors: ``{"owners": {owner: bytes, ...,
    "unattributed": bytes}, "device_live_bytes": {device: bytes},
    "live_bytes": total, "arrays": n}``.  Each storage counts once (views
    share one); on a card the total is ``torch.cuda.memory_allocated`` and
    the part no owner names is ``unattributed``."""
    import torch

    seen = set()
    owners = {}
    per_dev = {}
    total = 0
    n = 0
    for name, t in _iter_owned():
        if not isinstance(t, torch.Tensor):
            continue
        storage = t.untyped_storage()
        key = (str(t.device), storage.data_ptr())
        if key in seen:
            continue
        seen.add(key)
        nb = int(storage.nbytes())
        if not nb:
            continue
        n += 1
        total += nb
        owners[name] = owners.get(name, 0) + nb
        per_dev[key[0]] = per_dev.get(key[0], 0) + nb
    unattributed = 0
    for i in _cuda_devices():
        dev = "cuda:%d" % i
        allocated = int(torch.cuda.memory_allocated(i))
        unattributed += max(allocated - per_dev.get(dev, 0), 0)
        per_dev[dev] = max(allocated, per_dev.get(dev, 0))
    owners["unattributed"] = unattributed
    return {"owners": owners,
            "device_live_bytes": {d: int(b) for d, b in per_dev.items()},
            "live_bytes": total + unattributed, "arrays": n}


# -------------------------------------------------------------- headroom --

def headroom(live=None):
    """Per device — each card this process has initialised, else the CPU:
    ``{device: {"bytes_limit", "bytes_in_use", "headroom",
    ["estimated"]}}``.  On a card ``bytes_limit`` is the configured
    override or ``mem_get_info``'s total, and ``bytes_in_use`` its total
    less its free bytes; on the CPU only a configured limit arms it,
    against the owners' bytes there (flagged ``estimated``).  ``live``
    passes a precomputed per-device map from ``attribution()``."""
    import torch

    out = {}
    devices = [("cuda:%d" % i, i) for i in _cuda_devices()] or [("cpu", None)]
    for dev, index in devices:
        limit, in_use = None, None
        if index is not None:
            free, total = torch.cuda.mem_get_info(index)
            limit, in_use = int(total), int(total - free)
        limit = _configured_limit() or limit
        h = {"bytes_limit": int(limit) if limit else None}
        if in_use is None and limit:
            if live is None:
                live = attribution()["device_live_bytes"]
            in_use = live.get(dev, 0)
            h["estimated"] = True
        h["bytes_in_use"] = int(in_use) if in_use is not None else None
        h["headroom"] = (int(limit) - int(in_use)
                         if limit and in_use is not None else None)
        out[dev] = h
    return out


def hbm_frac(live=None):
    """``{device: bytes_in_use / bytes_limit}`` where both are known."""
    out = {}
    for dev, h in headroom(live=live).items():
        if h.get("bytes_limit") and h.get("bytes_in_use") is not None:
            out[dev] = round(h["bytes_in_use"] / h["bytes_limit"], 4)
    return out


def min_device_bytes_limit(fallback=None):
    """The tightest per-device byte limit over every visible card: the
    capacity number the embedding table router (``parallel/embedding.py``)
    and the admission math agree on.  The configured override first
    (``configure`` or ``PADDLE_TPU_MEMSCOPE_LIMIT``), then the smallest
    ``total_memory`` of the visible cards, then ``fallback``."""
    import torch

    cfg = _configured_limit()
    if cfg is not None:
        return cfg
    if torch.cuda.is_available():
        limits = [torch.cuda.get_device_properties(i).total_memory
                  for i in range(torch.cuda.device_count())]
        if limits:
            return int(min(limits))
    return fallback


# -------------------------------------------------- host-side accounting --

def host_accounting():
    """Host-RAM side of the story: process RSS, HostPS table resident bytes
    (initialized rows x row footprint), ShardPS wire replay-log bytes."""
    out = {}
    try:
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        out["rss_bytes"] = rss_pages * os.sysconf("SC_PAGE_SIZE")
    except Exception:
        pass
    from ..hostps import service as _svc
    from ..hostps import shard_router as _sr

    total = 0
    for emb in _svc.live_embeddings():
        t = getattr(emb.table, "local_table", emb.table)
        total += int(getattr(t, "nbytes_resident", 0) or 0)
    if total:
        out["hostps_tables_bytes"] = total
    total = 0
    for router in list(getattr(_sr, "_LIVE_ROUTERS", ())):
        for st in router._shards.values():
            with st.cond:
                entries = list(st.log)
            for _seq, rows, values, _lr in entries:
                total += int(getattr(rows, "nbytes", 0) or 0)
                total += int(getattr(values, "nbytes", 0) or 0)
    if total:
        out["ps_replay_bytes"] = total
    return out


# -------------------------------------------------------- program ledger --

_LEDGERS = {}
_LEDGER_ORDER = []
_LEDGER_FIELDS = ("argument_bytes", "output_bytes", "temp_bytes",
                  "generated_code_bytes", "alias_bytes")


def _nbytes(tensors):
    """Bytes of the distinct storages among ``tensors``."""
    import torch

    seen, total = set(), 0
    for t in tensors:
        if isinstance(t, torch.Tensor):
            s = t.untyped_storage()
            if (str(t.device), s.data_ptr()) not in seen:
                seen.add((str(t.device), s.data_ptr()))
                total += int(s.nbytes())
    return total


class LedgerProbe:
    """Measures a plan's first run: ``LedgerProbe(device, state + feed)``
    before it, ``finish(outputs)`` after it gives the ledger."""

    def __init__(self, device, arguments):
        import torch

        self.device = torch.device(device)
        self.argument_bytes = _nbytes(arguments)
        self.base = None
        if self.device.type == "cuda":
            # the first plan of a fresh process (a startup program) may run
            # before anything touched the card: the allocator's statistics
            # exist only once CUDA is initialised
            torch.cuda.init()
            torch.cuda.reset_peak_memory_stats(self.device)
            self.base = torch.cuda.memory_allocated(self.device)

    def finish(self, outputs):
        import torch

        led = {"argument_bytes": self.argument_bytes,
               "output_bytes": _nbytes(outputs)}
        if self.base is not None:
            peak = torch.cuda.max_memory_allocated(self.device) - self.base
            led["temp_bytes"] = max(int(peak) - led["output_bytes"], 0)
        return led


def ledgers():
    """[(ident, ledger)] in record order (process lifetime)."""
    with _LOCK:
        return [(i, dict(_LEDGERS[i])) for i in _LEDGER_ORDER]


def model_bytes(ledger):
    """The ledger's dispatch-time requirement: temp + output bytes (the
    arguments already exist)."""
    if not ledger:
        return None
    t = ledger.get("temp_bytes")
    o = ledger.get("output_bytes")
    if t is None and o is None:
        return None
    return int(t or 0) + int(o or 0)


def record_program(mon, ident, ledger, source="compile"):
    """The plan memory ledger hook (the executor, after a plan's first
    run).  Gauges ``monitor.mem.program.*{program=ident}`` + one
    ``mem_program`` timeline event carrying ``source``.  Returns the
    ledger (also kept process-wide for the headroom predictor and the OOM
    postmortem)."""
    if not ledger:
        try:
            mon.registry.counter("monitor.mem.program.unavailable").incr()
            mon.timeline.emit("mem_program", ident=ident, source=source,
                              available=False)
        except Exception:
            pass
        return None
    led = {k: int(v) for k, v in ledger.items() if v is not None}
    with _LOCK:
        prev = _LEDGERS.get(ident)
        if prev is None:
            _LEDGER_ORDER.append(ident)
        _LEDGERS[ident] = led
        if prev is not None and prev != led:
            # a new plan of the same ident (feed-shape drift) carries a new
            # requirement: re-run the headroom verdict against it
            _HEADROOM_SEEN.discard(ident)
    try:
        for k in _LEDGER_FIELDS:
            if led.get(k) is not None:
                mon.registry.gauge("monitor.mem.program.%s" % k,
                                   program=ident).set(led[k])
        mon.timeline.emit("mem_program", ident=ident, source=source,
                          available=True, **led)
    except Exception:
        pass
    return led


# ---------------------------------------------------- headroom predictor --

_HEADROOM_SEEN = set()     # idents already checked (one verdict per ident)


def predict_dispatch(mon, ident, ledger=None):
    """Pre-dispatch admission math for a measured plan: compare its
    temp+output requirement against every device's ``bytes_limit -
    bytes_in_use``.  One ``mem_headroom`` verdict event per ident; a
    predicted shortfall warns (+ ``monitor.mem.predicted_oom``) and, in
    refuse mode, raises ``MemoryBudgetError`` instead of dispatching."""
    with _LOCK:
        if ident in _HEADROOM_SEEN:
            return
        _HEADROOM_SEEN.add(ident)
        ledger = ledger or _LEDGERS.get(ident)
    need = model_bytes(ledger)
    if need is None:
        return
    try:
        hr = headroom()
    except Exception:
        return
    short = None
    for dev, h in hr.items():
        if h.get("headroom") is None:
            continue
        if need > h["headroom"]:
            short = (dev, h)
            break
    ev = {"ident": ident, "need_bytes": need,
          "predicted_oom": short is not None}
    if short is not None:
        dev, h = short
        ev.update(device=dev, bytes_limit=h.get("bytes_limit"),
                  bytes_in_use=h.get("bytes_in_use"),
                  headroom=h.get("headroom"),
                  estimated=bool(h.get("estimated")))
    try:
        mon.timeline.emit("mem_headroom", **ev)
        if short is not None:
            mon.registry.counter("monitor.mem.predicted_oom").incr()
            mon.timeline.flush()   # the warning must survive the death it
            # predicts
    except Exception:
        pass
    if short is not None:
        dev, h = short
        msg = ("memscope: program %s needs ~%d bytes of temp+output but "
               "device %s has only %s bytes of headroom (%s in use of %s "
               "limit%s) — a dispatch is likely to run out of memory"
               % (ident, need, dev, h.get("headroom"), h.get("bytes_in_use"),
                  h.get("bytes_limit"),
                  ", framework-estimated" if h.get("estimated") else ""))
        if refuse_enabled():
            # stay armed: a retry of the same program re-runs the math
            with _LOCK:
                _HEADROOM_SEEN.discard(ident)
            raise MemoryBudgetError(msg)
        warnings.warn(msg, stacklevel=2)


# -------------------------------------------------------- OOM postmortem --

def is_resource_exhausted(exc):
    """True for ``torch.cuda.OutOfMemoryError``, an injected ``oom_step``
    fault, the refuse-mode admission error, or an error that says it ran
    out of memory."""
    import torch

    if isinstance(exc, (InjectedOOMError, MemoryBudgetError,
                        torch.cuda.OutOfMemoryError)):
        return True
    s = str(exc)
    return "RESOURCE_EXHAUSTED" in s or "out of memory" in s.lower()


def oom_extra(mon, ident=None):
    """The flight-recorder ``extra`` for an OOM: failing program's ledger,
    the headroom math, the top owners, and the watermark tail."""
    with _LOCK:
        led = dict(_LEDGERS[ident]) if ident in _LEDGERS else None
    sec = {"failing_program": ident, "ledger": led,
           "need_bytes": model_bytes(led)}
    try:
        sec["headroom"] = headroom()
    except Exception:
        pass
    try:
        attr = attribution()
        owners = attr.get("owners", {})
        top = sorted(((o, b) for o, b in owners.items()
                      if o != "unattributed"), key=lambda kv: -kv[1])[:8]
        sec["owners_top"] = [{"owner": o, "bytes": int(b)} for o, b in top]
        sec["unattributed_bytes"] = int(owners.get("unattributed", 0))
        sec["live_bytes"] = attr.get("live_bytes")
    except Exception:
        pass
    try:
        sec["host"] = host_accounting()
    except Exception:
        pass
    try:
        sec["watermark_tail"] = [e for e in mon.timeline.tail()
                                 if e.get("ev") == "memory"][-4:]
    except Exception:
        pass
    return {"mem_oom": sec}


def note_oom(mon, ident, exc):
    """An OOM landed: count it and dump the flight postmortem with the
    memory section (one dump per exception object)."""
    try:
        mon.registry.counter("monitor.mem.oom").incr()
    except Exception:
        pass
    flight = getattr(mon, "flight", None)
    if flight is None:
        return None
    try:
        return flight.dump(exc=(type(exc), exc, exc.__traceback__),
                           reason="resource_exhausted",
                           extra=oom_extra(mon, ident))
    except Exception:
        return None
