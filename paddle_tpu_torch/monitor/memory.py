"""Device memory watermarks + owner attribution (the counterpart of the JAX
package's ``monitor/memory.py``).

Three complementary sources, all best-effort (the CPU reports no
allocator stats):

- **MemScope owner attribution** (memscope.py) — the tensors each
  registered owner holds (the executor's scope state, ``track(...)``
  providers), classified by owner, with the card's allocated total from
  ``torch.cuda.memory_allocated`` and an explicit ``unattributed``
  remainder.  torch has no ``jax.live_arrays()``: what no owner names is
  only visible in that remainder.
- ``torch.cuda.memory_stats(i)`` — the caching allocator's
  ``allocated_bytes.all.current`` / ``.peak`` as ``bytes_in_use`` /
  ``peak_bytes_in_use``, with the card's total
  (``torch.cuda.mem_get_info``) as ``bytes_limit``: what the CARD is
  holding for this process, temporaries included.  On the CPU the
  ``devices`` key is absent.
- host-side accounting (process RSS).

Each sample sets the same gauges as the reference, under the same names:
``*_peak`` gauges only ratchet up (``Gauge.set_max``); the owner split lands
in ``monitor.mem.owner_bytes{owner=}`` / ``monitor.mem.unattributed_frac``,
the per-device occupancy in ``monitor.mem.hbm_frac{device=}`` (+ the
unlabeled ``hbm_frac_max``), and the whole snapshot rides the ``memory``
timeline event that ``scripts/trace_summary.py`` reads.
"""

__all__ = ["memory_snapshot", "sample_memory", "device_stats"]

# owner labels ever published to the owner_bytes gauge (stale-zeroing set)
_PUBLISHED_OWNERS = set()


def device_stats():
    """``{"cuda:i": {bytes_in_use, peak_bytes_in_use, bytes_limit}}`` for
    each card this process has initialised; ``{}`` without one."""
    import torch

    devs = {}
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return devs
    for i in range(torch.cuda.device_count()):
        try:
            stats = torch.cuda.memory_stats(i)
            _, total = torch.cuda.mem_get_info(i)
        except Exception:
            continue
        devs["cuda:%d" % i] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total)}
    return devs


def memory_snapshot():
    """{"live_bytes", "arrays", "devices": {dev: {bytes_in_use, ...}},
    "owners": {owner: bytes}, "hbm_frac": {dev: frac}, "host": {...}} —
    every field best-effort, absent keys mean the device (or the owner
    registry) can't say."""
    from . import memscope

    snap = {}
    dev_live = None
    try:
        attr = memscope.attribution()
        snap["arrays"] = attr["arrays"]
        snap["live_bytes"] = attr["live_bytes"]
        dev_live = attr.get("device_live_bytes")
        if attr["owners"]:
            snap["owners"] = attr["owners"]
    except Exception:
        pass
    try:
        devs = device_stats()
    except Exception:
        devs = {}
    if devs:
        snap["devices"] = devs
    try:
        frac = memscope.hbm_frac(live=dev_live)
        if frac:
            snap["hbm_frac"] = frac
    except Exception:
        pass
    try:
        host = memscope.host_accounting()
        if host:
            snap["host"] = host
    except Exception:
        pass
    return snap


def sample_memory(registry, timeline=None):
    """Take one snapshot, update the watermark + attribution gauges,
    optionally emit a ``memory`` timeline event.  Returns the snapshot."""
    snap = memory_snapshot()
    if "live_bytes" in snap:
        registry.gauge("monitor.mem.live_bytes").set(snap["live_bytes"])
        registry.gauge("monitor.mem.live_bytes_peak").set_max(
            snap["live_bytes"])
        registry.gauge("monitor.mem.arrays").set(snap["arrays"])
    for dev, stats in snap.get("devices", {}).items():
        if "bytes_in_use" in stats:
            registry.gauge("monitor.mem.device_bytes_in_use",
                           device=dev).set(stats["bytes_in_use"])
        peak = stats.get("peak_bytes_in_use", stats.get("bytes_in_use"))
        if peak is not None:
            registry.gauge("monitor.mem.device_bytes_peak",
                           device=dev).set_max(peak)
    owners = snap.get("owners")
    if owners:
        for owner, b in owners.items():
            registry.gauge("monitor.mem.owner_bytes", owner=owner).set(b)
        # an owner absent from THIS sample must read 0, not its stale last
        # value, on a mid-run scrape
        for o in _PUBLISHED_OWNERS - set(owners):
            registry.gauge("monitor.mem.owner_bytes", owner=o).set(0)
        _PUBLISHED_OWNERS.update(owners)
        unattr = owners.get("unattributed", 0)
        registry.gauge("monitor.mem.unattributed_bytes").set(unattr)
        total = snap.get("live_bytes") or sum(owners.values())
        if total:
            registry.gauge("monitor.mem.unattributed_frac").set(
                round(unattr / total, 4))
    fracs = snap.get("hbm_frac")
    if fracs:
        for dev, f in fracs.items():
            registry.gauge("monitor.mem.hbm_frac", device=dev).set(f)
        registry.gauge("monitor.mem.hbm_frac_max").set_max(
            max(fracs.values()))
    for k, v in (snap.get("host") or {}).items():
        registry.gauge("monitor.mem.host.%s" % k).set(v)
    if timeline is not None:
        timeline.emit("memory", **snap)
    return snap
