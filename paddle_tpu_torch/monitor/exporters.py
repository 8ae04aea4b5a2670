"""Exporters: Prometheus text exposition + the human report table.

The reference's monitor stats surfaced two ways — printed into trainer logs
and scraped by the serving fleet's metrics agent.  Same two here:

- ``to_prometheus_text``/``write_prometheus`` — text-format 0.0.4 file
  exposition (node_exporter textfile-collector style: point a scraper at
  the file, no HTTP server inside the trainer);
- ``format_report`` — the aligned table ``stop_profiler`` prints.

Prometheus naming: stat names are dotted ("hostps.cache.hit"); metric names
sanitize to underscores with a ``paddle_tpu_`` namespace prefix.  Counters
export with a ``_total`` suffix, histograms as a summary: ``_count``/
``_sum`` plus ``_min``/``_max`` gauges and ``{quantile="0.5|0.95|0.99"}``
samples from the registry histogram's bounded sample buffer.

The port's copy of the JAX package's ``monitor/exporters.py``: stdlib only,
so the copy needs no change beyond its package.
"""

import re

__all__ = ["to_prometheus_text", "write_prometheus", "format_report",
           "merge_prometheus_texts", "merge_prometheus_files",
           "parse_prometheus_text", "parse_prometheus_file"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
_LABEL_BAD = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(name, prefix="paddle_tpu"):
    n = _NAME_RE.sub("_", name)
    return "%s_%s" % (prefix, n) if prefix else n


def _fmt_labels(labels):
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        key = _LABEL_BAD.sub("_", str(k))
        val = str(labels[k]).replace("\\", "\\\\").replace('"', '\\"')
        parts.append('%s="%s"' % (key, val))
    return "{%s}" % ",".join(parts)


def _fmt_value(v):
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(float(v)) if isinstance(v, float) else str(int(v))


def to_prometheus_text(registry=None):
    """Render the registry as Prometheus text exposition format."""
    if registry is None:
        from .registry import default_registry

        registry = default_registry()
    # group rows by (name, kind): one HELP/TYPE header per metric family,
    # label variants as separate samples under it
    families = {}
    for row in registry.snapshot():
        families.setdefault((row["name"], row["kind"]), []).append(row)
    lines = []
    for (name, kind), rows in sorted(families.items()):
        base = _metric_name(name)
        if kind == "counter":
            lines.append("# TYPE %s_total counter" % base)
            for r in rows:
                lines.append("%s_total%s %s" % (
                    base, _fmt_labels(r["labels"]), _fmt_value(r["value"])))
        elif kind == "gauge":
            lines.append("# TYPE %s gauge" % base)
            for r in rows:
                lines.append("%s%s %s" % (
                    base, _fmt_labels(r["labels"]), _fmt_value(r["value"])))
        else:   # histogram -> summary (quantiles from the sample buffer)
            lines.append("# TYPE %s summary" % base)
            for r in rows:
                lab = _fmt_labels(r["labels"])
                for q, v in sorted((r.get("quantiles") or {}).items()):
                    qlab = _fmt_labels(dict(r["labels"],
                                            quantile="%g" % q))
                    lines.append("%s%s %s" % (base, qlab, _fmt_value(v)))
                lines.append("%s_count%s %d" % (base, lab, r["calls"]))
                lines.append("%s_sum%s %s" % (base, lab,
                                              _fmt_value(r["total"])))
                if r["calls"]:
                    lines.append("%s_min%s %s" % (base, lab,
                                                  _fmt_value(r["min"])))
                    lines.append("%s_max%s %s" % (base, lab,
                                                  _fmt_value(r["max"])))
    return "\n".join(lines) + "\n" if lines else ""


def write_prometheus(path, registry=None):
    """Write the exposition to ``path`` atomically (rename over) so a
    scraper never reads a half-written file."""
    import os

    text = to_prometheus_text(registry)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
    return path


def merge_prometheus_texts(texts):
    """Fleet rollup: merge per-worker expositions into ONE exposition.

    ``texts`` maps a worker label (rank, hostname) to that worker's
    exposition text (each worker's monitor session writes its own
    ``metrics.prom``; rank 0 or the launcher merges).  Every sample gains a
    ``worker="<label>"`` label so same-named stats from different workers
    stay distinct samples of one metric family; ``# TYPE`` headers dedupe
    and samples regroup under their family (the format wants family lines
    contiguous).  Returns the merged text.
    """
    families = {}                 # TYPE header line -> [sample lines]
    order = []

    def bucket(header):
        if header not in families:
            families[header] = []
            order.append(header)
        return families[header]

    for worker in sorted(texts, key=str):
        cur = None
        for line in texts[worker].splitlines():
            line = line.strip()
            if not line:
                continue
            if line.startswith("# TYPE"):
                cur = line
                bucket(cur)
                continue
            if line.startswith("#"):
                continue
            metric, _, value = line.rpartition(" ")
            if not metric:
                continue
            wlabel = 'worker="%s"' % _LABEL_BAD.sub("_", str(worker))
            if metric.endswith("}"):
                base, _, labels = metric[:-1].partition("{")
                metric = "%s{%s%s}" % (base, wlabel,
                                       "," + labels if labels else "")
            else:
                metric = "%s{%s}" % (metric, wlabel)
            bucket(cur if cur is not None
                   else "# TYPE %s untyped" % metric.partition("{")[0]
                   ).append("%s %s" % (metric, value))
    lines = []
    for header in order:
        lines.append(header)
        lines.extend(families[header])
    return "\n".join(lines) + "\n" if lines else ""


def merge_prometheus_files(paths, out_path=None):
    """Merge exposition FILES (``{label: path}`` or an iterable of paths —
    labels default to the index).  Writes atomically to ``out_path`` when
    given; returns the merged text either way.  Missing files are skipped
    (a lost worker must not break the rollup — its absence IS the signal,
    visible through the fleet.worker_state gauges)."""
    import os

    if not isinstance(paths, dict):
        paths = {str(i): p for i, p in enumerate(paths)}
    texts = {}
    for label, p in paths.items():
        try:
            with open(p) as f:
                texts[label] = f.read()
        except OSError:
            continue
    text = merge_prometheus_texts(texts)
    if out_path:
        tmp = out_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, out_path)
    return text


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$")


_QUANTILE_RE = re.compile(r'quantile="([^"]*)"')


def parse_prometheus_text(text, first_wins=True):
    """Parse a text exposition back into ``{metric_name: value}`` (the
    inverse of ``to_prometheus_text`` for unlabeled samples; labeled
    variants keep the first seen when ``first_wins``).  Summary quantile
    samples key as ``name{quantile="0.99"}`` instead of hijacking the
    bare name — the bare key stays whatever non-quantile sample came
    first.  Unparseable lines are skipped — the consumers (fleet_top,
    FleetScope) read files that a live writer may be mid-replace on."""
    out = {}
    for line in (text or "").splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        key = m.group("name")
        qm = _QUANTILE_RE.search(m.group("labels") or "")
        if qm:
            key = '%s{quantile="%s"}' % (key, qm.group(1))
        if first_wins and key in out:
            continue
        try:
            out[key] = float(m.group("value"))
        except ValueError:
            continue
    return out


def parse_prometheus_file(path):
    """``parse_prometheus_text`` over a file; None when it is missing (a
    rank that never exported — its absence IS the signal)."""
    try:
        with open(path) as f:
            return parse_prometheus_text(f.read())
    except OSError:
        return None


def format_report(rows):
    """Aligned monitor table from ``StatRegistry.snapshot()`` rows — the
    section ``stop_profiler`` appends below the profiler/counter tables."""
    out = ["-------------------------  Monitor  --------------------------",
           "%-44s %-9s %12s %8s %10s %10s %10s"
           % ("Name", "Kind", "Value", "Calls", "Avg", "Min", "Max")]
    for r in rows:
        name = r["name"]
        if r["labels"]:
            name += "{%s}" % ",".join(
                "%s=%s" % kv for kv in sorted(r["labels"].items()))
        if r["kind"] == "histogram":
            if not r["calls"]:
                continue
            out.append("%-44s %-9s %12s %8d %10.4f %10.4f %10.4f"
                       % (name[:44], r["kind"], "", r["calls"], r["avg"],
                          r["min"], r["max"]))
        else:
            out.append("%-44s %-9s %12g %8s %10s %10s %10s"
                       % (name[:44], r["kind"], r["value"], "", "", "", ""))
    return "\n".join(out)
