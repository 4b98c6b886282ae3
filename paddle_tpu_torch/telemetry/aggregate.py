"""Fleet-wide metrics aggregation: merge per-process monitor snapshots
into one registry-shaped view.

Each process periodically publishes ``monitor.snapshot()`` (raw values:
counters, gauges with a timestamp, histogram bucket COUNTS + sum/count/
min/max) to the coordination KV under ``telemetry/metrics/<proc>``
(TTL-leased, so dead processes age out exactly like fleet replicas).
``merge(snapshots)`` folds them:

  * counters SUM across processes;
  * gauges are last-write-wins per (name, labels) — the snapshot with
    the newest timestamp owns the value (a gauge is a point-in-time
    reading; summing "queue depth" across a publisher that died an hour
    ago would lie);
  * histograms merge BUCKET-WISE: same bounds everywhere (the bounds
    ship in the snapshot and are verified), counts add element-wise,
    sum/count add, min/max fold — so the merged ``Histogram.quantile``
    is EXACTLY the quantile a single process observing the union would
    report (no approximation beyond the shared bucket width).

The merged result is a list of real ``monitor.Counter/Gauge/Histogram``
instances (constructed standalone — never registered), so every
consumer (``quantile()``, ``dump_prometheus``) runs the one canonical
implementation instead of a parallel re-derivation that could drift.
"""

from collections import OrderedDict

from ..fluid import monitor as _monitor

__all__ = ["merge", "merged_prometheus", "merged_quantile"]


def _labels_key(labels):
    return tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))


def _new_metric(kind, name, labels, buckets=None):
    if kind == "counter":
        return _monitor.Counter(name, labels=_labels_key(labels))
    if kind == "gauge":
        return _monitor.Gauge(name, labels=_labels_key(labels))
    if kind == "histogram":
        return _monitor.Histogram(name, labels=_labels_key(labels),
                                  buckets=buckets)
    raise ValueError("unknown metric kind %r" % (kind,))


def merge(snapshots):
    """Fold an iterable of ``monitor.snapshot()`` dicts into
    ``(metrics, kinds)``: a list of standalone metric instances plus the
    {name: (kind, help)} map ``dump_prometheus`` renders headers from.

    Raises ValueError when two processes disagree on a histogram's
    bucket bounds — merging mismatched grids silently would corrupt
    every quantile, and bounds are code-defined, so a mismatch means a
    version skew worth failing loudly on."""
    merged = OrderedDict()            # (name, labels_key) -> metric
    gauge_ts = {}                     # (name, labels_key) -> owner ts
    kinds = {}
    for snap in snapshots:
        if not snap:
            continue
        ts = float(snap.get("ts", 0.0))
        for m in snap.get("metrics", ()):
            name, kind = m["name"], m["kind"]
            labels = m.get("labels") or {}
            key = (name, _labels_key(labels))
            if name not in kinds or (m.get("help") and not kinds[name][1]):
                kinds[name] = (kind, m.get("help", ""))
            cur = merged.get(key)
            if cur is None:
                cur = _new_metric(kind, name, labels,
                                  buckets=m.get("bounds"))
                merged[key] = cur
            if cur.kind != kind:
                raise ValueError(
                    "metric %r is a %s in one process and a %s in "
                    "another" % (name, cur.kind, kind))
            if kind == "counter":
                cur._value += m["value"]
            elif kind == "gauge":
                if ts >= gauge_ts.get(key, float("-inf")):
                    gauge_ts[key] = ts
                    cur._value = m["value"]
            else:
                if tuple(m.get("bounds") or ()) != cur.buckets:
                    raise ValueError(
                        "histogram %r bucket bounds differ across "
                        "processes (%r vs %r) — version skew; cannot "
                        "merge exactly" % (name, tuple(m.get("bounds")),
                                           cur.buckets))
                counts = m["counts"]
                if len(counts) != len(cur._counts):
                    raise ValueError(
                        "histogram %r count vector length %d != %d"
                        % (name, len(counts), len(cur._counts)))
                for i, c in enumerate(counts):
                    cur._counts[i] += int(c)
                cur._sum += float(m["sum"])
                cur._count += int(m["count"])
                for field, fold in (("min", min), ("max", max)):
                    v = m.get(field)
                    if v is None:
                        continue
                    old = getattr(cur, "_" + field)
                    setattr(cur, "_" + field,
                            v if old is None else fold(old, v))
    return list(merged.values()), kinds


def merged_prometheus(snapshots, dst=None):
    """Prometheus text of the fleet-merged registry (the ``fleetstat``
    dump)."""
    metrics, kinds = merge(snapshots)
    return _monitor.dump_prometheus(dst, metrics=metrics, kinds=kinds)


def merged_quantile(snapshots, name, q, labels=None):
    """Fleet-wide quantile of one histogram series, exact over the
    merged buckets. None when no process observed it."""
    metrics, _ = merge(snapshots)
    key = _labels_key(labels)
    for m in metrics:
        if m.name == name and tuple(m.labels.items()) == key \
                and isinstance(m, _monitor.Histogram):
            return m.quantile(q)
    return None
