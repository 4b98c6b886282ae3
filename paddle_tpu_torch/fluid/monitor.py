"""Process-wide metrics registry: the port's copy of
``paddle_tpu/fluid/monitor.py`` (the reference's ``StatRegistry`` grown
into the counter/gauge/histogram triple a serving fleet scrapes), with
the same metric names and semantics.

The profiler answers "where did this run spend its time"; the monitor
answers "what has this process done since it started" (compile-cache
hits by tier, serving latency, fleet respawns). Everything is
lock-protected, label-aware and ``reset()``-able, so tests assert exact
deltas.

Exposition:
  * ``dump_json()``           -> plain dict
  * ``snapshot(proc=)``       -> the mergeable form the telemetry pusher
    publishes (``telemetry/aggregate.py`` folds a fleet's snapshots)
  * ``dump_prometheus(dst)``  -> Prometheus text format 0.0.4
  * ``PADDLE_MONITOR_DUMP=/path`` dumps at interpreter exit
    (``*.json`` -> JSON, anything else -> Prometheus text).

No torch or framework imports: every layer imports this without cycles.
"""

import atexit
import bisect
import json
import os
import re
import threading
from collections import OrderedDict

__all__ = ["Counter", "Gauge", "Histogram", "counter", "gauge",
           "histogram", "get_metric", "sum_labeled", "all_metrics",
           "reset", "dump_json", "dump_prometheus", "snapshot",
           "default_buckets"]

ENV_DUMP = "PADDLE_MONITOR_DUMP"

_LOCK = threading.Lock()          # registry structure
_REGISTRY = OrderedDict()         # (name, labels_tuple) -> metric
_KINDS = {}                       # name -> (kind, help)


def default_buckets(start=1e-6, factor=4.0, count=14):
    """Fixed log-scale bucket upper bounds: ``start * factor**i``.

    The default spans 1us .. ~67s — wide enough for a single kernel
    dispatch and a cold first-step compile in the same histogram."""
    return tuple(start * factor ** i for i in range(count))


def _labels_key(labels):
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    kind = None

    def __init__(self, name, labels=()):
        self.name = name
        self.labels = OrderedDict(labels)
        self._lock = threading.Lock()

    def to_dict(self):
        raise NotImplementedError


class Counter(_Metric):
    """Monotonic count (reference ``STAT_ADD``)."""

    kind = "counter"

    def __init__(self, name, labels=()):
        _Metric.__init__(self, name, labels)
        self._value = 0

    def inc(self, n=1):
        if n < 0:
            raise ValueError("Counter.inc(%r): counters only go up — "
                             "use a Gauge" % (n,))
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def _reset_value(self):
        with self._lock:
            self._value = 0

    def to_dict(self):
        return {"kind": self.kind, "value": self._value}


class Gauge(_Metric):
    """Point-in-time value (reference ``STAT_RESET`` on a stat)."""

    kind = "gauge"

    def __init__(self, name, labels=()):
        _Metric.__init__(self, name, labels)
        self._value = 0

    def set(self, v):
        with self._lock:
            self._value = v

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def dec(self, n=1):
        with self._lock:
            self._value -= n

    def track(self, n=1):
        """Context manager: ``inc(n)`` on entry, ``dec(n)`` on exit —
        the in-flight/occupancy idiom (e.g. a prefetch thread holds the
        gauge at 1 while its pull is outstanding). Exception-safe, so a
        crashed worker never leaves the gauge pinned high."""
        return _GaugeTracker(self, n)

    @property
    def value(self):
        return self._value

    def _reset_value(self):
        with self._lock:
            self._value = 0

    def to_dict(self):
        return {"kind": self.kind, "value": self._value}


class _GaugeTracker:
    def __init__(self, gauge, n):
        self._gauge = gauge
        self._n = n

    def __enter__(self):
        self._gauge.inc(self._n)
        return self._gauge

    def __exit__(self, *exc):
        self._gauge.dec(self._n)
        return False


class Histogram(_Metric):
    """Fixed log-scale buckets + sum/count/min/max. ``observe()`` is a
    bisect + two adds under the metric lock — cheap enough for the
    executor hot path."""

    kind = "histogram"

    def __init__(self, name, labels=(), buckets=None):
        _Metric.__init__(self, name, labels)
        self.buckets = tuple(sorted(buckets if buckets is not None
                                    else default_buckets()))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._min = None
        self._max = None

    def observe(self, v):
        v = float(v)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    def time(self):
        """Context manager observing the elapsed seconds of its body."""
        return _HistogramTimer(self)

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def quantile(self, q):
        """Approximate q-quantile (0 <= q <= 1) interpolated from the
        fixed buckets (the ``histogram_quantile`` estimate a Prometheus
        scrape would compute), clamped to the observed min/max so tight
        distributions don't report a whole bucket's width of error.
        Values landing in the +Inf overflow bucket report the observed
        max. Returns None while the histogram is empty."""
        if not 0.0 <= float(q) <= 1.0:
            raise ValueError("quantile q must be in [0, 1], got %r" % (q,))
        with self._lock:
            total = self._count
            counts = list(self._counts)
            mn, mx = self._min, self._max
        if not total:
            return None
        target = float(q) * total
        if target <= 0:
            return mn
        acc, prev = 0, 0.0
        for le, c in zip(self.buckets, counts):
            if c and acc + c >= target:
                lo = prev if mn is None else max(prev, min(mn, le))
                hi = le if mx is None else max(lo, min(le, mx))
                return lo + (hi - lo) * (target - acc) / c
            acc += c
            prev = le
        return mx  # overflow bucket: the best bounded answer available

    def bucket_counts(self):
        """Raw per-bucket counts (NOT cumulative), one per bound plus
        the trailing +Inf overflow slot — the mergeable form: two
        processes' vectors add element-wise and the merged ``quantile``
        is exact over the shared bounds (telemetry/aggregate.py)."""
        with self._lock:
            return list(self._counts)

    def cumulative_buckets(self):
        """[(upper_bound, cumulative_count), ...] ending with +Inf —
        the Prometheus histogram series shape."""
        out, acc = [], 0
        with self._lock:
            counts = list(self._counts)
        for le, c in zip(self.buckets, counts):
            acc += c
            out.append((le, acc))
        out.append((float("inf"), acc + counts[-1]))
        return out

    def _reset_value(self):
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._count = 0
            self._min = None
            self._max = None

    def to_dict(self):
        return {"kind": self.kind, "count": self._count,
                "sum": self._sum, "min": self._min, "max": self._max,
                "buckets": [[le, c] for le, c
                            in self.cumulative_buckets()]}


class _HistogramTimer:
    def __init__(self, hist):
        self._hist = hist

    def __enter__(self):
        import time

        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import time

        self._hist.observe(time.perf_counter() - self._t0)
        return False


def _get_or_create(cls, name, help, labels, **kw):
    key = (name, _labels_key(labels))
    with _LOCK:
        m = _REGISTRY.get(key)
        if m is not None:
            if m.kind != cls.kind:
                raise ValueError(
                    "metric %r already registered as a %s (wanted %s)"
                    % (name, m.kind, cls.kind))
            return m
        known = _KINDS.get(name)
        if known is not None and known[0] != cls.kind:
            raise ValueError(
                "metric %r already registered as a %s (wanted %s)"
                % (name, known[0], cls.kind))
        m = cls(name, labels=_labels_key(labels), **kw)
        _REGISTRY[key] = m
        if known is None or (help and not known[1]):
            _KINDS[name] = (cls.kind, help or (known[1] if known else ""))
        return m


def counter(name, help="", labels=None):
    """Get-or-create the Counter for (name, labels)."""
    return _get_or_create(Counter, name, help, labels)


def gauge(name, help="", labels=None):
    """Get-or-create the Gauge for (name, labels)."""
    return _get_or_create(Gauge, name, help, labels)


def histogram(name, help="", labels=None, buckets=None):
    """Get-or-create the Histogram for (name, labels). ``buckets`` is
    honored on first creation only (series of one name share bounds)."""
    return _get_or_create(Histogram, name, help, labels, buckets=buckets)


def get_metric(name, labels=None):
    """The registered metric, or None."""
    return _REGISTRY.get((name, _labels_key(labels)))


def sum_labeled(name):
    """Sum a counter/gauge named ``name`` across every label set it was
    registered under (0.0 when none exist) — the fleet/bench roll-up for
    per-model and per-replica series."""
    with _LOCK:
        return sum(m.value for (n, _), m in _REGISTRY.items()
                   if n == name and hasattr(m, "value"))


def all_metrics():
    """Snapshot list of registered metrics (registration order)."""
    with _LOCK:
        return list(_REGISTRY.values())


def reset():
    """Zero every metric's VALUE in place. Instances stay registered, so
    module-level references held by the executor/reader keep working —
    this is the test-isolation hook."""
    for m in all_metrics():
        m._reset_value()


# -- exposition ---------------------------------------------------------------

def dump_json():
    """{name: [{"labels": {...}, <metric fields>}, ...]} — the bench.py
    embedding format."""
    out = OrderedDict()
    for m in all_metrics():
        d = m.to_dict()
        d["labels"] = dict(m.labels)
        out.setdefault(m.name, []).append(d)
    return out


def snapshot(proc=None):
    """Raw mergeable snapshot of the whole registry — the blob each
    fleet process pushes to the coordination KV for cross-process
    aggregation (``telemetry/aggregate.merge``). Histograms ship their
    bucket BOUNDS and raw per-bucket counts so the merge can verify the
    grids match and add them element-wise; gauges ride with the
    snapshot timestamp so the merge can apply last-write-wins."""
    import time

    mets = []
    for m in all_metrics():
        rec = {"name": m.name, "kind": m.kind,
               "labels": dict(m.labels),
               "help": _KINDS.get(m.name, (m.kind, ""))[1]}
        if isinstance(m, Histogram):
            with m._lock:
                rec.update(bounds=list(m.buckets),
                           counts=list(m._counts), sum=m._sum,
                           count=m._count, min=m._min, max=m._max)
        else:
            rec["value"] = m.value
        mets.append(rec)
    return {"proc": proc, "pid": os.getpid(), "ts": time.time(),
            "metrics": mets}


_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _prom_name(name):
    if _NAME_OK.match(name):
        return name
    return re.sub(r"[^a-zA-Z0-9_:]", "_",
                  name if not name[:1].isdigit() else "_" + name)


def _prom_labels(labels, extra=()):
    items = list(labels.items()) + list(extra)
    if not items:
        return ""
    def esc(v):
        return str(v).replace("\\", "\\\\").replace('"', '\\"') \
            .replace("\n", "\\n")
    return "{%s}" % ",".join('%s="%s"' % (_prom_name(k), esc(v))
                             for k, v in items)


def _prom_num(v):
    if v is None:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(float(v)) if isinstance(v, float) else str(v)


def dump_prometheus(dst=None, metrics=None, kinds=None):
    """Render every metric in Prometheus text exposition format 0.0.4
    and return the text. ``dst``: None, a path string, or a writable
    stream. Series are grouped per name under one HELP/TYPE header,
    sorted for deterministic output (golden-testable).

    ``metrics``/``kinds`` render an EXPLICIT metric list instead of the
    process registry — the fleet-merged view (telemetry/aggregate.py)
    reuses this renderer so the aggregated dump cannot drift from the
    per-process format."""
    by_name = OrderedDict()
    for m in (all_metrics() if metrics is None else metrics):
        by_name.setdefault(m.name, []).append(m)
    kind_map = _KINDS if kinds is None else kinds
    lines = []
    for name in sorted(by_name):
        pname = _prom_name(name)
        kind, help = kind_map.get(name, (by_name[name][0].kind, ""))
        if help:
            lines.append("# HELP %s %s"
                         % (pname, help.replace("\\", "\\\\")
                            .replace("\n", "\\n")))
        lines.append("# TYPE %s %s" % (pname, kind))
        for m in sorted(by_name[name], key=lambda m: tuple(m.labels.items())):
            if isinstance(m, Histogram):
                for le, c in m.cumulative_buckets():
                    lines.append("%s_bucket%s %d" % (
                        pname,
                        _prom_labels(m.labels, [("le", _prom_num(le))]), c))
                lines.append("%s_sum%s %s" % (pname,
                                              _prom_labels(m.labels),
                                              _prom_num(m._sum)))
                lines.append("%s_count%s %d" % (pname,
                                                _prom_labels(m.labels),
                                                m._count))
            else:
                lines.append("%s%s %s" % (pname, _prom_labels(m.labels),
                                          _prom_num(m.value)))
    text = "\n".join(lines) + ("\n" if lines else "")
    if dst is not None:
        if hasattr(dst, "write"):
            dst.write(text)
        else:
            with open(dst, "w") as f:
                f.write(text)
    return text


# -- atexit dump --------------------------------------------------------------

def _dump_to_path(path):
    if path.endswith(".json"):
        with open(path, "w") as f:
            json.dump(dump_json(), f, indent=1)
    else:
        dump_prometheus(path)
    return path


def _atexit_dump():
    path = os.environ.get(ENV_DUMP)
    if not path:
        return
    try:
        _dump_to_path(path)
    except OSError:
        pass  # interpreter teardown: never raise


atexit.register(_atexit_dump)
