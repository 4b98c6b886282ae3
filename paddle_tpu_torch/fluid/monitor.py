"""Process-wide metrics registry: the Counter/Gauge/Histogram subset of
``paddle_tpu/fluid/monitor.py`` that the decode and serving modules call,
with the same metric names and semantics. Lock-protected and
label-aware; tests assert deltas of a metric's value."""

import bisect
import contextlib
import threading
import time
from collections import OrderedDict

__all__ = ["Counter", "Gauge", "Histogram", "counter", "gauge",
           "histogram", "default_buckets"]

_LOCK = threading.Lock()          # registry structure
_REGISTRY = OrderedDict()         # (name, labels_tuple) -> metric
_KINDS = {}                       # name -> kind


def default_buckets(start=1e-6, factor=4.0, count=14):
    """Fixed log-scale bucket upper bounds ``start * factor**i``
    (1 us .. ~67 s by default)."""
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


class Counter(_Metric):
    """Monotonic count."""

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


class Gauge(_Metric):
    """Point-in-time value."""

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

    @contextlib.contextmanager
    def track(self, n=1):
        """``inc(n)`` for the body's duration, ``dec(n)`` after, also
        when it raises (an in-flight count)."""
        self.inc(n)
        try:
            yield self
        finally:
            self.dec(n)

    @property
    def value(self):
        return self._value


class Histogram(_Metric):
    """Fixed log-scale buckets + sum/count/min/max."""

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

    @contextlib.contextmanager
    def time(self):
        """Observe the seconds the body takes."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0)

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def quantile(self, q):
        """Approximate q-quantile (0 <= q <= 1) interpolated from the
        fixed buckets, clamped to the observed min/max. Values in the
        +Inf overflow bucket report the observed max. None while
        empty."""
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
        return mx


def _get_or_create(cls, name, labels, **kw):
    key = (name, _labels_key(labels))
    with _LOCK:
        known = _KINDS.setdefault(name, cls.kind)
        if known != cls.kind:
            raise ValueError("metric %r already registered as a %s "
                             "(wanted %s)" % (name, known, cls.kind))
        m = _REGISTRY.get(key)
        if m is None:
            m = _REGISTRY[key] = cls(name, labels=key[1], **kw)
        return m


def counter(name, help="", labels=None):
    """Get-or-create the Counter for (name, labels). ``help`` documents
    the metric at its call site."""
    return _get_or_create(Counter, name, labels)


def gauge(name, help="", labels=None):
    """Get-or-create the Gauge for (name, labels)."""
    return _get_or_create(Gauge, name, labels)


def histogram(name, help="", labels=None, buckets=None):
    """Get-or-create the Histogram for (name, labels). ``buckets`` is
    honoured on first creation only."""
    return _get_or_create(Histogram, name, labels, buckets=buckets)

