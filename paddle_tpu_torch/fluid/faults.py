"""Deterministic fault injection at named points (the port's copy of
``paddle_tpu/fluid/faults.py``, with the points the port has so far).

Code is instrumented with a one-line ``faults.check("reader.stage")``
where a real failure would bite. An unarmed point costs a dict lookup;
an armed one counts its hits and raises on the Nth
(``arm(point, after_n=, times=)``), by default ``FaultInjected``, a
``resilience.TransientError``, so a point wrapped in a ``Retry`` shows
it absorbs the failure. Every fire is counted as
``faults_injected_total`` by point. The reference's other points
(checkpoint writes, RPCs, worker crashes) come with the modules that
hold them.
"""

import threading

from . import monitor as _monitor
from .resilience import TransientError

__all__ = ["FaultInjected", "POINTS", "arm", "disarm", "reset",
           "is_armed", "hits", "check"]

POINTS = (
    "reader.stage",    # fluid/reader.stage_feed: inside the DeviceStager
                       #   producer thread, before the device copy
)


class FaultInjected(TransientError):
    """Default injected failure: transient, so retry layers absorb it."""


class _Fault:
    __slots__ = ("after_n", "times", "exc", "hits", "fired")

    def __init__(self, after_n, times, exc):
        self.after_n = int(after_n)
        self.times = int(times)
        self.exc = exc
        self.hits = 0
        self.fired = 0


_LOCK = threading.Lock()
_ARMED = {}


def arm(point, after_n=0, times=1, exc=FaultInjected):
    """The first ``after_n`` hits of ``point`` pass, the next ``times``
    raise ``exc``, later ones pass again."""
    if point not in POINTS:
        raise ValueError("unknown fault point %r; known: %s"
                         % (point, ", ".join(POINTS)))
    with _LOCK:
        _ARMED[point] = _Fault(after_n, times, exc)


def disarm(point):
    with _LOCK:
        _ARMED.pop(point, None)


def reset():
    """Disarm every point."""
    with _LOCK:
        _ARMED.clear()


def is_armed(point):
    return point in _ARMED


def hits(point):
    """Hits since arming (0 when not armed)."""
    with _LOCK:
        f = _ARMED.get(point)
        return f.hits if f is not None else 0


def check(point):
    """The injection point: a no-op unless armed and due, then raises
    the armed exception class."""
    with _LOCK:
        f = _ARMED.get(point)
        if f is None:
            return
        f.hits += 1
        if not (f.hits > f.after_n and f.fired < f.times):
            return
        f.fired += 1
        exc = f.exc
    _monitor.counter("faults_injected_total",
                     help="injected faults fired, by injection point",
                     labels={"point": point}).inc()
    raise exc("injected fault at %r" % point)
