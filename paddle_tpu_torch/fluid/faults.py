"""Deterministic fault injection at named points (the port's copy of
``paddle_tpu/fluid/faults.py``, with the points the port has so far).

Code is instrumented with a one-line ``faults.check("io.write")`` where
a real failure would bite. An unarmed point costs a dict lookup; an
armed one counts its hits and fires on the Nth
(``arm(point, after_n=, times=)``): it raises, by default
``FaultInjected``, a ``resilience.TransientError``, so a point wrapped
in a ``Retry`` shows it absorbs the failure. ``worker.preempt`` sends
this process a real SIGTERM instead (the eviction notice
``distributed.preemption`` drains on), and ``take`` reports a fire
without raising (the executor's ``step.nonfinite``). Every fire is
counted as ``faults_injected_total`` by point. The ``coord.*`` points
are the coordination service's; the reference's other points
(``ps.rpc``, ``worker.exit``, ``worker.hang``) come with the rest of the
distributed runtime (ROADMAP queue 1 item 8).
"""

import os
import threading

from . import monitor as _monitor
from .resilience import TransientError

__all__ = ["FaultInjected", "POINTS", "arm", "disarm", "reset",
           "is_armed", "hits", "check", "take"]

POINTS = (
    "io.write",        # fluid/core/tensor_io.save_combine and the
                       #   checkpoint writer: after the temporary write,
                       #   before the rename that commits it
    "reader.stage",    # fluid/reader.stage_feed: inside the DeviceStager
                       #   producer thread, before the device copy
    "coord.rpc",       # distributed/coordination.CoordClient: before
                       #   each coordination-service round-trip
    "coord.crash",     # distributed/coordination.CoordServer: taken in
                       #   the serve loop — the server dies mid-request
                       #   (crash(): no final snapshot, WAL-only state)
    "coord.partition", # distributed/coordination._CoordConn: each armed
                       #   hit fails one client attempt transiently — a
                       #   network partition of exactly N attempts
    "step.nonfinite",  # the executor's anomaly scan: the step's results
                       #   are taken as non-finite (the policy path
                       #   without a diverging model)
    "worker.preempt",  # training scripts call check() once a step; sends
                       #   SIGTERM to this process
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


def _fire(point):
    """Count a hit; the armed exception class if this hit fires, else
    None."""
    with _LOCK:
        f = _ARMED.get(point)
        if f is None:
            return None
        f.hits += 1
        if not (f.hits > f.after_n and f.fired < f.times):
            return None
        f.fired += 1
        exc = f.exc
    _monitor.counter("faults_injected_total",
                     help="injected faults fired, by injection point",
                     labels={"point": point}).inc()
    return exc


def check(point):
    """The injection point: a no-op unless armed and due. Then
    ``worker.preempt`` sends this process SIGTERM (the drain handler
    decides what follows) and every other point raises the armed
    exception class."""
    exc = _fire(point)
    if exc is None:
        return
    if point == "worker.preempt":
        import signal

        os.kill(os.getpid(), signal.SIGTERM)
        return
    raise exc("injected fault at %r" % point)


def take(point):
    """Like ``check``, but returns whether the point fired instead of
    raising: for sites that inject a condition (``step.nonfinite``)."""
    return _fire(point) is not None
