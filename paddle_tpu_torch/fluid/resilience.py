"""The serving tier's failure types and admission breaker: ``Overloaded``,
``Closed`` and ``CircuitBreaker`` as in ``paddle_tpu/fluid/resilience.py``,
counted in the port's ``monitor`` under the same names."""

import threading
import time

from . import monitor as _monitor

__all__ = ["Overloaded", "Closed", "CircuitBreaker"]


class Overloaded(RuntimeError):
    """Admission control shed this request: a queue is at its depth
    bound, the admission breaker is open, or the KV page pool cannot
    seat the prompt. The client should back off, not retry at once.
    Carries no partial state."""


class Closed(RuntimeError):
    """The target was shut down deliberately and this operation arrived
    after the fact; retrying against the same instance cannot succeed."""


class CircuitBreaker:
    """Three-state breaker. CLOSED: calls pass; ``failure_threshold``
    consecutive failures trip it OPEN. OPEN: calls are rejected until
    ``reset_timeout`` seconds pass. HALF_OPEN: one probe is let through
    — success closes the breaker, failure re-opens it. Callers use the
    ``allow()`` / ``record_success()`` / ``record_failure()`` trio.
    Thread-safe."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold=5, reset_timeout=30.0,
                 name="breaker", clock=time.monotonic):
        if int(failure_threshold) < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout = float(reset_timeout)
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = None
        self._probing = False
        self._m_trips = _monitor.counter(
            "resilience_breaker_trips_total",
            help="breaker transitions into the open state",
            labels={"site": name})
        self._m_rejected = _monitor.counter(
            "resilience_breaker_rejected_total",
            help="calls short-circuited while the breaker was open",
            labels={"site": name})

    @property
    def state(self):
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self):
        # caller holds the lock
        if self._state == self.OPEN and \
                self._clock() - self._opened_at >= self.reset_timeout:
            self._state = self.HALF_OPEN

    def allow(self):
        """True if a call may proceed. The HALF_OPEN probe is single-shot:
        a second concurrent caller is rejected until it resolves."""
        with self._lock:
            self._maybe_half_open()
            if self._state == self.CLOSED:
                return True
            if self._state == self.HALF_OPEN and not self._probing:
                self._probing = True
                return True
            self._m_rejected.inc()
            return False

    def record_success(self):
        with self._lock:
            self._state = self.CLOSED
            self._failures = 0
            self._probing = False

    def record_failure(self):
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._state == self.HALF_OPEN or \
                    self._failures >= self.failure_threshold:
                if self._state != self.OPEN:
                    self._m_trips.inc()
                self._state = self.OPEN
                self._opened_at = self._clock()
