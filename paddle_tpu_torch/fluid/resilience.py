"""Failure types and the policies around them, as in
``paddle_tpu/fluid/resilience.py``, counted in the port's ``monitor``
under the same names: the serving tier's ``Overloaded``, ``Closed`` and
``CircuitBreaker``, and the input pipeline's ``TransientError`` and
bounded ``Retry`` with exponential backoff (``reader.DeviceStager``
retries a failed staging with it)."""

import random
import threading
import time

from . import monitor as _monitor

__all__ = ["Overloaded", "Closed", "CircuitBreaker", "TransientError",
           "Retry", "backoff_delay"]


def _site_counters(site):
    return (
        _monitor.counter(
            "resilience_retry_attempts_total",
            help="failed attempts that were retried (per site label)",
            labels={"site": site}),
        _monitor.counter(
            "resilience_retry_exhausted_total",
            help="Retry.call gave up: attempts/deadline exhausted or "
                 "non-retryable error",
            labels={"site": site}),
    )


class TransientError(Exception):
    """An operation failed in a way that is expected to succeed on retry
    (a queue hiccup, an injected fault). ``Retry``'s default predicate
    retries these plus ``OSError``/``ConnectionError``."""


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


def backoff_delay(attempt, base=0.1, factor=2.0, max_delay=30.0,
                  jitter=0.5, rand=random.random):
    """Exponential backoff with jitter: attempt 0 waits ~``base``, each
    further attempt multiplies by ``factor``, capped at ``max_delay``;
    ``jitter`` adds up to that fraction of the delay on top (0 makes it
    deterministic)."""
    d = min(float(max_delay), float(base) * float(factor) ** int(attempt))
    if jitter:
        d += d * float(jitter) * rand()
    return d


class Retry:
    """Bounded retry policy: ``retry.call(fn, *args)`` runs ``fn`` up to
    ``max_attempts`` times (or until ``deadline`` seconds have passed),
    sleeping ``delay(attempt)`` between failures. On exhaustion the last
    exception re-raises unchanged. ``retryable`` is an exception class,
    a tuple of them, or a predicate ``fn(exc) -> bool``; a non-retryable
    exception surfaces at once (counted as exhaustion). Stateless
    between calls, so one instance can guard every call site of a
    subsystem from any thread."""

    DEFAULT_RETRYABLE = (TransientError, OSError, ConnectionError)

    def __init__(self, max_attempts=3, base_delay=0.1, factor=2.0,
                 max_delay=30.0, deadline=None, jitter=0.5,
                 retryable=None, name="retry", sleep=time.sleep,
                 clock=time.monotonic):
        if int(max_attempts) < 1:
            raise ValueError("max_attempts must be >= 1, got %r"
                             % (max_attempts,))
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.factor = float(factor)
        self.max_delay = float(max_delay)
        self.deadline = None if deadline is None else float(deadline)
        self.jitter = float(jitter)
        self.name = name
        self._sleep = sleep
        self._clock = clock
        if retryable is None:
            retryable = self.DEFAULT_RETRYABLE
        if isinstance(retryable, type) and issubclass(retryable,
                                                      BaseException):
            retryable = (retryable,)
        if isinstance(retryable, tuple):
            classes = retryable
            self._retryable = lambda e: isinstance(e, classes)
        elif callable(retryable):
            self._retryable = retryable
        else:
            raise TypeError(
                "retryable must be an exception class, a tuple of them, "
                "or a predicate fn(exc) -> bool; got %r" % (retryable,))
        self._m_attempts, self._m_exhausted = _site_counters(name)

    def delay(self, attempt):
        """Seconds to sleep after failed attempt ``attempt`` (0-based)."""
        return backoff_delay(attempt, self.base_delay, self.factor,
                             self.max_delay, self.jitter)

    def call(self, fn, *args, **kwargs):
        t0 = self._clock()
        for attempt in range(self.max_attempts):
            try:
                return fn(*args, **kwargs)
            except BaseException as e:  # re-raised unless retryable
                if not self._retryable(e):
                    self._m_exhausted.inc()
                    raise
                last = attempt == self.max_attempts - 1
                if not last:
                    d = self.delay(attempt)
                    last = (self.deadline is not None and
                            self._clock() - t0 + d > self.deadline)
                if last:
                    self._m_exhausted.inc()
                    raise
                self._m_attempts.inc()
                self._sleep(d)
        raise AssertionError("unreachable")
