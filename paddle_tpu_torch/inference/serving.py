"""Continuous-batching generative serving (counterpart of
``GenerativeServer`` in ``paddle_tpu/inference/serving.py``).

Clients ``submit(src, prompt, ...)`` from any thread and get a
``Future``; ONE worker thread owns every device dispatch: it joins
waiting prompts into vacant slots of the live decode batch, steps the
batch, and resolves each request's future as its slot retires. Beyond
``max_queue_depth`` waiting requests ``submit`` sheds with the typed
``Overloaded``, and consecutive sheds trip a ``CircuitBreaker``; a
paged stream whose page pool cannot seat a prompt sheds that request
alone. ``close()`` flushes and rejects what it could not dispatch with
``Closed``. The dynamic-batching ``Server`` over the Program-IR
``Predictor`` is not ported yet."""

import threading
import time

import numpy as np

from ..fluid import monitor as _monitor
from ..fluid.resilience import CircuitBreaker, Closed, Overloaded

__all__ = ["Future", "GenerativeServer", "Overloaded", "Closed"]

# one device underneath every stream: serialise dispatches process-wide
_DISPATCH_LOCK = threading.Lock()


def _metrics(model):
    lbl = {"model": model}
    return {
        "requests": _monitor.counter(
            "serving_requests_total",
            help="requests accepted into the serving queue", labels=lbl),
        "shed": _monitor.counter(
            "serving_shed_total",
            help="requests shed by admission control (Overloaded)",
            labels=lbl),
        "batches": _monitor.counter(
            "serving_batches_total",
            help="coalesced batches dispatched", labels=lbl),
        "depth": _monitor.gauge(
            "serving_queue_depth",
            help="requests currently waiting in the serving queue",
            labels=lbl),
        "occupancy": _monitor.histogram(
            "serving_batch_occupancy",
            help="busy slots / decode batch width per step", labels=lbl,
            buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)),
        "wait": _monitor.histogram(
            "serving_queue_wait_seconds",
            help="submit -> dispatch queue wait", labels=lbl),
        "e2e": _monitor.histogram(
            "serving_request_seconds",
            help="submit -> future resolved end-to-end latency",
            labels=lbl),
    }


class Future:
    """Single-assignment result slot resolved by the worker thread."""

    def __init__(self):
        self._ev = threading.Event()
        self._value = None
        self._exc = None

    def done(self):
        return self._ev.is_set()

    def result(self, timeout=None):
        """Block until resolved; re-raises the worker-side exception if
        the request failed."""
        if not self._ev.wait(timeout):
            raise TimeoutError("serving future not resolved within %r s"
                               % (timeout,))
        if self._exc is not None:
            raise self._exc
        return self._value

    def _resolve(self, value):
        if not self._ev.is_set():
            self._value = value
            self._ev.set()

    def _reject(self, exc):
        if not self._ev.is_set():
            self._exc = exc
            self._ev.set()


class _Request:
    __slots__ = ("extra", "future", "t_submit")

    def __init__(self, extra):
        self.extra = extra
        self.future = Future()
        self.t_submit = time.perf_counter()


class GenerativeServer:
    """Continuous-batching server over ONE decode stream: clients
    ``submit(src, prompt, ...)``; the worker joins waiting prompts into
    vacant slots of the live decode batch and steps it, resolving each
    request's future with ``(tokens [n] int64, finished bool)`` as its
    slot retires.

    ``stream`` is a ``PagedDecodeSession``
    (``GenerativePredictor(..., paged=True).open_stream()``)."""

    def __init__(self, stream, max_queue_depth=64, breaker_threshold=16,
                 breaker_reset_s=0.25, model="generative"):
        self._stream = stream
        self._name = model
        self._max_queue_depth = int(max_queue_depth)
        self._queue = []
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._closed = False
        self._breaker = CircuitBreaker(
            failure_threshold=int(breaker_threshold),
            reset_timeout=float(breaker_reset_s),
            name="serving:%s" % model)
        self._m = _metrics(model)
        self._inflight = {}      # slot -> _Request
        self._worker = threading.Thread(
            target=self._loop, name="serve-%s" % model, daemon=True)
        self._worker.start()

    def submit(self, src, prompt, prompt_len=None, max_new_tokens=8):
        """One generation request -> Future of (tokens, finished)."""
        if not self._breaker.allow():
            self._m["shed"].inc()
            raise Overloaded(
                "model %r admission breaker is open (queue saturated); "
                "back off and retry" % self._name)
        req = _Request((np.asarray(src), np.asarray(prompt), prompt_len,
                        int(max_new_tokens)))
        with self._cv:
            if self._closed:
                raise Closed("server is closed")
            if len(self._queue) >= self._max_queue_depth:
                self._breaker.record_failure()
                self._m["shed"].inc()
                raise Overloaded(
                    "model %r queue is at its depth bound (%d waiting, "
                    "bound %d)" % (self._name, len(self._queue),
                                   self._max_queue_depth))
            self._breaker.record_success()
            self._queue.append(req)
            self._m["depth"].set(float(len(self._queue)))
            self._m["requests"].inc()
            self._cv.notify()
        return req.future

    def _loop(self):
        while True:
            with self._cv:
                while not self._queue and not self._inflight \
                        and not self._closed:
                    self._cv.wait(0.1)
                if self._closed and not self._queue and not self._inflight:
                    return
                waiting = self._queue
                self._queue = []
                self._m["depth"].set(0.0)
            try:
                self._pump(waiting)
            except BaseException as e:  # fail every rider, keep serving
                for req in waiting:
                    if not req.future.done():
                        req.future._reject(e)
                for req in self._inflight.values():
                    req.future._reject(e)
                self._inflight.clear()

    def _pump(self, waiting):
        """Join as many waiting requests as there are vacant slots, then
        step the batch once, resolving retiring slots. Leftover waiting
        requests go back to the queue head (FIFO preserved)."""
        stream, m = self._stream, self._m
        with _DISPATCH_LOCK:
            while waiting and stream.vacant_slots():
                req = waiting.pop(0)
                src, prompt, plen, budget = req.extra
                m["wait"].observe(time.perf_counter() - req.t_submit)
                try:
                    slot, done = stream.join(src, prompt, prompt_len=plen,
                                             max_new_tokens=budget)
                except Overloaded as e:
                    # the KV page pool cannot seat this prompt: shed THIS
                    # request and keep the batch alive for the others
                    m["shed"].inc()
                    req.future._reject(e)
                    continue
                if done is not None:    # finished at prefill
                    req.future._resolve(done)
                    m["e2e"].observe(time.perf_counter() - req.t_submit)
                else:
                    self._inflight[slot] = req
            completed = stream.step() if self._inflight else []
        if waiting:
            with self._cv:
                self._queue = waiting + self._queue
                m["depth"].set(float(len(self._queue)))
        t1 = time.perf_counter()
        for slot, tokens, finished in completed:
            req = self._inflight.pop(slot)
            req.future._resolve((tokens, finished))
            m["e2e"].observe(t1 - req.t_submit)
        m["batches"].inc()
        m["occupancy"].observe(
            (len(self._inflight) + len(completed)) / float(stream.width))

    def close(self, timeout=5.0):
        """Flush and stop: queued requests are still served until the
        worker exits; what it could not dispatch within ``timeout`` is
        rejected with ``Closed``. Idempotent."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout)
        with self._cv:
            leftovers, self._queue = self._queue, []
            self._m["depth"].set(0.0)
        for r in leftovers:
            r.future._reject(Closed("server closed before this request "
                                    "could be dispatched"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
