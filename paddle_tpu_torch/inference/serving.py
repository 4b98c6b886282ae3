"""In-process serving: dynamic request batching over ``Predictor``
(``Server``) and continuous decode batching over a paged decode stream
(``GenerativeServer``); the counterparts of
``paddle_tpu/inference/serving.py``.

``Server``: concurrent clients ``submit(model, feed)`` into a per-model
queue and get a ``Future``; one worker thread per model pops the
head-of-line signature group (priority, then earliest deadline, then
FIFO), stacks its rows into one batch and pads it, by repeating the last
row, up to the power-of-two ladder (1, 2, 4, ..., ``max_batch_size``),
so every request size maps onto ``len(ladder)`` batch shapes, which
``register(warmup_feed=)`` runs twice each before traffic: on the card
the predictor's executor runs a new shape once op by op and captures it
into a CUDA graph at the second run, so traffic only replays graphs. A batch
closes when it is full, when its oldest request has waited
``max_queue_delay_ms``, or a service-time margin before the earliest
``deadline_ms`` of its riders; a request whose deadline passes in the
queue is shed with ``Overloaded`` unrun.

``GenerativeServer``: ONE worker thread joins waiting prompts into
vacant slots of the live decode batch, steps the batch, and resolves
each request's future as its slot retires; a paged stream whose page
pool cannot seat a prompt sheds that request alone.

Both: beyond ``max_queue_depth`` waiting rows (requests, for the
generative server) ``submit`` sheds with the typed ``Overloaded``, and
consecutive sheds trip a ``CircuitBreaker``; ``close()`` flushes the
queues through the workers, rejects what they could not dispatch with
``Closed``, and is idempotent; ``submit`` after it raises ``Closed``.
One module-level ``_DISPATCH_LOCK`` serialises every dispatch onto the
one card; each worker launches on its own thread's current stream.
The series ``serving_*`` are labelled by model; the warm-up counts the
compile-cache disk hits its ladder made (``serving_warmup_disk_hits_total``:
steps loaded from ``__prelowered__/`` or the persistent cache instead of
built).

Telemetry (``telemetry.enabled()``): ``submit`` captures the caller's
trace; the worker records each traced rider's ``serving.queue_wait`` and
runs the batch inside ONE ``serving.batch`` span, parented into the
first traced rider's trace and linked to every rider's, so the
executor's ``executor.run`` span nests under it.
"""

import threading
import time

import numpy as np

from .. import telemetry as _telemetry
from ..fluid import compile_cache as _compile_cache
from ..fluid import monitor as _monitor
from ..fluid.resilience import CircuitBreaker, Closed, Overloaded

__all__ = ["Future", "ServeConfig", "Server", "GenerativeServer",
           "Overloaded", "Closed"]

# one device underneath every model and stream: serialise dispatches
# process-wide
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
            help="real rows / padded batch rows per dispatch (Server), "
                 "busy slots / decode batch width per step "
                 "(GenerativeServer)", labels=lbl,
            buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)),
        "wait": _monitor.histogram(
            "serving_queue_wait_seconds",
            help="submit -> dispatch queue wait", labels=lbl),
        "e2e": _monitor.histogram(
            "serving_request_seconds",
            help="submit -> future resolved end-to-end latency",
            labels=lbl),
        "warmup_seconds": _monitor.histogram(
            "serving_warmup_seconds",
            help="register() warm-up ladder wall time (one sample per "
                 "register call)", labels=lbl),
        "warmup_disk_hits": _monitor.counter(
            "serving_warmup_disk_hits_total",
            help="warm-up ladder steps served by the persistent compile "
                 "cache (plan and kernel libraries loaded from disk "
                 "instead of built)", labels=lbl),
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
    __slots__ = ("feed", "rows", "sig", "future", "t_submit", "extra",
                 "deadline", "priority", "trace")

    def __init__(self, feed=None, rows=1, sig=None, extra=None,
                 deadline_ms=None, priority=0, trace=None):
        self.feed = feed
        self.rows = rows
        self.sig = sig
        self.future = Future()
        self.t_submit = time.perf_counter()
        self.extra = extra
        self.deadline = None if deadline_ms is None \
            else self.t_submit + float(deadline_ms) / 1000.0
        self.priority = int(priority)
        self.trace = trace


class ServeConfig:
    """Per-model knobs of ``Server``.

    max_batch_size      dispatch as soon as this many rows share a
                        signature (also the top of the bucket ladder).
    max_queue_delay_ms  oldest-request wait before a partial batch
                        dispatches anyway: the latency/occupancy dial.
    max_queue_depth     admission bound in rows; past it submit sheds
                        with Overloaded.
    pad_value           fill of the trailing dims ``bucket_dims`` pads
                        (the batch dim repeats its last row).
    bucket_dims         {feed_name: (dim, ...)} trailing dims padded to
                        the next power of two at submit; None keeps
                        exact non-batch shapes per signature.
    breaker_threshold / breaker_reset_s
                        consecutive sheds that trip the admission breaker
                        open, and its hysteresis window.
    priority            default request priority (higher dispatches
                        first across waiting signatures).
    deadline_ms         default per-request budget from submit to
                        resolved future: the batch closes a
                        service-time margin before the earliest deadline
                        of its riders, and queued requests past their
                        deadline are shed. None keeps the fixed delay.
    """

    def __init__(self, max_batch_size=8, max_queue_delay_ms=2.0,
                 max_queue_depth=64, pad_value=0.0, bucket_dims=None,
                 breaker_threshold=16, breaker_reset_s=0.25,
                 priority=0, deadline_ms=None):
        if int(max_batch_size) < 1:
            raise ValueError("max_batch_size must be >= 1")
        if int(max_queue_depth) < 1:
            raise ValueError("max_queue_depth must be >= 1")
        if deadline_ms is not None and float(deadline_ms) <= 0:
            raise ValueError("deadline_ms must be positive when set")
        self.max_batch_size = int(max_batch_size)
        self.max_queue_delay_ms = float(max_queue_delay_ms)
        self.max_queue_depth = int(max_queue_depth)
        self.pad_value = pad_value
        self.bucket_dims = dict(bucket_dims or {})
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_reset_s = float(breaker_reset_s)
        self.priority = int(priority)
        self.deadline_ms = None if deadline_ms is None \
            else float(deadline_ms)

    def ladder(self):
        """The power-of-two batch sizes this model runs at."""
        sizes = []
        b = 1
        while b < self.max_batch_size:
            sizes.append(b)
            b <<= 1
        sizes.append(self.max_batch_size)
        return sizes


def _pow2ceil(n):
    return 1 << (int(n) - 1).bit_length() if n > 1 else 1


def _bucket_pad(arr, dims, pad_value):
    """Pad ``arr``'s listed trailing dims up to the next power of two."""
    arr = np.asarray(arr)
    pads = [(0, 0)] * arr.ndim
    changed = False
    for d in dims:
        if d == 0:
            raise ValueError("bucket_dims pads feature dims; the batch "
                             "dim (0) is always bucketed by the server")
        want = _pow2ceil(arr.shape[d])
        if want != arr.shape[d]:
            pads[d] = (0, want - arr.shape[d])
            changed = True
    if not changed:
        return arr
    return np.pad(arr, pads, constant_values=pad_value)


def _sched_key(r):
    """Head-of-line order: highest priority, then earliest deadline
    (requests without one after any with one), then FIFO."""
    return (-r.priority,
            r.deadline if r.deadline is not None else float("inf"),
            r.t_submit)


class _ModelEntry:
    def __init__(self, name, predictor, config):
        self.name = name
        self.predictor = predictor
        self.config = config
        self.queue = []
        self.rows_queued = 0
        self.service_est = 0.0   # dispatch-wall EWMA, the deadline margin
        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)
        self.breaker = CircuitBreaker(
            failure_threshold=config.breaker_threshold,
            reset_timeout=config.breaker_reset_s,
            name="serving:%s" % name)
        self.metrics = _metrics(name)
        self.worker = None


class Server:
    """Multi-model dynamic-batching server over ``Predictor``s.

    ::

        srv = Server()
        srv.register("enc", predictor, config=ServeConfig(max_batch_size=8),
                     warmup_feed={"x": one_row})
        fut = srv.submit("enc", {"x": rows})    # any client thread
        outs = fut.result(timeout=30)           # numpy fetches, sliced
        srv.close()

    Requests whose feeds share a signature after bucketing (feed names,
    dtypes, non-batch shapes) coalesce; a request may carry several rows
    (its feeds' common leading dim) up to ``max_batch_size``.
    """

    def __init__(self, service=None):
        self._models = {}
        self._closed = False
        self._lock = threading.Lock()
        # telemetry lane name for batcher-side spans (a Replica passes
        # "replica:<id>"; in-process embedders default to the ambient)
        self.service = service

    # -- registration ------------------------------------------------------
    def register(self, name, predictor, config=None, warmup_feed=None):
        """Host ``predictor`` under ``name``. ``warmup_feed`` is ONE
        exemplar row ({feed_name: [1, ...] array}); when given, every
        ladder batch size runs twice before the worker starts (a warm
        run, then the run that captures its CUDA graph on the card).
        Returns the ladder."""
        config = config or ServeConfig()
        with self._lock:
            if self._closed:
                raise Closed("server is closed")
            if name in self._models:
                raise ValueError("model %r already registered" % name)
            entry = _ModelEntry(name, predictor, config)
            self._models[name] = entry
        if warmup_feed is not None:
            self._warmup(entry, warmup_feed)
        entry.worker = threading.Thread(
            target=self._worker_loop, args=(entry,),
            name="serve-%s" % name, daemon=True)
        entry.worker.start()
        return entry.config.ladder()

    def _warmup(self, entry, warmup_feed):
        exemplar = {n: np.asarray(v) for n, v in warmup_feed.items()}
        for n, v in exemplar.items():
            if v.ndim < 1 or v.shape[0] != 1:
                raise ValueError(
                    "warmup_feed[%r] must be one exemplar row "
                    "[1, ...], got shape %r" % (n, v.shape))
        t0 = time.perf_counter()
        disk_hits0 = _compile_cache.disk_hit_count()
        with _DISPATCH_LOCK:
            for b in entry.config.ladder():
                batch = {n: np.repeat(_bucket_pad(
                    v, entry.config.bucket_dims.get(n, ()),
                    entry.config.pad_value), b, axis=0)
                    for n, v in exemplar.items()}
                for _ in range(2):
                    entry.predictor.run(batch)
        entry.metrics["warmup_seconds"].observe(time.perf_counter() - t0)
        skipped = _compile_cache.disk_hit_count() - disk_hits0
        if skipped:
            entry.metrics["warmup_disk_hits"].inc(skipped)

    # -- client side -------------------------------------------------------
    def submit(self, model, feed, deadline_ms=None, priority=None):
        """Enqueue one request; returns a ``Future`` of the predictor's
        fetch list sliced to this request's rows. Sheds with
        ``Overloaded`` past the admission bound, or when ``deadline_ms``
        (default ``ServeConfig.deadline_ms``) has already passed.
        ``priority`` (default ``ServeConfig.priority``) jumps the
        head-of-line queue."""
        entry = self._models[model]
        cfg, m = entry.config, entry.metrics
        if deadline_ms is None:
            deadline_ms = cfg.deadline_ms
        if priority is None:
            priority = cfg.priority
        if deadline_ms is not None and float(deadline_ms) <= 0:
            m["shed"].inc()
            raise Overloaded(
                "model %r request arrived with an expired deadline "
                "(%.3f ms)" % (model, float(deadline_ms)))
        if not entry.breaker.allow():
            m["shed"].inc()
            raise Overloaded(
                "model %r admission breaker is open (queue saturated); "
                "back off and retry" % model)
        feed = {n: _bucket_pad(np.asarray(v), cfg.bucket_dims.get(n, ()),
                               cfg.pad_value)
                for n, v in feed.items()}
        rows = {int(np.shape(v)[0]) for v in feed.values()}
        if len(rows) != 1:
            raise ValueError(
                "all feeds must share one leading (batch) dim; got %r"
                % {n: np.shape(v) for n, v in feed.items()})
        rows = rows.pop()
        if not 1 <= rows <= cfg.max_batch_size:
            raise ValueError(
                "request rows must be in [1, max_batch_size=%d], got %d"
                % (cfg.max_batch_size, rows))
        sig = tuple(sorted((n, str(v.dtype), v.shape[1:])
                           for n, v in feed.items()))
        req = _Request(feed, rows, sig, deadline_ms=deadline_ms,
                       priority=priority,
                       trace=_telemetry.current()
                       if _telemetry.enabled() else None)
        with entry.cv:
            if self._closed:
                raise Closed("server is closed")
            if entry.rows_queued + rows > cfg.max_queue_depth:
                entry.breaker.record_failure()
                m["shed"].inc()
                raise Overloaded(
                    "model %r queue is at its depth bound (%d rows "
                    "waiting, bound %d)" % (model, entry.rows_queued,
                                            cfg.max_queue_depth))
            entry.breaker.record_success()
            entry.queue.append(req)
            entry.rows_queued += rows
            m["depth"].set(float(entry.rows_queued))
            m["requests"].inc()
            entry.cv.notify()
        return req.future

    # -- batcher worker ----------------------------------------------------
    @staticmethod
    def _group_close_at(entry, group):
        """When the head group must stop coalescing: its oldest request
        plus ``max_queue_delay_ms``, or, earlier, ``service_est`` (the
        dispatch-wall EWMA, at least 5 ms) before its earliest deadline.
        A deadline only ever pulls the close forward."""
        delay = entry.config.max_queue_delay_ms / 1000.0
        cands = [min(r.t_submit for r in group) + delay]
        with_dl = [r.deadline for r in group if r.deadline is not None]
        if with_dl:
            cands.append(min(with_dl) - max(entry.service_est, 0.005))
        return min(cands)

    def _worker_loop(self, entry):
        cfg, m = entry.config, entry.metrics
        while True:
            with entry.cv:
                while not entry.queue and not self._closed:
                    entry.cv.wait(0.1)
                if self._closed and not entry.queue:
                    return
                # head and close time are recomputed on every wake, so a
                # newly arrived tighter request re-aims the batch
                while True:
                    now = time.perf_counter()
                    head = min(entry.queue, key=_sched_key)
                    group = [r for r in entry.queue if r.sig == head.sig]
                    avail = sum(r.rows for r in group)
                    close_at = self._group_close_at(entry, group)
                    if avail >= cfg.max_batch_size or now >= close_at \
                            or self._closed:
                        break
                    entry.cv.wait(close_at - now)
                now = time.perf_counter()
                group.sort(key=_sched_key)
                batch, expired, overflow, total = [], [], [], 0
                for r in group:
                    if r.deadline is not None and now > r.deadline:
                        expired.append(r)
                    elif total + r.rows <= cfg.max_batch_size:
                        batch.append(r)
                        total += r.rows
                    else:
                        overflow.append(r)
                entry.queue = [r for r in entry.queue
                               if r.sig != head.sig] + overflow
                entry.rows_queued -= total + sum(r.rows for r in expired)
                m["depth"].set(float(entry.rows_queued))
            for r in expired:
                m["shed"].inc()
                r.future._reject(Overloaded(
                    "model %r request deadline expired after %.1f ms in "
                    "queue; shed without dispatch"
                    % (entry.name, (now - r.t_submit) * 1000.0)))
            if batch:
                self._dispatch(entry, batch, total)

    def _dispatch(self, entry, batch, total):
        m = entry.metrics
        t0 = time.perf_counter()
        traced = [r for r in batch if r.trace is not None] \
            if _telemetry.enabled() else []
        for r in batch:
            m["wait"].observe(t0 - r.t_submit)
        for r in traced:
            # the queue-wait interval the batcher just measured, as a
            # fresh CHILD span in the request's own trace (the request
            # span keeps its identity for the batch span's links)
            _telemetry.record_span(
                "serving.queue_wait", r.t_submit, t0 - r.t_submit,
                _telemetry.child_of(r.trace), service=self.service,
                attrs={"model": entry.name})
        padded = min(_pow2ceil(total), entry.config.max_batch_size)
        if traced:
            # ONE batch span for the fan-in: parented into the first
            # rider's trace, LINKED to every request span that rode in
            # it, ambient so the executor span nests under it
            with _telemetry.span(
                    "serving.batch", parent=traced[0].trace,
                    service=self.service,
                    links=[r.trace for r in traced],
                    attrs={"model": entry.name,
                           "requests": len(batch), "rows": total,
                           "padded": padded}):
                self._run_batch(entry, batch, total, padded, t0)
        else:
            self._run_batch(entry, batch, total, padded, t0)

    def _run_batch(self, entry, batch, total, padded, t0):
        m = entry.metrics
        try:
            feed = {}
            for n in batch[0].feed:
                stack = np.concatenate([r.feed[n] for r in batch], axis=0)
                if padded > total:
                    # repeat the last row: values stay in their domain
                    # (pad_value could be an invalid embedding id)
                    fill = np.repeat(stack[-1:], padded - total, axis=0)
                    stack = np.concatenate([stack, fill], axis=0)
                feed[n] = stack
            with _DISPATCH_LOCK:
                outs = entry.predictor.run(feed)
            outs = [np.asarray(o) for o in outs]
        except BaseException as e:  # resolve every rider, keep serving
            for r in batch:
                r.future._reject(e)
            return
        m["batches"].inc()
        m["occupancy"].observe(total / float(padded))
        t1 = time.perf_counter()
        # a heavy weight on the newest sample tracks warm/cold changes
        # fast without whiplashing on one outlier
        dt = t1 - t0
        entry.service_est = dt if entry.service_est == 0.0 \
            else 0.5 * entry.service_est + 0.5 * dt
        off = 0
        for r in batch:
            r.future._resolve([o[off:off + r.rows] if np.ndim(o) >= 1
                               and np.shape(o)[0] == padded else o
                               for o in outs])
            off += r.rows
            m["e2e"].observe(t1 - r.t_submit)

    # -- lifecycle ---------------------------------------------------------
    def close(self, timeout=5.0):
        """Flush and stop: each worker drains its queue through the
        normal dispatch path before it exits; requests not dispatched
        within ``timeout`` are rejected with ``Closed``. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            models = list(self._models.values())
        for entry in models:
            with entry.cv:
                entry.cv.notify_all()
        for entry in models:
            if entry.worker is not None:
                entry.worker.join(timeout)
        for entry in models:
            with entry.cv:
                leftovers, entry.queue = entry.queue, []
                entry.rows_queued = 0
                entry.metrics["depth"].set(0.0)
            for r in leftovers:
                r.future._reject(Closed("server closed before this "
                                        "request could be dispatched"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class GenerativeServer:
    """Continuous-batching server over ONE decode stream: clients
    ``submit(src, prompt, ...)``; the worker joins waiting prompts into
    vacant slots of the live decode batch and steps it, resolving each
    request's future with ``(tokens [n] int64, finished bool)`` as its
    slot retires, so the batch never drains to serve a new arrival.

    ``stream`` is any ``GenerativePredictor.open_stream()``: the dense
    ``ContinuousDecodeSession`` (``slot_prefill=True``) or the
    ``PagedDecodeSession`` (``paged=True``). Both take the same
    join/step contract; a join is made only into a vacant slot, so the
    dense stream's RuntimeError for a full batch never reaches a client,
    while the paged stream's typed ``Overloaded`` (the page pool cannot
    seat the prompt) sheds that one request."""

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
        req = _Request(extra=(np.asarray(src), np.asarray(prompt),
                              prompt_len, int(max_new_tokens)))
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
