"""Per-process span buffer + merged multi-process chrome-trace export.

``span(name)`` records into a bounded ring (``deque(maxlen)``, newest
kept — the flight recorder wants the LAST seconds, matching the
profiler's ring policy). Spans are appended at START, open (``dur``
None) until the context exits, so a crash dump shows the in-flight
request, not just completed ones. Timestamps reuse the profiler's
perf_counter->unix anchor so host spans, executor profiler events, and
the profiler's device trace all land on one clock.

Export: ``export_trace(path)`` writes a chrome://tracing JSON where
every distinct (pid, service) pair gets its own pid lane — in a real
fleet that is one lane per process; in an in-process test fleet
(client + router + replicas in one pid) the service name still
separates the lanes. ``trace_spans(trace_id)`` / ``export_trace(path,
trace_id=...)`` give the per-trace lookup.
"""

import json
import os
import threading
import time
from collections import OrderedDict, deque

from ..fluid import monitor as _monitor
from ..fluid import profiler as _profiler
from . import context as _context

__all__ = ["span", "record_span", "snapshot", "clear", "set_max_spans",
           "dropped_span_count", "trace_spans", "export_trace",
           "merge_chrome_events"]

ENV_MAX_SPANS = "PADDLE_TELEMETRY_MAX_SPANS"

_LOCK = threading.Lock()
_MAX = int(os.environ.get(ENV_MAX_SPANS, 65536) or 65536)
_BUF = deque(maxlen=max(_MAX, 1))
_DROPPED = [0]

_M_SPANS = _monitor.counter(
    "telemetry_spans_total", help="trace spans recorded in this process")
_M_DROPPED = _monitor.counter(
    "telemetry_dropped_spans_total",
    help="trace spans evicted from the bounded span ring (oldest-out)")


def _unix_now():
    pc0, unix0 = _profiler._EPOCH_ANCHOR
    return time.perf_counter() - pc0 + unix0


def set_max_spans(n):
    """Resize the ring (tests); keeps the newest spans."""
    global _BUF
    with _LOCK:
        _BUF = deque(_BUF, maxlen=max(int(n), 1))


def dropped_span_count():
    return _DROPPED[0]


def _append(rec):
    with _LOCK:
        if len(_BUF) == _BUF.maxlen:
            _DROPPED[0] += 1
            _M_DROPPED.inc()
        _BUF.append(rec)
    _M_SPANS.inc()


def _make_record(name, ctx, service, t_start, dur=None, links=None,
                 attrs=None):
    rec = {"name": name, "service": service, "pid": os.getpid(),
           "tid": threading.get_ident() & 0xFFFFFFFF,
           "ts": t_start, "dur": dur,
           "trace_id": ctx.trace_id, "span_id": ctx.span_id,
           "parent_id": ctx.parent_id}
    if links:
        rec["links"] = [{"trace_id": l.trace_id, "span_id": l.span_id}
                        for l in links]
    if attrs:
        rec["attrs"] = dict(attrs)
    return rec


class _SpanScope:
    """The ``with span(...)`` body: records an OPEN span at entry,
    closes it (fills ``dur``) at exit, and keeps the child context +
    (optionally) the service ambient for everything nested."""

    __slots__ = ("_name", "_parent", "_service", "_links", "_attrs",
                 "_ctx_token", "_svc_token", "_rec", "_t0", "ctx")

    def __init__(self, name, parent, service, links, attrs):
        self._name = name
        self._parent = parent
        self._service = service
        self._links = links
        self._attrs = attrs
        self._ctx_token = self._svc_token = self._rec = None
        self.ctx = None

    def __enter__(self):
        parent = self._parent if self._parent is not None \
            else _context.current()
        self.ctx = _context.child_of(parent)
        self._ctx_token = _context.attach(self.ctx)
        if self._service is not None:
            self._svc_token = _context._SERVICE.set(self._service)
        service = self._service or _context.current_service()
        self._t0 = time.perf_counter()
        if self.ctx.sampled:
            self._rec = _make_record(self._name, self.ctx, service,
                                     _unix_now(), dur=None,
                                     links=self._links, attrs=self._attrs)
            _append(self._rec)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._rec is not None:
            self._rec["dur"] = time.perf_counter() - self._t0
            if exc_type is not None:
                self._rec.setdefault("attrs", {})["error"] = \
                    exc_type.__name__
        if self._svc_token is not None:
            _context._SERVICE.reset(self._svc_token)
        _context.detach(self._ctx_token)
        return False


def span(name, parent=None, service=None, links=None, attrs=None):
    """Context manager recording one span as a child of ``parent`` (or
    the ambient context; a fresh root when neither exists). ``service``
    names the chrome pid lane AND becomes ambient for nested spans.
    ``links`` (TraceContexts) mark fan-in: one batch span links the N
    request spans that rode in it."""
    return _SpanScope(name, parent, service, links, attrs)


def record_span(name, t_start_perf, dur, ctx, service=None, links=None,
                attrs=None):
    """Record an already-measured span (queue-wait intervals measured
    by the batcher). ``t_start_perf`` is a ``time.perf_counter()``
    reading; ``dur`` in seconds."""
    if ctx is None or not ctx.sampled:
        return None
    pc0, unix0 = _profiler._EPOCH_ANCHOR
    rec = _make_record(name, ctx, service or _context.current_service(),
                       t_start_perf - pc0 + unix0, dur=float(dur),
                       links=links, attrs=attrs)
    _append(rec)
    return rec


def snapshot(limit=None):
    """Copy of the ring (oldest->newest), optionally the newest
    ``limit`` only. Open spans carry ``dur`` None."""
    with _LOCK:
        recs = list(_BUF)
    if limit is not None:
        recs = recs[-int(limit):]
    return [dict(r) for r in recs]


def clear():
    with _LOCK:
        _BUF.clear()
        _DROPPED[0] = 0


def trace_spans(trace_id, spans=None):
    """All recorded spans of one trace (local ring by default; pass a
    merged multi-process list to look across the fleet)."""
    recs = snapshot() if spans is None else spans
    return [r for r in recs if r.get("trace_id") == trace_id]


# -- chrome-trace export -----------------------------------------------------

def merge_chrome_events(span_lists):
    """Merge per-process span lists into chrome traceEvents with one
    pid lane per distinct (pid, service). Returns (meta, events)."""
    lanes = OrderedDict()             # (pid, service) -> lane id
    meta, events = [], []
    for recs in span_lists:
        for r in recs:
            key = (r.get("pid", 0), r.get("service", ""))
            lane = lanes.get(key)
            if lane is None:
                lane = len(lanes)
                lanes[key] = lane
                meta.append({"name": "process_name", "ph": "M",
                             "pid": lane,
                             "args": {"name": "%s (pid %d)"
                                      % (key[1], key[0])}})
            args = {"trace_id": r.get("trace_id"),
                    "span_id": r.get("span_id"),
                    "parent_id": r.get("parent_id")}
            if r.get("links"):
                args["links"] = r["links"]
            if r.get("attrs"):
                args.update(r["attrs"])
            dur = r.get("dur")
            events.append({
                "name": r.get("name", "?"), "ph": "X", "pid": lane,
                "tid": r.get("tid", 0), "ts": r.get("ts", 0.0) * 1e6,
                # open spans (crash mid-flight) export with ~0 width
                # rather than vanishing — the postmortem wants them
                "dur": (dur if dur is not None else 0.0) * 1e6,
                "cat": "trace"})
    return meta, events


def export_trace(path, trace_id=None, extra_spans=None, coord_addr=None,
                 prefix="telemetry/"):
    """Write a merged chrome://tracing JSON.

    Sources: this process's ring, any ``extra_spans`` (list of span-dict
    lists, e.g. parsed flight dumps), and — with ``coord_addr`` — every
    live process's pushed ring from the coordination KV
    (``telemetry/spans/<proc>``). ``trace_id`` filters to one trace.
    Returns ``path``."""
    lists = [snapshot()]
    if extra_spans:
        lists.extend(extra_spans)
    if coord_addr:
        from . import pusher as _pusher

        lists.extend(_pusher.collect_spans(coord_addr, prefix=prefix))
    if trace_id is not None:
        lists = [trace_spans(trace_id, recs) for recs in lists]
    meta, events = merge_chrome_events(lists)
    meta.append({"name": "dropped_spans", "ph": "M", "pid": 0,
                 "args": {"count": _DROPPED[0]}})
    with open(path, "w") as f:
        json.dump({"traceEvents": meta + events,
                   "displayTimeUnit": "ms"}, f)
    return path
