"""Profiler: the port's counterpart of ``paddle_tpu/fluid/profiler.py``
(the reference's RecordEvent, Enable/DisableProfiler, per-event summary
table and chrome timeline).

Host events are step and section level: ``RecordEvent`` contexts and the
executor's ``executor_run[<fetches>#p<uid>]`` records (the executor
synchronises the card after each run while the profiler is on, so a
record spans the step's device work). With ``trace_dir`` a
``torch.profiler`` trace of the card runs beside them and is written
there as ``device_trace.json`` at stop. The summary table keeps the
reference's shape: Event / Calls / Total / Min / Max / Ave / Ratio.
"""

import contextlib
import json
import os
import time
from collections import OrderedDict, deque

from . import monitor as _monitor

__all__ = ["profiler", "start_profiler", "stop_profiler", "reset_profiler",
           "export_chrome_tracing", "dropped_span_count", "RecordEvent",
           "record_event", "is_profiler_enabled", "summary"]

_enabled = False
_events = OrderedDict()  # name -> [calls, total, min, max]
_trace = [None, None]    # (torch.profiler.profile, trace_dir) while on
_MAX_SPANS = 200_000
# (name, t_end, dur) ring for the chrome timeline: on overflow the OLDEST
# span goes, so the ring holds the last seconds of the run
_spans = deque(maxlen=_MAX_SPANS)
_dropped = [0]
# perf_counter has an arbitrary epoch; anchor it to unix time once
_EPOCH_ANCHOR = (time.perf_counter(), time.time())
DEVICE_TRACE = "device_trace.json"

_M_DROPPED = _monitor.counter(
    "profiler_dropped_spans_total",
    help="host spans evicted from the full span ring (oldest-out)")
_mon_hists = {}


def _mon_hist(name):
    h = _mon_hists.get(name)
    if h is None:
        h = _mon_hists[name] = _monitor.histogram(
            "profiler_event_seconds",
            help="host RecordEvent/Executor span durations",
            labels={"event": name})
    return h


def now():
    return time.perf_counter()


def dropped_span_count():
    """Spans evicted since the last reset_profiler()."""
    return _dropped[0]


def _record(name, seconds):
    if not _enabled:
        return
    e = _events.get(name)
    if e is None:
        _events[name] = [1, seconds, seconds, seconds]
    else:
        e[0] += 1
        e[1] += seconds
        e[2] = min(e[2], seconds)
        e[3] = max(e[3], seconds)
    _mon_hist(name).observe(seconds)
    if len(_spans) == _spans.maxlen:
        _dropped[0] += 1
        _M_DROPPED.inc()
    _spans.append((name, time.perf_counter(), seconds))


class RecordEvent:
    """A host event around a ``with`` block (reference
    platform/profiler.h:81)."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _record(self.name, time.perf_counter() - self._t0)
        return False


def record_event(name):
    return RecordEvent(name)


def is_profiler_enabled():
    return _enabled


def start_profiler(state="All", tracer_option="Default", trace_dir=None):
    """Collect host events; with ``trace_dir`` also trace the card with
    ``torch.profiler`` (CPU and CUDA activities)."""
    global _enabled
    _enabled = True
    if trace_dir is not None:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
        _trace[:] = [prof, trace_dir]


def stop_profiler(sorted_key=None, profile_path=None, timeline_path=None,
                  silent=False):
    """Stop collecting, print the summary table (unless ``silent``),
    write it to ``profile_path``, write the device trace into the
    ``trace_dir`` given at start, and with ``timeline_path`` export a
    chrome://tracing JSON of the host spans and the device trace."""
    global _enabled
    _enabled = False
    prof, trace_dir = _trace
    _trace[:] = [None, None]
    if prof is not None:
        prof.__exit__(None, None, None)
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, DEVICE_TRACE))
    report = summary(sorted_key)
    if not silent:
        print(report)
    if profile_path:
        with open(profile_path, "w") as f:
            f.write(report)
    if timeline_path:
        export_chrome_tracing(timeline_path, trace_dir=trace_dir)
    return report


def export_chrome_tracing(path, trace_dir=None):
    """Write a chrome://tracing JSON: the host RecordEvent/Executor spans
    as pid 0 and, when ``trace_dir`` holds a device trace, its events
    (torch.profiler's own clock) as pid 1."""
    pc0, unix0 = _EPOCH_ANCHOR
    events = [{"name": name, "ph": "X", "pid": 0, "tid": 0,
               "ts": ((t_end - dur) - pc0 + unix0) * 1e6, "dur": dur * 1e6,
               "cat": "host"} for name, t_end, dur in _spans]
    device = os.path.join(trace_dir, DEVICE_TRACE) if trace_dir else None
    if device and os.path.exists(device):
        with open(device) as f:
            for ev in json.load(f).get("traceEvents", []):
                if ev.get("ph") == "X":
                    events.append(dict(ev, pid=1))
    meta = [{"name": "process_name", "ph": "M", "pid": 0,
             "args": {"name": "host"}},
            {"name": "process_name", "ph": "M", "pid": 1,
             "args": {"name": "device (torch.profiler)"}},
            {"name": "dropped_spans", "ph": "M", "pid": 0,
             "args": {"count": _dropped[0]}}]
    with open(path, "w") as f:
        json.dump({"traceEvents": meta + events, "displayTimeUnit": "ms"}, f)
    return path


def reset_profiler():
    global _spans
    _events.clear()
    if _spans.maxlen != _MAX_SPANS:
        _spans = deque(maxlen=_MAX_SPANS)
    else:
        _spans.clear()
    _dropped[0] = 0


def summary(sorted_key=None):
    """Reference-shaped table: Event Calls Total Min Max Ave Ratio."""
    total_all = sum(e[1] for e in _events.values()) or 1e-12
    rows = [(name, calls, total, mn, mx, total / calls, total / total_all)
            for name, (calls, total, mn, mx) in _events.items()]
    if sorted_key in ("total", "calls", "max", "min", "ave"):
        idx = {"calls": 1, "total": 2, "min": 3, "max": 4,
               "ave": 5}[sorted_key]
        rows.sort(key=lambda r: r[idx], reverse=sorted_key != "min")
    lines = ["------------------------->  Profiling Report  "
             "<-------------------------", "",
             "%-40s %8s %12s %12s %12s %12s %8s" % (
                 "Event", "Calls", "Total(ms)", "Min(ms)", "Max(ms)",
                 "Ave(ms)", "Ratio")]
    for name, calls, total, mn, mx, ave, ratio in rows:
        lines.append("%-40s %8d %12.4f %12.4f %12.4f %12.4f %7.2f%%" % (
            name[:40], calls, total * 1e3, mn * 1e3, mx * 1e3, ave * 1e3,
            ratio * 100))
    return "\n".join(lines)


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=None,
             tracer_option="Default", trace_dir=None, timeline_path=None):
    """Reference ``fluid.profiler.profiler`` context manager."""
    reset_profiler()
    start_profiler(state, tracer_option, trace_dir)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path, timeline_path)
