"""Snapshot pusher: periodic publication of this process's monitor
registry and span ring to the coordination KV.

Keys are ``<prefix>metrics/<proc>`` and ``<prefix>spans/<proc>``
(prefix default ``telemetry/``), each leased with the KEY as the lease
id — the same registration idiom the fleet replicas use — so
``live_members`` both sweeps dead publishers and lists live ones in one
RPC, and a crashed process's stale snapshot ages out with its TTL
instead of polluting fleet aggregates forever.

The read side (``collect_metrics`` / ``collect_spans``) is what
``spans.export_trace(coord_addr=...)`` consumes: snapshots of every LIVE publisher, parsed, junk skipped.
"""

import collections
import json
import os
import threading

from ..distributed import wire as _wire
from ..fluid import monitor as _monitor

__all__ = ["ENV_PUSH_MS", "start_pusher", "stop_pusher",
           "collect_metrics", "collect_spans", "push_once"]

ENV_PUSH_MS = "PADDLE_TELEMETRY_PUSH_MS"

_SPAN_PUSH_LIMIT = 4096   # newest spans shipped per push (KV blobs stay small)
_BACKLOG_LIMIT = 8        # span snapshots buffered across a coord outage

_LOCK = threading.Lock()
_PUSHERS = {}             # proc name -> (stop_event, thread, client)

_M_PUSHES = _monitor.counter(
    "telemetry_pushes_total",
    help="monitor/span snapshots published to the coordination KV")
_M_PUSH_ERRORS = _monitor.counter(
    "telemetry_push_errors_total",
    help="snapshot publications lost to coordination-server errors")
_M_PUSH_BUFFERED = _monitor.counter(
    "telemetry_push_buffered_total",
    help="span snapshots buffered locally while the coordination "
         "service was unreachable (bounded; flushed with the next "
         "successful push)")
_M_PUSH_OVERSIZE = _monitor.counter(
    "telemetry_push_oversize_total",
    help="snapshot publications dropped because the blob exceeded the "
         "coordination frame cap (refused client-side, the connection "
         "stays usable)")


def _client(coord_addr, token=None):
    from ..distributed import coordination as _coordination

    if isinstance(coord_addr, _coordination.CoordClient):
        return coord_addr, False
    return _coordination.CoordClient(coord_addr, token=token), True


def push_once(client, proc, prefix="telemetry/", ttl=10.0,
              span_limit=_SPAN_PUSH_LIMIT, backlog=None):
    """One publication: metrics snapshot + span-ring tail, both leased.
    Raises on transport errors (the loop counts and retries; one-shot
    callers want to see the failure). ``backlog`` is the pusher loop's
    bounded deque of span snapshots captured during a coordination
    outage — they are prepended to this push and cleared on success, so
    spans that rotated out of the ring while the coordinator was down
    still reach the fleet view."""
    from . import spans as _spans

    mkey = prefix + "metrics/" + proc
    skey = prefix + "spans/" + proc
    span_tail = _spans.snapshot(limit=span_limit)
    if backlog:
        merged, seen = [], set()
        for batch in list(backlog) + [span_tail]:
            for rec in batch:
                sid = (rec.get("trace_id"), rec.get("span_id")) \
                    if isinstance(rec, dict) else None
                if sid is not None and sid in seen:
                    continue      # buffered batches overlap the ring tail
                if sid is not None:
                    seen.add(sid)
                merged.append(rec)
        span_tail = merged[-span_limit:]
    client.put(mkey, json.dumps(_monitor.snapshot(proc=proc)))
    client.put(skey, json.dumps(span_tail))
    client.lease(mkey, ttl=ttl)
    client.lease(skey, ttl=ttl)
    if backlog:
        backlog.clear()
    _M_PUSHES.inc()


def start_pusher(coord_addr, proc, interval=None, prefix="telemetry/",
                 token=None, ttl=None):
    """Publish this process's snapshots every ``interval`` seconds
    (default ``$PADDLE_TELEMETRY_PUSH_MS``/1000, falling back to 2 s)
    from a daemon thread. Idempotent per ``proc`` name."""
    if interval is None:
        interval = float(os.environ.get(ENV_PUSH_MS, 2000.0)) / 1000.0
    if ttl is None:
        ttl = max(3.0 * interval, 5.0)
    with _LOCK:
        if proc in _PUSHERS:
            return proc
        client, owned = _client(coord_addr, token=token)
        stop_ev = threading.Event()
        # outage buffer: bounded span snapshots (metrics are cumulative
        # — the latest snapshot supersedes the missed ones for free)
        backlog = collections.deque(maxlen=_BACKLOG_LIMIT)

        def _push(track_backlog):
            from . import spans as _spans

            try:
                push_once(client, proc, prefix=prefix, ttl=ttl,
                          backlog=backlog)
            except _wire.FrameTooLarge:
                # the blob can never fit: refused client-side before a
                # byte hit the socket, so the connection is NOT wedged —
                # count, drop, keep pushing the next (smaller) snapshot
                _M_PUSH_OVERSIZE.inc()
                backlog.clear()
            except (ConnectionError, RuntimeError, OSError):
                _M_PUSH_ERRORS.inc()  # server down/restarting: retry
                if track_backlog:
                    backlog.append(_spans.snapshot(limit=_SPAN_PUSH_LIMIT))
                    _M_PUSH_BUFFERED.inc()

        def _loop():
            while not stop_ev.wait(interval):
                _push(track_backlog=True)
        _push(track_backlog=False)
        t = threading.Thread(target=_loop, daemon=True,
                             name="telemetry-push-%s" % proc)
        _PUSHERS[proc] = (stop_ev, t, client if owned else None)
        t.start()
    return proc


def stop_pusher(proc=None):
    """Stop one pusher (or all), closing any client this module opened."""
    with _LOCK:
        items = list(_PUSHERS.items()) if proc is None else \
            [(proc, _PUSHERS[proc])] if proc in _PUSHERS else []
        for name, _ in items:
            _PUSHERS.pop(name, None)
    for name, (stop_ev, t, client) in items:
        stop_ev.set()
        t.join(timeout=2)
        if client is not None:
            try:
                client.close()
            except (ConnectionError, RuntimeError, OSError):
                pass


def _collect(coord_addr, kind, prefix, token):
    client, owned = _client(coord_addr, token=token)
    out = []
    try:
        for key in client.live_members(prefix + kind + "/"):
            blob = client.get(key)
            if blob is None:
                continue
            try:
                out.append(json.loads(blob.decode()))
            except (ValueError, UnicodeDecodeError):
                continue  # torn/garbage blob: skip, report the rest
    finally:
        if owned:
            client.close()
    return out


def collect_metrics(coord_addr, prefix="telemetry/", token=None):
    """Live processes' ``monitor.snapshot()`` dicts — feed straight into
    ``aggregate.merge``."""
    return _collect(coord_addr, "metrics", prefix, token)


def collect_spans(coord_addr, prefix="telemetry/", token=None):
    """Live processes' span-ring tails (list of span-dict lists) — feed
    into ``spans.merge_chrome_events`` / ``export_trace``."""
    return _collect(coord_addr, "spans", prefix, token)
