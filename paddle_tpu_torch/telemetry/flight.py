"""Crash flight recorder: what was this process doing in its final
seconds?

A fixed-size ring per process holds the most recent trace spans
(telemetry ring tail), profiler spans, monitor COUNTER DELTAS since the
previous flush (the activity of the last window, not lifetime totals),
and the last N wire ops (direction, opcode byte, frame size — recorded
by ``distributed/wire.py`` through ``record_wire_op``). The ring lands
on disk as ``<dir>/flight.<rank>.json`` two ways:

  * a periodic flusher (``PADDLE_FLIGHT_FLUSH_MS``, default 500 ms,
    atomic tmp+rename) — the only thing that survives SIGKILL, which a
    supervisor ``kill()`` and a real OOM both deliver; spans are
    recorded OPEN at start, so the request in flight at death is in the
    last flushed image;
  * an immediate ``dump(reason)`` on the catchable triggers: the
    preemption drain path, the watchdog's SIGUSR1 (hooked through
    ``distributed/preemption.py`` — the port's one signal site),
    an unhandled executor exception, and ``Replica.kill()``.

``collect(dirname)`` parses every ``flight.*.json`` under a directory —
the fleet supervisor calls it after a death so the postmortem shows
every process's final seconds side by side.
"""

import json
import os
import threading
import time
from collections import deque

from ..fluid import monitor as _monitor
from ..fluid import profiler as _profiler

__all__ = ["ENV_DIR", "ENV_FLUSH_MS", "ENV_WIRE_OPS", "is_active",
           "start", "stop", "dump", "record_wire_op", "collect",
           "dump_path"]

ENV_DIR = "PADDLE_FLIGHT_DIR"
ENV_FLUSH_MS = "PADDLE_FLIGHT_FLUSH_MS"
ENV_WIRE_OPS = "PADDLE_FLIGHT_WIRE_OPS"

_SPAN_TAIL = 512          # newest trace spans per dump
_PROF_TAIL = 256          # newest profiler spans per dump

_LOCK = threading.Lock()
_STATE = {"dir": None, "rank": None, "thread": None,
          "stop": None, "prev_counters": {}}
_WIRE_OPS = deque(maxlen=int(os.environ.get(ENV_WIRE_OPS, 64) or 64))

_M_DUMPS = _monitor.counter(
    "flight_dumps_total",
    help="flight-recorder rings written to disk (periodic + triggered)")


def is_active():
    return _STATE["dir"] is not None


def dump_path(dirname=None, rank=None):
    dirname = dirname or _STATE["dir"]
    rank = _STATE["rank"] if rank is None else rank
    return os.path.join(dirname, "flight.%s.json" % rank)


def record_wire_op(direction, op, nbytes):
    """Called by the wire layer for every frame when the recorder is
    active: ``direction`` 'send'/'recv', ``op`` the first payload byte
    (the opcode across every framed protocol), ``nbytes`` frame size."""
    _WIRE_OPS.append((time.time(), direction, int(op), int(nbytes)))


def _counter_values():
    vals = {}
    for m in _monitor.all_metrics():
        if isinstance(m, _monitor.Counter):
            vals[(m.name, tuple(m.labels.items()))] = m.value
    return vals


def _build_image(reason):
    from . import context as _context
    from . import spans as _spans

    cur = _counter_values()
    prev = _STATE["prev_counters"]
    deltas = {}
    for key, v in cur.items():
        d = v - prev.get(key, 0)
        if d:
            name, labels = key
            deltas["%s%s" % (name, dict(labels) if labels else "")] = d
    _STATE["prev_counters"] = cur
    return {
        "schema": 1,
        "rank": _STATE["rank"],
        "pid": os.getpid(),
        "service": _context.default_service(),
        "ts": time.time(),
        "reason": reason,
        "spans": _spans.snapshot(limit=_SPAN_TAIL),
        "profiler_spans": [
            {"name": n, "t_end": t, "dur": d}
            for n, t, d in list(_profiler._spans)[-_PROF_TAIL:]],
        "monitor_delta": deltas,
        "wire_ops": [
            {"ts": ts, "dir": dr, "op": op, "bytes": nb}
            for ts, dr, op, nb in list(_WIRE_OPS)],
    }


def dump(reason="manual"):
    """Write the ring now (atomic tmp+rename). Never raises — a flight
    dump on a dying process must not mask the original failure."""
    with _LOCK:
        if _STATE["dir"] is None:
            return None
        path = dump_path()
        tmp = "%s.tmp-%d" % (path, os.getpid())
        try:
            with open(tmp, "w") as f:
                json.dump(_build_image(reason), f)
            os.replace(tmp, path)
        except (OSError, ValueError):
            return None
        _M_DUMPS.inc()
        return path


def _flush_loop(stop_ev, interval):
    while not stop_ev.wait(interval):
        dump(reason="periodic")


def start(dirname=None, rank=None, interval=None):
    """Arm the recorder: periodic flusher + dump-on-drain/SIGUSR1.
    ``dirname`` defaults from ``$PADDLE_FLIGHT_DIR`` (no dir configured
    -> recorder stays off and this returns None). Idempotent."""
    from ..distributed import preemption as _preemption
    from ..distributed import wire as _wire

    dirname = dirname or os.environ.get(ENV_DIR)
    if not dirname:
        return None
    with _LOCK:
        if _STATE["dir"] is not None:
            return _STATE["dir"]
        os.makedirs(dirname, exist_ok=True)
        _STATE["dir"] = dirname
        _STATE["rank"] = str(
            rank if rank is not None
            else os.environ.get("PADDLE_FLEET_REPLICA_ID")
            or os.environ.get("PADDLE_TRAINER_ID") or os.getpid())
        _STATE["prev_counters"] = _counter_values()
        if interval is None:
            interval = float(os.environ.get(ENV_FLUSH_MS, 500.0)) / 1000.0
        stop_ev = threading.Event()
        t = threading.Thread(target=_flush_loop, args=(stop_ev, interval),
                             daemon=True, name="flight-flush")
        _STATE["stop"] = stop_ev
        _STATE["thread"] = t
        t.start()
    _wire.set_wire_observer(record_wire_op)
    _preemption.on_drain(lambda: dump(reason="drain"))
    _preemption.on_stack_signal(lambda: dump(reason="stack_signal"))
    return dirname


def stop(final_dump=True):
    """Disarm (tests / clean shutdown); optionally writes one last
    image first."""
    from ..distributed import wire as _wire

    if final_dump:
        dump(reason="stop")
    _wire.set_wire_observer(None)
    with _LOCK:
        ev, t = _STATE["stop"], _STATE["thread"]
        _STATE.update(dir=None, rank=None, thread=None, stop=None,
                      prev_counters={})
    if ev is not None:
        ev.set()
    if t is not None:
        t.join(timeout=2)
    _WIRE_OPS.clear()


def collect(dirname):
    """Parse every ``flight.*.json`` under ``dirname`` ->
    {rank: image}. Corrupt/partial files are skipped (a crash can race
    the flusher's rename) — the postmortem reports what survived."""
    out = {}
    try:
        names = sorted(os.listdir(dirname))
    except OSError:
        return out
    for name in names:
        if not (name.startswith("flight.") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(dirname, name)) as f:
                image = json.load(f)
        except (OSError, ValueError):
            continue
        out[name[len("flight."):-len(".json")]] = image
    return out
