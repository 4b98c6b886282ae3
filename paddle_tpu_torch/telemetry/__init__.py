"""Fleet-wide telemetry plane: distributed request tracing, cross-
process metrics aggregation, and a crash flight recorder. The port's
copy of ``paddle_tpu/telemetry/``: the same header encoding, span
records and KV layout, so traces cross between the two packages.

Three coupled parts, one switch:

  * **tracing** (`context`, `spans`): ``TraceContext`` rides every
    framed protocol (serving OP_SUBMIT/OP_INFER meta, a coordination
    wrap opcode), so one ``FleetClient.submit()`` is one trace spanning
    client -> router (queue/dispatch/redispatch) -> replica (batcher
    queue-wait, batch dispatch, executor run) -> response. Batched
    fan-in is explicit: the batch span LINKS the N request spans it
    carried. ``export_trace(path)`` writes a merged chrome://tracing
    JSON with one pid lane per (pid, service).
  * **metrics** (`pusher`, `aggregate`): processes push
    ``monitor.snapshot()`` to the coordination KV under TTL leases;
    ``aggregate.merge`` sums counters, last-write-wins gauges, and
    merges histogram buckets so fleet-wide quantiles are exact.
  * **flight recorder** (`flight`): a per-process ring of recent spans,
    monitor deltas, and wire ops, flushed to ``flight.<rank>.json``
    periodically and on drain/SIGUSR1/executor crash/kill, collected by
    the fleet supervisor for postmortems.

The switch: ``PADDLE_TELEMETRY`` unset (or 0/false) means ``enabled()``
is False and every instrumented site short-circuits — no trace key in
any frame (byte-identical wire), no per-request allocation.
``PADDLE_TELEMETRY_SAMPLE`` (default 1.0) down-samples at ROOT creation
only; a sampled=0 context still propagates so a child never resurrects
a dropped trace.
"""

import os
import random

from .context import (TraceContext, new_trace, child_of, current, attach,
                      detach, use, default_service, current_service,
                      use_service, encode_header, decode_header)
from .spans import (span, record_span, snapshot, clear, set_max_spans,
                    dropped_span_count, trace_spans, export_trace,
                    merge_chrome_events)
from . import aggregate
from . import flight
from . import pusher

__all__ = [
    "enabled", "enable", "disable", "sample",
    "TraceContext", "new_trace", "child_of", "current", "attach",
    "detach", "use", "default_service", "current_service", "use_service",
    "encode_header", "decode_header",
    "span", "record_span", "snapshot", "clear", "set_max_spans",
    "dropped_span_count", "trace_spans", "export_trace",
    "merge_chrome_events",
    "aggregate", "flight", "pusher",
]

ENV_ENABLED = "PADDLE_TELEMETRY"
ENV_SAMPLE = "PADDLE_TELEMETRY_SAMPLE"

_TRUTHY = ("1", "true", "yes", "on")

# cached: enabled() sits on the per-request fast path of every server
# loop, so it must be a tuple-index, not an environ parse
_STATE = [os.environ.get(ENV_ENABLED, "").strip().lower() in _TRUTHY]


def enabled():
    """Is the telemetry plane on? Off means instrumented sites are
    byte-identical passthrough."""
    return _STATE[0]


def enable(service=None):
    """Programmatic switch-on (tests, embedding apps). ``service``
    names this process's chrome lane (else ``$PADDLE_TELEMETRY_SERVICE``
    / ``proc-<pid>``)."""
    _STATE[0] = True
    if service is not None:
        os.environ["PADDLE_TELEMETRY_SERVICE"] = service
    return True


def disable():
    _STATE[0] = False
    return False


def sample():
    """Root-creation sampling decision: True with probability
    ``$PADDLE_TELEMETRY_SAMPLE`` (default 1.0 — every request traced).
    Applied ONLY when minting a root; propagated contexts keep their
    original verdict."""
    try:
        rate = float(os.environ.get(ENV_SAMPLE, 1.0))
    except ValueError:
        rate = 1.0
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return random.random() < rate
