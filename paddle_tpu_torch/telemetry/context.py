"""Trace context: the request identity that crosses the wire.

A ``TraceContext`` is (trace_id, span_id, parent_id, baggage, sampled).
The trace_id names the whole request tree (one ``FleetClient.submit``
== one trace_id, from the client socket through router dispatch,
replica batching, and the executor run); span_id names one node in it;
parent_id stitches the tree back together at export time. ``baggage``
is a tiny string->string dict that rides the whole trace (model name,
priority class) — keep it small, it is re-encoded on every hop.

Ambient propagation is contextvars-based so it follows async/thread
context copies but never leaks across unrelated threads: serving
threads ACTIVATE the context decoded from the wire, the batcher worker
re-activates each request's captured context explicitly (contexts do
not cross the submit-thread -> worker-thread boundary implicitly; see
``inference/serving.py``).

The wire encoding is a compact JSON dict (``{"t","s","p","b"}``) that
rides inside existing JSON metas (serving protocol) or a tiny length-
prefixed header (coordination RPC wrap) — old peers ignore unknown
meta keys, and the key is simply absent when telemetry is off, so the
off-path is byte-identical to the pre-telemetry wire format.
"""

import contextlib
import contextvars
import os
import secrets

__all__ = ["TraceContext", "new_trace", "child_of", "current", "attach",
           "detach", "use", "current_service", "use_service",
           "default_service", "encode_header", "decode_header"]

ENV_SERVICE = "PADDLE_TELEMETRY_SERVICE"

_CUR = contextvars.ContextVar("paddle_trace_ctx", default=None)
_SERVICE = contextvars.ContextVar("paddle_trace_service", default=None)


class TraceContext:
    """Immutable-by-convention trace identity for one span."""

    __slots__ = ("trace_id", "span_id", "parent_id", "baggage", "sampled")

    def __init__(self, trace_id, span_id, parent_id=None, baggage=None,
                 sampled=True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.baggage = dict(baggage) if baggage else {}
        self.sampled = bool(sampled)

    def child(self):
        """A fresh span under this one (same trace, same baggage)."""
        return TraceContext(self.trace_id, _new_span_id(),
                            parent_id=self.span_id, baggage=self.baggage,
                            sampled=self.sampled)

    def to_dict(self):
        """Compact wire form; inverse of ``decode_header``."""
        d = {"t": self.trace_id, "s": self.span_id}
        if self.parent_id:
            d["p"] = self.parent_id
        if self.baggage:
            d["b"] = dict(self.baggage)
        if not self.sampled:
            d["x"] = 0
        return d

    def __repr__(self):
        return ("TraceContext(trace=%s, span=%s, parent=%s)"
                % (self.trace_id, self.span_id, self.parent_id))


def _new_trace_id():
    return secrets.token_hex(8)     # 16 hex chars: unique per fleet run


def _new_span_id():
    return secrets.token_hex(4)


def new_trace(baggage=None, sampled=True):
    """A fresh root context (new trace_id, no parent)."""
    return TraceContext(_new_trace_id(), _new_span_id(), baggage=baggage,
                        sampled=sampled)


def child_of(ctx):
    """Child of ``ctx``; a fresh root when ``ctx`` is None."""
    return ctx.child() if ctx is not None else new_trace()


# -- ambient context ---------------------------------------------------------

def current():
    """The ambient TraceContext of this thread/context, or None."""
    return _CUR.get()


def attach(ctx):
    """Make ``ctx`` ambient; returns the token for ``detach``."""
    return _CUR.set(ctx)


def detach(token):
    _CUR.reset(token)


@contextlib.contextmanager
def use(ctx):
    """``with use(ctx):`` — ambient context scope."""
    token = _CUR.set(ctx)
    try:
        yield ctx
    finally:
        _CUR.reset(token)


# -- service identity (the chrome-trace pid lane) ----------------------------

def default_service():
    """This process's default lane name: ``$PADDLE_TELEMETRY_SERVICE``
    or ``proc-<pid>``."""
    return os.environ.get(ENV_SERVICE) or ("proc-%d" % os.getpid())


def current_service():
    """The ambient service name (set by ``use_service`` / a span with
    ``service=``), falling back to the process default."""
    return _SERVICE.get() or default_service()


@contextlib.contextmanager
def use_service(name):
    """Scope an ambient service name — every span recorded inside
    (including by nested layers like the executor) lands in this
    service's chrome lane."""
    token = _SERVICE.set(name)
    try:
        yield
    finally:
        _SERVICE.reset(token)


# -- wire header -------------------------------------------------------------

def encode_header(ctx):
    """Dict form for embedding in a protocol meta (or None)."""
    return None if ctx is None else ctx.to_dict()


def decode_header(d):
    """TraceContext from a wire dict; None on anything malformed (an
    old or foreign peer must never be able to poison the serve path)."""
    if not isinstance(d, dict):
        return None
    t, s = d.get("t"), d.get("s")
    if not (isinstance(t, str) and isinstance(s, str) and t and s):
        return None
    b = d.get("b")
    return TraceContext(t, s, parent_id=d.get("p") or None,
                        baggage=b if isinstance(b, dict) else None,
                        sampled=d.get("x", 1) != 0)
