"""Fleet client: submit inference to the router, get numpy fetches.

One ``FleetClient`` is one persistent wire connection (requests on it
serialize; run one per client thread for concurrency — the router gives
every connection its own serving thread). Typed errors cross the wire:
a shed request raises ``Overloaded`` (back off / lower the load), a
draining-everything fleet raises ``Closed``.
"""

from ..distributed import wire as _wire
from .. import telemetry as _telemetry
from . import protocol as _p

__all__ = ["FleetClient"]


class _RouterConn(_wire.Conn):
    MAGIC = _p.MAGIC_ROUTER
    TOKEN_ENV = _p.ENV_TOKEN


class FleetClient:
    """``FleetClient("host:port").submit("model", {"x": arr})`` -> list
    of numpy fetches (sliced to the request's rows, exactly like
    ``Server.submit(...).result()``)."""

    def __init__(self, endpoint, token=None):
        self._conn = _RouterConn(endpoint, token=token,
                                 retry_name="fleet.client")

    @property
    def endpoint(self):
        return self._conn.endpoint

    def submit(self, model, feed, deadline_ms=None, priority=None):
        """Route one request through the fleet. ``deadline_ms`` is the
        end-to-end SLO budget (the router sheds typed-``Overloaded``
        when it cannot be met; replicas batch deadline-aware inside
        it); ``priority`` orders head-of-line dispatch on the replica.

        With telemetry enabled this mints (or continues) the trace: the
        ``client.submit`` span is the trace root of the whole
        client -> router -> replica -> executor path, and its header
        rides the request meta. Off, the frame is byte-identical to the
        pre-telemetry format."""
        if not _telemetry.enabled():
            resp = self._conn.request(_p.pack_request(
                _p.OP_SUBMIT, model, feed, deadline_ms=deadline_ms,
                priority=priority))
            return _p.raise_for_status(resp)
        parent = _telemetry.current()
        if parent is None:
            # minting a root: the ONLY place the sampling rate applies
            parent = _telemetry.new_trace(sampled=_telemetry.sample())
        with _telemetry.span("client.submit", parent=parent,
                             service="client",
                             attrs={"model": model}) as sp:
            resp = self._conn.request(_p.pack_request(
                _p.OP_SUBMIT, model, feed, deadline_ms=deadline_ms,
                priority=priority,
                trace=_telemetry.encode_header(sp.ctx)))
            return _p.raise_for_status(resp)

    def ping(self):
        self._conn.request(bytes([_p.OP_PING]))
        return True

    def close(self):
        self._conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
