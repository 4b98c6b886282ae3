"""SLO-aware fleet router: the single endpoint clients talk to.

Membership is pulled, not configured: a refresher thread polls
``CoordClient.live_members(<prefix>replicas/)`` — the server-side lease
sweep guarantees every returned key carries a live lease — and mirrors
the per-replica load reports (``stats/<id>`` blobs the replicas
republish) into the routing table and the ``fleet_replica_*`` gauges.
A replica whose lease lapses simply stops appearing and is dropped;
one whose connection dies mid-request is evicted eagerly and the
request is RE-DISPATCHED to the next-best replica (inference is
idempotent), counted in ``fleet_requeued_total`` — a killed replica
loses zero requests.

Balancing picks the replica minimizing ``published queue depth +
router-local in-flight`` — the local term covers the publish interval
so a burst does not pile onto whichever replica last reported empty.

SLO enforcement happens BEFORE capacity burns: a request whose
``deadline_ms`` budget is exhausted (on arrival, or after failed
forwards) is shed with the typed ``Overloaded`` (``ST_OVERLOADED`` on
the wire), and the remaining budget — not the original — is forwarded
so the replica's deadline-aware batcher sees the truth. Every outcome
lands in the ``fleet_*`` monitor series; end-to-end latency is a
histogram whose ``quantile()`` gives the fleet p50/p99.

Transport stays entirely inside ``distributed/wire.py``; each client
connection thread keeps its own small per-replica ``Conn`` pool so
concurrent clients fan into a replica on parallel sockets (which its
batcher coalesces), with zero cross-thread lock traffic on the hot
path.
"""

import json
import os
import threading
import time

from ..distributed import coordination as _coordination
from ..distributed import wire as _wire
from ..fluid import monitor as _monitor
from .. import telemetry as _telemetry
from . import protocol as _p

__all__ = ["Router"]


def _m_routed(model):
    return _monitor.counter(
        "fleet_routed_total",
        help="requests routed to a replica and answered OK",
        labels={"model": model})


def _m_shed(model, reason):
    return _monitor.counter(
        "fleet_shed_total",
        help="requests shed with typed Overloaded (reason: deadline "
             "budget exhausted, no live replica, or all replicas "
             "refusing)",
        labels={"model": model, "reason": reason})


_M_REQUEUED = _monitor.counter(
    "fleet_requeued_total",
    help="forwards that failed on a dead/dying replica and were "
         "re-dispatched to another (the kill-one-replica no-loss path)")
_M_REPLICAS = _monitor.gauge(
    "fleet_replicas", help="replicas currently in the routing table")
_M_STALE_ROUTED = _monitor.counter(
    "fleet_stale_routing_total",
    help="requests routed over the last-known replica set while the "
         "coordination service was unreachable (degraded mode, inside "
         "the grace window)")


def _m_e2e(model):
    return _monitor.histogram(
        "fleet_request_seconds",
        help="router-side end-to-end latency (accept -> reply sent); "
             "quantile() yields the fleet p50/p99",
        labels={"model": model})


def _replica_gauges(rid):
    lbl = {"replica": rid}
    return {
        "depth": _monitor.gauge(
            "fleet_replica_queue_depth",
            help="last queue depth the replica published", labels=lbl),
        "occupancy": _monitor.gauge(
            "fleet_replica_occupancy",
            help="last mean batch occupancy the replica published",
            labels=lbl),
        "inflight": _monitor.gauge(
            "fleet_replica_inflight",
            help="router-local requests currently forwarded to this "
                 "replica", labels=lbl),
        "routed": _monitor.counter(
            "fleet_replica_routed_total",
            help="requests this replica answered OK (balance proof)",
            labels=lbl),
    }


class _ReplicaConn(_wire.Conn):
    """Fail-fast forward connection: NO transport retries — a dead
    replica must surface as ConnectionError immediately so the router
    re-dispatches in milliseconds instead of riding the default
    reconnect backoff."""

    MAGIC = _p.MAGIC_REPLICA
    TOKEN_ENV = _p.ENV_TOKEN
    RETRIES = 0

    def __init__(self, endpoint, token=None):
        super().__init__(endpoint, token=token,
                         retry_name="fleet.forward", connect_timeout=5)


class _Member:
    __slots__ = ("rid", "endpoint", "depth", "inflight", "gauges")

    def __init__(self, rid, endpoint):
        self.rid = rid
        self.endpoint = endpoint
        self.depth = 0.0          # last published queue depth
        self.inflight = 0         # router-local, refreshed under table mu
        self.gauges = _replica_gauges(rid)


class Router(_wire.FramedServer):
    """``Router(coord_addr).start()`` serves ``OP_SUBMIT`` on
    ``endpoint`` until ``close()``. See the module doc for semantics."""

    MAGIC = _p.MAGIC_ROUTER
    TOKEN_ENV = _p.ENV_TOKEN

    ENV_GRACE = "PADDLE_FLEET_GRACE_S"

    def __init__(self, coord_addr=None, prefix=None, host="127.0.0.1",
                 port=0, token=None, refresh_interval=0.2, grace=None):
        super().__init__(host=host, port=port, token=token, backlog=128)
        self.prefix = prefix or "fleet/"
        # fail-fast coordination client (small grace): the STALE TABLE
        # is this router's outage resilience — a refresh that blocked
        # for the full coordinator grace window would be pure latency
        self._coord = _coordination.CoordClient(
            coord_addr or _coordination.current_coord_addr(), grace=1.0)
        self._refresh_interval = float(refresh_interval)
        if grace is None:
            grace = float(os.environ.get(self.ENV_GRACE, "") or 10.0)
        self._grace = float(grace)
        self._stale_since = None      # monotonic ts of first failed refresh
        self._table = {}              # rid -> _Member
        self._table_mu = threading.Lock()
        self._rr = 0                  # round-robin tie-break cursor
        self._refresh_stop = threading.Event()
        self._refresh_thread = None
        self._token_arg = token

    # -- membership ----------------------------------------------------------
    def start(self):
        self.refresh()                # serve with a table from frame one
        super().start()
        self._refresh_thread = threading.Thread(
            target=self._refresh_loop, daemon=True, name="fleet-refresh")
        self._refresh_thread.start()
        return self

    def refresh(self):
        """One membership pull: live_members is the authority (expired
        leases already swept server-side); stats blobs update the
        balancing inputs and the per-replica gauges. A coordinator
        outage anywhere in the pull flips the table to STALE instead of
        raising — see ``_refresh_failed``."""
        try:
            self._refresh_once()
        except (ConnectionError, RuntimeError):
            self._refresh_failed()
        else:
            with self._table_mu:
                self._stale_since = None

    def _refresh_failed(self):
        """Coordinator unreachable: keep routing over the last-known
        replica set (marked stale — every request routed counts in
        ``fleet_stale_routing_total``) until the outage outlives the
        grace window; past it the view is too old to trust, so the
        table drops and requests shed typed ``no_replica``."""
        now = time.monotonic()
        with self._table_mu:
            if self._stale_since is None:
                self._stale_since = now
                return
            if now - self._stale_since <= self._grace:
                return
            for mem in self._table.values():
                mem.gauges["inflight"].set(0.0)
            self._table.clear()
            _M_REPLICAS.set(0.0)

    def _refresh_once(self):
        rep_prefix = self.prefix + "replicas/"
        keys = self._coord.live_members(rep_prefix)
        live = {}
        for key in keys:
            rid = key[len(rep_prefix):]
            blob = self._coord.get(key)
            if blob is None:  # evicted between list and get
                continue
            try:
                live[rid] = json.loads(blob.decode())
            except ValueError:
                continue
        stats = {}
        for rid in live:
            blob = self._coord.get(_p.stats_key(self.prefix, rid))
            if blob:
                try:
                    stats[rid] = json.loads(blob.decode())
                except ValueError:
                    pass
        with self._table_mu:
            for rid in list(self._table):
                if rid not in live:
                    self._table.pop(rid).gauges["inflight"].set(0.0)
            for rid, info in live.items():
                mem = self._table.get(rid)
                endpoint = info.get("endpoint", "")
                if mem is None or mem.endpoint != endpoint:
                    # new member, or a warm respawn reusing the id on a
                    # fresh port — either way forwards must re-dial
                    mem = _Member(rid, endpoint)
                    self._table[rid] = mem
                st = stats.get(rid)
                if st:
                    mem.depth = float(st.get("queue_depth", 0.0))
                    mem.gauges["depth"].set(mem.depth)
                    mem.gauges["occupancy"].set(
                        float(st.get("occupancy", 0.0)))
            _M_REPLICAS.set(float(len(self._table)))

    def _refresh_loop(self):
        while not self._refresh_stop.wait(self._refresh_interval):
            self.refresh()

    def members(self):
        """Snapshot of the routing table {rid: endpoint}."""
        with self._table_mu:
            return {rid: m.endpoint for rid, m in self._table.items()}

    def _pick(self, exclude):
        """Least-loaded live replica (published depth + local inflight),
        or None. Equal-load ties rotate round-robin — otherwise a
        sequential client (one in-flight at a time, everyone idle) would
        pin every request onto whichever replica registered first.
        Claims an inflight slot for the caller."""
        with self._table_mu:
            cands = [m for rid, m in self._table.items()
                     if rid not in exclude]
            if not cands:
                return None
            lo = min(m.depth + m.inflight for m in cands)
            ties = [m for m in cands if m.depth + m.inflight <= lo]
            mem = ties[self._rr % len(ties)]
            self._rr += 1
            mem.inflight += 1
            mem.gauges["inflight"].set(float(mem.inflight))
            if self._stale_since is not None:
                _M_STALE_ROUTED.inc()   # degraded mode: last-known view
            return mem

    def _release(self, mem):
        with self._table_mu:
            mem.inflight -= 1
            mem.gauges["inflight"].set(float(max(mem.inflight, 0)))

    def _evict(self, mem):
        """Eager eviction on connection failure — faster than waiting
        out the lease TTL; the next refresh re-adds it if it was only a
        blip (the lease is still the authority)."""
        with self._table_mu:
            if self._table.get(mem.rid) is mem:
                del self._table[mem.rid]
                _M_REPLICAS.set(float(len(self._table)))

    # -- serving -------------------------------------------------------------
    def _serve_authenticated(self, conn):
        pool = {}                     # rid -> _ReplicaConn
        try:
            while not self._stop.is_set():
                try:
                    req = _wire.read_frame(conn)
                except (ConnectionError, OSError):
                    return
                if not req:
                    resp = b"\x01empty request"
                elif req[0] == _p.OP_PING:  # trace: ping carries no payload, nothing to propagate
                    resp = b"\x00" + bytes([_p.ST_OK])
                elif req[0] == _p.OP_SUBMIT:  # trace: header decoded + forwarded inside _route
                    resp = self._route(req, pool)
                else:
                    resp = b"\x01unknown opcode %d" % req[0]
                try:
                    _wire.send_all(conn, _wire.frame(resp))
                except (ConnectionError, OSError):
                    return
        finally:
            for c in pool.values():
                c.close()

    def _conn_for(self, mem, pool):
        c = pool.get(mem.rid)
        if c is not None and c.endpoint != mem.endpoint:
            c.close()                 # respawned replica, fresh port
            c = None
        if c is None:
            c = _ReplicaConn(mem.endpoint, token=self._token_arg)
            pool[mem.rid] = c
        return c

    def _route(self, req, pool):
        t0 = time.perf_counter()
        try:
            model, deadline_ms, priority, feed, trace = \
                _p.unpack_request(req)
        except _wire.DecodeError as e:
            return b"\x01%s" % str(e).encode()[:512]
        # trace continues only when the client sent a header AND this
        # router has telemetry on; otherwise the request runs exactly
        # the pre-telemetry path (zero per-request allocation)
        ctx = _telemetry.decode_header(trace) \
            if (trace is not None and _telemetry.enabled()) else None
        if ctx is None:
            return self._route_one(t0, model, deadline_ms, priority,
                                   feed, pool, None)
        with _telemetry.span("router.route", parent=ctx, service="router",
                             attrs={"model": model}):
            return self._route_one(t0, model, deadline_ms, priority,
                                   feed, pool, ctx)

    def _route_one(self, t0, model, deadline_ms, priority, feed, pool,
                   ctx):
        deadline = None if deadline_ms is None \
            else t0 + float(deadline_ms) / 1000.0
        tried = set()
        while True:
            now = time.perf_counter()
            if deadline is not None and now >= deadline:
                _m_shed(model, "deadline").inc()
                return _p.err_reply(
                    _p.ST_OVERLOADED,
                    "deadline budget (%.1f ms) exhausted before a "
                    "replica answered" % deadline_ms)
            mem = self._pick(tried)
            if mem is None:
                reason = "no_replica" if not tried else "capacity"
                _m_shed(model, reason).inc()
                return _p.err_reply(
                    _p.ST_OVERLOADED,
                    "no live replica can take model %r (tried %d)"
                    % (model, len(tried)))
            left_ms = None if deadline is None \
                else max((deadline - now) * 1000.0, 0.001)

            def _forward(trace_hdr):
                fwd = _p.pack_request(_p.OP_INFER, model, feed,
                                      deadline_ms=left_ms,
                                      priority=priority, trace=trace_hdr)
                try:
                    return self._conn_for(mem, pool).request(fwd)
                finally:
                    self._release(mem)
            try:
                if ctx is None:
                    resp = _forward(None)
                else:
                    # one dispatch span per attempt; a redispatch after
                    # an eviction shows up as a second span (with the
                    # failed one carrying attrs.error)
                    with _telemetry.span(
                            "router.dispatch", service="router",
                            attrs={"replica": mem.rid,
                                   "redispatch": bool(tried)}) as sp:
                        resp = _forward(_telemetry.encode_header(sp.ctx))
            except (ConnectionError, RuntimeError):
                # dead or dying replica: evict eagerly, drop its pooled
                # conn, re-dispatch — the no-loss path
                tried.add(mem.rid)
                self._evict(mem)
                c = pool.pop(mem.rid, None)
                if c is not None:
                    c.close()
                _M_REQUEUED.inc()
                continue
            st = resp[0] if resp else _p.ST_ERROR
            if st in (_p.ST_OVERLOADED, _p.ST_CLOSED):
                # replica shed or draining: spill to the next-best one;
                # when every replica refuses, the loop sheds typed
                tried.add(mem.rid)
                continue
            if st == _p.ST_OK:
                _m_routed(model).inc()
                mem.gauges["routed"].inc()
                _m_e2e(model).observe(time.perf_counter() - t0)
            # conn.request stripped the replica's wire status; restore
            # ours so the client's Conn sees a well-formed reply
            return b"\x00" + resp

    # -- lifecycle -----------------------------------------------------------
    def close(self):
        self._refresh_stop.set()
        if self._refresh_thread is not None:
            self._refresh_thread.join(timeout=2)
        self.stop()
        self._coord.close()
