"""Fleet replica: one serving process wrapping the in-process dynamic
batcher (``inference.serving.Server``) behind a framed-TCP endpoint and
the coordination-service membership contract.

Lifecycle:

  * **Cold start.** Each model in the spec builds a ``Predictor`` from
    its exported dir — the ``__prelowered__/`` step plans and kernel
    libraries plus the persistent compile cache
    (``PADDLE_COMPILE_CACHE_DIR``) mean the warm-up ladder loads its
    steps and libraries instead of building them (no ``nvcc``); the
    registration blob carries the measured ``live_compiles`` and
    ``nvcc_runs`` so the router/bench can PROVE a respawned replica
    rejoined without compiling anything live. The ladder's warm runs
    and captures happen before it registers, so no request pays them.
  * **Register.** ``put(replicas/<id>, blob)`` + a TTL lease under the
    SAME key + a lease-keeper thread. The router's
    ``live_members`` view evicts this replica the moment the lease
    lapses — crash detection needs no extra machinery.
  * **Serve.** The router forwards ``OP_INFER`` frames; each connection
    thread submits into the batcher and blocks on its future, so
    concurrent router streams coalesce into batches exactly like
    in-process clients. A stats thread republishes queue-depth /
    batch-occupancy gauges to the KV every ``stats_interval`` for the
    router's balancing decision.
  * **Drain.** SIGTERM lands in ``distributed.preemption`` (the ONE
    port's one signal site); ``serve_forever`` wakes via ``on_drain``,
    stops admitting (new work answers ``ST_CLOSED``, which the router
    treats as "pick another replica"), lets in-flight batches finish,
    closes the batcher (which flushes), releases the lease, and exits
    0 — the supervisor reads exit 0 + the drain marker as a clean
    preempt and respawns warm.

A model entry's ``"place"`` (default "cuda") is its ``Config(place=)``.

Run as a subprocess via ``python -m paddle_tpu_torch.serving.replica`` with
``PADDLE_FLEET_SPEC`` (path to a JSON spec, or inline JSON) and
``PADDLE_COORD_ADDR`` set; or in-process for tests via ``Replica``.
"""

import json
import os
import sys
import threading
import time

import numpy as np

from ..distributed import coordination as _coordination
from ..distributed import preemption as _preemption
from ..distributed import wire as _wire
from ..fluid import monitor as _monitor
from ..fluid.resilience import Closed, Overloaded
from .. import telemetry as _telemetry
from . import protocol as _p

__all__ = ["ENV_SPEC", "ENV_REPLICA_ID", "ENV_LEASE_TTL", "ENV_STATS_MS",
           "Replica", "main"]

ENV_SPEC = "PADDLE_FLEET_SPEC"
ENV_REPLICA_ID = "PADDLE_FLEET_REPLICA_ID"
ENV_LEASE_TTL = "PADDLE_FLEET_LEASE_TTL"
ENV_STATS_MS = "PADDLE_FLEET_STATS_MS"

DEFAULT_PREFIX = "fleet/"

_M_DRAINS = _monitor.counter(
    "fleet_replica_drains_total",
    help="graceful replica drains completed (SIGTERM or API)")


def _live_compile_count():
    """Steps built live in this process so far: every in-memory
    compile-cache miss that the disk tier could not serve.
    Zero across a warm-up ladder is the cold-start acceptance proof."""
    mem_miss = _monitor.counter("executor_compile_cache_miss_total").value
    disk_hit = _monitor.counter(
        "executor_compile_cache_disk_hit_total").value
    return int(mem_miss - disk_hit)


class _ReplicaServer(_wire.FramedServer):
    """Framed-TCP front of one replica: each router connection gets a
    serving thread that unpacks ``OP_INFER``, submits into the shared
    batcher, and answers with the typed application status."""

    MAGIC = _p.MAGIC_REPLICA
    TOKEN_ENV = _p.ENV_TOKEN

    def __init__(self, replica, host="127.0.0.1", port=0, token=None):
        super().__init__(host=host, port=port, token=token, backlog=64)
        self._replica = replica

    def _serve_authenticated(self, conn):
        while not self._stop.is_set():
            try:
                req = _wire.read_frame(conn)
            except (ConnectionError, OSError):
                return
            resp = self._handle(req)
            try:
                _wire.send_all(conn, _wire.frame(resp))
            except (ConnectionError, OSError):
                return

    def _handle(self, req):
        if not req:
            return b"\x01empty request"
        op = req[0]
        if op == _p.OP_PING:  # trace: ping carries no payload, nothing to propagate
            return b"\x00" + bytes([_p.ST_OK])
        if op != _p.OP_INFER:  # trace: error reply, no downstream hop to propagate to
            return b"\x01unknown opcode %d" % op
        try:
            model, deadline_ms, priority, feed, trace = \
                _p.unpack_request(req)
        except _wire.DecodeError as e:
            return b"\x01%s" % str(e).encode()[:512]
        # a frame without a trace header (old router / telemetry off)
        # runs the exact pre-telemetry path; with one, the replica span
        # becomes ambient so the batcher's submit captures it
        ctx = _telemetry.decode_header(trace) \
            if (trace is not None and _telemetry.enabled()) else None
        if ctx is None:
            return self._replica._infer(model, feed, deadline_ms,
                                        priority)
        with _telemetry.span(
                "replica.infer", parent=ctx,
                service="replica:%s" % self._replica.replica_id,
                attrs={"model": model}):
            return self._replica._infer(model, feed, deadline_ms,
                                        priority)


class Replica:
    """One fleet member. ``spec`` is::

        {"prefix": "fleet/",            # coordination key namespace
         "models": [{"name": "fc",
                     "model_dir": "/path/to/exported",
                     "warmup": {"x": {"shape": [1, 32],
                                      "dtype": "float32"}},
                     "config": {...ServeConfig kwargs...}}, ...]}

    ``coord_addr`` defaults from ``PADDLE_COORD_ADDR``; without one the
    replica still serves (useful for single-process tests) but is
    invisible to routers.
    """

    def __init__(self, spec, coord_addr=None, replica_id=None,
                 host="127.0.0.1", port=0, token=None, lease_ttl=None,
                 stats_interval=None, result_timeout=60.0):
        self.spec = dict(spec)
        self.prefix = self.spec.get("prefix") or DEFAULT_PREFIX
        self.replica_id = str(
            replica_id or os.environ.get(ENV_REPLICA_ID)
            or "r%d" % os.getpid())
        self._coord_addr = coord_addr or _coordination.current_coord_addr()
        self._host, self._port, self._token = host, port, token
        self._lease_ttl = float(
            lease_ttl if lease_ttl is not None
            else os.environ.get(ENV_LEASE_TTL, 5.0))
        self._stats_interval = float(
            stats_interval if stats_interval is not None
            else float(os.environ.get(ENV_STATS_MS, 200.0)) / 1000.0)
        self._result_timeout = float(result_timeout)
        self._server = None          # inference.serving.Server
        self._wire = None            # _ReplicaServer
        self._coord = None           # CoordClient
        self._models = []            # registered model names
        self._draining = False
        self._inflight = 0
        self._mu = threading.Lock()
        self._idle = threading.Condition(self._mu)
        self._wake = threading.Event()
        self._stats_stop = threading.Event()
        self._stats_thread = None
        self.live_compiles = None    # measured across start()
        self.warmup_disk_hits = None
        self.nvcc_runs = None        # nvcc processes started by start()

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        """Build predictors + batcher, warm the bucket ladders, open the
        wire endpoint, then register with the coordination service (the
        registration blob carries the live-compile count measured across
        warm-up, so membership implies readiness)."""
        from .. import inference as _inference
        from ..kernels import _build

        compiles0 = _live_compile_count()
        nvcc0 = _build.nvcc_runs
        disk0 = _monitor.counter(
            "executor_compile_cache_disk_hit_total").value
        self._server = _inference.Server(
            service="replica:%s" % self.replica_id)
        for ms in self.spec["models"]:
            predictor = _inference.create_predictor(
                _inference.Config(model_dir=ms["model_dir"],
                                  place=ms.get("place", "cuda")))
            cfg = _inference.ServeConfig(**ms.get("config") or {})
            warmup = None
            if ms.get("warmup"):
                warmup = {
                    n: np.zeros([int(d) for d in w["shape"]],
                                dtype=w.get("dtype", "float32"))
                    for n, w in ms["warmup"].items()}
            self._server.register(ms["name"], predictor, config=cfg,
                                  warmup_feed=warmup)
            self._models.append(ms["name"])
        self.live_compiles = _live_compile_count() - compiles0
        self.warmup_disk_hits = int(_monitor.counter(
            "executor_compile_cache_disk_hit_total").value - disk0)
        self.nvcc_runs = _build.nvcc_runs - nvcc0
        self._wire = _ReplicaServer(self, host=self._host,
                                    port=self._port, token=self._token)
        self._wire.start()
        if self._coord_addr:
            self._coord = _coordination.CoordClient(self._coord_addr)
            key = _p.replica_key(self.prefix, self.replica_id)
            self._coord.put(key, json.dumps(self.describe()))
            self._coord.start_lease_keeper(key, ttl=self._lease_ttl)
            # coordinator restart/partition heal: the client replays the
            # lease itself; this hook re-publishes the registration blob
            # (a coordinator recovered WITHOUT a WAL comes back empty —
            # the fleet must relearn itself)
            self._coord.on_reconnect(self._reregister)
            self._publish_stats()
            self._stats_thread = threading.Thread(
                target=self._stats_loop, daemon=True,
                name="fleet-stats-%s" % self.replica_id)
            self._stats_thread.start()
            if _telemetry.enabled():
                # share the membership client: the pusher's puts ride
                # the same authenticated conn (Conn owns a request lock)
                _telemetry.pusher.start_pusher(
                    self._coord, "replica:%s" % self.replica_id)
        if _telemetry.enabled():
            # default chrome lane / flight-image service for anything
            # recorded outside an explicit span service
            os.environ.setdefault(_telemetry.context.ENV_SERVICE,
                                  "replica:%s" % self.replica_id)
        # no-op unless $PADDLE_FLIGHT_DIR is set (supervisor exports it)
        _telemetry.flight.start(rank=self.replica_id)
        return self

    @property
    def endpoint(self):
        return self._wire.endpoint

    def describe(self):
        """The registration blob routers read via the KV."""
        return {"replica": self.replica_id, "endpoint": self.endpoint,
                "pid": os.getpid(), "models": list(self._models),
                "live_compiles": self.live_compiles,
                "warmup_disk_hits": self.warmup_disk_hits,
                "nvcc_runs": self.nvcc_runs}

    # -- the serve path ------------------------------------------------------
    def _infer(self, model, feed, deadline_ms, priority):
        with self._mu:
            if self._draining:
                return _p.err_reply(
                    _p.ST_CLOSED,
                    "replica %s is draining" % self.replica_id)
            self._inflight += 1
        try:
            fut = self._server.submit(model, feed,
                                      deadline_ms=deadline_ms,
                                      priority=priority)
            outs = fut.result(timeout=self._result_timeout)
            return _p.ok_reply(outs)
        except Overloaded as e:
            return _p.err_reply(_p.ST_OVERLOADED, e)
        except Closed as e:
            return _p.err_reply(_p.ST_CLOSED, e)
        except KeyError:
            return _p.err_reply(
                _p.ST_ERROR, "model %r not hosted here" % (model,))
        except Exception as e:  # typed reply; the replica keeps serving
            return _p.err_reply(_p.ST_ERROR, repr(e))
        finally:
            with self._idle:
                self._inflight -= 1
                self._idle.notify_all()

    def _reregister(self):
        """Reconnect hook: re-publish registration + stats blobs. Keeps
        serving throughout — the wire endpoint never depended on the
        coordinator being up."""
        if self._draining:
            return
        try:
            self._coord.put(_p.replica_key(self.prefix, self.replica_id),
                            json.dumps(self.describe()))
        except (ConnectionError, RuntimeError):
            return  # still flapping: the next reconnect fires again
        self._publish_stats()

    # -- load reporting ------------------------------------------------------
    def _stats(self):
        depth = 0.0
        occ_sum, occ_count = 0.0, 0
        for name in self._models:
            g = _monitor.get_metric("serving_queue_depth",
                                    labels={"model": name})
            depth += g.value if g is not None else 0.0
            h = _monitor.get_metric("serving_batch_occupancy",
                                    labels={"model": name})
            if h is not None:
                occ_sum += h.sum
                occ_count += h.count
        return {"replica": self.replica_id, "queue_depth": depth,
                "inflight": self._inflight,
                "occupancy": (occ_sum / occ_count) if occ_count else 0.0,
                "ts": time.time()}

    def _publish_stats(self):
        try:
            self._coord.put(_p.stats_key(self.prefix, self.replica_id),
                            json.dumps(self._stats()))
        except (ConnectionError, RuntimeError):
            pass  # coord restarting/gone: lease expiry is the authority

    def _stats_loop(self):
        while not self._stats_stop.wait(self._stats_interval):
            self._publish_stats()

    # -- drain / shutdown ----------------------------------------------------
    def serve_forever(self):
        """Block until a drain is requested (SIGTERM via
        ``distributed.preemption``, or ``request_drain``/``stop()``),
        then drain and return. The wake-up is event-driven — no signal
        polling loop."""
        _preemption.on_drain(self._wake.set)
        self._wake.wait()
        self.drain()

    def stop(self):
        """Programmatic drain trigger (same path as SIGTERM)."""
        self._wake.set()

    def drain(self, timeout=30.0):
        """Graceful exit: refuse new work with ``ST_CLOSED`` (the router
        re-picks), wait for in-flight requests, flush+close the batcher,
        deregister, release the lease."""
        with self._mu:
            if self._draining:
                return
            self._draining = True
        deadline = time.monotonic() + timeout
        with self._idle:
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._idle.wait(min(left, 0.2))
        if self._server is not None:
            self._server.close()
        self._stats_stop.set()
        if self._stats_thread is not None:
            self._stats_thread.join(timeout=2)
        _telemetry.pusher.stop_pusher("replica:%s" % self.replica_id)
        if self._coord is not None:
            # deliberate deregistration: stop replaying the lease on
            # any later reconnect before deleting the records
            self._coord.forget_lease(
                _p.replica_key(self.prefix, self.replica_id))
            try:
                self._coord.delete(
                    _p.replica_key(self.prefix, self.replica_id))
                self._coord.delete(
                    _p.stats_key(self.prefix, self.replica_id))
            except (ConnectionError, RuntimeError):
                pass  # coord gone; lease expiry will evict us anyway
            self._coord.close()
        if self._wire is not None:
            self._wire.stop()
        _M_DRAINS.inc()

    def kill(self):
        """Abrupt death for tests/chaos: the endpoint and lease keeper
        vanish WITHOUT deregistering — routers must discover it via
        connection failure or lease expiry, exactly like a crash."""
        # the wire dies FIRST — a crash does not politely answer
        # ST_CLOSED while it falls over; routers must see connection
        # failure (eager eviction + requeue), not a graceful refusal
        if self._wire is not None:
            self._wire.stop()
        # last flight-recorder image before the process state is torn
        # down — the postmortem's "what was in flight when it died"
        _telemetry.flight.dump(reason="kill")
        with self._mu:
            self._draining = True
        self._stats_stop.set()
        if self._stats_thread is not None:
            self._stats_thread.join(timeout=2)
        _telemetry.pusher.stop_pusher("replica:%s" % self.replica_id)
        if self._coord is not None:
            self._coord.close()   # stops the lease keeper; no delete
        if self._server is not None:
            self._server.close()


def _load_spec(environ=None):
    env = environ if environ is not None else os.environ
    raw = env.get(ENV_SPEC)
    if not raw:
        raise SystemExit("%s must hold the fleet spec (path or JSON)"
                         % ENV_SPEC)
    if raw.lstrip().startswith("{"):
        return json.loads(raw)
    with open(raw) as f:
        return json.load(f)


def main(argv=None):
    """Subprocess entry: install the preemption handlers, start the
    replica, serve until SIGTERM, drain, exit 0 (leaving the preempt
    marker when a heartbeat dir is configured)."""
    _preemption.install()
    replica = Replica(_load_spec())
    replica.start()
    sys.stderr.write(
        "fleet replica %s serving %s at %s (live_compiles=%d, "
        "nvcc_runs=%d)\n"
        % (replica.replica_id, ",".join(replica._models),
           replica.endpoint, replica.live_compiles, replica.nvcc_runs))
    sys.stderr.flush()
    replica.serve_forever()
    _preemption.write_preempt_marker()
    sys.stderr.write("fleet replica %s drained cleanly; exiting 0\n"
                     % replica.replica_id)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
