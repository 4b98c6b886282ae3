"""The port's telemetry plane (paddle_tpu_torch/telemetry/), the
counterpart of each unit test of tests/test_telemetry.py and of its
fleet trace test: distributed request tracing across the wire (client
-> router -> replica -> executor, one trace per submit), cross-process
metrics aggregation with exact merged quantiles, and the crash flight
recorder (SIGKILL/SIGUSR1/kill postmortems). The fleet runs the port's
Predictor on the CPU. The reference's launcher postmortem test waits for
``distributed.launch`` (ROADMAP queue 1 item 8). Frames and headers are
also held byte for byte to the reference's encoders."""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from threading import Thread

import numpy as np
import pytest

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import telemetry
from paddle_tpu_torch.fluid import layers, monitor
from paddle_tpu_torch.distributed import wire as dwire
from paddle_tpu_torch.distributed.coordination import CoordClient, CoordServer
from paddle_tpu_torch.serving import FleetClient, Replica, Router
from paddle_tpu_torch.serving import protocol as fp
from paddle_tpu_torch.telemetry import aggregate, flight, pusher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))



@pytest.fixture(autouse=True)
def _telemetry_clean(monkeypatch):
    """Every test starts with the plane off, an empty ring, and no
    leftover pusher/flight state — and leaves it that way."""
    monkeypatch.delenv("PADDLE_TELEMETRY_SERVICE", raising=False)
    monkeypatch.delenv("PADDLE_TELEMETRY_SAMPLE", raising=False)
    telemetry.disable()
    telemetry.clear()
    yield
    pusher.stop_pusher()
    flight.stop(final_dump=False)
    telemetry.disable()
    telemetry.clear()
    telemetry.set_max_spans(int(os.environ.get(
        telemetry.spans.ENV_MAX_SPANS, 65536) or 65536))


# -- trace context ----------------------------------------------------------


def test_header_roundtrip_and_malformed():
    ctx = telemetry.new_trace(baggage={"model": "fc"})
    d = telemetry.encode_header(ctx)
    back = telemetry.decode_header(json.loads(json.dumps(d)))
    assert back.trace_id == ctx.trace_id
    assert back.span_id == ctx.span_id
    assert back.baggage == {"model": "fc"}
    assert back.sampled is True
    # a foreign/garbled header must decode to None, never raise
    for junk in (None, "x", 7, [], {}, {"t": "a"}, {"s": "b"},
                 {"t": 1, "s": 2}, {"t": "", "s": ""}):
        assert telemetry.decode_header(junk) is None
    assert telemetry.encode_header(None) is None


def test_child_keeps_trace_and_sampling_verdict():
    root = telemetry.new_trace(sampled=False)
    child = telemetry.child_of(root)
    assert child.trace_id == root.trace_id
    assert child.parent_id == root.span_id
    assert child.span_id != root.span_id
    # the sampling verdict survives the wire: a child decoded on a far
    # host must never resurrect a dropped trace
    wired = telemetry.decode_header(telemetry.encode_header(child))
    assert wired.sampled is False
    telemetry.enable()
    with telemetry.span("dropped", parent=wired):
        pass
    assert telemetry.snapshot() == []
    n0 = len(telemetry.snapshot())
    assert telemetry.record_span("x", time.perf_counter(), 0.0,
                                 wired) is None
    assert len(telemetry.snapshot()) == n0


def test_span_ring_keeps_newest_and_counts_drops():
    telemetry.enable()
    telemetry.set_max_spans(4)
    for i in range(10):
        with telemetry.span("s%d" % i):
            pass
    recs = telemetry.snapshot()
    assert [r["name"] for r in recs] == ["s6", "s7", "s8", "s9"]
    assert telemetry.dropped_span_count() == 6


def test_ambient_nesting_and_chrome_lanes(tmp_path):
    telemetry.enable()
    with telemetry.span("outer", service="router") as outer:
        with telemetry.span("inner") as inner:
            assert inner.ctx.trace_id == outer.ctx.trace_id
            assert inner.ctx.parent_id == outer.ctx.span_id
    recs = telemetry.snapshot()
    by_name = {r["name"]: r for r in recs}
    # the nested span inherits the ambient service (chrome lane)
    assert by_name["inner"]["service"] == "router"
    assert by_name["inner"]["parent_id"] == by_name["outer"]["span_id"]
    # one pid lane per distinct (pid, service); an OPEN span (no dur —
    # the crash-in-flight shape) still exports, with zero width
    open_rec = dict(by_name["outer"], service="replica:r0", dur=None)
    meta, events = telemetry.merge_chrome_events([recs, [open_rec]])
    lanes = {m["args"]["name"] for m in meta if m["name"] == "process_name"}
    assert any(n.startswith("router") for n in lanes)
    assert any(n.startswith("replica:r0") for n in lanes)
    assert [e for e in events if e["dur"] == 0.0]
    path = telemetry.export_trace(str(tmp_path / "t.json"),
                                  trace_id=recs[0]["trace_id"])
    doc = json.load(open(path))
    assert any(e.get("cat") == "trace" for e in doc["traceEvents"])


# -- wire compatibility -----------------------------------------------------


def test_telemetry_off_frames_are_byte_identical():
    """The off-path acceptance: no trace key, ZERO new wire bytes — the
    frame matches a byte-for-byte reconstruction of the pre-telemetry
    encoding."""
    assert not telemetry.enabled()
    feed = {"x": np.arange(12, dtype=np.float32).reshape(2, 6)}
    frame = fp.pack_request(fp.OP_SUBMIT, "fc", feed, deadline_ms=250.0,
                            priority=1)
    assert frame == fp.pack_request(fp.OP_SUBMIT, "fc", feed,
                                    deadline_ms=250.0, priority=1,
                                    trace=None)
    import struct
    meta = json.dumps({"model": "fc", "deadline_ms": 250.0,
                       "priority": 1},
                      separators=(",", ":")).encode()
    legacy = (struct.pack("<BI", fp.OP_SUBMIT, len(meta)) + meta
              + fp.pack_arrays([feed["x"]], names=["x"]))
    assert frame == legacy
    assert b"trace" not in frame
    model, dl, prio, out, trace = fp.unpack_request(frame)
    assert (model, dl, prio, trace) == ("fc", 250.0, 1, None)
    np.testing.assert_array_equal(out["x"], feed["x"])


def test_traced_frame_roundtrip_adds_only_the_meta_key():
    ctx = telemetry.new_trace()
    feed = {"x": np.zeros((1, 6), np.float32)}
    frame = fp.pack_request(fp.OP_SUBMIT, "fc", feed,
                            trace=telemetry.encode_header(ctx))
    *_, trace = fp.unpack_request(frame)
    assert telemetry.decode_header(trace).trace_id == ctx.trace_id
    # old-format frame through the NEW decoder: trace is simply None
    *_, no_trace = fp.unpack_request(
        fp.pack_request(fp.OP_SUBMIT, "fc", feed))
    assert no_trace is None


# -- fleet fixtures (mirrors tests/test_fleet.py) ---------------------------


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("telemetry_model")
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 21
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data("x", shape=[6], dtype="float32")
        h = layers.fc(x, size=16, act="relu")
        prob = layers.softmax(layers.fc(h, size=3))
    exe = fluid.Executor("cpu")
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(str(d), ["x"], [prob], exe,
                                      main_program=main)
    return str(d)


def _spec(model_dir, model="fc", delay_ms=2.0):
    return {"prefix": "fleet/",
            "models": [{"name": model, "model_dir": model_dir,
                        "place": "cpu",
                        "warmup": {"x": {"shape": [1, 6],
                                         "dtype": "float32"}},
                        "config": {"max_batch_size": 8,
                                   "max_queue_delay_ms": delay_ms}}]}


class _Fleet:
    def __init__(self, model_dir, n, model="fc", rid_prefix="rep",
                 delay_ms=2.0):
        self.coord = CoordServer().start()
        self.addr = "%s:%d" % (self.coord.host, self.coord.port)
        spec = _spec(model_dir, model=model, delay_ms=delay_ms)
        self.replicas = [
            Replica(spec, coord_addr=self.addr,
                    replica_id="%s%d" % (rid_prefix, i),
                    lease_ttl=2.0, stats_interval=0.05).start()
            for i in range(n)]
        self.router = Router(coord_addr=self.addr,
                             refresh_interval=0.05).start()
        self.endpoint = "%s:%d" % (self.router.host, self.router.port)
        self.client = FleetClient(self.endpoint)

    def close(self):
        self.client.close()
        self.router.close()
        for r in self.replicas:
            r.drain(timeout=5)
        self.coord.stop()


# -- the e2e acceptance trace -----------------------------------------------


def test_one_submit_is_one_trace_across_the_fleet(model_dir, tmp_path):
    """FleetClient.submit through a live router + 2 replicas yields ONE
    trace: client.submit -> router.route -> router.dispatch ->
    replica.infer -> serving.queue_wait / serving.batch ->
    predictor.run -> executor.run, all under one trace_id, correctly
    parented, with the batch span LINKING >= 2 concurrent request
    spans, exported to chrome with client/router/replica lanes."""
    telemetry.enable()
    f = _Fleet(model_dir, 2, model="tr", rid_prefix="tr",
               delay_ms=40.0)
    try:
        telemetry.clear()  # drop warmup spans; keep only the submits
        n_clients = 6
        clients = [FleetClient(f.endpoint) for _ in range(n_clients)]
        outs, errs = [None] * n_clients, []

        def _one(i):
            try:
                x = np.full((1, 6), float(i), np.float32)
                outs[i] = clients[i].submit("tr", {"x": x},
                                            deadline_ms=10000)
            except Exception as e:  # surfaced below; thread must not die silently
                errs.append(e)
        threads = [Thread(target=_one, args=(i,))
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        for c in clients:
            c.close()
        assert not errs, errs
        assert all(o is not None and o[0].shape == (1, 3) for o in outs)

        recs = telemetry.snapshot()
        submits = [r for r in recs if r["name"] == "client.submit"]
        assert len(submits) == n_clients
        # one trace per submit — ids never collide across requests
        assert len({r["trace_id"] for r in submits}) == n_clients

        # walk one full trace
        tid = submits[0]["trace_id"]
        tr = telemetry.trace_spans(tid)
        names = {r["name"] for r in tr}
        assert {"client.submit", "router.route", "router.dispatch",
                "replica.infer", "serving.queue_wait"} <= names, names
        by = {r["name"]: r for r in tr}
        assert by["router.route"]["parent_id"] == \
            by["client.submit"]["span_id"]
        assert by["router.dispatch"]["parent_id"] == \
            by["router.route"]["span_id"]
        assert by["replica.infer"]["parent_id"] == \
            by["router.dispatch"]["span_id"]
        assert by["serving.queue_wait"]["parent_id"] == \
            by["replica.infer"]["span_id"]
        # every span is closed (dur filled) and service-labelled
        assert by["client.submit"]["service"] == "client"
        assert by["router.route"]["service"] == "router"
        assert by["replica.infer"]["service"].startswith("replica:tr")
        assert all(r["dur"] is not None for r in tr)

        # batch fan-in: with 6 concurrent submits inside a 40 ms window
        # over 2 replicas, some batch carried >= 2 requests, and its
        # links point at real replica.infer request spans of DIFFERENT
        # traces
        batches = [r for r in recs if r["name"] == "serving.batch"]
        assert batches
        linked = max(batches, key=lambda r: len(r.get("links", [])))
        assert len(linked["links"]) >= 2
        infer_ids = {(r["trace_id"], r["span_id"])
                     for r in recs if r["name"] == "replica.infer"}
        for link in linked["links"]:
            assert (link["trace_id"], link["span_id"]) in infer_ids
        assert len({l["trace_id"] for l in linked["links"]}) >= 2
        # the executor ran INSIDE a batch span's trace
        exec_spans = [r for r in recs if r["name"] == "executor.run"]
        batch_tids = {r["trace_id"] for r in batches}
        assert exec_spans and \
            {r["trace_id"] for r in exec_spans} <= batch_tids
        assert {r["trace_id"] for r in recs
                if r["name"] == "predictor.run"} <= batch_tids

        # merged chrome export: one lane per service
        path = telemetry.export_trace(str(tmp_path / "fleet.json"))
        doc = json.load(open(path))
        lanes = {e["args"]["name"].split(" (")[0]
                 for e in doc["traceEvents"]
                 if e.get("name") == "process_name"}
        assert "client" in lanes and "router" in lanes
        assert any(n.startswith("replica:tr") for n in lanes)
    finally:
        f.close()


def test_disabled_fleet_serves_with_zero_spans(model_dir):
    """The whole fleet path with telemetry OFF: requests serve, nothing
    is recorded, nothing rides the wire."""
    assert not telemetry.enabled()
    f = _Fleet(model_dir, 1, model="off", rid_prefix="off")
    try:
        telemetry.clear()
        out = f.client.submit("off", {"x": np.zeros((1, 6), np.float32)},
                              deadline_ms=10000)
        assert out[0].shape == (1, 3)
        assert telemetry.snapshot() == []
    finally:
        f.close()


class _DirectReplicaConn(dwire.Conn):
    MAGIC = fp.MAGIC_REPLICA
    TOKEN_ENV = fp.ENV_TOKEN
    RETRIES = 0


def test_traced_frame_against_telemetry_off_replica(model_dir):
    """Forward-compat: a NEW (traced) frame served by a replica with
    telemetry off — the header is ignored, the request serves."""
    assert not telemetry.enabled()
    r = Replica(_spec(model_dir, model="bc"), replica_id="bc0").start()
    try:
        conn = _DirectReplicaConn(r.endpoint)
        try:
            ctx = telemetry.new_trace()
            req = fp.pack_request(
                fp.OP_INFER, "bc", {"x": np.zeros((1, 6), np.float32)},
                10000.0, 0, trace=telemetry.encode_header(ctx))
            out = fp.raise_for_status(conn.request(req))
            assert out[0].shape == (1, 3)
            assert telemetry.snapshot() == []
            # backward-compat: an OLD (traceless) frame against the same
            # replica with telemetry ON serves untraced
            telemetry.enable()
            old = fp.pack_request(
                fp.OP_INFER, "bc", {"x": np.zeros((1, 6), np.float32)},
                10000.0, 0)
            out = fp.raise_for_status(conn.request(old))
            assert out[0].shape == (1, 3)
            assert [s for s in telemetry.snapshot()
                    if s["name"] == "replica.infer"] == []
        finally:
            conn.close()
    finally:
        r.drain(timeout=5)


# -- coordination RPC tracing -----------------------------------------------


def test_coord_rpc_spans_join_the_callers_trace():
    telemetry.enable()
    srv = CoordServer().start()
    cli = CoordClient("%s:%d" % (srv.host, srv.port))
    try:
        with telemetry.span("op", service="ctl") as sp:
            cli.put("k", b"v")
            assert cli.get("k") == b"v"
            tid = sp.ctx.trace_id
        rpc = [r for r in telemetry.trace_spans(tid)
               if r["name"] == "coord.rpc"]
        assert len(rpc) == 2
        assert {r["service"] for r in rpc} == {"coord"}
        assert all(r["parent_id"] == sp.ctx.span_id for r in rpc)
    finally:
        cli.close()
        srv.stop()


def test_coord_client_downgrades_against_old_server():
    """A pre-telemetry server answers 'unknown opcode' to the _TRACED
    envelope: the client resends unwrapped, remembers the downgrade,
    and every later RPC works untraced."""
    from paddle_tpu_torch.distributed import coordination as dcoord

    class _OldServer(CoordServer):
        def _handle(self, req):
            if req and req[0] == dcoord._TRACED:  # trace: simulating a peer too old to know the envelope
                return b"\x01decode error: unknown opcode 13"
            return CoordServer._handle(self, req)

    telemetry.enable()
    srv = _OldServer().start()
    cli = CoordClient("%s:%d" % (srv.host, srv.port))
    try:
        with telemetry.span("op"):
            cli.put("k", b"v")      # first RPC triggers the downgrade
            assert cli.get("k") == b"v"
        assert cli._trace_ok is False
        assert [r for r in telemetry.snapshot()
                if r["name"] == "coord.rpc"] == []
    finally:
        cli.close()
        srv.stop()


def test_coord_client_reprobes_trace_after_server_restart():
    """The _TRACED downgrade must not outlive the server that caused
    it: when the client reconnects (old server replaced by a modern
    build on the same endpoint), it re-probes the envelope and traces
    flow again."""
    from paddle_tpu_torch.distributed import coordination as dcoord

    class _OldServer(CoordServer):
        def _handle(self, req):
            if req and req[0] == dcoord._TRACED:  # trace: simulating a peer too old to know the envelope
                return b"\x01decode error: unknown opcode 13"
            return CoordServer._handle(self, req)

    telemetry.enable()
    srv = _OldServer().start()
    port = srv.port
    cli = CoordClient("%s:%d" % (srv.host, srv.port), grace=30.0)
    try:
        with telemetry.span("op"):
            cli.put("k", b"v")
        assert cli._trace_ok is False      # downgraded, stays down...
        srv.crash()
        deadline = time.time() + 10
        while True:                        # modern build, same endpoint
            try:
                srv = CoordServer(port=port).start()
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.1)
        with telemetry.span("op2") as sp:
            cli.put("k", b"v2")            # rides the reconnect (sent
            #                                unwrapped); probe re-arms
            cli.put("k", b"v3")            # ...and this one re-probes
            tid = sp.ctx.trace_id
        assert cli._trace_ok is not False  # downgrade forgotten
        assert [r for r in telemetry.trace_spans(tid)
                if r["name"] == "coord.rpc"]
    finally:
        cli.close()
        srv.stop()


# -- metrics aggregation ----------------------------------------------------


def _hist_snapshot_entry(name, values, buckets):
    h = monitor.Histogram(name, buckets=buckets)
    for v in values:
        h.observe(v)
    return {"name": name, "kind": "histogram", "labels": {}, "help": "",
            "bounds": list(h.buckets), "counts": h.bucket_counts(),
            "sum": h.sum, "count": h.count, "min": h._min, "max": h._max}


def test_merged_quantiles_equal_union_quantiles():
    """The exactness acceptance: two processes' histogram snapshots
    merge to EXACTLY what one process observing the union would
    report — every quantile, min/max clamps included."""
    buckets = monitor.default_buckets()
    rng = np.random.RandomState(11)
    a = list(rng.lognormal(-3, 2, 400))
    b = list(rng.lognormal(-1, 1, 300))
    snaps = [
        {"proc": "a", "ts": 1.0, "metrics": [
            _hist_snapshot_entry("lat_seconds", a, buckets),
            {"name": "req_total", "kind": "counter", "labels": {},
             "help": "", "value": 7},
            {"name": "depth", "kind": "gauge", "labels": {},
             "help": "", "value": 3}]},
        {"proc": "b", "ts": 2.0, "metrics": [
            _hist_snapshot_entry("lat_seconds", b, buckets),
            {"name": "req_total", "kind": "counter", "labels": {},
             "help": "", "value": 5},
            {"name": "depth", "kind": "gauge", "labels": {},
             "help": "", "value": 9}]},
    ]
    union = monitor.Histogram("union", buckets=buckets)
    for v in a + b:
        union.observe(v)
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        got = aggregate.merged_quantile(snaps, "lat_seconds", q)
        want = union.quantile(q)
        assert got == pytest.approx(want, rel=1e-12), (q, got, want)
    metrics, kinds = aggregate.merge(snaps)
    by = {m.name: m for m in metrics}
    assert by["req_total"].value == 12          # counters SUM
    assert by["depth"].value == 9               # gauges last-write-wins
    assert by["lat_seconds"].count == 700
    assert kinds["lat_seconds"][0] == "histogram"
    text = aggregate.merged_prometheus(snaps)
    assert "req_total 12" in text
    assert "lat_seconds_count 700" in text


def test_merge_rejects_bucket_bound_skew():
    snaps = [
        {"proc": "a", "ts": 1.0, "metrics": [
            _hist_snapshot_entry("h", [0.1], (0.1, 1.0))]},
        {"proc": "b", "ts": 2.0, "metrics": [
            _hist_snapshot_entry("h", [0.1], (0.5, 1.0))]},
    ]
    with pytest.raises(ValueError, match="bucket bounds differ"):
        aggregate.merge(snaps)


def test_pusher_publishes_leased_snapshots_to_the_kv():
    """push -> collect round trip through a real coordination server:
    two publishers, both collected, counters merge as a sum; a lapsed
    lease ages the publisher out of the view."""
    srv = CoordServer().start()
    addr = "%s:%d" % (srv.host, srv.port)
    cli = CoordClient(addr)
    c = monitor.counter("tele_test_total", help="x")
    c.inc(4)
    try:
        pusher.push_once(cli, "p1", ttl=30.0)
        pusher.push_once(cli, "p2", ttl=0.4)
        snaps = pusher.collect_metrics(addr)
        assert {s["proc"] for s in snaps} == {"p1", "p2"}
        metrics, _ = aggregate.merge(snaps)
        by = {(m.name, tuple(m.labels.items())): m for m in metrics}
        assert by[("tele_test_total", ())].value == 8  # 4 from each
        spans_lists = pusher.collect_spans(addr)
        assert len(spans_lists) == 2
        time.sleep(0.6)  # p2's lease lapses: dead publisher ages out
        snaps = pusher.collect_metrics(addr)
        assert {s["proc"] for s in snaps} == {"p1"}
    finally:
        cli.close()
        srv.stop()


def test_pusher_oversized_snapshot_counted_and_dropped():
    """A snapshot bigger than the frame cap is refused CLIENT-side
    (FrameTooLarge before a byte hits the socket): the one-shot caller
    sees the raise, the pusher loop counts+drops it without touching
    the error counter, and the connection is NOT wedged — the same
    client keeps serving normal-sized requests."""
    srv = CoordServer().start()
    addr = "%s:%d" % (srv.host, srv.port)
    # tiny cap: the global monitor registry's JSON blob cannot fit
    cli = CoordClient(addr, grace=5.0, max_frame=512)
    over0 = monitor.counter("telemetry_push_oversize_total").value
    errs0 = monitor.counter("telemetry_push_errors_total").value
    try:
        with pytest.raises(dwire.FrameTooLarge):
            pusher.push_once(cli, "pbig", ttl=30.0)
        # the loop path: counted as oversize, NOT as a transport error
        pusher.start_pusher(cli, "pbig", interval=60.0)
        assert monitor.counter(
            "telemetry_push_oversize_total").value >= over0 + 1
        assert monitor.counter(
            "telemetry_push_errors_total").value == errs0
        cli.put("k", b"small")          # connection still usable
        assert cli.get("k") == b"small"
    finally:
        pusher.stop_pusher()
        cli.close()
        srv.stop()


# -- flight recorder --------------------------------------------------------


def test_flight_dump_and_collect(tmp_path):
    telemetry.enable()
    d = str(tmp_path / "fl")
    assert flight.start(dirname=d, rank="7", interval=30.0) == d
    with telemetry.span("request", service="replica:7"):
        monitor.counter("flight_t_total", help="x").inc(3)
        path = flight.dump(reason="test")  # mid-span: the span is OPEN
    assert path and os.path.exists(path)
    images = flight.collect(d)
    assert set(images) == {"7"}
    img = images["7"]
    assert img["schema"] == 1 and img["reason"] == "test"
    assert img["rank"] == "7" and img["pid"] == os.getpid()
    last = img["spans"][-1]
    assert last["name"] == "request" and last["dur"] is None
    assert img["monitor_delta"].get("flight_t_total") == 3
    # deltas are per-flush: an immediate second dump shows no new work
    flight.dump(reason="again")
    assert "flight_t_total" not in flight.collect(d)["7"]["monitor_delta"]
    # corrupt sibling files are skipped, not fatal
    (tmp_path / "fl" / "flight.bad.json").write_text("{truncated")
    assert set(flight.collect(d)) == {"7"}
    flight.stop(final_dump=False)
    assert not flight.is_active()


def test_flight_records_wire_ops(tmp_path):
    d = str(tmp_path / "fw")
    flight.start(dirname=d, rank="w", interval=30.0)
    srv = CoordServer().start()
    cli = CoordClient("%s:%d" % (srv.host, srv.port))
    try:
        cli.put("k", b"v")
        assert cli.get("k") == b"v"
    finally:
        cli.close()
        srv.stop()
    flight.dump(reason="wire")
    ops = flight.collect(d)["w"]["wire_ops"]
    assert ops, "framed coordination traffic must land in the ring"
    assert {o["dir"] for o in ops} <= {"send", "recv"}
    assert all(o["bytes"] > 0 for o in ops)
    flight.stop(final_dump=False)


_WORKER = textwrap.dedent("""
    import os, sys, time
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.distributed import preemption

    telemetry.enable("worker")
    telemetry.flight.start(dirname=sys.argv[1], rank=sys.argv[2],
                           interval=float(sys.argv[3]))
    preemption.install()
    scope = telemetry.span("inflight.request",
                           attrs={"step": 42})
    scope.__enter__()           # stays OPEN: the in-flight work at death
    print("READY", flush=True)
    time.sleep(30)
""")


def _spawn_worker(tmp_path, rank, interval=0.05):
    proc = subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(tmp_path), rank,
         str(interval)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.stdout.readline().strip() == b"READY"
    return proc


def test_flight_survives_sigkill_with_open_span(tmp_path):
    """The supervisor-kill acceptance shape: SIGKILL (uncatchable, like
    FleetSupervisor.kill) still leaves a flight image — the periodic
    flusher's last write — whose newest span is the OPEN in-flight
    request."""
    proc = _spawn_worker(tmp_path, "k0")
    try:
        time.sleep(0.5)          # a few flush intervals
        proc.kill()              # SIGKILL: no handler can run
        proc.wait(timeout=10)
        images = flight.collect(str(tmp_path))
        assert "k0" in images
        img = images["k0"]
        assert img["reason"] == "periodic"
        last = img["spans"][-1]
        assert last["name"] == "inflight.request"
        assert last["dur"] is None and last["attrs"]["step"] == 42
    finally:
        if proc.poll() is None:
            proc.kill()


def test_flight_dumps_on_watchdog_stack_signal(tmp_path):
    """The watchdog-hang acceptance shape: SIGUSR1 (what the hung-step
    watchdog sends) triggers an IMMEDIATE dump through the preemption
    chain, tagged stack_signal, in-flight span included."""
    # long flush interval: the triggered dump must not be overwritten
    # by a periodic flush before the test reads it
    proc = _spawn_worker(tmp_path, "h0", interval=30.0)
    try:
        deadline = time.time() + 10
        os.kill(proc.pid, signal.SIGUSR1)
        while time.time() < deadline:
            img = flight.collect(str(tmp_path)).get("h0")
            if img and img["reason"] == "stack_signal":
                break
            time.sleep(0.05)
        assert img and img["reason"] == "stack_signal", img
        assert img["spans"][-1]["name"] == "inflight.request"
    finally:
        proc.kill()
        proc.wait(timeout=10)


def test_supervisor_exports_flight_dir_and_collects(tmp_path):
    """FleetSupervisor plumbs PADDLE_FLIGHT_DIR to every child and
    collects survivors' rings for the postmortem."""
    from paddle_tpu_torch.serving.supervisor import FleetSupervisor

    sup = FleetSupervisor({}, 1, "127.0.0.1:1", log_dir=str(tmp_path))
    sup._spec_path = "unused"
    env = sup._child_env("rep0")
    assert env["PADDLE_FLIGHT_DIR"] == sup.flight_dir
    assert os.path.isdir(sup.flight_dir)
    image = {"schema": 1, "rank": "rep0", "reason": "kill",
             "spans": [{"name": "replica.infer", "dur": None}]}
    with open(os.path.join(sup.flight_dir, "flight.rep0.json"), "w") as f:
        json.dump(image, f)
    assert sup.collect_flight()["rep0"]["reason"] == "kill"
    assert sup.collect_flight("rep0")["spans"][-1]["dur"] is None
    assert sup.collect_flight("missing") is None


def test_replica_kill_dumps_flight_ring(model_dir, tmp_path):
    """The in-process Replica.kill() path (the crash-shape used by the
    no-loss fleet test) writes a final flight image tagged 'kill'."""
    telemetry.enable()
    d = str(tmp_path / "rk")
    flight.start(dirname=d, rank="kr0", interval=30.0)
    r = Replica(_spec(model_dir, model="kr"), replica_id="kr0").start()
    r.kill()
    images = flight.collect(d)
    assert "kr0" in images and images["kr0"]["reason"] == "kill"


def test_supervisor_kill_leaves_flight_postmortem(model_dir, tmp_path):
    """Full acceptance: a SIGKILLed replica SUBPROCESS leaves
    flight.<rid>.json in the supervisor's flight dir; collect_flight
    reads it back after the fact."""
    from paddle_tpu_torch.serving.supervisor import FleetSupervisor

    coord = CoordServer().start()
    addr = "%s:%d" % (coord.host, coord.port)
    sup = FleetSupervisor(
        _spec(model_dir), 1, addr,
        env={"PADDLE_TELEMETRY": "1", "PADDLE_FLIGHT_FLUSH_MS": "100",
             "PADDLE_FLEET_LEASE_TTL": "2.0", "PYTHONPATH": REPO},
        log_dir=str(tmp_path))
    dbg = CoordClient(addr)
    try:
        sup.start()
        deadline = time.time() + 180
        while ("fleet/replicas/rep0" not in
               dbg.live_members("fleet/replicas/")
               and time.time() < deadline):
            time.sleep(0.2)
        time.sleep(0.5)           # let a couple of flushes land
        sup.kill("rep0")
        deadline = time.time() + 30
        while time.time() < deadline:
            img = sup.collect_flight("rep0")
            if img is not None:
                break
            time.sleep(0.2)
        assert img is not None, "no flight image after SIGKILL"
        assert img["rank"] == "rep0"
        assert img["service"].startswith("replica")
    finally:
        dbg.close()
        sup.stop(timeout=30)
        coord.stop()
