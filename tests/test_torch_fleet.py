"""The port's serving fleet (paddle_tpu_torch/serving/) on the CPU: the
counterpart of each test of tests/test_fleet.py (membership via
coordination-KV leases, round trip and balance via published load
gauges, no-loss kill-one-replica re-dispatch, drain, typed shed and
``Closed``, the supervisor's SIGTERM drain and warm respawn from a
prelowered model with zero live compiles and no ``nvcc``), the two fleet
cases of tests/test_chaos.py (the coordinator killed and restarted under
a fleet, typed shed once the grace expires), and fleet answers held to
the reference's Predictor on one exported BERT-tiny encoder, rtol 1e-5
in fp32. Replicas run in-process as in the reference's tests; only the
supervisor's respawn and the SIGTERM drain start subprocesses."""

import json
import os
import signal
import sys
import time

import numpy as np
import pytest

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import inference
from paddle_tpu_torch.fluid import layers, monitor
from paddle_tpu_torch.distributed import wire as dwire
from paddle_tpu_torch.distributed.coordination import CoordClient, CoordServer
from paddle_tpu_torch.serving import FleetClient, Replica, Router
from paddle_tpu_torch.serving import protocol as fp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

class _DirectReplicaConn(dwire.Conn):
    """Test-only: talk to a replica endpoint without a router."""

    MAGIC = fp.MAGIC_REPLICA
    TOKEN_ENV = fp.ENV_TOKEN
    RETRIES = 0


# -- membership primitive (no accelerator needed) ---------------------------


def test_live_members_sweeps_expired_leases():
    """Registration = put(key, blob) + lease(key): live_members returns
    the key while the lease lives, and ONE server-side sweep evicts an
    expired member — lease AND registration blob — before the caller
    can observe it. Re-registering brings it straight back."""
    srv = CoordServer().start()
    cli = CoordClient("%s:%d" % (srv.host, srv.port))
    try:
        key = "fleet/replicas/rx"
        cli.put(key, b"{}")
        cli.lease(key, ttl=0.5)
        # a KV entry WITHOUT a lease is not a member (half-registered)
        cli.put("fleet/replicas/ghost", b"{}")
        assert cli.live_members("fleet/replicas/") == [key]
        time.sleep(0.8)
        # expiry: the sweep removes the lease and the registration blob
        assert cli.live_members("fleet/replicas/") == []
        assert cli.get(key) is None
        # ...but only under the asked-for prefix (scoped sweep)
        cli.put("other/replicas/ry", b"{}")
        cli.lease("other/replicas/ry", ttl=0.5)
        assert cli.live_members("fleet/replicas/") == []
        assert cli.live_members("other/replicas/") == ["other/replicas/ry"]
        # re-register after eviction: the same id joins again
        cli.put(key, b"{}")
        cli.lease(key, ttl=30.0)
        assert cli.live_members("fleet/replicas/") == [key]
    finally:
        cli.close()
        srv.stop()


# -- in-process fleets ------------------------------------------------------


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet_model")
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
    """CoordServer + N in-process replicas + router + client, torn down
    in reverse order."""

    def __init__(self, model_dir, n, model="fc", rid_prefix="rep",
                 lease_ttl=1.0):
        self.coord = CoordServer().start()
        self.addr = "%s:%d" % (self.coord.host, self.coord.port)
        spec = _spec(model_dir, model=model)
        self.replicas = [
            Replica(spec, coord_addr=self.addr,
                    replica_id="%s%d" % (rid_prefix, i),
                    lease_ttl=lease_ttl, stats_interval=0.05).start()
            for i in range(n)]
        self.router = Router(coord_addr=self.addr,
                             refresh_interval=0.05).start()
        self.client = FleetClient(
            "%s:%d" % (self.router.host, self.router.port))

    def close(self):
        self.client.close()
        self.router.close()
        for r in self.replicas:
            r.drain(timeout=5)
        self.coord.stop()


def test_fleet_round_trip_and_balance(model_dir):
    """Requests through router + replicas match the direct predictor,
    and equal-load replicas share the traffic (both routed counters
    advance — the occupancy/balance acceptance gauge)."""
    f = _Fleet(model_dir, 2, model="bal", rid_prefix="bal")
    try:
        assert sorted(f.router.members()) == ["bal0", "bal1"]
        direct = inference.create_predictor(inference.Config(model_dir, place="cpu"))
        rng = np.random.RandomState(3)
        for _ in range(16):
            x = rng.rand(rng.randint(1, 5), 6).astype(np.float32)
            out = f.client.submit("bal", {"x": x}, deadline_ms=10000)
            np.testing.assert_allclose(out[0], direct.run({"x": x})[0],
                                       atol=1e-5)
        per = {rid: monitor.counter("fleet_replica_routed_total",
                                    labels={"replica": rid}).value
               for rid in ("bal0", "bal1")}
        assert sum(per.values()) == 16
        assert per["bal0"] > 0 and per["bal1"] > 0, per
        assert monitor.get_metric("fleet_routed_total",
                                  labels={"model": "bal"}).value == 16
        e2e = monitor.get_metric("fleet_request_seconds",
                                 labels={"model": "bal"})
        assert e2e.count == 16 and 0 < e2e.quantile(0.5) <= e2e.quantile(0.99)
    finally:
        f.close()


def test_kill_one_replica_loses_no_requests(model_dir):
    """A killed replica (wire severed, lease left to expire — the crash
    shape) costs ZERO requests: in-flight forwards fail, the router
    evicts eagerly, re-dispatches (fleet_requeued_total), and lease
    expiry removes the corpse from the membership view."""
    f = _Fleet(model_dir, 2, model="kill", rid_prefix="kil",
               lease_ttl=0.6)
    try:
        direct = inference.create_predictor(inference.Config(model_dir, place="cpu"))
        rng = np.random.RandomState(5)
        # warm traffic so the router's conn pool reaches BOTH replicas
        for _ in range(8):
            x = rng.rand(2, 6).astype(np.float32)
            f.client.submit("kill", {"x": x}, deadline_ms=10000)
        requeued0 = monitor.counter("fleet_requeued_total").value
        f.replicas[0].kill()
        for _ in range(10):
            x = rng.rand(2, 6).astype(np.float32)
            out = f.client.submit("kill", {"x": x}, deadline_ms=10000)
            np.testing.assert_allclose(out[0], direct.run({"x": x})[0],
                                       atol=1e-5)
        assert monitor.counter("fleet_requeued_total").value > requeued0
        # the lease is the authority: the corpse leaves the coord view,
        # then the router's
        dbg = CoordClient(f.addr)
        deadline = time.time() + 10
        while ("fleet/replicas/kil0" in dbg.live_members("fleet/replicas/")
               and time.time() < deadline):
            time.sleep(0.05)
        assert dbg.live_members("fleet/replicas/") == \
            ["fleet/replicas/kil1"]
        dbg.close()
        while "kil0" in f.router.members() and time.time() < deadline:
            time.sleep(0.05)
        assert sorted(f.router.members()) == ["kil1"]
    finally:
        f.close()


def test_drain_deregisters_and_redirects(model_dir):
    """Graceful drain: the replica deregisters (KV deleted — it leaves
    the membership view without waiting out the lease), later traffic
    lands on the survivor, and double-drain is a no-op."""
    f = _Fleet(model_dir, 2, model="drn", rid_prefix="drn")
    try:
        rng = np.random.RandomState(7)
        f.replicas[0].drain(timeout=10)
        f.replicas[0].drain(timeout=10)   # idempotent
        dbg = CoordClient(f.addr)
        assert dbg.live_members("fleet/replicas/") == \
            ["fleet/replicas/drn1"]
        dbg.close()
        for _ in range(4):
            x = rng.rand(1, 6).astype(np.float32)
            out = f.client.submit("drn", {"x": x}, deadline_ms=10000)
            assert out[0].shape == (1, 3)
        assert monitor.counter("fleet_replica_routed_total",
                               labels={"replica": "drn1"}).value >= 4
    finally:
        f.close()


def test_empty_fleet_sheds_typed(model_dir):
    """No live replica: the router answers ST_OVERLOADED and the client
    raises the typed Overloaded — never a hang, never a bare error."""
    coord = CoordServer().start()
    router = Router(coord_addr="%s:%d" % (coord.host, coord.port),
                    refresh_interval=0.05).start()
    cli = FleetClient("%s:%d" % (router.host, router.port))
    try:
        shed0 = monitor.sum_labeled("fleet_shed_total")
        with pytest.raises(inference.Overloaded, match="no live replica"):
            cli.submit("fc", {"x": np.zeros((1, 6), np.float32)},
                       deadline_ms=500)
        assert monitor.sum_labeled("fleet_shed_total") == shed0 + 1
    finally:
        cli.close()
        router.close()
        coord.stop()


def test_draining_replica_answers_typed_closed(model_dir):
    """ST_CLOSED crosses the wire as the typed ``Closed``: a draining
    replica tells a DIRECT client (no router in between to re-pick)
    that retrying against it can never succeed."""
    r = Replica(_spec(model_dir, model="cls"), replica_id="cls0").start()
    try:
        r._draining = True        # drain flag only; wire stays up
        conn = _DirectReplicaConn(r.endpoint)
        try:
            req = fp.pack_request(
                fp.OP_INFER, "cls",
                {"x": np.zeros((1, 6), np.float32)}, 1000.0, 0)
            with pytest.raises(inference.Closed, match="draining"):
                fp.raise_for_status(conn.request(req))
        finally:
            conn.close()
    finally:
        r._draining = False
        r.drain(timeout=5)


# -- subprocess fleet (supervisor, SIGTERM drain, warm respawn) -------------


def test_supervisor_sigterm_drain_and_warm_respawn(model_dir, tmp_path):
    """The full process story: FleetSupervisor spawns replica processes,
    SIGTERM drains one gracefully (exit 0 through the preemption path),
    and the respawned process re-registers under the SAME id on a fresh
    endpoint. With prelowered models + a shared compile cache the
    respawn reports zero live compiles before rejoining."""
    from paddle_tpu_torch.serving.supervisor import FleetSupervisor

    # prelower the served ladder: children then load executables from
    # <model>/__prelowered__ instead of tracing+compiling live
    pre_dir = str(tmp_path / "pre_model")
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
        fluid.io.save_inference_model(
            pre_dir, ["x"], [prob], exe, main_program=main,
            prelower=True, prelower_batch_sizes=(1, 2, 4, 8))
    env = {"PADDLE_FLEET_LEASE_TTL": "2.0", "PYTHONPATH": REPO}
    coord = CoordServer().start()
    addr = "%s:%d" % (coord.host, coord.port)
    sup = FleetSupervisor(_spec(pre_dir), 1, addr, env=env,
                          log_dir=str(tmp_path))
    dbg = CoordClient(addr)
    try:
        sup.start()
        deadline = time.time() + 180
        key = "fleet/replicas/rep0"
        while (key not in dbg.live_members("fleet/replicas/")
               and time.time() < deadline):
            time.sleep(0.2)
        blob = json.loads(dbg.get(key).decode())
        pid0 = blob["pid"]
        assert blob["models"] == ["fc"]
        # SIGTERM-drain with respawn: preemption machinery finishes
        # in-flight work, deregisters, exits 0; the supervisor brings a
        # fresh process up under the same id
        rc = sup.drain("rep0", respawn=True, timeout=60)
        assert rc == 0
        while time.time() < deadline:
            blob = dbg.get(key)
            if blob is not None:
                info = json.loads(blob.decode())
                if info["pid"] != pid0:
                    break
            time.sleep(0.2)
        info = json.loads(dbg.get(key).decode())
        assert info["pid"] != pid0 and sup.respawns >= 1
        # warm respawn: zero live compiles — every ladder step came off
        # __prelowered__ disk entries
        assert info["live_compiles"] == 0, info
        assert info["warmup_disk_hits"] == 4, info
        assert info["nvcc_runs"] == 0, info
    finally:
        dbg.close()
        sup.stop(timeout=30)
        coord.stop()


# -- the coordinator dies under a fleet (tests/test_chaos.py) -------------

def _restart(port, wal_dir):
    deadline = time.time() + 10
    while True:
        try:
            return CoordServer(port=port, wal_dir=wal_dir).start()
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.1)


def test_fleet_rides_out_coordinator_crash(model_dir, tmp_path):
    """Acceptance: coordinator kill -9 + same-WAL restart under a
    2-replica fleet. The data path never touches the coordinator, so
    EVERY request is served (100% accounted, zero shed): healthy,
    degraded (stale routing table, ``fleet_stale_routing_total``
    grows), and recovered phases all included. The restarted server
    replays replica leases from its WAL at a bumped epoch and the
    router's refresh goes fresh again."""
    wal = str(tmp_path / "wal")
    srv = CoordServer(wal_dir=wal).start()
    addr, port, epoch0 = srv.endpoint, srv.port, srv.epoch
    dbg = CoordClient(addr, grace=10.0)
    reps, router, cli = [], None, None
    try:
        reps = [Replica(_spec(model_dir, model="fc"), coord_addr=addr,
                        replica_id="cx%d" % i, lease_ttl=5.0,
                        stats_interval=0.05).start()
                for i in range(2)]
        deadline = time.time() + 120
        while len(dbg.live_members("fleet/replicas/")) < 2:
            assert time.time() < deadline, "replicas never registered"
            time.sleep(0.05)
        router = Router(coord_addr=addr, refresh_interval=0.05).start()
        cli = FleetClient("%s:%d" % (router.host, router.port))
        rng = np.random.RandomState(3)
        shed0 = monitor.sum_labeled("fleet_shed_total")
        stale0 = monitor.counter("fleet_stale_routing_total").value

        def burst(n):
            for _ in range(n):
                x = rng.rand(rng.randint(1, 5), 6).astype(np.float32)
                out = cli.submit("fc", {"x": x}, deadline_ms=10000)
                assert out[0].shape == (x.shape[0], 3)

        burst(6)                       # healthy
        srv.crash()
        deadline = time.time() + 30    # detection = router's fail-fast
        while True:                    # coordination client (~1 s)
            with router._table_mu:
                stale = router._stale_since is not None
            if stale:
                break
            assert time.time() < deadline, "router never marked stale"
            time.sleep(0.05)
        burst(6)                       # degraded: last-known table
        assert monitor.counter(
            "fleet_stale_routing_total").value > stale0
        srv = _restart(port, wal)
        assert srv.epoch == epoch0 + 1
        deadline = time.time() + 60
        while True:
            with router._table_mu:
                fresh = router._stale_since is None \
                    and len(router._table) == 2
            if fresh:
                break
            assert time.time() < deadline, "router never recovered"
            time.sleep(0.05)
        burst(6)                       # recovered
        # 18/18 served above; shed-by-reason totals unchanged — the
        # outage never cost a request, typed or otherwise
        assert monitor.sum_labeled("fleet_shed_total") == shed0
    finally:
        if cli is not None:
            cli.close()
        if router is not None:
            router.close()
        for r in reps:
            r.drain(timeout=10)
        dbg.close()
        srv.stop()


def test_fleet_sheds_typed_after_grace_expires(model_dir, tmp_path):
    """Past the degraded-mode grace window the stale view is too old to
    trust: the table drops and requests shed typed ``no_replica`` —
    never an untyped error, never a hang."""
    from paddle_tpu_torch import inference

    wal = str(tmp_path / "wal")
    srv = CoordServer(wal_dir=wal).start()
    addr = srv.endpoint
    dbg = CoordClient(addr, grace=10.0)
    reps, router, cli = [], None, None
    try:
        reps = [Replica(_spec(model_dir, model="fc"), coord_addr=addr,
                        replica_id="gx0", lease_ttl=5.0,
                        stats_interval=0.05).start()]
        deadline = time.time() + 120
        while len(dbg.live_members("fleet/replicas/")) < 1:
            assert time.time() < deadline, "replica never registered"
            time.sleep(0.05)
        # grace=0: the first failed refresh already exceeds the window
        router = Router(coord_addr=addr, refresh_interval=0.05,
                        grace=0.0).start()
        cli = FleetClient("%s:%d" % (router.host, router.port))
        x = np.ones((1, 6), np.float32)
        assert cli.submit("fc", {"x": x}, deadline_ms=10000)[0].shape \
            == (1, 3)
        srv.crash()
        deadline = time.time() + 30
        while router.members():
            assert time.time() < deadline, "stale table never dropped"
            time.sleep(0.05)
        with pytest.raises(inference.Overloaded):
            cli.submit("fc", {"x": x}, deadline_ms=500)
    finally:
        if cli is not None:
            cli.close()
        if router is not None:
            router.close()
        # coordinator stays dead: deregistration RPCs can't land, so
        # tear the replicas down hard instead of drain()
        for r in reps:
            r.stop()
        dbg.close()
        srv.stop()




# -- a served encoder held to the reference ----------------------------------

def test_fleet_encoder_matches_reference_predictor(tmp_path):
    """A packed BERT-tiny encoder exported by the port with
    prelower=True, served by two in-process replicas (each registering
    with 0 live compiles, one disk hit per ladder size, no nvcc) behind a
    router to four client threads: every answer equals the reference's
    Predictor on the same directory and rows, rtol 1e-5 (fp32)."""
    import threading

    from paddle_tpu import inference as JI
    from paddle_tpu_torch.models import bert as PB

    feeds, seq = ["src_ids", "pos_ids", "sent_ids", "input_mask"], 16
    cfg = PB.BertConfig.tiny()
    cfg.use_fused_attention = "packed"
    with fluid.unique_name.guard():
        main, startup, enc = PB.build_encoder_program(cfg, seq_len=seq)
    exe, scope = fluid.Executor("cpu"), fluid.Scope()
    d = str(tmp_path / "enc")
    with fluid.scope_guard(scope):
        exe.run(startup, scope=scope)
        fluid.io.save_inference_model(d, feeds, [enc], exe,
                                      main_program=main, prelower=True,
                                      prelower_batch_sizes=(1, 2, 4, 8))
    warm = {n: {"shape": [1, seq] + ([1] if n == "input_mask" else []),
                "dtype": "float32" if n == "input_mask" else "int64"}
            for n in feeds}
    spec = {"prefix": "fleet/", "models": [{
        "name": "enc", "model_dir": d, "place": "cpu", "warmup": warm,
        "config": {"max_batch_size": 8, "max_queue_delay_ms": 5.0}}]}
    coord = CoordServer().start()
    reps = [Replica(spec, coord_addr=coord.endpoint, replica_id="enc%d" % i,
                    lease_ttl=2.0, stats_interval=0.05).start()
            for i in range(2)]
    router = Router(coord_addr=coord.endpoint, refresh_interval=0.05).start()
    endpoint = "%s:%d" % (router.host, router.port)
    try:
        for r in reps:
            info = r.describe()
            assert (info["live_compiles"], info["warmup_disk_hits"],
                    info["nvcc_runs"]) == (0, 4, 0), info
        batch = PB.synthetic_batch(PB.BertConfig.tiny(), 16, seq, seed=5)
        reqs = [{n: batch[n][i:i + 1 + i % 3] for n in feeds}
                for i in range(0, 16, 1)]
        outs, errs = [None] * len(reqs), []

        def client(k):
            cli = FleetClient(endpoint)
            try:
                for i in range(k, len(reqs), 4):
                    outs[i] = cli.submit("enc", reqs[i],
                                         deadline_ms=30000)[0]
            except Exception as e:  # surfaced below
                errs.append(e)
            finally:
                cli.close()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not errs, errs
        ref = JI.create_predictor(JI.Config(d))
        for req, out in zip(reqs, outs):
            np.testing.assert_allclose(out, ref.run(req)[0], rtol=1e-5,
                                       atol=1e-5)
    finally:
        router.close()
        for r in reps:
            r.drain(timeout=5)
        coord.stop()


def test_smoke_cold_start_and_fleet_phases_on_the_cpu():
    """chip_smoke.py's cold_start and fleet phases rehearsed on the CPU
    at BERT-tiny's widths (S 128): the export, two cold child processes
    from __prelowered__/ and from the cache dir, a fleet of two replica
    processes with one SIGTERM'd mid-traffic and respawned, every check
    of the phases but those only the card has (a library's source, the
    traced replay's kernels)."""
    import chip_smoke
    import torch
    from paddle_tpu_torch.kernels import attention as A
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.tiny()
    cfg.max_seq = chip_smoke.SERVE_SEQ
    got = chip_smoke.served_fleet(A, inference, monitor,
                                  torch.device("cpu"), cfg=cfg)
    assert {k: v["nvcc_runs"] for k, v in got.items()
            if k != "fleet_replicas_nvcc_runs"} == \
        {"prelowered": 0, "cache_dir": 0}
    assert got["fleet_replicas_nvcc_runs"] == [0, 0, 0]
