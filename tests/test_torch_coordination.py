"""The port's coordination service (paddle_tpu_torch/distributed/
coordination.py and wire.py): the single-process cases of
tests/test_coord_durability.py (WAL + snapshot crash recovery, the epoch
handshake, transparently reconnecting clients, the monotonic lease
clock), and interop with the reference package: a port ``CoordClient``
against a reference ``CoordServer`` and the reverse, a WAL directory
written by one server recovered by the other's, and, with telemetry
off, the frames of every opcode byte for byte equal between the
packages (requests and replies), the serving protocol's too."""

import json
import os
import threading
import time

import pytest

from paddle_tpu_torch.distributed import coordination, wire
from paddle_tpu_torch.distributed.coordination import (CoordClient, CoordServer,
                                                 SNAPSHOT_FILE, WAL_FILE)
from paddle_tpu_torch.fluid import monitor
from paddle_tpu_torch.serving import protocol as pfp
from paddle_tpu_torch import telemetry as ptel

from paddle_tpu.distributed import coordination as jcoord
from paddle_tpu.distributed import wire as jwire
from paddle_tpu.serving import protocol as jfp

def _restart(port, wal_dir, **kw):
    """Rebind the coordinator on the SAME port right after a crash —
    SO_REUSEADDR makes this safe, but give the kernel a beat if the
    listener teardown races the rebind."""
    deadline = time.time() + 10
    while True:
        try:
            return CoordServer(port=port, wal_dir=wal_dir, **kw).start()
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.1)


# -- crash recovery ---------------------------------------------------------

def test_crash_recovery_restores_kv_and_counters(tmp_path):
    """kill -9 (``crash()``: no final snapshot) + restart on the same
    WAL dir: every acknowledged mutation survives, the epoch bumps,
    and the SAME client object re-dials transparently."""
    wal = str(tmp_path / "wal")
    srv = CoordServer(wal_dir=wal).start()
    port, epoch0 = srv.port, srv.epoch
    cli = CoordClient(srv.endpoint, grace=30.0)
    try:
        cli.put("k1", b"v1")
        cli.put("k2", b"v2")
        assert cli.delete("k2") is True
        assert cli.add("ctr", 3) == 3
        srv.crash()
        srv = _restart(port, wal)
        assert srv.epoch == epoch0 + 1
        assert cli.get("k1") == b"v1"
        assert cli.get("k2") is None
        # journaled as the RESULT: replay cannot double-count the add
        assert cli.add("ctr", 2) == 5
        assert cli.server_epoch == srv.epoch
    finally:
        cli.close()
        srv.stop()


def test_clean_stop_compacts_into_snapshot(tmp_path):
    """A clean ``stop()`` snapshots and truncates the WAL, so the next
    start replays nothing."""
    wal = str(tmp_path / "wal")
    srv = CoordServer(wal_dir=wal).start()
    cli = CoordClient(srv.endpoint)
    try:
        cli.put("k", b"v")
    finally:
        cli.close()
        srv.stop()
    assert os.path.getsize(os.path.join(wal, WAL_FILE)) == 0
    snap = json.loads(open(os.path.join(wal, SNAPSHOT_FILE), "rb").read())
    assert "k" in snap["kv"]
    srv2 = CoordServer(wal_dir=wal)
    try:
        assert srv2._kv == {"k": b"v"}
        assert srv2.epoch == snap["epoch"] + 1
    finally:
        srv2.stop()


def test_periodic_snapshot_compacts_wal(tmp_path):
    """Every ``snapshot_every`` records the WAL is folded into an
    atomic snapshot and truncated; recovery still sees everything."""
    wal = str(tmp_path / "wal")
    snaps0 = monitor.counter("coord_snapshots_total").value
    srv = CoordServer(wal_dir=wal, snapshot_every=4).start()
    port = srv.port
    cli = CoordClient(srv.endpoint, grace=30.0)
    try:
        for i in range(10):
            cli.put("k%d" % i, b"v%d" % i)
        assert monitor.counter("coord_snapshots_total").value - snaps0 >= 2
        # only the records since the last snapshot remain in the log
        with open(os.path.join(wal, WAL_FILE), "rb") as f:
            assert len(f.read().splitlines()) < 4
        srv.crash()
        srv = _restart(port, wal)
        for i in range(10):
            assert cli.get("k%d" % i) == b"v%d" % i
    finally:
        cli.close()
        srv.stop()


def test_torn_wal_tail_is_tolerated(tmp_path):
    """A crash mid-append tears only the unacknowledged tail: replay
    keeps every record before it and stops at the torn line."""
    wal = str(tmp_path / "wal")
    srv = CoordServer(wal_dir=wal).start()
    port = srv.port
    cli = CoordClient(srv.endpoint, grace=30.0)
    try:
        for i in range(3):
            cli.put("k%d" % i, b"v")
        srv.crash()
        with open(os.path.join(wal, WAL_FILE), "ab") as f:
            f.write(b'{"o":"put","k":"torn","v":"A')  # no newline, no seq
        srv = _restart(port, wal)
        for i in range(3):
            assert cli.get("k%d" % i) == b"v"
        assert cli.get("torn") is None
    finally:
        cli.close()
        srv.stop()


def test_corrupt_snapshot_refuses_loudly(tmp_path):
    """Snapshots are written atomically, so garbage means operator
    error — the server must refuse to serve empty state over it."""
    wal = tmp_path / "wal"
    wal.mkdir()
    (wal / SNAPSHOT_FILE).write_bytes(b"\x00not json at all")
    with pytest.raises(RuntimeError, match="corrupt"):
        CoordServer(wal_dir=str(wal))


# -- barriers and watches across a restart ----------------------------------

def test_barrier_blocked_across_crash_releases_both(tmp_path):
    """The journaled arrival survives the crash; the blocked waiter
    re-dials and both ranks release with the SAME generation."""
    wal = str(tmp_path / "wal")
    srv = CoordServer(wal_dir=wal).start()
    port = srv.port
    a = CoordClient(srv.endpoint, grace=30.0)
    b = CoordClient(srv.endpoint, grace=30.0)
    got = {}
    try:
        t = threading.Thread(
            target=lambda: got.__setitem__(
                "a", a.barrier("bar", 2, "ra", timeout=60.0)))
        t.start()
        time.sleep(0.4)           # ra's arrival journaled; ra blocked
        srv.crash()
        srv = _restart(port, wal)
        got["b"] = b.barrier("bar", 2, "rb", timeout=60.0)
        t.join(60)
        assert not t.is_alive(), "blocked rank never released"
        assert got["a"] == got["b"]
    finally:
        a.close()
        b.close()
        srv.stop()


def test_blocked_wait_get_survives_restart(tmp_path):
    """A ``get(wait=True)`` watch blocked through the crash re-arms on
    the restarted server and still wakes on the put."""
    wal = str(tmp_path / "wal")
    srv = CoordServer(wal_dir=wal).start()
    port = srv.port
    a = CoordClient(srv.endpoint, grace=30.0)
    b = CoordClient(srv.endpoint, grace=30.0)
    got = {}
    try:
        t = threading.Thread(
            target=lambda: got.__setitem__(
                "v", a.get("late", wait=True, timeout=60.0)))
        t.start()
        time.sleep(0.3)
        srv.crash()
        srv = _restart(port, wal)
        b.put("late", b"ok")
        t.join(60)
        assert not t.is_alive(), "watcher never woke"
        assert got["v"] == b"ok"
    finally:
        a.close()
        b.close()
        srv.stop()


# -- leases: monotonic in memory, wall-clock on disk ------------------------

def test_lease_immune_to_wall_clock_step():
    """Satellite regression: in-memory lease deadlines live on the
    MONOTONIC clock — an NTP step (even a huge one) must not expire a
    live lease; only monotonic time passing may."""
    mono, wall = [100.0], [1.0e9]
    srv = CoordServer(clock=lambda: mono[0], wall=lambda: wall[0])
    try:
        srv._do_lease("c", 5.0)
        wall[0] += 3600.0         # one-hour NTP step forward
        assert json.loads(srv._do_live()[1:]) == ["c"]
        wall[0] -= 7200.0         # and a step backward
        assert json.loads(srv._do_live()[1:]) == ["c"]
        mono[0] += 6.0            # real time actually passing
        assert json.loads(srv._do_live()[1:]) == []
    finally:
        srv.stop()


def test_lease_wall_deadline_survives_restart(tmp_path):
    """Across a restart only the wall clock survives: the journaled
    absolute wall deadline converts back to a monotonic one, so the
    REMAINING ttl (minus the outage) is what the new server enforces."""
    wal = str(tmp_path / "wal")
    mono1, wall1 = [0.0], [1000.0]
    srv = CoordServer(wal_dir=wal, clock=lambda: mono1[0],
                      wall=lambda: wall1[0]).start()
    port = srv.port
    cli = CoordClient(srv.endpoint, grace=30.0)
    try:
        cli.lease("c", ttl=100.0)       # wall deadline 1100 journaled
        cli.forget_lease("c")           # no client-side replay: the
        srv.crash()                     # WAL alone must carry it
        # restart 60 wall-seconds into the outage: 40 s must remain
        mono2, wall2 = [500.0], [1060.0]
        srv = _restart(port, wal, clock=lambda: mono2[0],
                       wall=lambda: wall2[0])
        assert cli.live() == ["c"]
        mono2[0] += 50.0                # past the remaining 40 s
        assert cli.live() == []
    finally:
        cli.close()
        srv.stop()


def test_client_replays_leases_onto_amnesiac_server():
    """An EPHEMERAL coordinator restart loses all state — the client's
    post-reconnect lease replay re-establishes every lease it holds."""
    srv = CoordServer().start()
    port = srv.port
    cli = CoordClient(srv.endpoint, grace=30.0)
    try:
        cli.lease("member/x", ttl=60.0)
        srv.crash()
        deadline = time.time() + 10
        while True:                     # ephemeral rebind, same port
            try:
                srv = CoordServer(port=port).start()
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.1)
        cli.ping()                      # rides the reconnect; replay
        assert "member/x" in cli.live()  # runs after it completes
    finally:
        cli.close()
        srv.stop()


# -- epoch handshake + reconnect accounting ---------------------------------

def test_epoch_handshake_and_restart_counter(tmp_path):
    """The hello advertises the server epoch; a reconnect that lands on
    a bumped epoch is counted as kind=restart (vs resume)."""
    wal = str(tmp_path / "wal")
    srv = CoordServer(wal_dir=wal).start()
    port = srv.port
    cli = CoordClient(srv.endpoint, grace=30.0)
    restarts0 = coordination._m_reconnects("restart").value
    try:
        cli.ping()
        assert cli.server_epoch == srv.epoch
        srv.crash()
        srv = _restart(port, wal)
        cli.ping()
        assert cli.server_epoch == srv.epoch
        assert coordination._m_reconnects("restart").value \
            == restarts0 + 1
    finally:
        cli.close()
        srv.stop()


# -- oversized frames refused before the socket -----------------------------

def test_oversized_request_refused_client_side():
    """A request bigger than the frame cap raises FrameTooLarge BEFORE
    any byte hits the socket: no retry budget burned, and the very same
    connection keeps working for the next (smaller) request."""
    srv = CoordServer().start()
    cli = CoordClient(srv.endpoint, max_frame=256)
    try:
        with pytest.raises(wire.FrameTooLarge):
            cli.put("k", b"x" * 1024)
        cli.put("k", b"small")
        assert cli.get("k") == b"small"
    finally:
        cli.close()
        srv.stop()


# -- interop with the reference package -------------------------------------

def _exercise(cli):
    """One of each client opcode; returns what the calls returned."""
    out = [cli.put("fleet/replicas/a", b"{}"), cli.get("fleet/replicas/a"),
           cli.add("ctr", 4), cli.add("ctr", 1), cli.keys("fleet/"),
           cli.delete("ctr"), cli.get("ctr")]
    cli.lease("fleet/replicas/a", ttl=30.0)
    out += [cli.live(), cli.live_members("fleet/replicas/"), cli.ping(),
            cli.barrier("b1", 1, "c0", timeout=10.0)]
    return out


@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("ref", "port"), ("port", "ref")],
                         ids=["port_client_ref_server",
                              "ref_client_port_server"])
def test_client_and_server_interoperate(server_pkg, client_pkg):
    pkgs = {"ref": jcoord, "port": coordination}
    srv = pkgs[server_pkg].CoordServer().start()
    cli = pkgs[client_pkg].CoordClient(srv.endpoint)
    same = coordination.CoordClient(srv.endpoint) \
        if client_pkg == "ref" else jcoord.CoordClient(srv.endpoint)
    try:
        got = _exercise(cli)
        assert got[1] == b"{}" and got[2] == 4 and got[3] == 5
        assert got[8] == ["fleet/replicas/a"]
        # the other package's client reads what this one wrote
        assert same.get("fleet/replicas/a") == b"{}"
        assert same.live_members("fleet/replicas/") == ["fleet/replicas/a"]
        assert cli.server_epoch == same.server_epoch == srv.epoch
    finally:
        cli.close()
        same.close()
        srv.stop()


def test_wal_recovers_across_packages(tmp_path):
    """A reference server's WAL dir recovered by the port's server (and
    back): the journal and snapshot layouts are one format."""
    wal = str(tmp_path / "wal")
    srv = jcoord.CoordServer(wal_dir=wal).start()
    cli = jcoord.CoordClient(srv.endpoint)
    cli.put("k", b"ref")
    cli.add("n", 7)
    cli.close()
    srv.crash()
    port_srv = CoordServer(wal_dir=wal).start()
    pcli = CoordClient(port_srv.endpoint)
    try:
        assert pcli.get("k") == b"ref" and pcli.add("n", 1) == 8
        pcli.put("k2", b"port")
    finally:
        pcli.close()
        port_srv.stop()
    back = jcoord.CoordServer(wal_dir=wal).start()
    jcli = jcoord.CoordClient(back.endpoint)
    try:
        assert jcli.get("k2") == b"port" and jcli.add("n", 0) == 8
    finally:
        jcli.close()
        back.stop()


def _recording(conn_cls, log):
    orig = conn_cls.request

    def request(self, payload):
        resp = orig(self, payload)
        log.append((bytes(payload), bytes(resp)))
        return resp
    return orig, request


def test_frames_byte_identical_with_telemetry_off(monkeypatch):
    """With telemetry off, every coordination request the port's client
    sends and every reply its server gives equals the reference's, byte
    for byte, on the same call sequence; so do the serving protocol's
    request and reply frames."""
    assert not ptel.enabled()
    from paddle_tpu import telemetry as jtel
    assert not jtel.enabled()
    logs = {}
    for name, mod, wmod in (("port", coordination, wire),
                            ("ref", jcoord, jwire)):
        log = logs[name] = []
        orig, rec = _recording(wmod.Conn, log)
        monkeypatch.setattr(wmod.Conn, "request", rec)
        srv = mod.CoordServer().start()
        cli = mod.CoordClient(srv.endpoint)
        try:
            _exercise(cli)
        finally:
            cli.close()
            srv.stop()
        monkeypatch.setattr(wmod.Conn, "request", orig)
    assert [p for p, _ in logs["port"]] == [p for p, _ in logs["ref"]]
    # replies carry no time-dependent bytes for these opcodes
    assert [r for _, r in logs["port"]] == [r for _, r in logs["ref"]]
    import numpy as np
    feed = {"x": np.arange(12, dtype=np.float32).reshape(2, 6),
            "ids": np.arange(4, dtype=np.int64).reshape(2, 2)}
    for op in (pfp.OP_SUBMIT, pfp.OP_INFER):
        assert pfp.pack_request(op, "m", feed, 250.0, 1) == \
            jfp.pack_request(op, "m", feed, 250.0, 1)
    outs = [feed["x"][:1], np.zeros((0, 3), np.float16)]
    assert pfp.ok_reply(outs) == jfp.ok_reply(outs)
    assert pfp.err_reply(pfp.ST_CLOSED, "draining") == \
        jfp.err_reply(jfp.ST_CLOSED, "draining")
    assert (pfp.MAGIC_ROUTER, pfp.MAGIC_REPLICA) == \
        (jfp.MAGIC_ROUTER, jfp.MAGIC_REPLICA)
