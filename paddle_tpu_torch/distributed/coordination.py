"""Coordination service: the TCP control plane (the reference's
``gen_nccl_id`` over gRPC, a tiny RPC service every trainer contacts
before the first collective runs). The port's copy of
``paddle_tpu/distributed/coordination.py``, the same opcodes, frames
and WAL layout, so clients and servers of the two packages interoperate.
Here the serving fleet registers through it; the launcher and the
rendezvous backends that also use it wait for ROADMAP queue 1 item 8.

One ``CoordServer`` (standalone, or hosted by a launcher) holds the
whole control-plane state in memory:

  * a key-value store (small blobs) with wait-and-watch GET — the
    primitive rendezvous, rank assignment, and fleet membership are
    built from;
  * generation-numbered barriers with idempotent arrival (a retried
    ARRIVE after a dropped response must not count twice);
  * liveness leases (the file-heartbeat model of the reference's
    ``heartbeat.py`` over TCP) — a client renews ``lease(id, ttl)``; ``live()``
    is the set whose leases have not expired.

Transport is the shared ``distributed/wire.py`` framing (length-prefix,
magic+token handshake under ``PADDLE_COORD_TOKEN``, reconnect with the
``fluid.resilience.Retry`` policy at site ``coord.rpc``). Server-side
blocking is deliberately SHORT per request (≤ ``_WAIT_SLICE``): the
client's socket carries a fixed timeout, so long waits are client-side
loops of short server-side waits — a dropped connection mid-wait then
costs one slice, not the whole deadline.

Durability (``CoordServer(wal_dir=...)``): every mutation is journaled
to an append-only WAL (JSON lines, fsync'd before the ack) and
periodically compacted into an atomic snapshot (tmp+fsync+rename via
the shared ``fluid.io`` helper), so a kill -9 loses nothing that was
acknowledged. A restarted server replays snapshot+WAL, bumps its
**epoch**, and advertises it in the handshake hello — reconnecting
clients can therefore tell "the server restarted" (re-probe
capabilities, replay leases) from "a partition healed" (nothing was
lost). Leases are persisted with ABSOLUTE wall-clock deadlines (only
wall time survives a restart) but swept in-memory on the monotonic
clock, so an NTP step can never mass-expire live members.

Client resilience: ``CoordClient(grace=...)`` re-dials through
outages up to the grace window (``PADDLE_COORD_GRACE_S``, default
30 s) with the shared ``Retry`` policy; after any reconnect it
re-asserts every lease it holds, re-probes ``_TRACED`` support, and
fires registered ``on_reconnect`` callbacks (fleet replicas
re-register through this). Barrier arrivals are generation-numbered
and idempotent per client id, so replayed requests can never
double-count.

Env contract: ``PADDLE_COORD_ADDR`` (host:port of a live server) is
where fleet replicas register (``PADDLE_COORD_BACKEND`` selects a
rendezvous backend once the port has one); ``PADDLE_COORD_WAL_DIR``
makes standalone servers durable; ``PADDLE_COORD_GRACE_S`` bounds client re-dial patience.
"""

import base64
import json
import os
import struct
import sys
import threading
import time

from ..fluid import faults as _faults
from ..fluid import monitor as _monitor
from . import wire as _wire

__all__ = ["ENV_ADDR", "ENV_BACKEND", "ENV_TOKEN", "ENV_WAL_DIR",
           "ENV_GRACE", "CoordServer", "CoordClient",
           "current_coord_addr"]

ENV_ADDR = "PADDLE_COORD_ADDR"
ENV_BACKEND = "PADDLE_COORD_BACKEND"
ENV_TOKEN = "PADDLE_COORD_TOKEN"
ENV_WAL_DIR = "PADDLE_COORD_WAL_DIR"
ENV_GRACE = "PADDLE_COORD_GRACE_S"
ENV_WAL_FSYNC = "PADDLE_COORD_WAL_FSYNC"
ENV_SNAPSHOT_EVERY = "PADDLE_COORD_SNAPSHOT_EVERY"

# client re-dial budget across a coordinator outage (seconds)
_DEFAULT_GRACE = 30.0

# WAL/snapshot layout inside wal_dir
WAL_FILE = "wal.jsonl"
SNAPSHOT_FILE = "snapshot.json"

_MAGIC = b"PTCO1"

# opcodes
(_PUT, _GET, _DEL, _ADD, _LIST, _BAR_ARRIVE, _BAR_WAIT, _LEASE, _LIVE,
 _PING, _STOP, _LIVE_MEMBERS) = range(1, 13)
# telemetry envelope: opcode + u16 header len + JSON trace header +
# the ORIGINAL request. A prefix wrapper rather than a trailing field
# because _PUT consumes req[off:] as the value — appended trace bytes
# would corrupt every stored blob. Old servers answer it with "unknown
# opcode"; the client then falls back to unwrapped requests.
_TRACED = 13

# server-side waits are bounded by this slice; clients loop short waits
# up to their own deadline (see module doc)
_WAIT_SLICE = 5.0

# control-plane blobs are small (world plans, endpoints, nccl-id-sized
# payloads); a far lower cap than the PS tier keeps a bad peer from
# parking 256 MiB in the KV store
_MAX_FRAME = int(os.environ.get("PADDLE_COORD_MAX_FRAME_BYTES",
                                16 * 1024 * 1024))

_M_PUTS = _monitor.counter(
    "coord_puts_total", "KV put requests served by the coordination service")
_M_GETS = _monitor.counter(
    "coord_gets_total", "KV get requests served by the coordination service")
_M_BARRIERS = _monitor.counter(
    "coord_barriers_total", "barrier generations released")
_M_BARRIER_WAIT = _monitor.histogram(
    "coord_barrier_wait_seconds",
    "per-participant wall time from arrival to barrier release")
_M_WATCHERS = _monitor.gauge(
    "coord_watch_clients",
    "requests currently blocked server-side in a wait (watching GET or "
    "barrier wait)")
_M_WAL_RECORDS = _monitor.counter(
    "coord_wal_records_total",
    "mutations journaled to the coordination write-ahead log")
_M_SNAPSHOTS = _monitor.counter(
    "coord_snapshots_total",
    "compacted coordination-state snapshots written (WAL truncated)")

_M_RECONNECTS = {}


def _m_reconnects(kind):
    c = _M_RECONNECTS.get(kind)
    if c is None:
        c = _M_RECONNECTS[kind] = _monitor.counter(
            "coord_client_reconnects_total",
            help="client re-dials that succeeded, by kind (resume: same "
                 "server epoch, a partition healed; restart: the epoch "
                 "changed, the server was restarted/replaced)",
            labels={"kind": kind})
    return c


def current_coord_addr():
    """The coordination-service endpoint this process should use, or
    None outside a TCP-coordinated job."""
    return os.environ.get(ENV_ADDR) or None


def _pack_str(s):
    b = s.encode()
    if len(b) > 0xFFFF:
        raise ValueError("string field of %d bytes too long" % len(b))
    return struct.pack("<H", len(b)) + b


def _unpack_str(buf, off):
    try:
        (n,) = struct.unpack_from("<H", buf, off)
        off += 2
        s = buf[off:off + n]
        if len(s) != n:
            raise _wire.DecodeError("truncated string field")
        return s.decode("utf-8"), off + n
    except (struct.error, UnicodeDecodeError) as e:
        raise _wire.DecodeError("malformed string field: %r" % e)


def _unpack(fmt, buf, off):
    try:
        vals = struct.unpack_from(fmt, buf, off)
    except struct.error as e:
        raise _wire.DecodeError("truncated fields %s: %r" % (fmt, e))
    return vals, off + struct.calcsize(fmt)


class _Barrier:
    __slots__ = ("generation", "arrived", "arrive_ts")

    def __init__(self):
        self.generation = 0
        self.arrived = set()
        self.arrive_ts = {}


class CoordServer(_wire.FramedServer):
    """Threaded control-plane server. All state lives under one
    ``threading.Condition`` — every mutation notifies, every wait is a
    bounded ``wait_for`` on it; with tens of clients and
    control-plane-sized traffic the single lock is nowhere near
    contention.

    With ``wal_dir`` set the server is CRASH-RECOVERABLE: mutations are
    journaled (fsync'd) before they are acknowledged, snapshots compact
    the log, and a restart with the same ``wal_dir`` resumes with the
    full KV/counter/barrier/lease state at a bumped epoch. Without it
    the server is the original ephemeral in-memory service (epoch
    derived from the wall clock so restarts are still detectable).

    ``clock``/``wall`` are injectable for tests: ``clock`` (monotonic
    domain) drives every in-memory deadline and sweep, ``wall`` is used
    ONLY to persist absolute lease deadlines across restarts — a wall
    clock step therefore cannot expire a live lease."""

    MAGIC = _MAGIC
    TOKEN_ENV = ENV_TOKEN

    def __init__(self, host="127.0.0.1", port=0, token=None,
                 wal_dir=None, snapshot_every=None, clock=time.monotonic,
                 wall=time.time):
        super().__init__(host=host, port=port, token=token, backlog=64)
        self._clock = clock
        self._wall = wall
        self._cv = threading.Condition()
        self._kv = {}             # key -> bytes
        self._barriers = {}       # name -> _Barrier
        self._leases = {}         # client id -> MONOTONIC expiry deadline
        self._wal_dir = wal_dir
        self._snapshot_every = int(
            snapshot_every if snapshot_every is not None
            else os.environ.get(ENV_SNAPSHOT_EVERY, 512) or 512)
        self._wal_fsync = os.environ.get(ENV_WAL_FSYNC, "1") != "0"
        self._wal_f = None
        self._seq = 0             # last journaled/applied record number
        self._since_snapshot = 0
        if wal_dir:
            os.makedirs(wal_dir, exist_ok=True)
            self._epoch = self._recover() + 1
            # make the new epoch durable (and compact the replayed WAL)
            # BEFORE the first client can be answered
            self._snapshot_locked()
        else:
            self._epoch = int(self._wall() * 1000.0) & 0xFFFFFFFFFFFF

    @property
    def epoch(self):
        """Monotonically increasing server incarnation number,
        advertised in the handshake hello."""
        return self._epoch

    def _hello_payload(self):
        return struct.pack("<Q", self._epoch)

    # -- durability ---------------------------------------------------------
    def _wal_path(self):
        return os.path.join(self._wal_dir, WAL_FILE)

    def _snap_path(self):
        return os.path.join(self._wal_dir, SNAPSHOT_FILE)

    def _recover(self):
        """Rebuild state from snapshot + WAL tail; returns the
        recovered epoch (0 for a fresh dir). Replay skips records the
        snapshot already covers (``seq`` guard — a crash between the
        snapshot rename and the WAL truncate leaves such records) and
        stops at the first torn line (a crash mid-append tears only
        the unacknowledged tail)."""
        epoch, snap_seq = 0, 0
        try:
            with open(self._snap_path(), "rb") as f:
                snap = json.loads(f.read().decode())
        except FileNotFoundError:
            snap = None
        except (ValueError, OSError, UnicodeDecodeError) as e:
            # the snapshot is written atomically, so garbage here is
            # operator error (wrong dir, torn copy) — refuse loudly
            # rather than silently serving empty state
            raise RuntimeError("corrupt coordination snapshot %s: %r"
                               % (self._snap_path(), e))
        if snap is not None:
            epoch = int(snap.get("epoch", 0))
            snap_seq = int(snap.get("seq", 0))
            self._apply_snapshot(snap)
        self._seq = snap_seq
        try:
            f = open(self._wal_path(), "rb")
        except FileNotFoundError:
            return epoch
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line.decode())
                    seq = int(rec["s"])
                except (ValueError, KeyError, UnicodeDecodeError):
                    break         # torn tail: everything before it holds
                if seq <= snap_seq:
                    continue
                self._apply(rec)
                self._seq = seq
        return epoch

    def _apply_snapshot(self, snap):
        self._kv = {k: base64.b64decode(v)
                    for k, v in snap.get("kv", {}).items()}
        self._barriers = {}
        for name, b in snap.get("barriers", {}).items():
            bar = _Barrier()
            bar.generation = int(b["g"])
            bar.arrived = set(b.get("a", []))
            self._barriers[name] = bar
        now_mono, now_wall = self._clock(), self._wall()
        # wall deadline -> monotonic: the REMAINING ttl is what survives
        self._leases = {cid: now_mono + (float(wd) - now_wall)
                        for cid, wd in snap.get("leases", {}).items()}

    def _apply(self, rec):
        op = rec.get("o")
        if op == "put":
            self._kv[rec["k"]] = base64.b64decode(rec["v"])
        elif op == "del":
            self._kv.pop(rec["k"], None)
        elif op == "bar":
            bar = self._barriers.setdefault(rec["n"], _Barrier())
            bar.generation = int(rec["g"])
            bar.arrived = set(rec.get("a", []))
            bar.arrive_ts = {}
        elif op == "lease":
            self._leases[rec["id"]] = \
                self._clock() + (float(rec["wd"]) - self._wall())
        elif op == "sweep":
            for cid in rec.get("ids", []):
                self._leases.pop(cid, None)
                if rec.get("kv"):
                    self._kv.pop(cid, None)
        # unknown record types from a newer version are skipped: they
        # describe state this version cannot hold anyway

    def _journal(self, rec):
        """Append one WAL record (caller holds ``self._cv``). The
        handler acks only after this returns, so an acknowledged
        mutation is on disk (fsync unless PADDLE_COORD_WAL_FSYNC=0).
        No-op for ephemeral servers."""
        if self._wal_f is None:
            return
        self._seq += 1
        rec["s"] = self._seq
        self._wal_f.write(
            (json.dumps(rec, separators=(",", ":")) + "\n").encode())
        self._wal_f.flush()
        if self._wal_fsync:
            os.fsync(self._wal_f.fileno())
        _M_WAL_RECORDS.inc()
        self._since_snapshot += 1
        if self._since_snapshot >= self._snapshot_every:
            self._snapshot_locked()

    def _snapshot_locked(self):
        """Compact the state into an atomic snapshot (the PR-4
        tmp+fsync+rename helper) and truncate the WAL. Called under
        ``self._cv`` once serving (construction runs single-threaded)."""
        if not self._wal_dir:
            return
        from ..fluid.io import _atomic_write_bytes

        now_mono, now_wall = self._clock(), self._wall()
        snap = {
            "epoch": self._epoch,
            "seq": self._seq,
            "kv": {k: base64.b64encode(v).decode("ascii")
                   for k, v in self._kv.items()},
            "barriers": {n: {"g": b.generation, "a": sorted(b.arrived)}
                         for n, b in self._barriers.items()},
            "leases": {cid: now_wall + (d - now_mono)
                       for cid, d in self._leases.items()},
        }
        _atomic_write_bytes(
            self._snap_path(),
            json.dumps(snap, separators=(",", ":")).encode())
        if self._wal_f is not None:
            self._wal_f.close()
        # every record <= seq now lives in the snapshot: restart the log
        self._wal_f = open(self._wal_path(), "wb")
        self._since_snapshot = 0
        _M_SNAPSHOTS.inc()

    def stop(self):
        super().stop()
        with self._cv:
            if self._wal_f is not None:
                # clean shutdown: compact so the next start replays
                # nothing, then release the handle
                self._snapshot_locked()
                self._wal_f.close()
                self._wal_f = None

    def crash(self):
        """Simulated kill -9 for chaos tests: sever every connection
        and the listener WITHOUT the final snapshot/compaction a clean
        ``stop()`` performs — recovery must come from the fsync'd WAL
        alone, exactly as after a real SIGKILL."""
        _wire.FramedServer.stop(self)
        with self._cv:
            f, self._wal_f = self._wal_f, None
        if f is not None:
            try:
                f.close()     # per-record flush means nothing is lost here
            except OSError:
                pass

    # -- request handling ---------------------------------------------------
    def _serve_authenticated(self, conn):
        while not self._stop.is_set():
            try:
                req = _wire.read_frame(conn, _MAX_FRAME)
            except (ConnectionError, OSError):
                return
            if _faults.take("coord.crash"):
                # chaos: die mid-request — the requester never gets an
                # ack, every other client sees its connection sever
                self.crash()
                return
            resp = self._handle(req)
            try:
                _wire.send_all(conn, _wire.frame(resp))
            except (ConnectionError, OSError):
                return
            if req and req[0] == _STOP:  # trace: shutdown sentinel, no downstream hop
                self._stop.set()
                return

    def _handle(self, req):
        try:
            if not req:
                raise _wire.DecodeError("empty request")
            op = req[0]
            if op == _PING:
                return b"\x00"
            if op == _STOP:
                return b"\x00"
            if op == _TRACED:
                return self._handle_traced(req)
            key, off = _unpack_str(req, 1)
            if op == _PUT:
                return self._do_put(key, req[off:])
            if op == _GET:
                (wait,), off = _unpack("<d", req, off)
                return self._do_get(key, wait)
            if op == _DEL:
                return self._do_del(key)
            if op == _ADD:
                (delta,), off = _unpack("<q", req, off)
                return self._do_add(key, delta)
            if op == _LIST:
                return self._do_list(key)
            if op == _BAR_ARRIVE:
                cid, off = _unpack_str(req, off)
                (world,), off = _unpack("<q", req, off)
                return self._do_barrier_arrive(key, cid, world)
            if op == _BAR_WAIT:
                (gen, wait), off = _unpack("<qd", req, off)
                return self._do_barrier_wait(key, gen, wait)
            if op == _LEASE:
                (ttl,), off = _unpack("<d", req, off)
                return self._do_lease(key, ttl)
            if op == _LIVE:
                return self._do_live()
            if op == _LIVE_MEMBERS:
                return self._do_live_members(key)
            raise _wire.DecodeError("unknown opcode %d" % op)
        except _wire.DecodeError as e:
            return b"\x01" + ("decode error: %s" % e).encode()[:512]
        except Exception as e:  # surface to the client, keep serving
            return b"\x01" + repr(e).encode()[:512]

    def _handle_traced(self, req):
        """Unwrap a ``_TRACED`` envelope: activate the carried trace
        context, record one server-side span, serve the inner request
        through the normal dispatch. A server with telemetry off (or a
        garbled header) still serves the inner request — the envelope
        is observability, never a semantic gate."""
        from .. import telemetry as _telemetry

        try:
            (hlen,) = struct.unpack_from("<H", req, 1)
            hdr = json.loads(req[3:3 + hlen].decode())
            inner = req[3 + hlen:]
        except (struct.error, ValueError, UnicodeDecodeError) as e:
            raise _wire.DecodeError("malformed trace envelope: %r" % e)
        if not inner:
            raise _wire.DecodeError("trace envelope with empty request")
        ctx = _telemetry.decode_header(hdr) \
            if _telemetry.enabled() else None
        if ctx is None:
            return self._handle(inner)
        with _telemetry.span("coord.rpc", parent=ctx, service="coord",
                             attrs={"op": inner[0]}):
            return self._handle(inner)

    # -- KV -----------------------------------------------------------------
    def _do_put(self, key, value):
        with self._cv:
            self._kv[key] = bytes(value)
            self._journal({"o": "put", "k": key,
                           "v": base64.b64encode(
                               self._kv[key]).decode("ascii")})
            self._cv.notify_all()
        _M_PUTS.inc()
        return b"\x00"

    def _do_get(self, key, wait):  # wal: read-only (wait-and-watch GET)
        _M_GETS.inc()
        deadline = self._clock() + min(max(wait, 0.0), _WAIT_SLICE)
        with self._cv:
            if key in self._kv:
                return b"\x00\x01" + self._kv[key]  # ok, found + value
            with _M_WATCHERS.track():
                while key not in self._kv:
                    left = deadline - self._clock()
                    if left <= 0 or self._stop.is_set():
                        return b"\x00\x00"          # ok, not found
                    self._cv.wait(timeout=min(left, 0.2))
            return b"\x00\x01" + self._kv[key]

    def _do_del(self, key):
        with self._cv:
            existed = self._kv.pop(key, None) is not None
            if existed:
                self._journal({"o": "del", "k": key})
            self._cv.notify_all()
        return b"\x00" + (b"\x01" if existed else b"\x00")

    def _do_add(self, key, delta):
        # atomic fetch-add; stored as ascii so a plain GET interops
        with self._cv:
            cur = int(self._kv.get(key, b"0") or b"0")
            cur += int(delta)
            self._kv[key] = str(cur).encode()
            # journaled as the RESULT, not the delta: replaying a
            # record the snapshot already covers stays idempotent
            self._journal({"o": "put", "k": key,
                           "v": base64.b64encode(
                               self._kv[key]).decode("ascii")})
            self._cv.notify_all()
        return b"\x00" + struct.pack("<q", cur)

    def _do_list(self, prefix):  # wal: read-only (key enumeration)
        with self._cv:
            keys = sorted(k for k in self._kv if k.startswith(prefix))
        return b"\x00" + json.dumps(keys).encode()

    # -- barriers -----------------------------------------------------------
    def _do_barrier_arrive(self, name, cid, world):
        if world <= 0:
            raise _wire.DecodeError("barrier world must be positive")
        now = self._clock()
        with self._cv:
            bar = self._barriers.setdefault(name, _Barrier())
            entry_gen = bar.generation
            changed = False
            if cid not in bar.arrived:       # idempotent re-arrival
                bar.arrived.add(cid)
                bar.arrive_ts[cid] = now
                changed = True
            if len(bar.arrived) >= world:
                for t in bar.arrive_ts.values():
                    _M_BARRIER_WAIT.observe(now - t)
                bar.generation += 1
                bar.arrived.clear()
                bar.arrive_ts.clear()
                _M_BARRIERS.inc()
                changed = True
                self._cv.notify_all()
            if changed:
                # the POST-arrival state (generation + arrived set), so
                # replay is a state replace, not a re-count — a blocked
                # gang survives a coordinator restart mid-barrier
                self._journal({"o": "bar", "n": name,
                               "g": bar.generation,
                               "a": sorted(bar.arrived)})
            return b"\x00" + struct.pack("<q", entry_gen)

    def _do_barrier_wait(self, name, gen, wait):  # wal: read-only (generation watch)
        deadline = self._clock() + min(max(wait, 0.0), _WAIT_SLICE)
        with self._cv:
            bar = self._barriers.setdefault(name, _Barrier())
            if bar.generation > gen:
                return b"\x00\x01" + struct.pack("<q", bar.generation)
            with _M_WATCHERS.track():
                while bar.generation <= gen:
                    left = deadline - self._clock()
                    if left <= 0 or self._stop.is_set():
                        return (b"\x00\x00"
                                + struct.pack("<q", bar.generation))
                    self._cv.wait(timeout=min(left, 0.2))
            return b"\x00\x01" + struct.pack("<q", bar.generation)

    # -- leases -------------------------------------------------------------
    def _do_lease(self, cid, ttl):
        ttl = max(float(ttl), 0.0)
        with self._cv:
            # in-memory deadline on the MONOTONIC clock (immune to NTP
            # steps); journaled with the absolute WALL deadline — the
            # only clock that survives a restart
            self._leases[cid] = self._clock() + ttl
            self._journal({"o": "lease", "id": cid,
                           "wd": self._wall() + ttl})
        return b"\x00"

    def _do_live(self):
        now = self._clock()
        with self._cv:
            # expired leases are garbage, not history — drop them so the
            # map cannot grow with elastic client churn
            dead = [c for c, d in self._leases.items() if d <= now]
            for c in dead:
                del self._leases[c]
            if dead:
                self._journal({"o": "sweep", "ids": dead})
            live = sorted(self._leases)
        return b"\x00" + json.dumps(live).encode()

    def _do_live_members(self, prefix):
        # the membership primitive the fleet router polls: sweep expired
        # leases UNDER THIS PREFIX and delete both the lease record and
        # the member's KV entry (its registration blob), so one atomic
        # server-side pass guarantees the returned keys all carry a live
        # lease — the caller can never observe a dead replica.
        now = self._clock()
        with self._cv:
            dead = [c for c, d in self._leases.items()
                    if c.startswith(prefix) and d <= now]
            for c in dead:
                del self._leases[c]
                self._kv.pop(c, None)
            if dead:
                self._journal({"o": "sweep", "ids": dead, "kv": True})
                self._cv.notify_all()
            live = sorted(c for c in self._leases
                          if c.startswith(prefix) and c in self._kv)
        return b"\x00" + json.dumps(live).encode()


class CoordClient:
    """Client proxy over one ``wire.Conn``. Thread-safe (the Conn owns a
    request lock). Every wait is a client-side loop of short
    server-side waits so socket timeouts never fire mid-wait.

    ``grace`` is the re-dial budget (seconds) across a coordinator
    outage — requests transparently retry/reconnect up to that long
    before surfacing ConnectionError (default ``PADDLE_COORD_GRACE_S``
    or 30 s; pass 0 for the legacy fail-fast policy, what the fleet
    router uses so its refresh loop never blocks). After any reconnect
    the client re-asserts every lease it holds, re-probes ``_TRACED``
    support (a replaced server may speak it even if the old one did
    not), and fires ``on_reconnect`` callbacks."""

    def __init__(self, endpoint, token=None, grace=None, max_frame=None):
        if grace is None:
            grace = float(os.environ.get(ENV_GRACE, "") or _DEFAULT_GRACE)
        self._grace = max(float(grace), 0.0)
        self._conn = _CoordConn(endpoint, token=token,
                                deadline=self._grace or None,
                                max_frame=max_frame)
        self._lease_thread = None
        self._lease_stop = threading.Event()
        self._trace_ok = None     # False after an old server rejects _TRACED
        self._leases_mu = threading.Lock()
        self._leases_held = {}    # lease id -> ttl, replayed on reconnect
        self._reconnect_cbs = []

    @property
    def endpoint(self):
        return self._conn.endpoint

    @property
    def server_epoch(self):
        """The server incarnation from the last handshake, or None
        against a server that predates the epoch hello."""
        hello = self._conn.server_hello
        if hello and len(hello) >= 8:
            return struct.unpack_from("<Q", hello)[0]
        return None

    def on_reconnect(self, fn):
        """Register ``fn()`` to run after this client re-dials the
        server (restart or healed partition) — the hook fleet replicas
        re-register through. Lease re-establishment is automatic and
        happens before the callbacks fire."""
        self._reconnect_cbs.append(fn)
        return fn

    def _request(self, payload):
        """Every RPC routes here: with telemetry on and a sampled trace
        active, the request ships inside the ``_TRACED`` envelope so the
        server's span lands in the caller's trace. An old server that
        rejects the envelope ("unknown opcode" — the inner op was NOT
        executed) downgrades this client to unwrapped requests (until
        the next reconnect re-probes)."""
        try:
            return self._request_raw(payload)
        finally:
            self._after_rpc()

    def _request_raw(self, payload):
        from .. import telemetry as _telemetry

        if self._trace_ok is not False and _telemetry.enabled():
            ctx = _telemetry.current()
            if ctx is not None and ctx.sampled:
                hdr = json.dumps(_telemetry.encode_header(ctx),
                                 separators=(",", ":")).encode()
                try:
                    return self._conn.request(
                        struct.pack("<BH", _TRACED, len(hdr)) + hdr
                        + payload)
                except RuntimeError as e:
                    if "unknown opcode" not in str(e):
                        raise
                    self._trace_ok = False
        return self._conn.request(payload)

    def _after_rpc(self):
        """Reconnect re-establishment, run AFTER the triggering request
        completes (the Conn's request lock is released — hooks issue
        RPCs of their own). The flag handoff clears first, so nested
        ``_request`` calls from the hooks cannot recurse."""
        reconnected, restarted = self._conn.consume_reconnect()
        if not reconnected:
            return
        _m_reconnects("restart" if restarted else "resume").inc()
        # the server may be a different build now: probe _TRACED again
        # instead of inheriting a permanent downgrade
        self._trace_ok = None
        with self._leases_mu:
            held = list(self._leases_held.items())
        for cid, ttl in held:
            try:
                self._conn.request(
                    struct.pack("<B", _LEASE) + _pack_str(cid)
                    + struct.pack("<d", ttl))
            except (ConnectionError, RuntimeError):
                break   # still flapping: the keeper's next beat retries
        for cb in list(self._reconnect_cbs):
            try:
                cb()
            except Exception:  # a broken hook must not poison the RPC that tripped it
                pass

    # -- KV -----------------------------------------------------------------
    def put(self, key, value):
        if isinstance(value, str):
            value = value.encode()
        self._request(
            struct.pack("<B", _PUT) + _pack_str(key) + bytes(value))

    def get(self, key, wait=False, timeout=60.0):
        """Value bytes, or None when absent. ``wait=True`` blocks up to
        ``timeout`` seconds for the key to appear."""
        deadline = time.monotonic() + (timeout if wait else 0.0)
        while True:
            left = max(deadline - time.monotonic(), 0.0)
            resp = self._request(
                struct.pack("<B", _GET) + _pack_str(key) +
                struct.pack("<d", min(left, _WAIT_SLICE)))
            if resp[:1] == b"\x01":
                return resp[1:]
            if not wait or time.monotonic() >= deadline:
                return None

    def delete(self, key):
        """True when the key existed — the atomic claim primitive
        (exactly one of N concurrent deleters sees True)."""
        resp = self._request(struct.pack("<B", _DEL) + _pack_str(key))
        return resp[:1] == b"\x01"

    def add(self, key, delta=1):
        """Atomic fetch-add; returns the post-add value."""
        resp = self._request(
            struct.pack("<B", _ADD) + _pack_str(key) +
            struct.pack("<q", int(delta)))
        return struct.unpack("<q", resp)[0]

    def keys(self, prefix=""):
        resp = self._request(struct.pack("<B", _LIST) +
                                  _pack_str(prefix))
        return json.loads(resp.decode())

    # -- barrier ------------------------------------------------------------
    def barrier(self, name, world, client_id, timeout=120.0):
        """Block until ``world`` distinct client ids arrive at
        ``name``. Arrival is idempotent per client id, so transport
        retries cannot double-count. Returns the released generation;
        raises TimeoutError past ``timeout``."""
        resp = self._request(
            struct.pack("<B", _BAR_ARRIVE) + _pack_str(name) +
            _pack_str(client_id) + struct.pack("<q", int(world)))
        (entry_gen,) = struct.unpack("<q", resp)
        deadline = time.monotonic() + timeout
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    "barrier %r (world %d) not released within %.1fs"
                    % (name, world, timeout))
            resp = self._request(
                struct.pack("<B", _BAR_WAIT) + _pack_str(name) +
                struct.pack("<qd", entry_gen, min(left, _WAIT_SLICE)))
            released, gen = resp[0], struct.unpack_from("<q", resp, 1)[0]
            if released:
                return gen

    # -- broadcast ----------------------------------------------------------
    def broadcast(self, key, value=None, timeout=60.0):
        """Small-blob broadcast: the root passes ``value`` (put), every
        other rank passes None (wait-get). Returns the blob bytes."""
        if value is not None:
            if isinstance(value, str):
                value = value.encode()
            self.put(key, value)
            return bytes(value)
        got = self.get(key, wait=True, timeout=timeout)
        if got is None:
            raise TimeoutError("broadcast key %r not published within "
                               "%.1fs" % (key, timeout))
        return got

    # -- liveness -----------------------------------------------------------
    def lease(self, client_id, ttl=10.0):
        with self._leases_mu:
            # remembered FIRST: even if this very request rides a
            # reconnect, the replay set already includes it
            self._leases_held[client_id] = float(ttl)
        self._request(struct.pack("<B", _LEASE) +
                           _pack_str(client_id) + struct.pack("<d", ttl))

    def forget_lease(self, client_id):
        """Stop replaying ``client_id`` after reconnects (deregistration
        path); the server-side lease simply expires."""
        with self._leases_mu:
            self._leases_held.pop(client_id, None)

    def live(self):
        resp = self._request(struct.pack("<B", _LIVE) +
                                  _pack_str(""))
        return json.loads(resp.decode())

    def live_members(self, prefix):
        """Keys under ``prefix`` whose lease is still live, after a
        server-side sweep that evicts expired members (lease AND KV
        registration blob in one pass). Membership registration is
        ``put(key, blob)`` + ``lease(key, ttl)`` with the SAME string as
        key and lease id; this is the read side the fleet router polls."""
        resp = self._request(struct.pack("<B", _LIVE_MEMBERS) +
                                  _pack_str(prefix))
        return json.loads(resp.decode())

    def start_lease_keeper(self, client_id, ttl=10.0, interval=None):
        """Daemon thread renewing this client's lease at interval
        (default ttl/3)."""
        if self._lease_thread is not None:
            return self
        interval = interval or max(ttl / 3.0, 0.5)

        def _keep():
            while not self._lease_stop.wait(interval):
                try:
                    self.lease(client_id, ttl=ttl)
                except (ConnectionError, RuntimeError):
                    # server down past the grace window: KEEP the
                    # keeper alive — the first beat that lands after
                    # the server returns re-establishes the lease
                    continue
        self.lease(client_id, ttl=ttl)
        self._lease_thread = threading.Thread(target=_keep, daemon=True)
        self._lease_thread.start()
        return self

    def ping(self):
        self._request(struct.pack("<B", _PING))

    def stop_server(self):
        # trace: STOP stays unwrapped — _serve_authenticated matches req[0] == _STOP
        self._conn.request(struct.pack("<B", _STOP))

    def close(self):
        self._lease_stop.set()
        if self._lease_thread is not None:
            self._lease_thread.join(timeout=2)
            self._lease_thread = None
        self._conn.close()


class _CoordConn(_wire.Conn):
    MAGIC = _MAGIC
    TOKEN_ENV = ENV_TOKEN

    def __init__(self, endpoint, token=None, deadline=None,
                 max_frame=None):
        super().__init__(endpoint, token=token, retry_name="coord.rpc",
                         max_frame=max_frame or _MAX_FRAME,
                         deadline=deadline)

    def _round_trip(self, payload):
        # coord.partition models a network partition: the attempt fails
        # transiently (FaultInjected is retryable), so an armed streak
        # of N looks like an N-attempt-long outage to this client only
        _faults.check("coord.partition")
        return super()._round_trip(payload)


def main(argv=None):
    """Standalone coordinator entry
    (``python -m paddle_tpu_torch.distributed.coordination``) — what the
    chaos harness and multi-node deployments SIGKILL and restart
    against the same ``--wal-dir``. Prints the bound endpoint and
    epoch on stdout, then serves until STOP/SIGTERM."""
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.coordination",
        description="standalone durable coordination service")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--wal-dir",
                   default=os.environ.get(ENV_WAL_DIR) or None,
                   help="WAL/snapshot dir (default $%s); omit for an "
                        "ephemeral in-memory server" % ENV_WAL_DIR)
    p.add_argument("--token", default=None,
                   help="shared secret (default $%s)" % ENV_TOKEN)
    args = p.parse_args(argv)
    srv = CoordServer(host=args.host, port=args.port, token=args.token,
                      wal_dir=args.wal_dir).start()
    sys.stdout.write("coordination service at %s epoch=%d wal=%s\n"
                     % (srv.endpoint, srv.epoch, args.wal_dir or "-"))
    sys.stdout.flush()
    try:
        while not srv._stop.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
