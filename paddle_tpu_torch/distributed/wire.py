"""Shared framed-TCP plumbing for every socket-served tier: the port's
copy of ``paddle_tpu/distributed/wire.py``, byte for byte the same
protocol, so a port client talks to a reference server and back. The
coordination service (``coordination.py``) and the serving fleet
(``serving/``) ride it; the parameter-server tier and the sample
exchange wait for ROADMAP queue 1 item 8.

The protocol: u32 length-prefixed frames, a
magic + u16-token-length + token hello before any opcode is served, a
frame-size cap an attacker-supplied length cannot blow past, and
``stop()`` that severs live connections (shutdown + close) so serving
threads cannot keep answering after shutdown. Clients reconnect with
the shared ``fluid.resilience.Retry`` policy and drop their socket on
any mid-stream failure — framing cannot be resynchronized, so the next
attempt starts on a fresh connection.

This module is also the port's one ``socket.socket(`` site: port
probing, listener creation, and connections all route through here.
"""

import os
import socket
import struct
import threading

from ..fluid import resilience as _resilience

__all__ = ["DecodeError", "FrameTooLarge", "send_all", "recv_exact",
           "frame", "read_frame", "create_listener", "connect",
           "free_port", "reserve_port_range", "FramedServer", "Conn",
           "set_wire_observer"]

# default frame cap; servers/clients for a specific tier may pass their
# own (the PS tier keeps PADDLE_PS_MAX_FRAME_BYTES)
_MAX_FRAME = int(os.environ.get("PADDLE_WIRE_MAX_FRAME_BYTES",
                                256 * 1024 * 1024))

_DEFAULT_MAGIC = b"PTWR1"


class DecodeError(RuntimeError):
    """A well-framed message whose PAYLOAD is malformed (bad opcode
    layout, truncated field, non-UTF-8 key). Connection-level failures
    raise ConnectionError instead — a DecodeError means the peer speaks
    the framing but sent garbage inside it, so the server can answer
    with an error frame and keep the connection."""


class FrameTooLarge(ConnectionError):
    """A frame length past the cap. Subclasses ConnectionError on
    purpose: the refused bytes are still in the stream, so the
    connection cannot be resynchronized and must be dropped."""


# optional frame observer (the telemetry flight recorder's wire-op
# ring). None on the hot path costs one global load; the hook sees
# (direction, first-payload-byte, frame-size) only — never payloads.
_OBSERVER = None


def set_wire_observer(fn):
    """Install ``fn(direction, op_byte, nbytes)`` (or None to remove);
    returns the previous observer. Must never raise — it runs inside
    every framed send/recv."""
    global _OBSERVER
    prev = _OBSERVER
    _OBSERVER = fn
    return prev


def send_all(sock, data):
    if _OBSERVER is not None and len(data) >= 5:
        # framed payload: 4-byte length prefix then the opcode byte
        _OBSERVER("send", data[4], len(data) - 4)
    sock.sendall(data)


def recv_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def frame(payload):
    return struct.pack("<I", len(payload)) + payload


def read_frame(sock, max_bytes=None):
    (n,) = struct.unpack("<I", recv_exact(sock, 4))
    if n > (max_bytes or _MAX_FRAME):
        raise FrameTooLarge(
            "frame of %d bytes exceeds the %d-byte cap"
            % (n, max_bytes or _MAX_FRAME))
    payload = recv_exact(sock, n)
    if _OBSERVER is not None and payload:
        _OBSERVER("recv", payload[0], n)
    return payload


# -- port/listener helpers ---------------------------------------------------

def create_listener(host="127.0.0.1", port=0, backlog=64):
    """A bound, listening TCP socket with SO_REUSEADDR. Raises OSError
    when the port is taken — callers own the retry policy."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        s.bind((host, port))
        s.listen(backlog)
    except OSError:
        s.close()
        raise
    return s


def connect(endpoint, timeout=30):
    """TCP connection to ``host:port`` (thin create_connection wrapper
    so callers stay socket-free)."""
    host, port = endpoint.rsplit(":", 1)
    return socket.create_connection((host, int(port)), timeout=timeout)


def free_port(host="127.0.0.1"):
    s = socket.socket()
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


def reserve_port_range(n, tries=10, host="127.0.0.1"):
    """A base port such that base..base+n-1 are ALL bindable right now.
    ``free_port`` probes one port only, so a consecutive range starting
    there can still collide with a live listener; verify the whole
    range (retrying with a fresh base) before handing it out. The
    TOCTOU window between this check and the real bind remains — the
    caller must treat a later bind failure as retryable."""
    for _ in range(tries):
        base = free_port(host)
        socks = []
        try:
            for i in range(1, n):
                s = socket.socket()
                s.bind((host, base + i))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    return free_port(host)  # contended host: fall back to the single probe


# -- server ------------------------------------------------------------------

class FramedServer:
    """Shared transport base: bound socket, daemon accept loop, live
    connection tracking (``stop()`` severs serving threads, not just
    the acceptor), and the magic+token handshake — subclasses implement
    ``_serve_authenticated(conn)``. ``magic`` namespaces the protocol
    (PS tier vs coordination service) so a client of one cannot
    accidentally drive the other; ``token_env`` names the env var the
    shared secret defaults from."""

    MAGIC = _DEFAULT_MAGIC
    TOKEN_ENV = "PADDLE_WIRE_TOKEN"

    def __init__(self, host="127.0.0.1", port=0, token=None, backlog=64):
        self.token = os.environ.get(self.TOKEN_ENV, "") \
            if token is None else str(token)
        self._srv = create_listener(host, port, backlog)
        self.host, self.port = self._srv.getsockname()
        self._stop = threading.Event()
        self._accept_thread = None
        self._conns = set()
        self._conns_mu = threading.Lock()

    @property
    def endpoint(self):
        return "%s:%d" % (self.host, self.port)

    def start(self):
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        return self

    def _accept_loop(self):
        self._srv.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()
        try:
            self._srv.close()
        except OSError:
            pass

    def stop(self):
        self._stop.set()
        # sever live connections too — their serving threads would
        # otherwise keep answering after "shutdown". shutdown() (not just
        # close()) reliably wakes threads blocked in recv and prevents
        # the freed fd from being re-read by the old thread.
        with self._conns_mu:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
        # a never-started server still holds its bound socket — release it
        try:
            self._srv.close()
        except OSError:
            pass

    def _serve_conn(self, conn):
        with self._conns_mu:
            self._conns.add(conn)
        try:
            # hello: magic + u16 token length + token; anything else is
            # dropped before a single opcode can run
            try:
                conn.settimeout(10)
                magic = self.MAGIC
                hello = recv_exact(conn, len(magic) + 2)
                if hello[:len(magic)] != magic:
                    return
                (tlen,) = struct.unpack_from("<H", hello, len(magic))
                tok = recv_exact(conn, tlen).decode("utf-8", "replace") \
                    if tlen else ""
                if tok != self.token:
                    send_all(conn, frame(b"\x01bad token"))
                    return
                send_all(conn, frame(b"\x00" + self._hello_payload()))
                conn.settimeout(None)
            except (ConnectionError, OSError, struct.error):
                return
            self._serve_authenticated(conn)
        finally:
            with self._conns_mu:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _hello_payload(self):
        """Extra bytes appended to the handshake OK frame (after the
        ``\\x00`` status byte). Subclasses advertise instance identity
        here — the coordination service packs its server epoch so a
        reconnecting client can tell a restarted server from a healed
        partition. Clients that predate the field only check byte 0 and
        ignore the surplus, so extending it is wire-compatible."""
        return b""

    def _serve_authenticated(self, conn):
        raise NotImplementedError


# -- client ------------------------------------------------------------------

class Conn:
    """One persistent client connection with a request lock, the shared
    token handshake, and reconnect-with-backoff. Requests are retried
    across reconnects — callers must keep every opcode idempotent or
    carry their own dedup (the PS tier's push (client, seq) pair).

    The retry policy is the shared ``fluid.resilience.Retry`` (5
    attempts, 0.2s base, doubled per attempt) under the caller's
    ``retry_name`` monitor site; ``deadline`` switches it to a
    time-budgeted reconnect loop instead (short capped delays retried
    until the budget runs out — the coordination client's grace
    window). ``fault_site`` (default: retry_name) is checked through
    ``fluid.faults`` before every attempt so tests can inject
    transport failures."""

    MAGIC = _DEFAULT_MAGIC
    TOKEN_ENV = "PADDLE_WIRE_TOKEN"
    RETRIES = 4
    BACKOFF = 0.2  # seconds, doubled per attempt

    def __init__(self, endpoint, token=None, retry_name="wire.rpc",
                 fault_site=None, max_frame=None, connect_timeout=30,
                 deadline=None):
        host, port = endpoint.rsplit(":", 1)
        self._addr = (host, int(port))
        self._token = os.environ.get(self.TOKEN_ENV, "") \
            if token is None else str(token)
        self._max_frame = max_frame
        self._connect_timeout = connect_timeout
        self._fault_site = fault_site or retry_name
        self._mu = threading.Lock()
        self._sock = None
        # handshake-hello / reconnect bookkeeping (all mutated while a
        # connect is in flight, i.e. under the request lock)
        self._server_hello = None
        self._connected_once = False
        self._pending_reconnect = False
        self._pending_ident_change = False
        if deadline is None:
            attempts, max_delay = self.RETRIES + 1, 30.0
        else:
            # deadline-bounded: enough attempts that the time budget —
            # not the attempt count — is what runs out, with delays
            # capped low so the client re-dials promptly once the
            # server is back
            attempts = 1000
            max_delay = min(2.0, max(float(deadline) / 8.0, 0.05))
        self._attempts = attempts
        self._retry = _resilience.Retry(
            max_attempts=attempts, base_delay=self.BACKOFF,
            factor=2.0, max_delay=max_delay, deadline=deadline,
            jitter=0.0,
            retryable=(OSError, ConnectionError,
                       _resilience.TransientError),
            name=retry_name)
        self._connect()

    @property
    def endpoint(self):
        return "%s:%d" % self._addr

    @property
    def server_hello(self):
        """The server's identity payload from the last successful
        handshake (b"" from servers that predate the field)."""
        return self._server_hello

    def consume_reconnect(self):
        """``(reconnected, identity_changed)`` since the last call,
        clearing both flags — the handoff point for re-establishment
        hooks (lease replay, trace re-probe), which callers run AFTER
        their request completes, outside the request lock.
        ``identity_changed`` distinguishes a replaced/restarted server
        (hello payload differs) from a healed partition."""
        with self._mu:
            r, c = self._pending_reconnect, self._pending_ident_change
            self._pending_reconnect = False
            self._pending_ident_change = False
        return r, c

    def _connect(self):
        sock = socket.create_connection(self._addr,
                                        timeout=self._connect_timeout)
        tok = self._token.encode()
        try:
            send_all(sock, self.MAGIC + struct.pack("<H", len(tok)) + tok)
            resp = read_frame(sock, self._max_frame)
            if not resp or resp[0] != 0:
                raise ConnectionError(
                    "server rejected handshake: %s"
                    % resp[1:].decode("utf-8", "replace"))
        except Exception:
            sock.close()
            raise
        hello = resp[1:]
        if self._connected_once:
            self._pending_reconnect = True
            if hello != self._server_hello:
                self._pending_ident_change = True
        self._server_hello = hello
        self._connected_once = True
        self._sock = sock

    def _round_trip(self, payload):
        """One attempt: (re)connect if needed, send, read the response.
        A failure mid-stream leaves the framing desynchronized, so the
        socket is dropped before the error propagates to the Retry —
        the next attempt starts on a fresh connection."""
        from ..fluid import faults as _faults

        if self._sock is None:
            self._connect()
        try:
            _faults.check(self._fault_site)
            send_all(self._sock, frame(payload))
            return read_frame(self._sock, self._max_frame)
        except (OSError, ConnectionError, _resilience.TransientError):
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
            raise

    def request(self, payload):
        if self._max_frame is not None and len(payload) > self._max_frame:
            # refuse BEFORE the socket sees a byte: the server would
            # drop the connection (an oversized frame cannot be
            # resynchronized) and the retry layer would burn its whole
            # budget re-sending a frame that can never fit
            raise FrameTooLarge(
                "request of %d bytes exceeds the %d-byte frame cap"
                % (len(payload), self._max_frame))
        with self._mu:
            try:
                resp = self._retry.call(self._round_trip, payload)
            except (OSError, ConnectionError) as e:
                raise ConnectionError(
                    "server %s:%d unreachable after %d attempts: %r"
                    % (self._addr + (self._attempts, e)))
        if not resp or resp[0] != 0:
            raise RuntimeError("server error: %s"
                               % resp[1:].decode("utf-8", "replace"))
        return resp[1:]

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
