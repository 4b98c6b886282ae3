"""Fleet wire protocol: the request/response encoding shared by the
router, the replicas, and ``FleetClient`` — all carried over the
``distributed/wire.py`` framed-TCP transport (length-prefixed frames,
magic+token handshake), which stays the tree's ONE socket site.

Payloads are numpy feeds/fetches, never pickles (a peer's bytes must
not run code), so arrays travel as a small JSON header (names, dtypes,
shapes, SLO fields) followed by the raw C-order buffers. Two protocol magics keep
the roles apart — ``MAGIC_ROUTER`` fronts clients, ``MAGIC_REPLICA``
fronts the router — so a fleet client can never accidentally drive a
replica directly; both authenticate under ``PADDLE_FLEET_TOKEN``.

Responses are two-layered: the wire status byte (``0`` = the frame was
served; non-zero is a transport/protocol fault that ``wire.Conn``
surfaces as RuntimeError) followed by an APPLICATION status byte that
carries the serving taxonomy — ``ST_OVERLOADED`` maps back to the typed
``fluid.resilience.Overloaded`` and ``ST_CLOSED`` to ``Closed`` on the
client side, so shedding and draining stay typed end to end across
process boundaries.
"""

import json
import struct

import numpy as np

from ..distributed import wire as _wire
from ..fluid.resilience import Closed, Overloaded

__all__ = [
    "ENV_TOKEN", "MAGIC_ROUTER", "MAGIC_REPLICA",
    "OP_SUBMIT", "OP_INFER", "OP_PING",
    "ST_OK", "ST_ERROR", "ST_OVERLOADED", "ST_CLOSED",
    "pack_request", "unpack_request", "pack_arrays", "unpack_arrays",
    "ok_reply", "err_reply", "raise_for_status", "replica_key",
    "stats_key",
]

ENV_TOKEN = "PADDLE_FLEET_TOKEN"

MAGIC_ROUTER = b"PTFR1"
MAGIC_REPLICA = b"PTFP1"

# opcodes (first byte of a request frame)
OP_SUBMIT = 1    # client -> router: route one inference request
OP_INFER = 2     # router -> replica: run one inference request
OP_PING = 3

# application status codes (second byte of a reply frame, after the
# wire status byte)
ST_OK = 0
ST_ERROR = 1       # model-side failure; message follows
ST_OVERLOADED = 2  # typed shed: deadline expired / no capacity
ST_CLOSED = 3      # replica draining / server closed


def _dumps(obj):
    return json.dumps(obj, separators=(",", ":")).encode()


def pack_arrays(arrays, names=None):
    """JSON header + raw C-order buffers for a list of numpy arrays
    (``names`` attaches feed names; fetches go nameless)."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    header = [{"dtype": a.dtype.str, "shape": list(a.shape)}
              for a in arrays]
    if names is not None:
        for h, n in zip(header, names):
            h["name"] = n
    hb = _dumps(header)
    return b"".join([struct.pack("<I", len(hb)), hb]
                    + [a.tobytes() for a in arrays])


def unpack_arrays(buf, off=0):
    """Inverse of ``pack_arrays`` -> (list of (name-or-None, array))."""
    try:
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        header = json.loads(buf[off:off + hlen].decode())
        off += hlen
        out = []
        for h in header:
            dt = np.dtype(h["dtype"])
            shape = tuple(int(d) for d in h["shape"])
            n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            chunk = buf[off:off + n]
            if len(chunk) != n:
                raise _wire.DecodeError("truncated array buffer")
            off += n
            out.append((h.get("name"),
                        np.frombuffer(chunk, dtype=dt).reshape(shape)))
        return out
    except (struct.error, ValueError, KeyError, TypeError) as e:
        raise _wire.DecodeError("malformed array payload: %r" % e)


def pack_request(op, model, feed, deadline_ms=None, priority=None,
                 trace=None):
    """One inference request frame (client->router or router->replica):
    opcode byte + JSON SLO header + the feed arrays.

    ``trace`` is an OPTIONAL telemetry header (the compact dict from
    ``telemetry.encode_header``). It rides as one extra meta key, so a
    frame without it is byte-identical to the pre-telemetry format, an
    old peer's ``meta.get`` simply never sees it, and a telemetry-off
    sender adds zero wire bytes."""
    fields = {"model": model, "deadline_ms": deadline_ms,
              "priority": priority}
    if trace is not None:
        fields["trace"] = trace
    meta = _dumps(fields)
    names = sorted(feed)
    return (struct.pack("<BI", op, len(meta)) + meta
            + pack_arrays([np.asarray(feed[n]) for n in names],
                          names=names))


def unpack_request(req):
    """Inverse of ``pack_request`` (minus the opcode byte, which the
    server dispatches on) -> (model, deadline_ms, priority, feed,
    trace). ``trace`` is the raw header dict or None — old-format
    frames (no trace key) decode exactly as before."""
    try:
        (mlen,) = struct.unpack_from("<I", req, 1)
        meta = json.loads(req[5:5 + mlen].decode())
        model = meta["model"]
    except (struct.error, ValueError, KeyError) as e:
        raise _wire.DecodeError("malformed request meta: %r" % e)
    feed = {}
    for name, arr in unpack_arrays(req, 5 + mlen):
        if name is None:
            raise _wire.DecodeError("request array missing feed name")
        feed[name] = arr
    return (model, meta.get("deadline_ms"), meta.get("priority"), feed,
            meta.get("trace"))


def ok_reply(arrays):
    """Wire-ok + ST_OK + the fetch arrays."""
    return b"\x00" + bytes([ST_OK]) + pack_arrays(arrays)


def err_reply(status, msg):
    """Wire-ok + typed application status + utf-8 message (the frame
    was served correctly; the REQUEST outcome is the typed error)."""
    return b"\x00" + bytes([status]) + str(msg).encode()[:2048]


def raise_for_status(payload):
    """Decode an application reply (wire status already stripped by
    ``wire.Conn.request``): returns the fetch list on ST_OK, raises the
    matching typed exception otherwise."""
    if not payload:
        raise _wire.DecodeError("empty fleet reply")
    st = payload[0]
    if st == ST_OK:
        return [a for _, a in unpack_arrays(payload, 1)]
    msg = payload[1:].decode("utf-8", "replace")
    if st == ST_OVERLOADED:
        raise Overloaded(msg)
    if st == ST_CLOSED:
        raise Closed(msg)
    raise RuntimeError("fleet request failed: %s" % msg)


# -- coordination-KV key layout ---------------------------------------------

def replica_key(prefix, replica_id):
    """Registration blob key; ALSO the lease id (live_members contract:
    same string leases the key it registered)."""
    return "%sreplicas/%s" % (prefix, replica_id)


def stats_key(prefix, replica_id):
    """Load-report blob key (queue depth / occupancy gauges)."""
    return "%sstats/%s" % (prefix, replica_id)
