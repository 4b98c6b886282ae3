"""desc-dict <-> protobuf bytes of a Program (``framework.proto``), by a
hand-written proto3 wire codec.

The port's counterpart of ``paddle_tpu/fluid/core/proto_io.py``, which
goes through the ``protobuf`` package; the port's machines may not have
that package, so this module writes the wire format itself:

- varint fields (int64, bool), negative int64 as ten-byte two's
  complement, not zig-zag; doubles as little-endian fixed64;
- strings and sub-messages length-delimited;
- repeated scalars packed (``VarDesc.shape``, ``IntList.val``,
  ``FloatList.val``), repeated strings one field each;
- proto3 defaults (0, false, "") left out, except inside the ``Attr``
  oneof, whose member is written whatever its value;
- map entries (op attrs, ``param_grad_map``) as messages of key and value,
  both always written, in the order the ``protobuf`` package's default
  (upb) backend gives them under ``deterministic=True``: ascending by
  the keys' bytes, except that a key comes before any key it extends
  ("bias_after_scale" before "bias").

So ``program_to_bytes`` gives the bytes the reference writes with
``SerializeToString(deterministic=True)``, and ``program_from_bytes``
reads them (packed or not, unknown fields skipped). Loads are
version-gated and op-checked against the port's own registry
(``fluid/compat.py``).
"""

import struct

from ..compat import (PROGRAM_VERSION, CompatibleInfo,  # noqa: F401
                      ProgramCompatError, ProgramVersionError,
                      check_program_compatible)

_VARINT, _FIXED64, _LEN, _FIXED32 = 0, 1, 2, 5
_NONE = "\0__none__"
_REPR = "\0__repr__"


# -- encoding ------------------------------------------------------------------
def _varint(n):
    n = int(n)
    if n < 0:
        n += 1 << 64
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _key(field, wire):
    return _varint(field << 3 | wire)


def _len(field, payload):
    return _key(field, _LEN) + _varint(len(payload)) + payload


def _int(field, n):
    return _key(field, _VARINT) + _varint(n) if n else b""


def _bool(field, b):
    return _key(field, _VARINT) + b"\x01" if b else b""


def _str(field, s):
    return _len(field, s.encode()) if s else b""


def _strs(field, items):
    return b"".join(_len(field, s.encode()) for s in items)


def _packed_ints(field, items):
    return _len(field, b"".join(_varint(n) for n in items)) if items else b""


def _packed_doubles(field, items):
    if not items:
        return b""
    return _len(field, struct.pack("<%dd" % len(items), *items))


def _attr(value):
    """The bytes of an ``Attr`` (the reference's ``_attr_to_pb`` rules:
    bool, int, float, str, lists by their elements, None and anything
    else as tagged strings)."""
    if isinstance(value, bool):
        return _key(4, _VARINT) + _varint(int(value))
    if isinstance(value, int):
        return _key(1, _VARINT) + _varint(value)
    if isinstance(value, float):
        return _key(2, _FIXED64) + struct.pack("<d", value)
    if isinstance(value, str):
        return _len(3, value.encode())
    if isinstance(value, (list, tuple)):
        if (value and all(isinstance(v, bool) for v in value)) or \
                all(isinstance(v, int) for v in value):
            return _len(5, _packed_ints(1, [int(v) for v in value]))
        if all(isinstance(v, (int, float)) for v in value):
            return _len(6, _packed_doubles(1, [float(v) for v in value]))
        return _len(7, _strs(1, [str(v) for v in value]))
    if value is None:
        return _len(3, _NONE.encode())
    return _len(3, (_REPR + repr(value)).encode())


def _map_order(keys):
    """Map keys in upb's deterministic order: as if each key's bytes
    ended in a terminator above every byte value."""
    return sorted(keys, key=lambda k: tuple(k.encode()) + (256,))


def _map_entry(field, key, value_bytes):
    return _len(field, _len(1, key.encode()) + value_bytes)


def _slots(field, slots):
    return b"".join(_len(field, _str(1, slot) + _strs(2, args))
                    for slot, args in slots.items())


def _op(o):
    attrs = b"".join(_map_entry(4, k, _len(2, _attr(o["attrs"][k])))
                     for k in _map_order(o["attrs"]))
    return (_str(1, o["type"]) + _slots(2, o["inputs"]) +
            _slots(3, o["outputs"]) + attrs)


def _var(v):
    return (_str(1, v["name"]) +
            _packed_ints(2, [int(s) for s in v["shape"]]) +
            _str(3, v["dtype"]) +
            _bool(4, v.get("persistable", False)) +
            _bool(5, v.get("stop_gradient", False)) +
            _bool(6, v.get("is_data", False)) +
            _bool(7, v.get("is_parameter", False)) +
            _bool(8, v.get("trainable", False)))


def _block(b):
    return (_int(1, b["idx"]) + _int(2, b.get("parent_idx", -1)) +
            b"".join(_len(3, _var(v)) for v in b["vars"]) +
            b"".join(_len(4, _op(o)) for o in b["ops"]))


def program_to_bytes(desc):
    """The ``ProgramDesc`` bytes of a desc dict (``Program.to_desc()``,
    plus ``feed_names`` / ``fetch_names`` for an inference model)."""
    pgm = desc.get("param_grad_map", {})
    return (_int(1, desc.get("version", PROGRAM_VERSION)) +
            _int(2, desc.get("random_seed", 0)) +
            b"".join(_len(3, _block(b)) for b in desc["blocks"]) +
            b"".join(_map_entry(4, k, _len(2, pgm[k].encode()))
                     for k in _map_order(pgm)) +
            _strs(5, desc.get("feed_names", [])) +
            _strs(6, desc.get("fetch_names", [])))


# -- decoding ------------------------------------------------------------------
def _read_varint(buf, pos):
    n = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint in ProgramDesc bytes")
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if b < 0x80:
            return n, pos
        shift += 7


def _signed(n):
    n &= (1 << 64) - 1
    return n - (1 << 64) if n >> 63 else n


def _fields(buf):
    """(field number, wire type, value) of each field of one message:
    an int for varints, bytes for everything else."""
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == _VARINT:
            val, pos = _read_varint(buf, pos)
        elif wire == _FIXED64:
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == _FIXED32:
            val, pos = buf[pos:pos + 4], pos + 4
        elif wire == _LEN:
            n, pos = _read_varint(buf, pos)
            val, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError("unsupported wire type %d in ProgramDesc bytes"
                             % wire)
        if pos > end:
            raise ValueError("truncated field %d in ProgramDesc bytes"
                             % field)
        yield field, wire, val


def _ints(wire, val):
    """A repeated int64 field's values from one occurrence, packed or
    not."""
    if wire == _VARINT:
        return [_signed(val)]
    out, pos = [], 0
    while pos < len(val):
        n, pos = _read_varint(val, pos)
        out.append(_signed(n))
    return out


def _doubles(wire, val):
    if wire == _FIXED64:
        return [struct.unpack("<d", val)[0]]
    return list(struct.unpack("<%dd" % (len(val) // 8), val))


def _text(val):
    return bytes(val).decode()


def _attr_from(buf):
    kind, value = None, None
    for field, wire, val in _fields(buf):
        if field == 1:
            kind, value = "i", _signed(val)
        elif field == 2:
            kind, value = "f", struct.unpack("<d", val)[0]
        elif field == 3:
            kind, value = "s", _text(val)
        elif field == 4:
            kind, value = "b", bool(val)
        elif field in (5, 6, 7):
            items = []
            for f, w, v in _fields(val):
                if f == 1:
                    items += (_ints(w, v) if field == 5 else
                              _doubles(w, v) if field == 6 else [_text(v)])
            kind, value = field, items
    if kind == "s":
        if value == _NONE:
            return None
        if value.startswith(_REPR):
            import ast

            try:
                return ast.literal_eval(value[len(_REPR):])
            except (ValueError, SyntaxError):
                return value
    return value


def _map_from(buf, value_of):
    key, value = "", value_of(b"")
    for field, _, val in _fields(buf):
        if field == 1:
            key = _text(val)
        elif field == 2:
            value = value_of(val)
    return key, value


def _slot_from(buf):
    slot, args = "", []
    for field, _, val in _fields(buf):
        if field == 1:
            slot = _text(val)
        elif field == 2:
            args.append(_text(val))
    return slot, args


def _op_from(buf):
    op = {"type": "", "inputs": {}, "outputs": {}, "attrs": {}}
    for field, _, val in _fields(buf):
        if field == 1:
            op["type"] = _text(val)
        elif field in (2, 3):
            slot, args = _slot_from(val)
            op["inputs" if field == 2 else "outputs"][slot] = args
        elif field == 4:
            k, v = _map_from(val, _attr_from)
            op["attrs"][k] = v
    return op


_VAR_FLAGS = {4: "persistable", 5: "stop_gradient", 6: "is_data",
              7: "is_parameter", 8: "trainable"}


def _var_from(buf):
    var = {"name": "", "shape": [], "dtype": ""}
    var.update(dict.fromkeys(_VAR_FLAGS.values(), False))
    for field, wire, val in _fields(buf):
        if field == 1:
            var["name"] = _text(val)
        elif field == 2:
            var["shape"] += _ints(wire, val)
        elif field == 3:
            var["dtype"] = _text(val)
        elif field in _VAR_FLAGS:
            var[_VAR_FLAGS[field]] = bool(val)
    return var


def _block_from(buf):
    blk = {"idx": 0, "parent_idx": 0, "vars": [], "ops": []}
    for field, _, val in _fields(buf):
        if field == 1:
            blk["idx"] = _signed(val)
        elif field == 2:
            blk["parent_idx"] = _signed(val)
        elif field == 3:
            blk["vars"].append(_var_from(val))
        elif field == 4:
            blk["ops"].append(_op_from(val))
    return blk


def program_from_bytes(data, check=True):
    """The desc dict of ``ProgramDesc`` bytes, then the load gate
    (``compat.check_program_compatible``): a program of another version
    raises ``ProgramVersionError``, one with op types the port cannot
    lower ``ProgramCompatError``. ``check=False`` skips the gate (tools
    that only read the graph)."""
    desc = {"version": 0, "random_seed": 0, "blocks": [],
            "param_grad_map": {}, "feed_names": [], "fetch_names": []}
    for field, _, val in _fields(memoryview(data)):
        if field == 1:
            desc["version"] = _signed(val)
        elif field == 2:
            desc["random_seed"] = _signed(val)
        elif field == 3:
            desc["blocks"].append(_block_from(val))
        elif field == 4:
            k, v = _map_from(val, _text)
            desc["param_grad_map"][k] = v
        elif field in (5, 6):
            desc["feed_names" if field == 5 else "fetch_names"].append(
                _text(val))
    if check:
        info = check_program_compatible(desc)
        if not info:
            cls = (ProgramVersionError
                   if info.status == CompatibleInfo.UNSUPPORTED_VERSION
                   else ProgramCompatError)
            raise cls("program is not loadable by this build: %r"
                      % (info,), status=info.status)
    return desc
