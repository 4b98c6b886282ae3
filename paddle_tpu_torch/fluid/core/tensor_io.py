"""The PTC1 combined tensor file (``save_combine`` / ``load_combine``):
the port's copy of ``paddle_tpu/fluid/core/tensor_io.py``'s struct
writer and reader, byte for byte, with torch tensors besides numpy
arrays. bfloat16 (dtype code 5), which numpy cannot hold, is written
from a torch.bfloat16 tensor and read back as one.

Layout, little-endian: ``b"PTC1"``, u32 count, then per tensor u32 name
length, the name, u32 dtype code, u32 ndim, u64 per dim, u64 byte
count, the row-major bytes.
"""

import os
import struct

import numpy as np
import torch

__all__ = ["save_combine", "load_combine"]

_CODE_OF = {"float32": 0, "float64": 1, "int32": 2, "int64": 3, "uint8": 4,
            "bfloat16": 5, "float16": 6, "bool": 7, "int8": 8, "int16": 9,
            "uint16": 10, "uint32": 11, "uint64": 12}
_NP_OF = {0: np.float32, 1: np.float64, 2: np.int32, 3: np.int64,
          4: np.uint8, 6: np.float16, 7: np.bool_, 8: np.int8, 9: np.int16,
          10: np.uint16, 11: np.uint32, 12: np.uint64}
_BF16 = 5


def _raw(value):
    """(dtype code, shape, bytes) of a numpy array or a torch tensor."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return _BF16, tuple(t.shape), t.view(torch.int16).numpy().tobytes()
        value = t.numpy()
    a = np.ascontiguousarray(value)
    if a.dtype.name not in _CODE_OF:
        raise ValueError("unsupported dtype %s" % a.dtype.name)
    return _CODE_OF[a.dtype.name], a.shape, a.tobytes()


def save_combine(path, arrays, atomic=True):
    """Write named arrays or tensors (a dict or (name, value) pairs) to
    one file. ``atomic=True``: the bytes go to ``<path>.tmp-<pid>``, are
    fsync'd and renamed over ``path`` (the ``io.write`` fault point sits
    between the two), so ``path`` holds the old bytes or the new, never
    a prefix. ``atomic=False`` writes ``path`` in place, for a caller
    whose own staging commits it (the checkpoint writer's temporary
    directory). At most 16 dims, as the format allows."""
    items = list(arrays.items()) if isinstance(arrays, dict) else list(arrays)
    entries = []
    for name, value in items:
        code, shape, data = _raw(value)
        if len(shape) > 16:
            raise ValueError("PTC1 stores at most 16 dims; %r has %d"
                             % (name, len(shape)))
        entries.append((name, code, shape, data))
    if not atomic:
        _write(path, entries)
        return
    tmp = "%s.tmp-%d" % (path, os.getpid())
    try:
        _write(tmp, entries)
        _fsync_path(tmp)
        from .. import faults as _faults

        _faults.check("io.write")  # a crash here leaves path untouched
        os.replace(tmp, path)
    except BaseException:  # leave no temporary file behind, then re-raise
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def _write(path, entries):
    with open(path, "wb") as f:
        f.write(b"PTC1")
        f.write(struct.pack("<I", len(entries)))
        for name, code, shape, data in entries:
            nb = name.encode()
            f.write(struct.pack("<I", len(nb)))
            f.write(nb)
            f.write(struct.pack("<II", code, len(shape)))
            for d in shape:
                f.write(struct.pack("<Q", d))
            f.write(struct.pack("<Q", len(data)))
            f.write(data)


def _fsync_path(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def load_combine(path):
    """Read a PTC1 file -> {name: value} in file order: numpy arrays, and
    torch.bfloat16 tensors for bfloat16 entries."""
    with open(path, "rb") as f:
        if f.read(4) != b"PTC1":
            raise IOError("%s is not a PTC1 file" % path)
        (count,) = struct.unpack("<I", f.read(4))
        out = {}
        for _ in range(count):
            (name_len,) = struct.unpack("<I", f.read(4))
            name = f.read(name_len).decode()
            code, ndim = struct.unpack("<II", f.read(8))
            shape = tuple(struct.unpack("<Q", f.read(8))[0]
                          for _ in range(ndim))
            (nbytes,) = struct.unpack("<Q", f.read(8))
            data = f.read(nbytes)
            if len(data) != nbytes:
                raise IOError("%s: entry %r is truncated" % (path, name))
            if code == _BF16:
                bits = np.frombuffer(data, dtype=np.int16).reshape(shape)
                out[name] = torch.from_numpy(bits.copy()).view(
                    torch.bfloat16)
            elif code in _NP_OF:
                out[name] = np.frombuffer(data, dtype=_NP_OF[code]) \
                    .reshape(shape).copy()
            else:
                raise ValueError("unsupported dtype code %d" % code)
        return out
