"""LoD (ragged sequence) tensors: the port's copy of
``paddle_tpu/fluid/lod.py``, the reference's "bounded LoD".

A LoD tensor is a flat ``[rows, ...]`` tensor whose first dimension is a
static physical bound, paired with an int32 ``lengths`` vector bound to
``name + "@LOD"`` in the lowering environment. The logical total is
``sum(lengths)``; rows past it are padding that every sequence op masks
out (``fluid/ops/sequence_ops.py``), so lengths change batch to batch
with no change of shape. Only the innermost level is carried on the
device; the host-side ``LoDTensor`` accepts nested lengths and
flattens the innermost level.

The port adds a second static number beside the lengths: the *time
bound* of a LoD value, an int no smaller than its longest sequence,
bound to ``name + "@LOD_BOUND"``. The recurrences and the per-sequence
reductions run over ``[n, bound]`` instead of the reference's
``[n, rows]``: their values at positions below each length are the
same, and the work shrinks from the flat bound (32768 rows at a batch
of 128 reviews) to the longest review. The executor reads it on the
host from a ``LoDTensor`` feed's lengths (``length_bound``) and keys
the step by it; the sequence ops carry it to their outputs; where none
is known an op falls back to the flat bound (the row count).
"""

import numpy as np

__all__ = ["LoDTensor", "LoDTensorArray", "create_lod_tensor",
           "LOD_SUFFIX", "lod_name", "BOUND_SUFFIX", "bound_name",
           "length_bound"]

LOD_SUFFIX = "@LOD"
BOUND_SUFFIX = "@LOD_BOUND"


def lod_name(name):
    return name + LOD_SUFFIX


def bound_name(name):
    return name + BOUND_SUFFIX


def length_bound(longest, rows):
    """The time bound of a LoD feed whose longest sequence is
    ``longest`` over ``rows`` physical rows: the smallest of 16, 20, 24,
    28, 32, 40, 48, 56, 64, ... (four steps an octave from 16) that
    holds ``longest``, at most ``rows``. A step is keyed by it, so
    batches whose longest sequences fall in one bucket share one
    captured graph, and a recurrence runs at most a quarter of an
    octave past the longest sequence."""
    b, step = 16, 4
    while b < longest:
        b += step
        if b == 2 * step * 4:
            step *= 2
    return int(min(b, rows))


class LoDTensor:
    """Host-side (data, recursive lengths) pair accepted by ``feed={}``.

    The Executor decomposes it: ``name`` gets the flat data, ``name@LOD``
    the innermost-level lengths. ``data`` may also be a torch tensor (a
    batch a stager already copied to the card); the lengths stay on the
    host."""

    def __init__(self, data, recursive_seq_lens=None):
        self._data = data if hasattr(data, "is_cuda") else np.asarray(data)
        if recursive_seq_lens is None:
            recursive_seq_lens = [[self._data.shape[0]]]
        if recursive_seq_lens and not isinstance(
                recursive_seq_lens[0], (list, tuple, np.ndarray)):
            recursive_seq_lens = [recursive_seq_lens]
        self._rsl = [list(int(x) for x in lvl) for lvl in recursive_seq_lens]
        total = int(sum(self._rsl[-1]))
        if total > self._data.shape[0]:
            raise ValueError(
                "sum(lengths)=%d exceeds data rows %d"
                % (total, self._data.shape[0]))

    def recursive_sequence_lengths(self):
        return [list(lvl) for lvl in self._rsl]

    def lod(self):
        """Offset form (the reference's ``LoD``): prefix sums per level."""
        out = []
        for lvl in self._rsl:
            offs = [0]
            for x in lvl:
                offs.append(offs[-1] + x)
            out.append(offs)
        return out

    def lengths(self):
        """Innermost-level lengths as int32 (the device-side binding)."""
        return np.asarray(self._rsl[-1], np.int32)

    def data(self):
        return self._data

    def __array__(self, dtype=None, copy=None):
        data = self._data
        if hasattr(data, "is_cuda"):
            data = data.detach().cpu().numpy()
        return data if dtype is None else data.astype(dtype)

    @property
    def shape(self):
        return tuple(self._data.shape)

    def __repr__(self):
        return "LoDTensor(shape=%s, recursive_seq_lens=%s)" % (
            tuple(self._data.shape), self._rsl)


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """The reference's ``fluid.create_lod_tensor``; ``place`` is advisory."""
    return LoDTensor(data, recursive_seq_lens)


class LoDTensorArray(list):
    """Ordered container of LoDTensors (the reference's
    ``core.LoDTensorArray``). Every insertion path coerces plain arrays,
    so elements always honor the LoDTensor API."""

    @staticmethod
    def _coerce(value):
        return value if isinstance(value, LoDTensor) else LoDTensor(value,
                                                                    None)

    def __init__(self, iterable=()):
        super().__init__(self._coerce(v) for v in iterable)

    def append(self, value):
        super().append(self._coerce(value))

    def extend(self, iterable):
        super().extend(self._coerce(v) for v in iterable)

    def insert(self, index, value):
        super().insert(index, self._coerce(value))

    def __setitem__(self, index, value):
        if isinstance(index, slice):
            value = [self._coerce(v) for v in value]
        else:
            value = self._coerce(value)
        super().__setitem__(index, value)
