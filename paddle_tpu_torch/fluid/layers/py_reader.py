"""py_reader: the reference's in-graph feeding queue, as the host-side
queue the executor drains (the port's copy of
``paddle_tpu/fluid/layers/py_reader.py``).

The loop is the reference's: ``reader.start()``, then ``exe.run(program)``
with no feed until ``fluid.core.EOFException``, then ``reader.reset()``.
``Executor.run`` pulls each reader's next batch on the host before the
step and passes it as an ordinary feed under the slot names, so the
``py_reader_dequeue`` op lowers to an identity binding, the program keeps
its feed signature and, on the card, its CUDA graph; at the end of a
pass EOF raises before any step runs. Shapes and dtypes are declared up
front and must be static. ``position`` counts the batches taken since
``start()``; ``CheckpointManager`` saves it, and ``resume_at`` fast-
forwards a restarted pass to the batch after a checkpoint.
"""

import logging
import time as _time
import weakref

import numpy as np

from .. import monitor as _monitor
from ..layer_helper import LayerHelper

_LOG = logging.getLogger(__name__)

_M_BATCHES = _monitor.counter(
    "py_reader_batches_total",
    help="batches the executor pulled from py_reader queues")
_M_EOF = _monitor.counter(
    "py_reader_eof_total", help="end-of-pass events (EOFException raised)")
_M_FEED_SECONDS = _monitor.histogram(
    "py_reader_feed_seconds",
    help="host time to pull + normalize one py_reader batch")

__all__ = ["py_reader", "create_py_reader_by_data", "read_file",
           "double_buffer"]


class _PyReader:
    """Host-side state: the provider function and the live iterator."""

    def __init__(self, names, shapes, dtypes):
        self.names = list(names)
        self.shapes = [tuple(int(d) for d in s) for s in shapes]
        self.dtypes = [np.dtype(d) for d in dtypes]
        self._provider = None
        self._it = None
        # batches taken since start(), and a pending fast-forward
        self._pos = 0
        self._resume_to = 0
        # while the executor's window prefetch pulls ahead: the position
        # of the committed steps
        self._committed = None

    # -- decoration (the reference's surface) -----------------------------
    def decorate_paddle_reader(self, reader, places=None):
        """``reader()`` yields one batch an item: a list of per-sample
        tuples or a tuple of arrays."""
        self._provider = reader
        return self

    decorate_sample_list_generator = decorate_paddle_reader

    def decorate_tensor_provider(self, reader, places=None):
        self._provider = reader
        return self

    decorate_batch_generator = decorate_tensor_provider

    # -- run control -------------------------------------------------------
    def start(self):
        if self._provider is None:
            raise RuntimeError(
                "py_reader.start(): decorate a reader first "
                "(decorate_paddle_reader / decorate_tensor_provider)")
        self._it = iter(self._provider())
        self._pos = 0
        if self._resume_to:
            # a checkpoint's resume: skip the batches the saved run took
            # this pass (the provider must be deterministic)
            skip, self._resume_to = self._resume_to, 0
            for _ in range(skip):
                if self._next() is None:
                    break

    def reset(self):
        self._it = None
        self._pos = 0
        self._resume_to = 0

    @property
    def position(self):
        """Batches taken since start()."""
        return self._pos

    @property
    def checkpoint_position(self):
        """The cursor a checkpoint saves: the batches the committed steps
        took, without a window the executor's prefetch pulled ahead."""
        return self._pos if self._committed is None else self._committed

    def resume_at(self, n):
        """Skip the first ``n`` batches at the next start(). On a live
        pass at once: forward by skipping; back (a rollback to an older
        checkpoint) by restarting the provider and skipping ``n``, so
        the batches after the checkpoint are read again."""
        n = int(n)
        if n < 0:
            raise ValueError("resume_at: n must be >= 0, got %d" % n)
        if self._it is None:
            self._resume_to = n
            return
        if n < self._pos:
            self._it = iter(self._provider())
            self._pos = 0
        while self._pos < n:
            if self._next() is None:
                break

    def _to_arrays(self, item):
        if isinstance(item, dict):
            vals = [item[n] for n in self.names]
        else:
            vals = list(item)
        if vals and not isinstance(vals[0], np.ndarray) \
                and isinstance(vals[0], (list, tuple)):
            # a batch of per-sample tuples -> one stack a slot
            vals = [np.stack([np.asarray(s[i]) for s in vals])
                    for i in range(len(self.names))]
        out = []
        for v, dt, shp in zip(vals, self.dtypes, self.shapes):
            a = np.ascontiguousarray(np.asarray(v, dtype=dt))
            if a.shape == shp:
                pass
            elif a.shape[0] == shp[0] and a.size == int(np.prod(shp)):
                a = a.reshape(shp)        # e.g. (B,) label -> (B, 1)
            elif 0 < a.shape[0] < shp[0] and \
                    a.size == a.shape[0] * int(np.prod(shp[1:])):
                # a partial final batch cannot fill the static shape: it
                # ends the pass, as drop_last would
                _LOG.warning(
                    "py_reader: dropping a partial final batch of shape "
                    "%s (declared %s) — use fluid.io.batch(..., "
                    "drop_last=True) to silence", a.shape, shp)
                raise StopIteration
            else:
                raise ValueError(
                    "py_reader batch shape %s does not match the "
                    "declared slot shape %s" % (a.shape, shp))
            out.append(a)
        return tuple(out)

    def _next(self):
        """The next batch (a tuple of numpy arrays, one a slot), or None
        at the end of the pass. The executor calls it before the step."""
        if self._it is None:
            raise RuntimeError("py_reader: call start() before exe.run()")
        t0 = _time.perf_counter()
        try:
            out = self._to_arrays(next(self._it))
        except StopIteration:
            _M_EOF.inc()
            return None
        _M_FEED_SECONDS.observe(_time.perf_counter() - t0)
        _M_BATCHES.inc()
        self._pos += 1
        return out


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """Declare the queue and return the reader object;
    ``read_file(reader)`` gives its data vars. ``capacity`` and
    ``use_double_buffer`` are taken for parity (the executor's window
    prefetch does the buffering). Shapes must be static: pass the
    concrete batch size."""
    for s in shapes:
        if any(int(d) < 0 for d in s):
            raise ValueError(
                "py_reader shapes must be fully static, got %r — "
                "pass the concrete batch size (fluid.layers.data vars "
                "prepend -1; build with append_batch_size=False)"
                % (list(s),))
    helper = LayerHelper(name or "py_reader")
    prefix = helper.name_prefix
    names = ["%s.slot%d" % (prefix, i) for i in range(len(shapes))]
    reader = _PyReader(names, shapes, dtypes)
    blk = helper.main_program.current_block()
    out_vars = [blk.create_var(name=n, shape=s, dtype=str(d))
                for n, s, d in zip(names, reader.shapes, reader.dtypes)]
    blk.append_op(
        "py_reader_dequeue", inputs={},
        outputs={"Out": out_vars},
        attrs={"reader_id": _register(reader),
               "shapes": [list(s) for s in reader.shapes],
               "dtypes": [str(d) for d in reader.dtypes]})
    reader._out_vars = out_vars
    return reader


def create_py_reader_by_data(capacity, feed_list, name=None,
                             use_double_buffer=True):
    """``py_reader`` over the shapes and dtypes of data vars."""
    return py_reader(capacity,
                     shapes=[v.shape for v in feed_list],
                     dtypes=[v.dtype for v in feed_list],
                     name=name, use_double_buffer=use_double_buffer)


def read_file(reader):
    """The data vars the dequeue op produces (one a declared slot)."""
    vs = reader._out_vars
    return vs[0] if len(vs) == 1 else vs


def double_buffer(reader, place=None, name=None):
    """Identity, for parity: the executor's prefetch buffers."""
    return reader


# weak registry: the program records only the id, and the user's reader
# object keeps its entry alive
_READERS = weakref.WeakValueDictionary()
_NEXT_ID = [0]


def _register(reader):
    rid = _NEXT_ID[0]
    _NEXT_ID[0] += 1
    _READERS[rid] = reader
    return rid


def program_py_readers(program):
    """The readers of the ``py_reader_dequeue`` ops of ``program``'s
    global block, in op order; raises if one was collected."""
    out = []
    for op in program.global_block().ops:
        if op.type == "py_reader_dequeue":
            r = _READERS.get(int(op.attr("reader_id")))
            if r is None:
                raise RuntimeError(
                    "the py_reader feeding this program was "
                    "garbage-collected — keep the object returned "
                    "by layers.py_reader() alive and start() it")
            out.append(r)
    return out


def _register_dequeue_op():
    from ..registry import register

    @register("py_reader_dequeue")
    def _dequeue(ctx, op):
        # the executor fed this step's batch under the slot names (the
        # outputs' names): the op binds them as its outputs
        for n in op.output("Out"):
            ctx.set(n, ctx.get(n))


_register_dequeue_op()
