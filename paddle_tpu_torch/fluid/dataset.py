"""Datasets over MultiSlot text files (the port's counterpart of
``paddle_tpu/fluid/dataset.py``): files parse on the host, samples
shuffle in host memory, and batches assemble into the executor's feed
dicts: a dense slot stacked to its var's declared shape, a ragged slot
(a var with ``lod_level`` > 0) as a ``LoDTensor`` of flat rows.
``Executor.train_from_dataset`` drives one pass.

Line format (the reference's MultiSlotDataFeed): per slot
``<num> <v>*num``; a slot of an integer var holds int64 feasigns ('u'),
any other float32 values ('f').

Not ported yet, each refused naming its ROADMAP item:
- the native C++ line parser and channel (queue 1 item 9): the numpy
  parser gives the same samples (the reference's own
  ``test_native_and_numpy_parsers_agree``);
- ``set_exchange`` and ``global_shuffle`` across trainers, and
  ``BoxPSDataset`` (queue 1 item 8);
- ``set_hdfs_config`` (queue 1 item 9).
"""

import os
import subprocess
import threading

import numpy as np

from .framework import Variable, convert_dtype
from .lod import LoDTensor

__all__ = ["DatasetFactory", "DatasetBase", "InMemoryDataset",
           "QueueDataset", "FileInstantDataset"]

DISTRIBUTED_ITEM = "ROADMAP queue 1 item 8"
NATIVE_ITEM = "ROADMAP queue 1 item 9"


class DatasetFactory:
    """Name -> dataset instance (the reference's ``dataset.py:22``)."""

    def create_dataset(self, datafeed_class="QueueDataset"):
        if datafeed_class == "BoxPSDataset":
            raise NotImplementedError(
                "BoxPSDataset binds a dataset to the parameter-server "
                "tier, which is not ported yet (%s)" % DISTRIBUTED_ITEM)
        kinds = {"InMemoryDataset": InMemoryDataset,
                 "QueueDataset": QueueDataset,
                 "FileInstantDataset": FileInstantDataset}
        if datafeed_class not in kinds:
            raise ValueError("unknown dataset class %r (one of %s)"
                             % (datafeed_class,
                                sorted(kinds) + ["BoxPSDataset"]))
        return kinds[datafeed_class]()


def _numpy_parse(text, types):
    """MultiSlot lines -> per-slot (values, offsets)."""
    n_slots = len(types)
    vals = [[] for _ in range(n_slots)]
    offs = [[0] for _ in range(n_slots)]
    for ln, line in enumerate(text.splitlines()):
        tok = line.split()
        if not tok:
            continue
        i = 0
        for s in range(n_slots):
            if i >= len(tok):
                raise ValueError("line %d: missing slot %d" % (ln, s))
            num = int(tok[i])
            i += 1
            if num <= 0:
                raise ValueError("line %d: slot %d has num=%d" % (ln, s,
                                                                  num))
            seg = tok[i:i + num]
            if len(seg) != num:
                raise ValueError("line %d: slot %d truncated" % (ln, s))
            conv = int if types[s] == "u" else float
            vals[s].extend(conv(t) for t in seg)
            offs[s].append(offs[s][-1] + num)
            i += num
    out = []
    for s in range(n_slots):
        dt = np.int64 if types[s] == "u" else np.float32
        out.append((np.asarray(vals[s], dt),
                    np.asarray(offs[s], np.int64)))
    return out


def _native_parse(lib, data, types):
    """The reference's C++ line parser: not ported."""
    raise NotImplementedError(
        "the native MultiSlot parser is not ported yet (%s); the numpy "
        "parser gives the same samples" % NATIVE_ITEM)


class DatasetBase:
    """Configuration (vars, files, batch size, threads) and parsing
    (the reference's ``dataset.py:64``)."""

    def __init__(self):
        self._batch_size = 1
        self._thread_num = 1
        self._filelist = []
        self._use_vars = []
        self._pipe_command = None
        self._rng = np.random.RandomState(0)

    # -- configuration -----------------------------------------------------
    def set_pipe_command(self, pipe_command):
        """A shell filter each file streams through before parsing."""
        self._pipe_command = pipe_command

    def set_batch_size(self, batch_size):
        self._batch_size = int(batch_size)

    def set_thread(self, thread_num):
        self._thread_num = max(1, int(thread_num))

    def set_filelist(self, filelist):
        self._filelist = list(filelist)

    def set_use_var(self, var_list):
        for v in var_list:
            if not isinstance(v, Variable):
                raise TypeError("set_use_var takes Variables, got %r" % v)
        self._use_vars = list(var_list)

    def set_hdfs_config(self, fs_name, fs_ugi):
        raise NotImplementedError(
            "set_hdfs_config: reading datasets from HDFS is not ported "
            "yet (%s)" % NATIVE_ITEM)

    def set_seed(self, seed):
        self._rng = np.random.RandomState(seed)

    # -- parsing ------------------------------------------------------------
    def _slot_types(self):
        types = []
        for v in self._use_vars:
            dt = convert_dtype(v.dtype or "float32")
            types.append("u" if np.issubdtype(np.dtype(dt), np.integer)
                         else "f")
        return types

    def _read_file(self, fname):
        with open(fname, "rb") as f:
            raw = f.read()
        if self._pipe_command:
            raw = subprocess.run(self._pipe_command, shell=True, input=raw,
                                 capture_output=True, check=True).stdout
        return raw

    def _parse_file(self, fname):
        """-> samples, each a tuple of per-slot 1-D numpy arrays."""
        if not self._use_vars:
            raise RuntimeError("set_use_var must be called before loading")
        slots = _numpy_parse(self._read_file(fname).decode(),
                             self._slot_types())
        n_lines = len(slots[0][1]) - 1
        return [tuple(vals[offs[i]:offs[i + 1]] for vals, offs in slots)
                for i in range(n_lines)]

    # -- batching ------------------------------------------------------------
    @staticmethod
    def _lod_bound(n):
        """The physical row bound of a ragged batch's flat rows: the
        next power of two, at least 16, so the feed signatures of a pass
        number O(log longest batch) and their steps are shared."""
        b = 16
        while b < n:
            b *= 2
        return b

    def _batch_to_feed(self, batch):
        """Samples -> a feed dict: a ragged slot (``lod_level`` > 0) as a
        ``LoDTensor`` of its rows zero-padded to ``_lod_bound``, a dense
        slot stacked and shaped as its var declares."""
        feed = {}
        for si, var in enumerate(self._use_vars):
            cols = [s[si] for s in batch]
            if getattr(var, "lod_level", 0) and var.lod_level > 0:
                flat = np.concatenate(cols)
                if flat.ndim == 1:
                    flat = flat[:, None]
                bound = self._lod_bound(flat.shape[0])
                if bound > flat.shape[0]:
                    pad = np.zeros((bound - flat.shape[0],) + flat.shape[1:],
                                   flat.dtype)
                    flat = np.concatenate([flat, pad])
                feed[var.name] = LoDTensor(flat, [[len(c) for c in cols]])
                continue
            arrs = [np.asarray(c) for c in cols]
            shape = [d for d in (var.shape or []) if d not in (-1, None)]
            if shape:
                arrs = [a.reshape(shape) for a in arrs]
            feed[var.name] = np.stack(arrs)
        return feed

    def _iter_batches(self, samples, drop_last=False):
        buf = []
        for s in samples:
            buf.append(s)
            if len(buf) == self._batch_size:
                yield self._batch_to_feed(buf)
                buf = []
        if buf and not drop_last:
            yield self._batch_to_feed(buf)

    def batch_reader(self, drop_last=False):
        raise NotImplementedError

    def desc(self):
        return {"batch_size": self._batch_size, "thread": self._thread_num,
                "files": list(self._filelist),
                "slots": [v.name for v in self._use_vars],
                "types": self._slot_types() if self._use_vars else []}


class InMemoryDataset(DatasetBase):
    """Every file loaded into host memory, then shuffled locally (the
    reference's ``dataset.py:276``)."""

    def __init__(self):
        super().__init__()
        self._samples = []
        self._preload_threads = None

    def load_into_memory(self):
        """Parse every file, ``thread_num`` files at a time, in file
        order."""
        if self._thread_num <= 1 or len(self._filelist) <= 1:
            self._samples = [s for f in self._filelist
                             for s in self._parse_file(f)]
            return
        results = [None] * len(self._filelist)
        errors = []

        def work(idx, fname):
            try:
                results[idx] = self._parse_file(fname)
            except Exception as e:  # raised below with the file name
                errors.append((fname, e))

        threads = []
        for i, f in enumerate(self._filelist):
            t = threading.Thread(target=work, args=(i, f))
            t.start()
            threads.append(t)
            if len(threads) >= self._thread_num:
                threads.pop(0).join()
        for t in threads:
            t.join()
        if errors:
            fname, err = errors[0]
            raise RuntimeError("failed to parse %r: %s" % (fname, err)) \
                from err
        self._samples = [s for r in results for s in r]

    def preload_into_memory(self, thread_num=None):
        """``load_into_memory`` on a background thread;
        ``wait_preload_done`` joins it."""
        if thread_num:
            self.set_thread(thread_num)
        t = threading.Thread(target=self.load_into_memory)
        t.start()
        self._preload_threads = [t]

    def wait_preload_done(self):
        for t in self._preload_threads or []:
            t.join()
        self._preload_threads = None

    def local_shuffle(self):
        self._rng.shuffle(self._samples)

    def set_exchange(self, server, endpoints, seed=None):
        raise NotImplementedError(
            "set_exchange: the sample exchange between trainers is not "
            "ported yet (%s)" % DISTRIBUTED_ITEM)

    def global_shuffle(self, fleet=None, thread_num=12):
        """With no fleet, one trainer: a shuffle of the samples, as the
        reference's. Across trainers: not ported."""
        if fleet is not None:
            raise NotImplementedError(
                "global_shuffle across trainers is not ported yet (%s)"
                % DISTRIBUTED_ITEM)
        self._rng.shuffle(self._samples)

    def release_memory(self):
        self._samples = []

    def get_memory_data_size(self, fleet=None):
        if fleet is not None:
            raise NotImplementedError(
                "get_memory_data_size across trainers is not ported yet "
                "(%s)" % DISTRIBUTED_ITEM)
        return len(self._samples)

    def get_shuffle_data_size(self, fleet=None):
        return len(self._samples)

    def batch_reader(self, drop_last=False):
        def reader():
            yield from self._iter_batches(self._samples, drop_last)

        return reader


class QueueDataset(DatasetBase):
    """Streaming: files parse on a background thread and batches queue
    ahead of the consumer; nothing is kept (the reference's
    ``dataset.py:646``)."""

    def local_shuffle(self):
        raise NotImplementedError(
            "QueueDataset streams; use InMemoryDataset for local_shuffle "
            "(reference raises the same)")

    def global_shuffle(self, fleet=None):
        raise NotImplementedError(
            "QueueDataset streams; use InMemoryDataset for global_shuffle")

    def batch_reader(self, drop_last=False):
        """Batches through a bounded Python queue from a producer
        thread (the reference's native channel is not ported)."""
        if os.environ.get("PADDLE_TPU_NATIVE_CHANNEL") == "1":
            raise NotImplementedError(
                "the native dataset channel (PADDLE_TPU_NATIVE_CHANNEL=1) "
                "is not ported yet (%s)" % NATIVE_ITEM)
        return self._reader_over_queue(drop_last)

    def _produce_batches(self, drop_last):
        buf = []
        for f in self._filelist:
            for s in self._parse_file(f):
                buf.append(s)
                if len(buf) == self._batch_size:
                    yield self._batch_to_feed(buf)
                    buf = []
        if buf and not drop_last:
            yield self._batch_to_feed(buf)

    def _reader_over_queue(self, drop_last):
        import queue as _q

        def reader():
            q = _q.Queue(maxsize=max(2, self._thread_num * 2))
            end = object()
            stop = threading.Event()

            def put(item):
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.05)
                        return True
                    except _q.Full:
                        pass
                return False

            def produce():
                try:
                    for feed in self._produce_batches(drop_last):
                        if not put(feed):
                            return
                    put(end)
                except Exception as e:  # raised in the consumer
                    put(("__dataset_error__", e))

            t = threading.Thread(target=produce, daemon=True)
            t.start()
            try:
                while True:
                    item = q.get()
                    if item is end:
                        break
                    if isinstance(item, tuple) and len(item) == 2 and \
                            isinstance(item[0], str) and \
                            item[0] == "__dataset_error__":
                        raise RuntimeError(
                            "QueueDataset stream failed") from item[1]
                    yield item
            finally:
                # a consumer that stops early releases the producer
                stop.set()
                t.join()

        return reader


class FileInstantDataset(QueueDataset):
    """The reference's ``dataset.py:729``: a QueueDataset flavour, with
    the same streaming semantics here."""
