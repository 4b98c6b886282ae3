"""DataLoader and the device stager: the host-to-device input pipeline
(the port's counterpart of ``paddle_tpu/fluid/reader.py``).

A background ``DeviceStager`` thread assembles numpy batches and copies
them to the card ahead of their step (``stage_feed``): from pinned
memory, ``non_blocking``, on the stager's own ``torch.cuda.Stream``,
which records an event after the copies. The staged feed
(``StagedFeed``) is handed over a bounded queue; the consumer's stream
waits on its event (and ``record_stream``s its tensors) before the
consumer sees it, so a step, eager or a graph replay, never reads a
half-written batch. The executor takes the staged tensors as feeds
unchanged.

``PyReader`` is the reference's older decorate-style API over
``GeneratorLoader``. Not ported yet: sharding-aware staging onto a mesh
(a ``sharding=`` other than None; ROADMAP queue 1 item 7).
"""

import os as _os
import queue as _queue
import threading
import time as _time

import numpy as np
import torch

from .. import resolve_device
from . import faults as _faults
from . import monitor as _monitor
from . import resilience as _resilience
from .framework import Variable
from .lod import LoDTensor

__all__ = ["DataLoader", "GeneratorLoader", "DeviceStager", "StagedFeed",
           "stage_feed", "copy_feed", "WorkerInfo", "get_worker_info",
           "PyReader"]

MESH_ITEM = "ROADMAP queue 1 item 7"

# -- monitor series (the reference's names; process-wide) --------------------
_M_BATCHES = _monitor.counter(
    "reader_batches_total",
    help="batches produced by DataLoader/GeneratorLoader")
_M_STALLS = _monitor.counter(
    "reader_queue_full_total",
    help="producer stalls: the prefetch queue was full when a batch "
         "was ready (consumer is the bottleneck)")
_M_FEED_SECONDS = _monitor.histogram(
    "reader_feed_seconds",
    help="batch assembly + device staging time (_to_feed)")
_M_PREFETCH_DEPTH = _monitor.gauge(
    "reader_prefetch_depth",
    help="staged batches queued ahead of the consumer (DeviceStager "
         "queue occupancy; capacity-bounded)")
_M_PREFETCH_STALL = _monitor.histogram(
    "reader_prefetch_stall_seconds",
    help="consumer wait on the DeviceStager queue (0 when the next "
         "staged batch was already waiting — the prefetch kept up)")

# transient staging failures (an injected reader.stage fault) are
# retried with backoff inside the producer thread instead of ending the
# pipeline; attempts come from PADDLE_STAGE_RETRIES (>= 1), and each retry
# and exhaustion is counted under site="reader.stage"
_STAGE_RETRY = _resilience.Retry(
    max_attempts=max(1, int(_os.environ.get("PADDLE_STAGE_RETRIES", "3"))),
    base_delay=0.05, max_delay=1.0,
    retryable=_resilience.TransientError, name="reader.stage")

# one side stream a card for every stager's copies
_STREAMS = {}
_STREAMS_LOCK = threading.Lock()


def _stage_stream(device):
    with _STREAMS_LOCK:
        s = _STREAMS.get(device)
        if s is None:
            s = _STREAMS[device] = torch.cuda.Stream(device)
        return s


class StagedFeed(dict):
    """A feed dict whose tensors were copied on a stager's stream.
    ``wait()`` makes the calling thread's current stream wait for those
    copies and marks the tensors as used there; the stager calls it on
    the consumer's side, before handing the feed over."""

    event = device = None

    def wait(self):
        event, self.event = self.event, None
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for v in self.values():
                if isinstance(v, LoDTensor):
                    v = v.data()
                if isinstance(v, torch.Tensor) and v.is_cuda:
                    v.record_stream(stream)
        return self


def stage_feed(feed, place="cuda", sharding=None, keep_on_host=()):
    """One feed dict on ``place``: each numpy array becomes a tensor
    there; on a card copied from pinned memory, non-blocking, on the
    stager stream, with an event recorded after the copies (a
    ``StagedFeed``; the consumer calls ``wait()``). Names in
    ``keep_on_host`` (the raw ids a host-tier embedding table maps on the
    host) and non-array values pass through as they are; a ``LoDTensor``
    keeps its lengths on the host and its data is copied."""
    if sharding is not None:
        raise NotImplementedError(
            "stage_feed(sharding=...): staging feeds pre-sharded onto a "
            "mesh is not ported yet (%s)" % MESH_ITEM)
    _faults.check("reader.stage")
    return copy_feed(feed, resolve_device(place), keep_on_host)


def copy_feed(feed, device, keep_on_host=()):
    """``stage_feed``'s copies, with no fault point: the numpy arrays of
    ``feed`` as tensors on ``device`` (a ``torch.device``), on a card on
    the stager stream behind an event."""
    out = StagedFeed()

    def copy(value):
        value = torch.from_numpy(np.ascontiguousarray(value))
        if device.type == "cuda":
            value = value.pin_memory().to(device, non_blocking=True)
        return value

    def put(name, value):
        if name not in keep_on_host:
            if isinstance(value, np.ndarray):
                value = copy(value)
            elif isinstance(value, LoDTensor) and isinstance(
                    value.data(), np.ndarray):
                value = LoDTensor(copy(value.data()),
                                  value.recursive_sequence_lengths())
        out[name] = value

    if device.type == "cuda":
        stream = _stage_stream(device)
        with torch.cuda.stream(stream):
            for name, value in feed.items():
                put(name, value)
            out.event, out.device = torch.cuda.Event(), device
            out.event.record(stream)
    else:
        for name, value in feed.items():
            put(name, value)
    return out


class DeviceStager:
    """Bounded ahead-of-time staging: a producer thread pulls items from
    ``source``, runs ``transform`` (batch assembly and/or
    ``stage_feed``) and hands the results over a bounded queue, so batch
    i+1's copy overlaps step i; ``reader_prefetch_depth`` reports how far
    ahead it runs.

    The thread is non-daemon: a stager that outlives its pipeline is a
    bug. Iterate to the end or call ``close()``, which is idempotent,
    unblocks a producer stalled on a full queue and joins the thread.
    Producer exceptions re-raise in the consumer. A ``StagedFeed`` is
    waited on (``StagedFeed.wait``) on the consumer's thread before it is
    returned."""

    _END = object()

    def __init__(self, source, transform=None, capacity=2, name="stager"):
        self._q = _queue.Queue(maxsize=max(1, int(capacity)))
        self._stop = threading.Event()
        self._done = False
        self._transform = transform
        self._source = iter(source)
        self._thread = threading.Thread(
            target=self._produce, name="paddle-device-stager[%s]" % name,
            daemon=False)
        self._thread.start()

    # -- producer side --------------------------------------------------
    def _put(self, item):
        # a stall is counted once a batch, up front: the blocking put
        # below can absorb a short stall without raising Full
        if self._q.full():
            _M_STALLS.inc()
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                _M_PREFETCH_DEPTH.set(self._q.qsize())
                return True
            except _queue.Full:
                pass
        return False

    def _produce(self):
        try:
            for item in self._source:
                if self._stop.is_set():
                    return
                if self._transform is not None:
                    item = _STAGE_RETRY.call(self._transform, item)
                if not self._put(item):
                    return
        except BaseException as e:  # re-raised on the consumer side
            self._put(("__stager_error__", e))
        finally:
            self._put(self._END)

    # -- consumer side --------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        t0 = _time.perf_counter()
        item = self._q.get()
        _M_PREFETCH_STALL.observe(_time.perf_counter() - t0)
        _M_PREFETCH_DEPTH.set(self._q.qsize())
        if item is self._END:
            self.close()
            raise StopIteration
        if isinstance(item, tuple) and len(item) == 2 and \
                isinstance(item[0], str) and item[0] == "__stager_error__":
            self.close()
            raise item[1]
        if isinstance(item, StagedFeed):
            item.wait()
        return item

    def close(self):
        """Stop the producer and join its thread; items still queued are
        dropped."""
        if self._done and not self._thread.is_alive():
            return
        self._done = True
        self._stop.set()
        # drain, so a producer blocked on a full queue sees _stop
        while True:
            try:
                self._q.get_nowait()
            except _queue.Empty:
                break
        self._thread.join()
        _M_PREFETCH_DEPTH.set(0)


class WorkerInfo:
    """Identity of the current DataLoader worker process. A generator
    that shards its own input by ``get_worker_info()`` calls
    ``mark_sharded()``, and the loader keeps every batch it yields
    instead of filtering them round-robin."""

    def __init__(self, rank, num_workers):
        self.id = rank
        self.num_workers = num_workers
        self.consumed_shard = False

    def mark_sharded(self):
        self.consumed_shard = True


_worker_info = None


def get_worker_info():
    """None in the main process; a WorkerInfo inside a worker."""
    return _worker_info


class GeneratorLoader:
    """Iterable loader: a sample or batch generator as prefetched feed
    dicts, staged on ``place`` (the card unless the caller passes the
    CPU). ``use_double_buffer=False`` turns off both the prefetch thread
    and the ahead-of-time staging: each batch assembles in the consumer
    and reaches the executor as host arrays."""

    def __init__(self, feed_list, capacity=4, stage_on_device=True,
                 use_multiprocess=False, num_workers=2,
                 use_double_buffer=True, sharding=None, place=None):
        if sharding is not None:
            raise NotImplementedError(
                "DataLoader(sharding=...): staging feeds pre-sharded onto "
                "a mesh is not ported yet (%s)" % MESH_ITEM)
        self._feed_names = [v.name if isinstance(v, Variable) else str(v)
                            for v in feed_list]
        self._capacity = capacity
        self._double_buffer = bool(use_double_buffer)
        self._stage = bool(stage_on_device) and self._double_buffer
        self._place = resolve_device("cuda" if place is None else place) \
            if self._stage else None
        self._gen = None
        self._use_multiprocess = use_multiprocess
        self._num_workers = max(1, int(num_workers))

    # -- generator registration -----------------------------------------
    def set_sample_generator(self, generator, batch_size, drop_last=True):
        def batcher():
            buf = []
            for sample in generator():
                buf.append(sample if isinstance(sample, (list, tuple))
                           else (sample,))
                if len(buf) == batch_size:
                    yield [np.stack([np.asarray(s[i]) for s in buf])
                           for i in range(len(buf[0]))]
                    buf = []
            if buf and not drop_last:
                yield [np.stack([np.asarray(s[i]) for s in buf])
                       for i in range(len(buf[0]))]

        self._gen = batcher
        return self

    def set_sample_list_generator(self, generator):
        def batcher():
            for samples in generator():
                yield [np.stack([np.asarray(s[i]) for s in samples])
                       for i in range(len(samples[0]))]

        self._gen = batcher
        return self

    def set_batch_generator(self, generator):
        self._gen = generator
        return self

    # -- iteration -------------------------------------------------------
    def _to_feed(self, batch):
        t0 = _time.perf_counter()
        items = ([batch[n] for n in self._feed_names]
                 if isinstance(batch, dict) else list(batch))
        feed = {n: a if isinstance(a, torch.Tensor) else np.asarray(a)
                for n, a in zip(self._feed_names, items)}
        if self._stage:
            feed = stage_feed(feed, self._place)
        _M_FEED_SECONDS.observe(_time.perf_counter() - t0)
        _M_BATCHES.inc()
        return feed

    def _iter_threaded(self):
        stager = DeviceStager(self._gen(), transform=self._to_feed,
                              capacity=self._capacity, name="loader")
        try:
            for item in stager:
                yield item
        finally:
            # leaving the loop (break, or the generator collected) must
            # not leak the non-daemon producer thread
            stager.close()

    def _iter_sync(self):
        """use_double_buffer=False: no thread, no queue, no staging."""
        for batch in self._gen():
            yield self._to_feed(batch)

    def _iter_multiprocess(self):
        """Worker processes (fork) run the generator and ship numpy
        batches over a queue; the staging stays in this process. Each
        worker runs the whole generator and keeps the batches of its
        round-robin share, unless the generator shards itself through
        ``get_worker_info()`` (then every batch it yields is kept)."""
        import multiprocessing as mp
        import traceback

        ctx = mp.get_context("fork")
        q = ctx.Queue(maxsize=max(2, self._capacity))
        n = self._num_workers
        names = self._feed_names

        def worker(rank, gen, nworkers):
            global _worker_info
            _worker_info = WorkerInfo(rank, nworkers)
            try:
                for i, batch in enumerate(gen()):
                    if not _worker_info.consumed_shard and \
                            i % nworkers != rank:
                        continue
                    items = ([batch[k] for k in names]
                             if isinstance(batch, dict) else list(batch))
                    q.put([np.asarray(a) for a in items])
                q.put(None)
            except BaseException:  # shipped to the parent, raised there
                q.put(("__worker_error__", rank, traceback.format_exc()))

        procs = [ctx.Process(target=worker, args=(r, self._gen, n),
                             daemon=True) for r in range(n)]
        for p in procs:
            p.start()
        done = 0
        try:
            while done < n:
                item = q.get()
                if item is None:
                    done += 1
                    continue
                if isinstance(item, tuple) and item[0] == "__worker_error__":
                    raise RuntimeError("DataLoader worker %d died:\n%s"
                                       % (item[1], item[2]))
                feed = self._to_feed(item)
                yield feed.wait() if isinstance(feed, StagedFeed) else feed
        finally:
            for p in procs:
                p.terminate()
                p.join()

    def __iter__(self):
        if self._gen is None:
            raise RuntimeError("no generator set (set_batch_generator / "
                               "set_sample_generator / "
                               "set_sample_list_generator)")
        if self._use_multiprocess:
            return self._iter_multiprocess()
        if not self._double_buffer:
            return self._iter_sync()
        return self._iter_threaded()


class DataLoader:
    """``from_generator`` and ``from_dataset`` (the reference's
    ``reader.py:73``)."""

    @staticmethod
    def from_generator(feed_list=None, capacity=4, use_double_buffer=True,
                       iterable=True, return_list=False,
                       stage_on_device=True, use_multiprocess=False,
                       num_workers=2, sharding=None, place=None):
        """``use_double_buffer=True`` (default): a background
        ``DeviceStager`` thread prefetches up to ``capacity`` batches,
        each assembled and, with ``stage_on_device=True``, already on
        ``place`` (the card unless the caller passes the CPU).
        ``use_double_buffer=False``: synchronous, no prefetch thread and
        no staging. ``use_multiprocess=True``: ``num_workers`` forked
        processes run the generator."""
        if not feed_list:
            raise ValueError("feed_list is required")
        return GeneratorLoader(feed_list, capacity=capacity,
                               stage_on_device=stage_on_device,
                               use_multiprocess=use_multiprocess,
                               num_workers=num_workers,
                               use_double_buffer=use_double_buffer,
                               sharding=sharding, place=place)

    @staticmethod
    def from_dataset(dataset, places=None, drop_last=True):
        """A Dataset's batches as prefetched feed dicts, staged on
        ``places`` (the card unless the caller passes the CPU)."""
        if isinstance(places, (list, tuple)):
            places = places[0]
        loader = GeneratorLoader(dataset._use_vars, place=places)
        loader.set_batch_generator(dataset.batch_reader(drop_last))
        return loader


class PyReader:
    """The reference's ``PyReader`` (``paddle_tpu/fluid/reader.py:442``):
    the older decorate_* API over ``GeneratorLoader``; ``start()`` and
    ``reset()`` do nothing in iterable mode. ``place`` is the staging
    device, the card unless the caller passes the CPU."""

    def __init__(self, feed_list=None, capacity=4, use_double_buffer=True,
                 iterable=True, return_list=False, sharding=None,
                 place=None):
        self._loader = GeneratorLoader(feed_list, capacity,
                                       use_double_buffer=use_double_buffer,
                                       sharding=sharding, place=place)

    def decorate_sample_generator(self, sample_generator, batch_size,
                                  drop_last=True, places=None):
        self._loader.set_sample_generator(sample_generator, batch_size,
                                          drop_last)

    def decorate_sample_list_generator(self, reader, places=None):
        self._loader.set_sample_list_generator(reader)

    def decorate_batch_generator(self, reader, places=None):
        self._loader.set_batch_generator(reader)

    def start(self):
        pass

    def reset(self):
        pass

    def __iter__(self):
        return iter(self._loader)
