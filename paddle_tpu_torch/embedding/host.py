"""HostEmbeddingTable: the host-memory residence tier behind a device row
cache (the port's counterpart of ``paddle_tpu/embedding/host.py``).

The whole table (values and per-row optimizer state) lives in host
memory as numpy arrays; the program only ever sees a fixed cache
``<table>@CACHE`` of ``resident_budget + 1`` rows (the last row is
scratch, never a slot). Per batch, the table maps raw ids to cache slots
on the host, admits the missing rows and evicts LRU/TTL victims, writing
back their device values and optimizer slot rows, so a host-tier step
equals the all-on-device table; growing the vocabulary touches only host
arrays, so the program's step and its CUDA graph never change.

The device side works on the scope's own tensors, in place:
- admission is ``index_copy_`` into the cache and its moments (a rebound
  persistable would make the executor copy the whole cache into a
  graph's captured storage before every replay);
- eviction reads back only the victims' rows; that copy waits for the
  last replay, so ``embedding_lookup_seconds`` includes the wait, as the
  reference's ``np.asarray`` of a device array does;
- ``prefetch`` stages the next batch's missing rows from a background
  thread: pinned host rows copied with ``non_blocking=True`` on a side
  ``torch.cuda.Stream``, which records an event; ``prepare`` makes the
  current stream wait on it and ``record_stream``s the staged tensors
  before admitting them. On the CPU the thread only builds the tensors.
  Errors in the thread surface at consume time; the thread is non-daemon
  and joined before any state it reads is changed, by ``close()`` and
  ``embedding.reset_tables()`` too.

The reference pads each admission to a power-of-two bucket so that XLA
compiles a bounded set of scatter shapes; torch needs no such bound, so
the port admits exactly the missing rows.
"""

import threading
import time

import numpy as np
import torch

from . import metrics

# Optimizer op types the host tier can round-trip through eviction: the
# per-row slot inputs written back and restored with the param rows
# (Adam's beta-pow accumulators are global, not per row, and stay plain
# device persistables).
_SLOT_INPUTS = {
    "sgd": (),
    "momentum": ("Velocity",),
    "adam": ("Moment1", "Moment2"),
    "adagrad": ("Moment",),
}

# Every optimizer op type that takes a Param input: the cache param
# driven by one whose state cannot be written back raises.
_OPTIMIZER_TYPES = frozenset(_SLOT_INPUTS) | {
    "lars_momentum", "adamax", "decayed_adagrad", "adadelta", "rmsprop",
    "ftrl", "lamb", "dpsgd",
}


def _host_ids(ids):
    """``ids`` as a numpy array: a torch tensor on the card is copied to
    the host (a sync with the work queued before it)."""
    if isinstance(ids, torch.Tensor):
        return ids.detach().cpu().numpy()
    return np.asarray(ids)


def _to_device(t, device):
    """A host tensor on ``device``: from pinned memory, non-blocking, on
    the current stream, when ``device`` is a card."""
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class HostEmbeddingTable:
    """Host-resident embedding table with a fixed device cache budget.

    ``num_rows`` may be far above the budget and can ``grow()`` at any
    time without changing the program's step. ``ttl_steps`` evicts rows
    idle for more than that many prepared steps; LRU eviction runs
    whenever a batch needs more slots than are free. The rows start from
    ``np.random.RandomState(seed)``, as the reference's do, so both
    packages start from the same table.
    """

    residence = "host"

    def __init__(self, name, num_rows, dim, resident_budget, ttl_steps=None,
                 dtype="float32", seed=0, init_scale=None, register=True):
        if num_rows < 1 or dim < 1:
            raise ValueError(
                "HostEmbeddingTable %r: num_rows and dim must be >= 1, "
                "got (%r, %r)" % (name, num_rows, dim))
        if resident_budget < 1:
            raise ValueError(
                "HostEmbeddingTable %r: resident_budget must be >= 1, "
                "got %r" % (name, resident_budget))
        if ttl_steps is not None and ttl_steps < 1:
            raise ValueError(
                "HostEmbeddingTable %r: ttl_steps must be >= 1 or None, "
                "got %r" % (name, ttl_steps))
        self.name = name
        self.num_rows = int(num_rows)
        self.dim = int(dim)
        self.budget = int(resident_budget)
        self.ttl_steps = ttl_steps
        self.dtype = np.dtype(dtype)
        self._rng = np.random.RandomState(seed)
        # the framework's Xavier-uniform scale for a [num_rows, dim] table
        scale = init_scale if init_scale is not None \
            else float(np.sqrt(6.0 / (num_rows + dim)))
        self._init_scale = scale
        self._values = self._init_rows(self.num_rows)
        self._slot_stores = {}   # store key ("adam:Moment1") -> [num_rows, dim]
        # residency state
        self._lut = np.full(self.num_rows, -1, np.int64)   # id -> slot
        self._slot_ids = np.full(self.budget, -1, np.int64)  # slot -> id
        self._stamp = np.zeros(self.budget, np.int64)      # slot -> last tick
        self._free = list(range(self.budget - 1, -1, -1))
        self._tick = 0
        self._attach = None      # (scope, cache_name, {dev_var: store_key})
        self._device = None      # the cache's device, from the last prepare
        # one bounded in-flight prefetch, on its own stream on the card
        self._prefetch_thread = None
        self._staged = None      # (sorted missing ids, {key: rows}, event)
        self._prefetch_error = None
        self._stream = None
        self._lock = threading.Lock()
        if register:
            from . import register_host_table

            register_host_table(self)

    # -- host store ---------------------------------------------------------

    def _init_rows(self, n):
        s = self._init_scale
        return self._rng.uniform(-s, s, (n, self.dim)).astype(self.dtype)

    def load(self, values):
        """Replace the host store's values (a baseline run's initial
        table, a checkpoint). Resets nothing on the device: load before
        training or after ``reset_residency``."""
        values = np.asarray(values, self.dtype)
        if values.shape != (self.num_rows, self.dim):
            raise ValueError(
                "HostEmbeddingTable %r: load expects shape %s, got %s"
                % (self.name, (self.num_rows, self.dim), values.shape))
        self._values = values.copy()

    def grow(self, num_rows):
        """Extend the vocabulary to ``num_rows``, on the host only: the
        device cache's shape is the budget's, so the program's step (and
        its graph) stays as it is."""
        num_rows = int(num_rows)
        if num_rows < self.num_rows:
            raise ValueError(
                "HostEmbeddingTable %r: cannot shrink %d -> %d rows"
                % (self.name, self.num_rows, num_rows))
        extra = num_rows - self.num_rows
        if not extra:
            return
        self._join_prefetch()
        self._values = np.concatenate([self._values, self._init_rows(extra)])
        for k in self._slot_stores:
            self._slot_stores[k] = np.concatenate(
                [self._slot_stores[k],
                 np.zeros((extra, self.dim), self.dtype)])
        self._lut = np.concatenate(
            [self._lut, np.full(extra, -1, np.int64)])
        self.num_rows = num_rows

    def snapshot(self):
        """Host values with every resident row flushed back: the whole
        current table."""
        self.flush()
        return self._values.copy()

    def slot_snapshot(self, key):
        """A flushed per-row optimizer slot store (e.g. "adam:Moment1")."""
        self.flush()
        return self._slot_stores[key].copy()

    @property
    def resident_count(self):
        return int((self._slot_ids >= 0).sum())

    # -- residency ----------------------------------------------------------

    def reset_residency(self):
        """Forget the device cache's contents (startup semantics: the
        executor runs this for ``host_embedding_init``, as it initialises
        device parameters)."""
        self._join_prefetch()
        self._staged = None
        self._lut[:] = -1
        self._slot_ids[:] = -1
        self._stamp[:] = 0
        self._free = list(range(self.budget - 1, -1, -1))
        self._tick = 0
        metrics.resident_rows(self.name).set(0)

    def prepare(self, ids, scope, cache_name, slot_map, iters=1):
        """Map a batch's raw ids onto resident cache slots, first staging
        the missing rows into the device cache (evicting LRU/TTL victims
        with write-back). Returns the int32 slots, shaped as ``ids``.

        ``slot_map``: {device accumulator var name -> store key} of the
        optimizer slots bound to the cache param in this program.
        """
        t0 = time.perf_counter()
        with self._lock:
            self._join_prefetch()
            ids = _host_ids(ids)
            flat = ids.reshape(-1).astype(np.int64)
            if flat.size == 0:
                raise ValueError(
                    "embedding lookup on table %r got an empty ids batch"
                    % self.name)
            lo, hi = int(flat.min()), int(flat.max())
            if lo < 0 or hi >= self.num_rows:
                bad = lo if lo < 0 else hi
                raise IndexError(
                    "embedding lookup id %d out of range for table %r "
                    "with %d rows (valid ids: 0..%d) — check the feed or "
                    "grow() the table" % (bad, self.name, self.num_rows,
                                          self.num_rows - 1))
            uniq = np.unique(flat)
            metrics.unique_ratio(self.name).set(uniq.size / flat.size)
            self._tick += int(iters)
            self._attach = (scope, cache_name, dict(slot_map))
            cache = scope.find_var(cache_name)
            if cache is not None:
                self._device = cache.device
            for key in slot_map.values():
                if key not in self._slot_stores:
                    self._slot_stores[key] = np.zeros(
                        (self.num_rows, self.dim), self.dtype)

            missing = uniq[self._lut[uniq] < 0]
            needed = np.zeros(self.num_rows, bool)
            needed[uniq] = True
            res_mask = self._slot_ids >= 0
            # a slot is evictable when resident and not needed this batch
            evictable = res_mask & ~needed[np.clip(self._slot_ids, 0, None)]

            # TTL expiry first, then LRU for what the batch still needs
            evict = np.zeros(self.budget, bool)
            if self.ttl_steps is not None:
                evict |= evictable & (self._tick - self._stamp
                                      > self.ttl_steps)
            shortfall = missing.size - (len(self._free) + int(evict.sum()))
            if shortfall > 0:
                cand = np.nonzero(evictable & ~evict)[0]
                if cand.size < shortfall:
                    raise RuntimeError(
                        "resident_budget=%d of table %r cannot hold one "
                        "batch: %d distinct rows needed, only %d slots "
                        "free/evictable — raise the budget or shrink the "
                        "batch/window" % (self.budget, self.name,
                                          uniq.size, self.budget))
                order = np.argsort(self._stamp[cand], kind="stable")
                evict[cand[order[:shortfall]]] = True
            evict_slots = np.nonzero(evict)[0]
            if evict_slots.size:
                self._evict(evict_slots, scope, cache_name, slot_map)

            if missing.size:
                slots_new = np.array(
                    [self._free.pop() for _ in range(missing.size)],
                    np.int64)
                vals = self._consume_prefetch(missing, slot_map)
                self._admit(slots_new, vals, scope, cache_name, slot_map)
                self._lut[missing] = slots_new
                self._slot_ids[slots_new] = missing
            self._stamp[self._lut[uniq]] = self._tick
            metrics.resident_rows(self.name).set(self.resident_count)
            slots = self._lut[flat].reshape(ids.shape).astype(np.int32)
        metrics.lookup_seconds(self.name).observe(time.perf_counter() - t0)
        return slots

    def _write_back(self, slots, scope, cache_name, slot_map):
        """Copy the device rows at ``slots`` (values and optimizer slots)
        into the host store: only those rows cross to the host, and the
        copy waits for the work queued before it (the last replay)."""
        rids = self._slot_ids[slots]
        idx = None
        for key, dev in self._targets(cache_name, slot_map):
            arr = scope.find_var(dev)
            store = self._values if key == "values" \
                else self._slot_stores.get(key)
            if arr is None or store is None:
                continue
            if idx is None:
                idx = torch.from_numpy(slots.astype(np.int64)).to(arr.device)
            with torch.no_grad():
                store[rids] = arr.index_select(0, idx).cpu().numpy()
        return rids

    def _evict(self, slots, scope, cache_name, slot_map):
        """Write the victims' rows back to the host store, then free
        their slots."""
        rids = self._write_back(slots, scope, cache_name, slot_map)
        metrics.evictions(self.name).inc(int(slots.size))
        self._lut[rids] = -1
        self._slot_ids[slots] = -1
        self._free.extend(int(s) for s in slots)

    def _admit(self, slots, vals, scope, cache_name, slot_map):
        """Copy the admitted rows into the scope's cache tensors in place
        (``index_copy_``), on the current stream."""
        idx = None
        for key, dev in self._targets(cache_name, slot_map):
            arr = scope.find_var(dev)
            if arr is None:
                raise RuntimeError(
                    "host-tier embedding %r: device var %r missing from "
                    "scope — run the startup program first"
                    % (self.name, dev))
            if idx is None:
                idx = _to_device(torch.from_numpy(slots.astype(np.int64)),
                                 arr.device)
            v = vals[key]
            if isinstance(v, np.ndarray):
                v = torch.from_numpy(v)
            with torch.no_grad():
                arr.index_copy_(0, idx, _to_device(v, arr.device).to(
                    arr.dtype))

    def _targets(self, cache_name, slot_map):
        return [("values", cache_name)] + [(key, dev)
                                           for dev, key in slot_map.items()]

    def flush(self):
        """Write every resident row (values and optimizer slots) back to
        the host store without evicting: what checkpoints and
        equivalence checks read."""
        if self._attach is None:
            return
        scope, cache_name, slot_map = self._attach
        slots = np.nonzero(self._slot_ids >= 0)[0]
        if slots.size:
            self._write_back(slots, scope, cache_name, slot_map)

    # -- async prefetch -----------------------------------------------------

    def prefetch(self, ids):
        """Stage the rows batch ``ids`` would miss on the device from a
        background thread, while the current step computes. One stage is
        in flight at a time; ``prepare`` consumes it (hits) or falls
        back to copying from the host store (misses)."""
        ids = _host_ids(ids).reshape(-1)
        uniq = np.unique(ids.astype(np.int64))
        uniq = uniq[(uniq >= 0) & (uniq < self.num_rows)]
        with self._lock:
            self._join_prefetch()
            missing = uniq[self._lut[uniq] < 0]
            keys = ["values"] + sorted(self._slot_stores)
            sources = {k: (self._values if k == "values"
                           else self._slot_stores[k])[missing]
                       for k in keys}
            device = self._device
        t = threading.Thread(target=self._stage,
                             args=(missing, sources, device),
                             name="embedding-prefetch-%s" % self.name)
        t.start()
        self._prefetch_thread = t

    def _stage(self, missing, sources, device):
        """The prefetch thread: on the card, the rows' copies on the
        table's side stream and an event after them; else host tensors."""
        try:
            event = None
            if device is not None and device.type == "cuda":
                if self._stream is None:
                    self._stream = torch.cuda.Stream(device)
                with torch.cuda.stream(self._stream):
                    rows = self._copy_rows(sources, device)
                    event = torch.cuda.Event()
                    event.record(self._stream)
            else:
                rows = self._copy_rows(sources, torch.device("cpu"))
            self._staged = (missing, rows, event)
        except Exception as e:  # surfaced at consume time
            self._staged = None
            self._prefetch_error = e

    @staticmethod
    def _copy_rows(sources, device):
        """Host rows to ``device`` on the current (side) stream, from
        pinned memory, non-blocking."""
        return {k: _to_device(torch.from_numpy(v), device)
                for k, v in sources.items()}

    def _join_prefetch(self):
        t = self._prefetch_thread
        if t is not None:
            t.join()
            self._prefetch_thread = None
        if self._prefetch_error is not None:
            e, self._prefetch_error = self._prefetch_error, None
            raise e

    def _consume_prefetch(self, missing, slot_map):
        """Rows to admit for the sorted ``missing`` ids: the staged
        tensors on an exact prefetch hit (the current stream made to wait
        for their copies), else host arrays. Counts each row's hit or
        miss either way."""
        staged, self._staged = self._staged, None
        need = ["values"] + sorted(set(slot_map.values()))
        hits = 0
        if staged is not None:
            sids, srows, event = staged
            if all(k in srows for k in need):
                hits = int(np.intersect1d(missing, sids).size)
        metrics.prefetch_hit(self.name).inc(hits)
        metrics.prefetch_miss(self.name).inc(int(missing.size) - hits)
        if staged is not None and hits == missing.size \
                and sids.size == missing.size:
            rows = {k: srows[k] for k in need}
            if event is not None:
                stream = torch.cuda.current_stream(self._device)
                stream.wait_event(event)
                for t in rows.values():
                    t.record_stream(stream)
            return rows
        return {k: (self._values if k == "values"
                    else self._slot_stores[k])[missing] for k in need}

    def close(self):
        """Join any in-flight prefetch. Idempotent."""
        t = self._prefetch_thread
        if t is not None:
            t.join()
            self._prefetch_thread = None
        self._staged = None
        self._prefetch_error = None


class HostLookupBinding:
    """Per-lookup glue the executor's feed hook drives: maps the raw ids
    feed to ``<table>@SLOTS`` through the table's residency. Attached to
    the Program by ``layers.embedding`` (host residence)."""

    def __init__(self, table_name, cache_name, slots_name, ids_name):
        self.table_name = table_name
        self.cache_name = cache_name
        self.slots_name = slots_name
        self.ids_name = ids_name
        self._slot_map_cache = None

    def prepare(self, program, feed, scope, iters=1):
        from . import get_host_table

        table = get_host_table(self.table_name)
        ids = feed.get(self.ids_name)
        if ids is None:
            if self.slots_name in feed:
                return  # the caller staged the slots itself
            raise KeyError(
                "host-tier embedding table %r needs feed %r (the raw ids) "
                "so the engine can stage resident rows" % (self.table_name,
                                                           self.ids_name))
        feed[self.slots_name] = table.prepare(
            ids, scope, self.cache_name, self._slot_map(program),
            iters=iters)

    def prefetch(self, feed):
        """Hint the next batch's feed: stage its missing rows in the
        background."""
        from . import get_host_table

        ids = feed.get(self.ids_name)
        if ids is not None:
            get_host_table(self.table_name).prefetch(ids)

    def _slot_map(self, program):
        """{device accumulator var -> store key} of the optimizer slots
        bound to the cache param, found from the program's optimizer ops
        so eviction can round-trip Adam / momentum state per row."""
        key = (program._uid, program._mutation)
        if self._slot_map_cache is not None \
                and self._slot_map_cache[0] == key:
            return self._slot_map_cache[1]
        m = {}
        for op in program.global_block().ops:
            if op.type not in _OPTIMIZER_TYPES:
                continue
            pin = op.input("Param")
            if not pin or pin[0] != self.cache_name:
                continue
            if op.type not in _SLOT_INPUTS:
                raise NotImplementedError(
                    "host-tier embedding %r is driven by optimizer op %r, "
                    "whose per-row state cannot be written back on "
                    "eviction — supported: %s"
                    % (self.table_name, op.type,
                       ", ".join(sorted(_SLOT_INPUTS))))
            for slot_in in _SLOT_INPUTS[op.type]:
                names = op.input(slot_in)
                if names:
                    m[names[0]] = "%s:%s" % (op.type, slot_in)
        self._slot_map_cache = (key, m)
        return m


def append_host_lookup(helper, input_var, size, table, padding_idx, dtype):
    """Emit the host-tier lookup for ``layers.embedding``: the fixed
    cache param (budget + 1 rows; the last is scratch), the int32 slots
    feed var the table fills per batch, the ``host_embedding_lookup`` op,
    and the startup program's ``host_embedding_init``."""
    from ..fluid.param_attr import ParamAttr

    if int(size[1]) != table.dim:
        raise ValueError(
            "embedding size %s does not match host table %r dim %d"
            % (list(size), table.name, table.dim))
    if int(size[0]) > table.num_rows:
        raise ValueError(
            "embedding vocab %d exceeds host table %r rows %d — grow() "
            "the table first" % (int(size[0]), table.name, table.num_rows))
    program = helper.main_program
    block = program.global_block()
    bindings = getattr(program, "_embedding_bindings", None)
    if bindings is None:
        bindings = program._embedding_bindings = []
    existing = next((b for b in bindings
                     if getattr(b, "table_name", None) == table.name), None)
    cache_name = table.name + "@CACHE"
    slots_name = table.name + "@SLOTS"
    if existing is not None:
        if existing.ids_name != input_var.name:
            raise NotImplementedError(
                "host table %r is already looked up with ids %r in this "
                "program; a second lookup must reuse the same ids feed"
                % (table.name, existing.ids_name))
        w = block.var(cache_name)
        slots = block.var(slots_name)
    else:
        w = helper.create_parameter(
            ParamAttr(name=cache_name), (table.budget + 1, table.dim),
            dtype)
        slots = block.create_var(
            name=slots_name, shape=tuple(input_var.shape), dtype="int32",
            persistable=False, stop_gradient=True)
        helper.startup_program.global_block().append_op(
            "host_embedding_init", attrs={"table_name": table.name})
        bindings.append(HostLookupBinding(
            table.name, cache_name, slots_name, input_var.name))
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="host_embedding_lookup",
        inputs={"W": [w], "Ids": [slots], "RawIds": [input_var]},
        outputs={"Out": [out]},
        attrs={"table_name": table.name, "is_sparse": True,
               "padding_idx": -1 if padding_idx is None else padding_idx,
               "budget": table.budget},
    )
    return out
