"""paddle_tpu_torch.embedding: the sparse embedding engine (the port's
counterpart of ``paddle_tpu.embedding``), two residence tiers behind one
API:

- the device tier: ``fluid.layers.embedding(is_sparse=True)`` appends
  ``embedding_lookup`` (``fluid/ops/embedding_ops.py``), a gather whose
  backward is a SelectedRows (rows, values) pair, which the optimizer ops
  apply as fused row-sparse updates without a dense [vocab, dim]
  gradient;
- the host tier: ``HostEmbeddingTable`` (``host.py``) keeps the table
  and its per-row optimizer state in host memory behind a fixed device
  row cache, with LRU/TTL eviction and write-back, and async prefetch.
  A lookup whose param name has a registered table (or
  ``residence="host"``) goes there; the executor's feed hook
  (``prepare_feed``) maps each batch's raw ids to cache slots before the
  step runs, and vocabulary growth never changes the step.

Monitor series (``metrics.py``): ``embedding_lookup_seconds``,
``embedding_unique_ratio``, ``embedding_prefetch_{hit,miss}_total``,
``embedding_evictions_total``, ``embedding_resident_rows``.

Not ported yet: the sharded table (``ShardedEmbeddingTable``, ROADMAP
queue 1 item 7) and the parameter-server tier's lookups (queue 1 item
8).
"""

from . import lookup, metrics  # noqa: F401
from .host import HostEmbeddingTable, HostLookupBinding  # noqa: F401
from .lookup import (  # noqa: F401
    HOST_LOOKUP_TYPES, SPARSE_LOOKUP_TYPES, find_host_lookup_ops,
    find_sparse_lookup_ops, is_sparse_lookup)

__all__ = [
    "HostEmbeddingTable", "register_host_table", "get_host_table",
    "has_host_table", "reset_tables", "prepare_feed", "prefetch",
    "find_sparse_lookup_ops", "find_host_lookup_ops", "is_sparse_lookup",
]

_HOST_TABLES = {}


def register_host_table(table):
    """Register a HostEmbeddingTable under its name (its constructor does
    this). ``layers.embedding`` routes a sparse lookup whose param name
    matches onto the host tier."""
    prev = _HOST_TABLES.get(table.name)
    if prev is not None and prev is not table:
        raise ValueError(
            "a host embedding table named %r is already registered — "
            "reset_tables() between model builds, or pick another name"
            % table.name)
    _HOST_TABLES[table.name] = table
    return table


def get_host_table(name):
    t = _HOST_TABLES.get(name)
    if t is None:
        raise KeyError(
            "no host embedding table registered under %r — construct a "
            "HostEmbeddingTable before building the program" % name)
    return t


def has_host_table(name):
    return name in _HOST_TABLES


def reset_tables():
    """Close (join any prefetch thread of) and forget every registered
    host table."""
    for t in list(_HOST_TABLES.values()):
        t.close()
    _HOST_TABLES.clear()


def prepare_feed(program, feed, scope, iters=1):
    """Executor hook: before a step (or an ``iters=k`` window) runs,
    every host-tier binding of ``program`` maps its raw-ids feed onto
    resident cache slots (admitting and evicting rows) and adds the
    ``<table>@SLOTS`` feed. A no-op for programs without bindings."""
    for b in getattr(program, "_embedding_bindings", ()):
        b.prepare(program, feed, scope, iters=iters)


def prefetch(program, next_feed):
    """Overlap hint: stage in the background the rows ``next_feed``'s
    batch will miss, for every host-tier binding of ``program``, while
    the current step computes."""
    for b in getattr(program, "_embedding_bindings", ()):
        b.prefetch(next_feed)


def host_ids_feeds(program):
    """The raw-ids feeds the host-tier bindings of ``program`` read on
    the host (a stager leaves them there)."""
    return frozenset(b.ids_name
                     for b in getattr(program, "_embedding_bindings", ()))
