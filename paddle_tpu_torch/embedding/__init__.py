"""paddle_tpu_torch.embedding: the sparse embedding engine's device tier
(the port's counterpart of ``paddle_tpu.embedding``).

``fluid.layers.embedding(is_sparse=True)`` appends the device tier's
``embedding_lookup`` op (``fluid/ops/embedding_ops.py``): a gather
whose backward is a SelectedRows (rows, values) pair, which the
optimizer ops apply as fused row-sparse updates without building a
dense [vocab, dim] gradient.

Not ported yet: the host tier (``HostEmbeddingTable``, host-resident
tables behind a device row cache, prefetch; ROADMAP queue 4, "the host
embedding tier") and the sharded table (queue 7). No host table can be
registered, so ``has_host_table`` answers False.
"""

from . import lookup  # noqa: F401
from .lookup import (  # noqa: F401
    HOST_LOOKUP_TYPES, SPARSE_LOOKUP_TYPES, find_host_lookup_ops,
    find_sparse_lookup_ops, is_sparse_lookup)

__all__ = ["HostEmbeddingTable", "register_host_table", "has_host_table",
           "find_sparse_lookup_ops", "find_host_lookup_ops",
           "is_sparse_lookup"]

HOST_TIER_ITEM = "ROADMAP queue 4, the host embedding tier"


def _host_tier_missing(what):
    return NotImplementedError(
        "%s: the host embedding tier is not ported yet (%s)"
        % (what, HOST_TIER_ITEM))


class HostEmbeddingTable:
    """A host-resident table behind a device row cache: not ported.
    The reference's constructor registers the table; here it raises."""

    def __init__(self, *args, **kwargs):
        raise _host_tier_missing("HostEmbeddingTable")


def register_host_table(table):
    """Register a host table under its name: raises, as the port has no
    host tier."""
    raise _host_tier_missing("register_host_table(%r)"
                             % getattr(table, "name", table))


def has_host_table(name):
    """Whether a host table is registered under ``name``: never, in the
    port."""
    return False
