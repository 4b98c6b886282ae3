"""Program introspection for sparse-lookup ops (the port's copy of
``paddle_tpu/embedding/lookup.py``): anything that wants "the sparse
lookups of this program" (backward, tooling) asks this module instead of
matching op types itself."""

# Op types whose backward is a SelectedRows (rows, values) pair on a device
# parameter ("W" input). lookup_table only qualifies with is_sparse=True.
SPARSE_LOOKUP_TYPES = ("embedding_lookup", "host_embedding_lookup",
                       "lookup_table", "lookup_table_v2")

# Host-resident lookup op types: the table (or its resident cache) is
# managed by a host-side store rather than being a plain dense parameter.
HOST_LOOKUP_TYPES = ("host_embedding_lookup", "distributed_lookup_table")


def is_sparse_lookup(op):
    """True when ``op`` is an embedding lookup whose W-grad is sparse."""
    if op.type in ("embedding_lookup", "host_embedding_lookup"):
        return op.attr("is_sparse", True)
    if op.type in ("lookup_table", "lookup_table_v2"):
        return op.attr("is_sparse", False)
    return False


def find_sparse_lookup_ops(program):
    """Every sparse-lookup op in the global block (engine + legacy types)."""
    return [op for op in program.global_block().ops if is_sparse_lookup(op)]


def find_host_lookup_ops(program):
    """Every host-resident lookup op (engine host tier + legacy PS shim)."""
    return [op for op in program.global_block().ops
            if op.type in HOST_LOOKUP_TYPES]
