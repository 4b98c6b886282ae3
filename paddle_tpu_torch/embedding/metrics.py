"""Monitor series of the sparse embedding engine's host tier, under the
reference's names and help strings (``paddle_tpu/embedding/metrics.py``),
on the port's ``fluid/monitor.py``. Each carries a ``table`` label, so a
model with two tables is observable per table.
"""

from ..fluid import monitor

_HELP = {
    "embedding_lookup_seconds":
        "host-side lookup staging time per prepared batch (id validation, "
        "dedup, residency mapping, admission/eviction, H2D staging)",
    "embedding_unique_ratio":
        "unique ids / total ids of the last prepared batch",
    "embedding_prefetch_hit_total":
        "rows a background prefetch had already staged when the batch "
        "was prepared",
    "embedding_prefetch_miss_total":
        "rows fetched synchronously at prepare time (not prefetched)",
    "embedding_evictions_total":
        "resident rows evicted (LRU pressure or TTL expiry), written back "
        "to the host store",
    "embedding_resident_rows":
        "rows currently resident in the device cache",
}


def lookup_seconds(table):
    return monitor.histogram("embedding_lookup_seconds",
                             _HELP["embedding_lookup_seconds"],
                             labels={"table": table})


def unique_ratio(table):
    return monitor.gauge("embedding_unique_ratio",
                         _HELP["embedding_unique_ratio"],
                         labels={"table": table})


def prefetch_hit(table):
    return monitor.counter("embedding_prefetch_hit_total",
                           _HELP["embedding_prefetch_hit_total"],
                           labels={"table": table})


def prefetch_miss(table):
    return monitor.counter("embedding_prefetch_miss_total",
                           _HELP["embedding_prefetch_miss_total"],
                           labels={"table": table})


def evictions(table):
    return monitor.counter("embedding_evictions_total",
                           _HELP["embedding_evictions_total"],
                           labels={"table": table})


def resident_rows(table):
    return monitor.gauge("embedding_resident_rows",
                         _HELP["embedding_resident_rows"],
                         labels={"table": table})
