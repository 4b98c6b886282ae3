"""``embedding_lookup``, the sparse embedding engine's device tier, and
``host_embedding_lookup`` / ``host_embedding_init``, the host tier's
device half (the port's counterparts of
``paddle_tpu/fluid/ops/embedding_ops.py``).

The reference makes the batch's ids unique before it gathers, so that a
row-sharded table on the TPU gathers each row once. On one card the
unique costs more than it saves: two sorts of the 106,496 ids a DeepFM
step against a 4 MB gather (PERF.md §6). Its output equals a plain
gather to the bit, so the port gathers the ids as they are and keeps the
``dedup`` attr in the desc for parity only. An out-of-range id reads a
row of NaN, as the reference's ``jnp.take`` does, through a clamped
index and a select: no host check, no device assert.

The SelectedRows gradient: where the block's ``autodiff`` op lists this
lookup in ``sparse_wrt``, the output becomes an autograd leaf before the
``padding_idx`` mask (``sparse_leaf``), so the values of the gradient
are the cotangent of the lookup's output and the padded positions get
zeros; no dense [vocab, dim] gradient is built.

``host_embedding_lookup`` gathers from the fixed resident cache
``<table>@CACHE`` at the ``<table>@SLOTS`` feed the host table filled for
this batch (``embedding/host.py``), so the step never depends on the
vocabulary. Its gradient is the same SelectedRows pair, over cache slots
(the autodiff op's rows are the lookup's ``Ids``, the slots), so the lazy
row-sparse optimizers update only the touched cache rows. The raw ids
ride along for the ``padding_idx`` rule only. ``host_embedding_init``
sits in the startup program; the executor resets the table's residency
on the host when it meets the op, and its lowering does nothing.
"""

from ..registry import register
from .tensor_ops import _Embedding, pad_mask, sparse_leaf, squeeze_ids


@register("embedding_lookup")
def _embedding_lookup(ctx, op):
    w = ctx.get_input(op, "W")
    ids = squeeze_ids(ctx.get_input(op, "Ids"))
    out = sparse_leaf(ctx, op, _Embedding.apply(w, ids))
    ctx.set_output(op, "Out", pad_mask(op, ids, out))


@register("host_embedding_lookup")
def _host_embedding_lookup(ctx, op):
    w = ctx.get_input(op, "W")  # the resident cache, [budget + 1, dim]
    slots = squeeze_ids(ctx.get_input(op, "Ids"))
    out = sparse_leaf(ctx, op, _Embedding.apply(w, slots))
    if op.input("RawIds"):
        out = pad_mask(op, squeeze_ids(ctx.get_input(op, "RawIds")), out)
    ctx.set_output(op, "Out", out)


@register("host_embedding_init")
def _host_embedding_init(ctx, op):
    """A no-op here: the executor resets the table's residency on the
    host, synchronously, when a run's block holds this op."""
