"""``embedding_lookup``, the sparse embedding engine's device tier (the
port's counterpart of ``paddle_tpu/fluid/ops/embedding_ops.py``).

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
"""

from ..registry import register
from .tensor_ops import _Embedding, pad_mask, sparse_leaf, squeeze_ids


@register("embedding_lookup")
def _embedding_lookup(ctx, op):
    w = ctx.get_input(op, "W")
    ids = squeeze_ids(ctx.get_input(op, "Ids"))
    out = sparse_leaf(ctx, op, _Embedding.apply(w, ids))
    ctx.set_output(op, "Out", pad_mask(op, ids, out))
