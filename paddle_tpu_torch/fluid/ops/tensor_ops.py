"""Shape/layout ops: reshape, transpose, unsqueeze, gather and the dense
lookup_table; cast (AMP) and the select ops of dynamic loss scaling:
assign, where, zeros_like (counterparts in
``paddle_tpu/fluid/ops/tensor_ops.py``)."""

import threading

import torch
import torch.nn.functional as F

from ..registry import register, to_torch_dtype


def _resolve_reshape(x, shape):
    # fluid: 0 copies the input's dim at that position
    return [x.shape[i] if int(s) == 0 else int(s) for i, s in enumerate(shape)]


@register("reshape")
def _reshape(ctx, op):
    x = ctx.get_input(op, "X")
    ctx.set_output(op, "Out", torch.reshape(
        x, _resolve_reshape(x, op.attr("shape"))))


@register("transpose")
def _transpose(ctx, op):
    ctx.set_output(op, "Out",
                   ctx.get_input(op, "X").permute(*op.attr("axis")))


@register("unsqueeze")
def _unsqueeze(ctx, op):
    out = ctx.get_input(op, "X")
    for a in sorted(op.attr("axes")):
        out = out.unsqueeze(a)
    ctx.set_output(op, "Out", out)


@register("gather")
def _gather(ctx, op):
    """Rows of X at Index (any shape): out [*Index.shape, *X.shape[1:]]."""
    x = ctx.get_input(op, "X")
    idx = ctx.get_input(op, "Index")
    ctx.set_output(op, "Out", x[idx.long()])


# held while _Embedding.backward has torch's deterministic flag set
_DETERMINISTIC_LOCK = threading.Lock()


class _Embedding(torch.autograd.Function):
    """``F.embedding`` whose weight gradient is the same at every run.
    PyTorch's default CUDA backward sums the rows of a repeated id in an
    order that changes from run to run (BERT's position and sentence
    embeddings, whose ids repeat in every batch row); under
    ``torch.use_deterministic_algorithms`` it takes a fixed order, at
    up to 0.2 ms more a call at config 3 (PERF.md §6). The
    flag is process-wide: it is set for this one call and restored,
    under a module lock, so two backwards on two threads cannot restore
    each other's saved value; an op another thread runs in that window
    runs deterministically too."""

    @staticmethod
    def forward(ctx, w, ids):
        ctx.save_for_backward(ids)
        ctx.rows = w.shape[0]
        return F.embedding(ids, w)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        with _DETERMINISTIC_LOCK:
            was = (torch.are_deterministic_algorithms_enabled(),
                   torch.is_deterministic_algorithms_warn_only_enabled())
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                dw = torch.ops.aten.embedding_dense_backward(
                    grad.contiguous(), ids, ctx.rows, -1, False)
            finally:
                torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        return dw, None


@register("lookup_table")
def _lookup_table(ctx, op):
    """Dense embedding lookup: a trailing Ids dim of 1 is squeezed, and
    rows at ``padding_idx`` read (and pass back) zeros; the weight's
    gradient is run-to-run reproducible (``_Embedding``)."""
    w = ctx.get_input(op, "W")
    ids = ctx.get_input(op, "Ids")
    if op.attr("is_sparse", False) or op.attr("is_distributed", False):
        raise NotImplementedError(
            "sparse and distributed lookup_table (SelectedRows gradients) "
            "are not ported yet")
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    ids = ids.long()
    out = _Embedding.apply(w, ids)
    padding_idx = op.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((ids == padding_idx).unsqueeze(-1), 0.0)
    ctx.set_output(op, "Out", out)


@register("cast")
def _cast(ctx, op):
    dtype = to_torch_dtype(op.attr("out_dtype", op.attr("dtype", "float32")))
    ctx.set_output(op, "Out", ctx.get_input(op, "X").to(dtype))


@register("assign")
def _assign(ctx, op):
    """Out binds X's tensor: no op writes a tensor in place except
    ``adam``, which writes only its own Param and moments."""
    ctx.set_output(op, "Out", ctx.get_input(op, "X"))


@register("where")
def _where(ctx, op):
    ctx.set_output(op, "Out", torch.where(ctx.get_input(op, "Condition"),
                                          ctx.get_input(op, "X"),
                                          ctx.get_input(op, "Y")))


@register("zeros_like")
def _zeros_like(ctx, op):
    ctx.set_output(op, "Out", torch.zeros_like(ctx.get_input(op, "X")))
