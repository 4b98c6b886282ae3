"""Shape/layout ops: reshape, transpose, unsqueeze, gather and the dense
lookup_table; cast (AMP) and the select ops of dynamic loss scaling:
assign, where, zeros_like (counterparts in
``paddle_tpu/fluid/ops/tensor_ops.py``)."""

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


@register("lookup_table")
def _lookup_table(ctx, op):
    """Dense embedding lookup: a trailing Ids dim of 1 is squeezed, and
    rows at ``padding_idx`` read (and pass back) zeros."""
    w = ctx.get_input(op, "W")
    ids = ctx.get_input(op, "Ids")
    if op.attr("is_sparse", False) or op.attr("is_distributed", False):
        raise NotImplementedError(
            "sparse and distributed lookup_table (SelectedRows gradients) "
            "are not ported yet")
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    ids = ids.long()
    out = F.embedding(ids, w)
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
