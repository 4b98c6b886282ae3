"""Losses (counterparts in ``paddle_tpu/fluid/ops/loss.py``):
cross_entropy over probabilities (hard labels with ``ignore_index``, or
soft labels; probabilities clipped at 1e-20 before the log),
softmax_with_cross_entropy (Loss [..., 1] and Softmax, hard labels with
``ignore_index`` or soft labels), sigmoid_cross_entropy_with_logits
(elementwise, in the reference's stable form) and square_error_cost
((x - y)^2 elementwise)."""

import torch
import torch.nn.functional as F

from ..registry import register


@register("cross_entropy")
def _cross_entropy(ctx, op):
    x = ctx.get_input(op, "X")
    label = ctx.get_input(op, "Label")
    if op.attr("soft_label", False):
        out = -(label * torch.log(x.clamp_min(1e-20))).sum(-1, keepdim=True)
    else:
        lab = label[..., 0] if label.dim() == x.dim() and \
            label.shape[-1] == 1 else label
        lab = lab.long()
        ignored = (lab == op.attr("ignore_index", -100)).unsqueeze(-1)
        # an ignored label picks column 0, whose loss is then zeroed
        p = torch.gather(x, -1, torch.where(ignored[..., 0], 0, lab)
                         .unsqueeze(-1))
        out = (-torch.log(p.clamp_min(1e-20))).masked_fill(ignored, 0.0)
    ctx.set_output(op, "Y", out)


@register("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(ctx, op):
    logits = ctx.get_input(op, "Logits")
    label = ctx.get_input(op, "Label")
    axis = op.attr("axis", -1)
    logp = F.log_softmax(logits, dim=axis)
    if op.attr("soft_label", False):
        loss = -(label * logp).sum(dim=axis, keepdim=True)
    else:
        ignore = op.attr("ignore_index", -100)
        lab = label
        if label.dim() == logits.dim() and label.shape[axis] == 1:
            lab = label.squeeze(axis)
        lab = lab.long()
        ignored = (lab == ignore).unsqueeze(-1)
        # an ignored label picks column 0, whose loss is then zeroed
        idx = torch.where(lab == ignore, 0, lab).unsqueeze(-1)
        src = logp
        if src.shape[:-1] != idx.shape[:-1]:
            # the reference's take_along_axis broadcasts the leading dims
            # (what its shape inference records for a logits var whose
            # rows it could not infer)
            lead = torch.broadcast_shapes(src.shape[:-1], idx.shape[:-1])
            src = src.expand(*lead, src.shape[-1])
            idx = idx.expand(*lead, 1)
        picked = torch.gather(src, axis, idx)
        loss = (-picked).masked_fill(ignored, 0.0)
    ctx.set_output(op, "Softmax", logp.exp())
    ctx.set_output(op, "Loss", loss)


@register("sigmoid_cross_entropy_with_logits")
def _sigmoid_cross_entropy_with_logits(ctx, op):
    """max(x, 0) - x * label + log(1 + exp(-|x|)); zero where the label
    is ``ignore_index``, divided by the count of the others when
    ``normalize``."""
    x = ctx.get_input(op, "X")
    label = ctx.get_input(op, "Label")
    loss = x.clamp_min(0.0) - x * label + F.softplus(-x.abs())
    keep = label != op.attr("ignore_index", -100)
    loss = torch.where(keep, loss, 0.0)
    if op.attr("normalize", False):
        loss = loss / keep.to(x.dtype).sum().clamp_min(1.0)
    ctx.set_output(op, "Out", loss)


@register("square_error_cost")
def _square_error_cost(ctx, op):
    ctx.set_output(op, "Out", torch.square(ctx.get_input(op, "X")
                                           - ctx.get_input(op, "Y")))
