"""softmax_with_cross_entropy (counterpart in
``paddle_tpu/fluid/ops/loss.py``): Loss [..., 1] and Softmax, hard
labels with ``ignore_index`` or soft labels."""

import torch
import torch.nn.functional as F

from ..registry import register


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
        picked = torch.gather(logp, axis,
                              torch.where(lab == ignore, 0, lab)
                              .unsqueeze(-1))
        loss = (-picked).masked_fill(ignored, 0.0)
    ctx.set_output(op, "Softmax", logp.exp())
    ctx.set_output(op, "Loss", loss)
