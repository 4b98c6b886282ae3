"""Activations (counterpart in ``paddle_tpu/fluid/ops/activations.py``):
gelu, the exact erf form unless ``approximate``."""

import torch.nn.functional as F

from ..registry import register


@register("gelu")
def _gelu(ctx, op):
    approximate = bool(op.attr("approximate", False))
    ctx.set_output(op, "Out", F.gelu(ctx.get_input(op, "X"),
                                     approximate="tanh" if approximate
                                     else "none"))
