"""Activations (counterpart in ``paddle_tpu/fluid/ops/activations.py``):
gelu, the exact erf form unless ``approximate``; relu; sigmoid; tanh;
sign (for ``L1Decay``); and exp, floor, ceil, cos, sqrt and square (the
learning-rate schedules and the gradient clips)."""

import torch
import torch.nn.functional as F

from ..registry import register


@register("gelu")
def _gelu(ctx, op):
    approximate = bool(op.attr("approximate", False))
    ctx.set_output(op, "Out", F.gelu(ctx.get_input(op, "X"),
                                     approximate="tanh" if approximate
                                     else "none"))


@register("relu")
def _relu(ctx, op):
    ctx.set_output(op, "Out", F.relu(ctx.get_input(op, "X")))


@register("sigmoid")
def _sigmoid(ctx, op):
    ctx.set_output(op, "Out", torch.sigmoid(ctx.get_input(op, "X")))


@register("tanh")
def _tanh(ctx, op):
    ctx.set_output(op, "Out", torch.tanh(ctx.get_input(op, "X")))


@register("sign")
def _sign(ctx, op):
    ctx.set_output(op, "Out", torch.sign(ctx.get_input(op, "X")))


_UNARY = {"exp": torch.exp, "floor": torch.floor, "ceil": torch.ceil,
          "cos": torch.cos, "sqrt": torch.sqrt, "square": torch.square}


def _make_unary(name):
    @register(name)
    def _lower(ctx, op):
        ctx.set_output(op, "Out", _UNARY[name](ctx.get_input(op, "X")))


for _name in _UNARY:
    _make_unary(_name)
