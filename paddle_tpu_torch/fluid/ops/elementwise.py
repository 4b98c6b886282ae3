"""Elementwise binary ops with fluid's axis broadcast (add, sub, mul,
div, min, max, pow), the comparisons (bool outputs, numpy broadcast),
logical_and, logical_or, logical_xor and logical_not (counterparts in
``paddle_tpu/fluid/ops/elementwise.py``)."""

import torch

from ..registry import register


def broadcast_y(x, y, axis):
    """fluid semantics: Y's dims align with X's starting at ``axis``
    (trailing size-1 dims of Y dropped); axis=-1 or equal ranks is
    numpy's right-aligned broadcast."""
    if axis is None or axis == -1 or x.dim() == y.dim():
        return y
    yshape = list(y.shape)
    while yshape and yshape[-1] == 1 and len(yshape) > 1:
        yshape.pop()
    new_shape = [1] * x.dim()
    for i, s in enumerate(yshape):
        new_shape[axis + i] = s
    return y.reshape(new_shape)


_FNS = {"elementwise_add": torch.add, "elementwise_sub": torch.sub,
        "elementwise_mul": torch.mul, "elementwise_div": torch.div,
        "elementwise_min": torch.minimum, "elementwise_max": torch.maximum,
        "elementwise_pow": torch.pow}


def _make(name):
    @register(name)
    def _lower(ctx, op):
        x = ctx.get_input(op, "X")
        y = broadcast_y(x, ctx.get_input(op, "Y"), op.attr("axis", -1))
        ctx.set_output(op, "Out", _FNS[name](x, y))


for _name in _FNS:
    _make(_name)


_COMPARE = {"less_than": torch.lt, "less_equal": torch.le,
            "greater_than": torch.gt, "greater_equal": torch.ge,
            "equal": torch.eq, "not_equal": torch.ne,
            "logical_and": torch.logical_and, "logical_or": torch.logical_or,
            "logical_xor": torch.logical_xor}


def _make_compare(name):
    @register(name)
    def _lower(ctx, op):
        ctx.set_output(op, "Out", _COMPARE[name](ctx.get_input(op, "X"),
                                                 ctx.get_input(op, "Y")))


for _name in _COMPARE:
    _make_compare(_name)


@register("logical_not")
def _logical_not(ctx, op):
    ctx.set_output(op, "Out", torch.logical_not(ctx.get_input(op, "X")))
