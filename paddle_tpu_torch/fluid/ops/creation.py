"""Tensor creation: fill_constant, fill_constant_batch_size_like,
uniform_random and gaussian_random
(counterparts in ``paddle_tpu/fluid/ops/creation.py``). The random ops
draw from the scope's generator (``LowerCtx.uniform`` / ``normal``)."""

import torch

from ..registry import register, to_torch_dtype


def _shape(op):
    return tuple(int(s) for s in op.attr("shape"))


@register("fill_constant")
def _fill_constant(ctx, op):
    ctx.set_output(op, "Out", torch.full(
        _shape(op), op.attr("value", 0.0),
        dtype=to_torch_dtype(op.attr("dtype", "float32")),
        device=ctx.device))


@register("fill_constant_batch_size_like")
def _fill_constant_batch_size_like(ctx, op):
    """fill_constant whose dim ``output_dim_idx`` takes Input's dim
    ``input_dim_idx`` (the batch)."""
    ref = ctx.get_input(op, "Input")
    shape = list(_shape(op))
    shape[op.attr("output_dim_idx", 0)] = ref.shape[
        op.attr("input_dim_idx", 0)]
    ctx.set_output(op, "Out", torch.full(
        shape, op.attr("value", 0.0),
        dtype=to_torch_dtype(op.attr("dtype", "float32")),
        device=ref.device))


@register("uniform_random")
def _uniform_random(ctx, op):
    out = ctx.uniform(_shape(op), op.attr("min", -1.0), op.attr("max", 1.0))
    ctx.set_output(op, "Out", out.to(to_torch_dtype(op.attr("dtype",
                                                            "float32"))))


@register("gaussian_random")
def _gaussian_random(ctx, op):
    out = ctx.normal(_shape(op), op.attr("mean", 0.0), op.attr("std", 1.0))
    ctx.set_output(op, "Out", out.to(to_torch_dtype(op.attr("dtype",
                                                            "float32"))))
