"""Tensor creation: fill_constant, fill_constant_batch_size_like,
assign_value, range, uniform_random and gaussian_random
(counterparts in ``paddle_tpu/fluid/ops/creation.py``). The random ops
draw from the scope's generator (``LowerCtx.uniform`` / ``normal``)."""

import numpy as np
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


@register("assign_value")
def _assign_value(ctx, op):
    """The ``values`` attr (a flat list) in ``dtype``, shaped ``shape``."""
    ctx.set_output(op, "Out", torch.tensor(
        op.attr("values"), dtype=to_torch_dtype(op.attr("dtype", "float32")),
        device=ctx.device).reshape(_shape(op)))


def _static_bound(block, name):
    """The value of ``name`` where an ``assign_value`` or a
    ``fill_constant`` of ``block`` produces it, else None."""
    for o in block.ops:
        if name in o.output_arg_names():
            if o.type == "assign_value":
                return float(np.asarray(o.attr("values")).ravel()[0])
            if o.type == "fill_constant":
                return float(o.attr("value"))
    return None


@register("range")
def _range(ctx, op):
    """[start, end) by step. The length is static: the bounds are attrs,
    or Variables that an ``assign_value`` / ``fill_constant`` of the
    block produces (their build-time value), as in the reference; a
    bound computed at run time raises."""
    vals = []
    for slot, attr in (("Start", "start"), ("End", "end"), ("Step", "step")):
        v = op.attr(attr)
        if v is None:
            names = op.input(slot)
            v = _static_bound(ctx.block, names[0]) if names else None
            if v is None:
                raise NotImplementedError(
                    "range bounds must be python scalars or "
                    "assign_value/fill_constant Variables — a "
                    "runtime-variable bound cannot have a static shape")
        vals.append(v)
    ctx.set_output(op, "Out", torch.arange(
        *vals, dtype=to_torch_dtype(op.attr("dtype", "float32")),
        device=ctx.device))


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
