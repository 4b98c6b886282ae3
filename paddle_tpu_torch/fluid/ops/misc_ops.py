"""LoD rebinding ops (counterpart of the first part of
``paddle_tpu/fluid/ops/misc_ops.py``): ``lod_reset`` and ``lod_append``
pass X through and bind new ``@LOD`` lengths to the output.

A target known on the host (another value's LoD, or an attribute's
offsets) brings its time bound along: the LoD's own, or
``lod.length_bound`` of the attribute's longest length. A target given
as Y's int values (offsets) lives on the device, so its bound falls
back to the row count, the reference's own flat bound, and nothing is
read on the host inside a step. The attribute's lengths are built on
the device with fills, not copied from the host, so a step of these
ops captures into a CUDA graph.
"""

import torch

from ..lod import bound_name, length_bound, lod_name
from ..registry import register
from .sequence_ops import _set_lod


def _host_lengths(ctx, op, x, offsets):
    """Bind the lengths of host ``offsets`` and their time bound to
    ``op``'s output."""
    lengths = [int(b) - int(a) for a, b in zip(offsets[:-1], offsets[1:])]
    dev = torch.stack([torch.full((), v, dtype=torch.int32, device=x.device)
                       for v in lengths]) if lengths else torch.zeros(
                           0, dtype=torch.int32, device=x.device)
    _set_lod(ctx, op, "Out", dev,
             length_bound(max(lengths, default=0), x.shape[0]))


@register("lod_reset")
def _lod_reset(ctx, op):
    """X with the lengths of Y's LoD, of Y's int offsets, or of the
    ``target_lod`` offsets."""
    x = ctx.get_input(op, "X")
    ctx.set_output(op, "Out", x)
    y_names = op.input("Y")
    if not y_names:
        _host_lengths(ctx, op, x, op.attr("target_lod", []))
        return
    y = y_names[0]
    if lod_name(y) in ctx.env:
        _set_lod(ctx, op, "Out", ctx.env[lod_name(y)],
                 ctx.env.get(bound_name(y)))
        return
    offs = ctx.get(y).reshape(-1).to(torch.int32)
    _set_lod(ctx, op, "Out", offs[1:] - offs[:-1])


@register("lod_append")
def _lod_append(ctx, op):
    """X with a deeper level's lengths (the ``level`` offsets). Only the
    innermost level rides the device, so the new level replaces the
    lengths, as in the reference."""
    x = ctx.get_input(op, "X")
    ctx.set_output(op, "Out", x)
    _host_lengths(ctx, op, x, op.attr("level", []))
