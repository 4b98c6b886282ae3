"""Dense math ops: mul / matmul (plain ``torch.matmul``, as the JAX
package left its products to XLA; bf16 operands under AMP), scale,
sum, mean, the reduce family (sum, mean, max, min, prod, all, any),
cos_sim, arg_max (``ctc_greedy_decoder``'s), einsum, top_k, and
isfinite of dynamic loss scaling (counterparts in
``paddle_tpu/fluid/ops/math.py``)."""

import numpy as np
import torch

from ..registry import register


@register("mul")
def _mul(ctx, op):
    """Flatten x to 2-D at x_num_col_dims and y at y_num_col_dims, then
    matmul."""
    x = ctx.get_input(op, "X")
    y = ctx.get_input(op, "Y")
    xd = op.attr("x_num_col_dims", 1)
    yd = op.attr("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(int(np.prod(xs[:xd])), -1)
    y2 = y.reshape(int(np.prod(ys[:yd])), -1)
    x2, y2 = _promoted(ctx, x2, y2)
    ctx.set_output(op, "Out", torch.matmul(x2, y2).reshape(xs[:xd] + ys[yd:]))


def _promoted(ctx, x, y):
    """x and y in their promoted type where the executor promotes mixed
    products (``Executor(promote_products=True)``, which a Predictor under
    ``inference.Config.enable_bf16`` runs: an fp32 activation against a
    weight cast to bf16 at load runs in fp32, as jnp.matmul runs it).
    Elsewhere a mixed product raises, as torch.matmul does."""
    if x.dtype == y.dtype or not ctx.promote_products:
        return x, y
    t = torch.promote_types(x.dtype, y.dtype)
    return x.to(t), y.to(t)


@register("matmul")
def _matmul(ctx, op):
    x = ctx.get_input(op, "X")
    y = ctx.get_input(op, "Y")
    if x.dim() == 1:
        x = x.unsqueeze(0)
    if y.dim() == 1:
        y = y.unsqueeze(1)
    if op.attr("transpose_X", False):
        x = x.transpose(-1, -2)
    if op.attr("transpose_Y", False):
        y = y.transpose(-1, -2)
    out = torch.matmul(*_promoted(ctx, x, y))
    alpha = op.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    ctx.set_output(op, "Out", out)


@register("scale")
def _scale(ctx, op):
    x = ctx.get_input(op, "X")
    scale, bias = op.attr("scale", 1.0), op.attr("bias", 0.0)
    if op.attr("bias_after_scale", True):
        out = x * scale + bias
    else:
        out = (x + bias) * scale
    ctx.set_output(op, "Out", out.to(x.dtype))


@register("sum")
def _sum(ctx, op):
    xs = ctx.get_inputs(op, "X")
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    ctx.set_output(op, "Out", out)


@register("mean")
def _mean(ctx, op):
    """The mean of every element: a 0-d tensor, as jnp.mean gives."""
    ctx.set_output(op, "Out", torch.mean(ctx.get_input(op, "X")))


@register("top_k")
def _top_k(ctx, op):
    """The k largest along the last axis, largest first; int64 indices."""
    vals, idx = torch.topk(ctx.get_input(op, "X"), op.attr("k", 1), dim=-1)
    ctx.set_output(op, "Out", vals)
    ctx.set_output(op, "Indices", idx)


def _prod(x, dims, keepdim):
    """The product over ``dims`` (torch.prod takes one dim): the reduced
    dims moved last and flattened."""
    rest = [d for d in range(x.dim()) if d not in dims]
    out = x.permute(rest + list(dims)).reshape(
        [x.shape[d] for d in rest] + [-1]).prod(-1)
    if keepdim:
        for d in sorted(dims):
            out = out.unsqueeze(d)
    return out


# reduce_max / reduce_min take amax / amin, which share the gradient of
# equal maxima evenly, as JAX's max does (torch.max(dim=) gives it all
# to one index)
_REDUCERS = {
    "reduce_sum": lambda x, d, k: x.sum(dim=d, keepdim=k),
    "reduce_mean": lambda x, d, k: x.mean(dim=d, keepdim=k),
    "reduce_max": lambda x, d, k: x.amax(dim=d, keepdim=k),
    "reduce_min": lambda x, d, k: x.amin(dim=d, keepdim=k),
    "reduce_prod": _prod,
    "reduce_all": lambda x, d, k: x.bool().all(dim=d, keepdim=k),
    "reduce_any": lambda x, d, k: x.bool().any(dim=d, keepdim=k),
}


def _reduce(reducer):
    def lower(ctx, op):
        """Over ``dim`` (negative counts from the end), or every dim with
        ``reduce_all``; ``keep_dim`` keeps them as 1. No dims: X as it
        is."""
        x = ctx.get_input(op, "X")
        keep = op.attr("keep_dim", False)
        if op.attr("reduce_all", False):
            dims = tuple(range(x.dim()))
        else:
            dim = op.attr("dim", [0])
            dims = tuple(d if d >= 0 else d + x.dim()
                         for d in (dim if isinstance(dim, (list, tuple))
                                   else [dim]))
        ctx.set_output(op, "Out", reducer(x, dims, keep) if dims else x)
    return lower


for _name, _fn in _REDUCERS.items():
    register(_name)(_reduce(_fn))


@register("cos_sim")
def _cos_sim(ctx, op):
    """Row-wise cosine similarity [..., 1]: x . y / (|x| |y| + 1e-12), the
    reference's formula (``F.cosine_similarity`` clamps each norm
    instead)."""
    x = ctx.get_input(op, "X")
    y = ctx.get_input(op, "Y")
    xn = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), dim=-1, keepdim=True))
    ctx.set_output(op, "Out", torch.sum(x * y, dim=-1, keepdim=True)
                   / (xn * yn + 1e-12))


@register("arg_max")
def _arg_max(ctx, op):
    """int64 index of the first maximum along ``axis`` (the reference
    keeps no reduced dim)."""
    ctx.set_output(op, "Out", torch.argmax(ctx.get_input(op, "X"),
                                           dim=op.attr("axis", -1)))


@register("arg_min")
def _arg_min(ctx, op):
    """int64 index of the first minimum along ``axis``."""
    ctx.set_output(op, "Out", torch.argmin(ctx.get_input(op, "X"),
                                           dim=op.attr("axis", -1)))


@register("einsum")
def _einsum(ctx, op):
    ctx.set_output(op, "Out", torch.einsum(op.attr("equation"),
                                           *ctx.get_inputs(op, "Operands")))


@register("isfinite")
def _isfinite(ctx, op):
    """One bool: every element of X is finite."""
    ctx.set_output(op, "Out", torch.isfinite(ctx.get_input(op, "X")).all())


@register("clip")
def _clip(ctx, op):
    ctx.set_output(op, "Out", torch.clamp(ctx.get_input(op, "X"),
                                          op.attr("min"), op.attr("max")))


@register("clip_by_norm")
def _clip_by_norm(ctx, op):
    """X scaled to L2 norm ``max_norm`` where its norm is larger; a
    select on the device, no host sync."""
    x = ctx.get_input(op, "X")
    max_norm = op.attr("max_norm")
    norm = torch.sqrt(torch.sum(torch.square(x)))
    ctx.set_output(op, "Out", torch.where(norm > max_norm,
                                          x * (max_norm / norm), x))
