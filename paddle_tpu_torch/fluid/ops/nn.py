"""NN ops: layer_norm, dropout, softmax, fused_multihead_attention and
its packed-layout form (counterparts in ``paddle_tpu/fluid/ops/nn.py``)."""

import torch

from ...kernels import attention as _attention
from ..registry import register, to_torch_dtype


@register("softmax")
def _softmax(ctx, op):
    ctx.set_output(op, "Out", torch.softmax(ctx.get_input(op, "X"),
                                            dim=op.attr("axis", -1)))


@register("layer_norm")
def _layer_norm(ctx, op):
    """Normalise over the dims from ``begin_norm_axis`` on, in fp32; Y in
    X's type. Mean and Variance are flattened to [-1] in their declared
    types (the variance is recovered from the reciprocal std torch keeps)."""
    x = ctx.get_input(op, "X")
    scale = ctx.get_input(op, "Scale")
    bias = ctx.get_input(op, "Bias")
    eps = op.attr("epsilon", 1e-5)
    norm_shape = tuple(x.shape[op.attr("begin_norm_axis", 1):])
    xf = x.float()
    out, mean, rstd = torch.native_layer_norm(
        xf, norm_shape,
        None if scale is None else scale.float().reshape(norm_shape),
        None if bias is None else bias.float().reshape(norm_shape), eps)
    ctx.set_output(op, "Y", out.to(x.dtype))
    for slot, val in (("Mean", mean), ("Variance", rstd.pow(-2) - eps)):
        names = op.output(slot)
        if names:
            ctx.set(names[0], val.reshape(-1).to(
                to_torch_dtype(ctx.var_dtype(names[0]))))


@register("dropout")
def _dropout(ctx, op):
    """Masks from 8-bit random words, as the reference draws them: kept
    where the word is below round((1-p) * 256); the train-time scale is
    corrected to the realised keep rate thresh / 256, so E[train out]
    equals the inference output exactly."""
    x = ctx.get_input(op, "X")
    p = op.attr("dropout_prob", 0.5)
    impl = op.attr("dropout_implementation", "downgrade_in_infer")
    keep = 1.0 - p
    thresh = min(max(int(round(keep * 256.0)), 0 if keep <= 0.0 else 1), 256)
    if op.attr("is_test", False):
        ctx.set_output(op, "Out",
                       x * keep if impl == "downgrade_in_infer" else x)
        return
    if thresh <= 0 or thresh >= 256:
        # a keep rate that rounds to 0 or 1: constant mask, but the op
        # still takes its draw, so later ops' draws do not shift
        ctx.next_seed()
        if thresh >= 256:
            full = x * keep if impl == "downgrade_in_infer" else x
        else:
            full = torch.zeros_like(x)
        ctx.set_output(op, "Out", full)
        ctx.set_output(op, "Mask", (torch.ones_like if thresh >= 256
                                    else torch.zeros_like)(x))
        return
    mask = (ctx.random_bytes(x.shape) < thresh).to(x.dtype)
    realized = thresh / 256.0
    scale = 1.0 / realized if impl == "upscale_in_train" else keep / realized
    ctx.set_output(op, "Out", x * (mask * scale))
    ctx.set_output(op, "Mask", mask)


@register("fused_multihead_attention")
def _fused_multihead_attention(ctx, op):
    """softmax(q·kᵀ·scale + bias)·v over [B, H, S, d] heads in one fused
    kernel family (``kernels/attention.py``); the dropout seed is drawn
    from the generator when the op trains with p > 0."""
    p = 0.0 if op.attr("is_test", False) else float(
        op.attr("dropout_prob", 0.0))
    seed = ctx.next_seed() if p > 0.0 else None
    ctx.set_output(op, "Out", _attention.fused_attention(
        ctx.get_input(op, "Q"), ctx.get_input(op, "K"),
        ctx.get_input(op, "V"), ctx.get_input(op, "Bias"),
        scale=op.attr("scale", None), dropout_prob=p, seed=seed))


@register("fused_multihead_attention_packed")
def _fused_multihead_attention_packed(ctx, op):
    """The packed-layout form: q, k, v [B, S, H*d] as the projections
    write them, heads read through their strides in the same kernels; the
    seed drawn as for ``fused_multihead_attention``."""
    p = 0.0 if op.attr("is_test", False) else float(
        op.attr("dropout_prob", 0.0))
    seed = ctx.next_seed() if p > 0.0 else None
    ctx.set_output(op, "Out", _attention.fused_attention_packed(
        ctx.get_input(op, "Q"), ctx.get_input(op, "K"),
        ctx.get_input(op, "V"), ctx.get_input(op, "Bias"),
        n_heads=int(op.attr("n_heads", 1)), scale=op.attr("scale", None),
        dropout_prob=p, seed=seed))
