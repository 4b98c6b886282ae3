"""NN ops: conv2d, pool2d, batch_norm, layer_norm, dropout, softmax,
fused_multihead_attention and its packed-layout form (counterparts in
``paddle_tpu/fluid/ops/nn.py``).

The reference has no Pallas kernel for convolutions, pooling or batch
norm, so these lower to torch's own calls (cuDNN and ATen's kernels on
the card). ``data_format="NHWC"`` takes ``x.permute(0, 3, 1, 2)``: that
view of NHWC memory is a channels-last NCHW tensor, so the card runs
its NHWC kernels on it with no copy, and the output is permuted back.
The program's entry ``transpose`` to NHWC is a view of the NCHW feed,
so the first convolution lays its input out channels-last once; every
later activation is NHWC in memory (cuDNN's and ATen's kernels keep
their input's memory format).
"""

import contextlib
import threading

import torch
import torch.nn.functional as F

from ...kernels import attention as _attention
from ..registry import register, to_torch_dtype


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


# held while a convolution's backward has cuDNN's deterministic flag set
_CUDNN_LOCK = threading.Lock()


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN restricted to deterministic algorithms for the block. The
    flag is process-wide: it is set and restored under a module lock, so
    two backwards on two threads cannot restore each other's saved
    value; a convolution another thread runs in that window runs
    deterministically too."""
    with _CUDNN_LOCK:
        was = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            yield
        finally:
            torch.backends.cudnn.deterministic = was


class _Conv2d(torch.autograd.Function):
    """``F.conv2d`` whose gradients are the same at every run: cuDNN's
    default weight-gradient and data-gradient algorithms may sum in an
    order that changes from run to run, so the backward runs under
    ``_deterministic_cudnn`` (what that costs: PERF.md §6). The forward
    and the input's memory format are cuDNN's usual ones."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups)
        return F.conv2d(x, w, None, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        with _deterministic_cudnn():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                grad, x, w, None, stride, padding, dilation, False, [0, 0],
                groups, [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                         False])
        return dx, dw, None, None, None, None


@register("conv2d")
@register("depthwise_conv2d")
def _conv2d(ctx, op):
    """Input NCHW or NHWC (``data_format``), Filter OIHW either way;
    ``depthwise_conv2d`` takes one group per input channel."""
    x = ctx.get_input(op, "Input")
    w = ctx.get_input(op, "Filter")
    nhwc = op.attr("data_format", "NCHW") == "NHWC"
    if nhwc:
        # laid out once where an NHWC tensor is a view of NCHW memory
        # (the program's entry transpose, a view in the port); every
        # later one is channels-last already and passes as it is
        x = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
    groups = x.shape[1] if op.type == "depthwise_conv2d" else \
        (op.attr("groups", 1) or 1)
    out = _Conv2d.apply(x, w, _pair(op.attr("strides", [1, 1])),
                        _pair(op.attr("paddings", [0, 0])),
                        _pair(op.attr("dilations", [1, 1])), groups)
    ctx.set_output(op, "Output", out.permute(0, 2, 3, 1) if nhwc else out)


def _torch_windows(size, k, s, p, ceil_mode):
    """Whether torch's pooling gives the reference's windows along one
    axis: torch pads at most half a window, and in ceil mode drops a
    last window that starts in the padding, which the reference keeps."""
    if 2 * p > k:
        return False
    n = (size + 2 * p + (s - 1 if ceil_mode else 0) - k) // s + 1
    return not ceil_mode or (n - 1) * s < size + p


def _pool(x, pooling_type, ksize, strides, pads, ceil_mode, exclusive,
          global_pool, adaptive):
    """The reference's pooling on an NCHW tensor (or channels-last
    view): windows over the input padded by ``pads`` on both sides, and
    by ``stride - 1`` more on the high side in ceil mode; max over -inf
    padding; avg divides by the in-window count of input elements when
    ``exclusive or ceil_mode``, else by the window's size."""
    h, w = x.shape[2], x.shape[3]
    if global_pool:
        ksize, strides, pads = (h, w), (1, 1), (0, 0)
    if adaptive:
        oh, ow = ksize
        if h % oh or w % ow:
            raise ValueError("adaptive pool needs divisible dims, got %s "
                             "into %s" % ((h, w), (oh, ow)))
        ksize = strides = (h // oh, w // ow)
        pads = (0, 0)
    by_count = exclusive or ceil_mode
    if all(_torch_windows(n, k, s, p, ceil_mode) for n, k, s, p in
           zip((h, w), ksize, strides, pads)):
        if pooling_type == "max":
            return F.max_pool2d(x, ksize, strides, pads, ceil_mode=ceil_mode)
        return F.avg_pool2d(x, ksize, strides, pads, ceil_mode=ceil_mode,
                            count_include_pad=not by_count)
    extra = [s - 1 if ceil_mode else 0 for s in strides]
    pad = (pads[1], pads[1] + extra[1], pads[0], pads[0] + extra[0])
    if pooling_type == "max":
        return F.max_pool2d(F.pad(x, pad, value=float("-inf")), ksize,
                            strides)
    summed = F.avg_pool2d(F.pad(x, pad), ksize, strides, divisor_override=1)
    if by_count:
        ones = torch.ones((1, 1, h, w), dtype=x.dtype, device=x.device)
        return summed / F.avg_pool2d(F.pad(ones, pad), ksize, strides,
                                     divisor_override=1)
    return summed / (ksize[0] * ksize[1])


@register("pool2d")
def _pool2d(ctx, op):
    x = ctx.get_input(op, "X")
    nhwc = op.attr("data_format", "NCHW") == "NHWC"
    out = _pool(x.permute(0, 3, 1, 2) if nhwc else x,
                op.attr("pooling_type", "max"),
                _pair(op.attr("ksize", [2, 2])),
                _pair(op.attr("strides", [1, 1])),
                _pair(op.attr("paddings", [0, 0])),
                op.attr("ceil_mode", False), op.attr("exclusive", True),
                op.attr("global_pooling", False), op.attr("adaptive", False))
    ctx.set_output(op, "Out", out.permute(0, 2, 3, 1) if nhwc else out)


@register("batch_norm")
def _batch_norm(ctx, op):
    """ATen's batch norm (``native_batch_norm``: statistics and the
    normalisation in fp32 whatever X's type, Y in X's type; autograd
    keeps X and the two statistics, no fp32 copy of a bf16 X).

    Training: the batch's mean and ``invstd = 1/sqrt(var + eps)`` come
    from the op itself; ``SavedMean`` and ``SavedVariance`` are those two
    (the reference's SavedVariance is invstd too), and the running
    statistics move toward the BIASED batch variance ``invstd^-2 - eps``
    (torch's own running update would take the unbiased one), written
    detached in their declared types. In fp32 that recovery is within a
    few ulp of ``var + eps``, far inside the 1e-5 the op is held to
    while the variance is not far below eps. ``is_test`` or
    ``use_global_stats``: normalise with the running statistics, which
    stay as they are."""
    x = ctx.get_input(op, "X")
    scale = ctx.get_input(op, "Scale")
    bias = ctx.get_input(op, "Bias")
    mean = ctx.get_input(op, "Mean")
    var = ctx.get_input(op, "Variance")
    eps = op.attr("epsilon", 1e-5)
    momentum = op.attr("momentum", 0.9)
    nhwc = op.attr("data_layout", "NCHW") == "NHWC"
    xin = x.movedim(-1, 1) if nhwc else x
    if op.attr("is_test", False) or op.attr("use_global_stats", False):
        y = torch.ops.aten.native_batch_norm(xin, scale, bias, mean, var,
                                             False, 0.0, eps)[0]
    else:
        y, use_mean, invstd = torch.ops.aten.native_batch_norm(
            xin, scale, bias, None, None, True, 0.0, eps)
        use_mean, invstd = use_mean.detach(), invstd.detach()
        use_var = invstd.pow(-2) - eps
        for slot, new, old in (
                ("MeanOut", momentum * mean + (1.0 - momentum) * use_mean,
                 mean),
                ("VarianceOut", momentum * var + (1.0 - momentum) * use_var,
                 var)):
            names = op.output(slot)
            if names:
                ctx.set(names[0], new.detach().to(old.dtype))
        ctx.set_output(op, "SavedMean", use_mean.to(mean.dtype))
        ctx.set_output(op, "SavedVariance", invstd.to(mean.dtype))
    ctx.set_output(op, "Y", y.movedim(1, -1) if nhwc else y)


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
