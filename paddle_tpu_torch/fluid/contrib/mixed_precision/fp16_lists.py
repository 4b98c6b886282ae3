"""AMP op lists: which ops run in low precision, which stay fp32 and
which follow their inputs (the port's copy of
``paddle_tpu/fluid/contrib/mixed_precision/fp16_lists.py``; the lists
are the reference's, so both packages rewrite a program alike).

On the H100, white ops take bf16 operands: ``mul``/``matmul`` run as
bf16 ``torch.matmul``, ``fused_multihead_attention`` reads bf16 q, k, v
(and bias) in its kernels. ``layer_norm`` and ``batch_norm`` are gray,
as in the reference: their lowerings normalise in fp32 whatever the
activation type.
"""

__all__ = ["AutoMixedPrecisionLists"]

white_list = {
    "conv2d", "conv3d", "depthwise_conv2d", "conv2d_transpose",
    "conv3d_transpose", "matmul", "mul", "bmm",
    "fused_multihead_attention",
    "fused_multihead_attention_packed",
}

black_list = {
    "exp", "log", "square", "softmax", "log_softmax", "mean", "sum",
    "reduce_sum", "reduce_mean", "cos_sim", "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits", "cross_entropy",
    "group_norm", "instance_norm", "l2_normalize",
}

gray_list = {
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min", "relu", "gelu",
    "tanh", "sigmoid", "dropout", "pool2d", "pool3d", "reshape", "transpose",
    "concat", "split", "slice", "flatten", "squeeze", "unsqueeze", "stack",
    "scale", "cast", "pad", "gather", "lookup_table", "lookup_table_v2",
    "batch_norm", "layer_norm",
}


class AutoMixedPrecisionLists:
    """User-tunable white/black lists."""

    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None):
        self.white_list = set(white_list)
        self.black_list = set(black_list)
        self.gray_list = set(gray_list)
        self.black_varnames = set(custom_black_varnames or [])
        for t in custom_white_list or []:
            self.black_list.discard(t)
            self.white_list.add(t)
        for t in custom_black_list or []:
            self.white_list.discard(t)
            self.black_list.add(t)
