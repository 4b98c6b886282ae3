"""Composite network blocks (counterpart of ``paddle_tpu/fluid/nets.py``):
``simple_img_conv_pool``, ``img_conv_group`` (the VGG block),
``sequence_conv_pool`` (over LoD sequences), ``glu`` and
``scaled_dot_product_attention`` (matmuls and a softmax; no fused
attention kernel, as in the reference)."""

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool",
           "glu", "scaled_dot_product_attention"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=conv_stride, padding=conv_padding, dilation=conv_dilation,
        groups=conv_groups, param_attr=param_attr, bias_attr=bias_attr,
        act=act)
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding,
        global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """Convolutions (each with batch norm and dropout where asked), then
    one pool: a VGG stack. Per-convolution arguments may be lists."""
    tmp = input
    if isinstance(conv_num_filter, int):
        conv_num_filter = [conv_num_filter]

    def _expand(x):
        return x if isinstance(x, (list, tuple)) else \
            [x] * len(conv_num_filter)

    conv_padding = _expand(conv_padding)
    conv_filter_size = _expand(conv_filter_size)
    param_attr = _expand(param_attr)
    conv_with_batchnorm = _expand(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _expand(conv_batchnorm_drop_rate)
    for i, nf in enumerate(conv_num_filter):
        local_act = conv_act if not conv_with_batchnorm[i] else None
        tmp = layers.conv2d(
            input=tmp, num_filters=nf, filter_size=conv_filter_size[i],
            padding=conv_padding[i], param_attr=param_attr[i],
            act=local_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            if conv_batchnorm_drop_rate[i] > 0:
                tmp = layers.dropout(tmp, conv_batchnorm_drop_rate[i])
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max", bias_attr=None):
    """A ``sequence_conv`` over LoD sequences, then a ``sequence_pool``:
    one [n, num_filters] row a sequence."""
    conv_out = layers.sequence_conv(
        input=input, num_filters=num_filters, filter_size=filter_size,
        param_attr=param_attr, bias_attr=bias_attr, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    """Gated linear unit: ``input`` halved on ``dim``, a * sigmoid(b)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head softmax(q kᵀ / sqrt(d)) v over [B, T, D] tensors, as
    reshapes, transposes, two matmuls and a softmax."""
    if queries.shape[-1] != keys.shape[-1]:
        raise ValueError("queries and keys must share the last dim")
    d_key = int(keys.shape[-1]) // num_heads

    def _split_heads(x):
        if num_heads == 1:
            return x
        reshaped = layers.reshape(
            x, [0, 0, num_heads, int(x.shape[-1]) // num_heads])
        return layers.transpose(reshaped, [0, 2, 1, 3])

    def _merge_heads(x):
        if num_heads == 1:
            return x
        trans = layers.transpose(x, [0, 2, 1, 3])
        return layers.reshape(
            trans, [0, 0, int(trans.shape[2]) * int(trans.shape[3])])

    q, k, v = _split_heads(queries), _split_heads(keys), _split_heads(values)
    scaled_q = layers.scale(q, scale=d_key ** -0.5)
    product = layers.matmul(scaled_q, k, transpose_y=True)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    return _merge_heads(layers.matmul(weights, v))
