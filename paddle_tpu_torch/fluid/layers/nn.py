"""NN layers (counterparts in ``paddle_tpu/fluid/layers/nn.py``): the
subset the BERT, LeNet, ResNet, DeepFM, seq2seq, word2vec and VGG
programs, the learning-rate schedules and the gradient clips emit. Each validates its arguments,
creates parameters through LayerHelper and appends its ops; the math is
in the op lowerings (``fluid/ops``)."""

import numpy as np

from .. import framework, unique_name
from ..initializer import Constant, Normal
from ..layer_helper import LayerHelper

__all__ = [
    "fc", "embedding", "conv2d", "pool2d", "batch_norm", "layer_norm",
    "dropout", "fused_attention", "fused_attention_packed", "reshape",
    "transpose", "unsqueeze",
    "scale", "gather", "matmul", "topk", "mean", "relu", "sign",
    "reduce_sum", "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_min", "elementwise_max",
    "elementwise_pow", "softmax", "einsum", "slice", "squeeze", "stack",
    "expand", "split", "sum", "logical_or", "clip",
    "clip_by_norm", "autoincreased_step_counter", "im2sequence", "row_conv",
    "one_hot", "reduce_mean", "reduce_max", "reduce_min", "reduce_prod",
    "reduce_all", "reduce_any", "linear_chain_crf", "crf_decoding",
    "ctc_greedy_decoder",
]


def _data_type(x):
    return framework.dtype_str(x.dtype)


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully connected: each input flattened to 2-D at
    ``num_flatten_dims`` times its own [in, size] weight, the products
    summed (a ``sum`` op), plus bias, then the activation."""
    helper = LayerHelper("fc", **locals())
    inputs = input if isinstance(input, (list, tuple)) else [input]
    mul_results = []
    for inp in inputs:
        in_features = int(np.prod(inp.shape[num_flatten_dims:]))
        w = helper.create_parameter(param_attr, [in_features, size],
                                    _data_type(inp))
        out = helper.create_variable_for_type_inference(inp.dtype)
        helper.append_op(type="mul", inputs={"X": [inp], "Y": [w]},
                         outputs={"Out": [out]},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        mul_results.append(out)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(
            inputs[0].dtype)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_act = _append_bias(helper, pre_bias, bias_attr,
                           dim_start=num_flatten_dims)
    return helper.append_activation(pre_act, act)


def _append_bias(helper, x, bias_attr, dim_start=1, channel_dim=None):
    """A bias over the dims from ``dim_start`` on, or over the one
    ``channel_dim`` (a convolution's channels)."""
    if bias_attr is False:
        return x
    if channel_dim is not None:
        bias_size = [x.shape[channel_dim]] \
            if x.shape and len(x.shape) > channel_dim else [1]
        axis = channel_dim
    else:
        bias_size = [int(np.prod(x.shape[dim_start:]))] if x.shape else [1]
        axis = dim_start
    b = helper.create_parameter(bias_attr, bias_size, _data_type(x),
                                is_bias=True)
    if b is None:
        return x
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="elementwise_add", inputs={"X": [x], "Y": [b]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32",
              table_lr=0.01, table_optimizer="sgd", residence=None):
    """Embedding lookup. ``is_sparse=True`` routes onto the sparse
    embedding engine's device tier: the ``embedding_lookup`` op (with
    the reference's ``dedup`` attr), whose gradient is a SelectedRows
    pair that the optimizer applies as a fused row-sparse update.
    ``residence`` picks the tier ("device" or "host"); by default a
    lookup whose param name has a registered ``HostEmbeddingTable`` goes
    to the host tier (the table in host memory behind a fixed device
    row cache). ``is_distributed=True``, the parameter-server tier, which
    ``table_lr`` and ``table_optimizer`` configure, is not ported yet."""
    helper = LayerHelper("embedding", **locals())
    if is_distributed:
        raise NotImplementedError(
            "embedding(is_distributed=True): the parameter-server tier is "
            "not ported yet (ROADMAP queue 8)")
    pname = (param_attr.name if param_attr is not None
             and getattr(param_attr, "name", None) else None)
    if residence not in (None, "device", "host"):
        raise ValueError(
            "embedding residence must be None, 'device' or 'host', got %r"
            % (residence,))
    if residence is None and pname is not None:
        from ... import embedding as _embedding

        if _embedding.has_host_table(pname):
            residence = "host"
    if residence == "host":
        if pname is None:
            raise ValueError(
                "residence='host' needs param_attr with a name matching a "
                "registered HostEmbeddingTable")
        from ... import embedding as _embedding
        from ...embedding.host import append_host_lookup

        return append_host_lookup(helper, input, size,
                                  _embedding.get_host_table(pname),
                                  padding_idx, dtype)
    w = helper.create_parameter(param_attr, size, dtype)
    out = helper.create_variable_for_type_inference(dtype)
    padding_idx = -1 if padding_idx is None else padding_idx
    if is_sparse:
        helper.append_op(
            type="embedding_lookup", inputs={"W": [w], "Ids": [input]},
            outputs={"Out": [out]},
            attrs={"is_sparse": True, "dedup": True,
                   "padding_idx": padding_idx})
        return out
    helper.append_op(
        type="lookup_table", inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [out]},
        attrs={"is_sparse": is_sparse, "is_distributed": is_distributed,
               "padding_idx": padding_idx})
    return out


def _pair_list(v):
    return [v, v] if isinstance(v, int) else list(v)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    """2-D convolution over NCHW or NHWC input with an OIHW filter drawn
    from Normal(0, sqrt(2 / fan_in)), plus a per-channel bias unless
    ``bias_attr=False``, then the activation."""
    helper = LayerHelper("conv2d", **locals())
    groups = groups or 1
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    num_channels = (input.shape[-1] if data_format == "NHWC"
                    else input.shape[1])
    filter_shape = [num_filters, num_channels // groups] + list(filter_size)
    fan = num_channels * filter_size[0] * filter_size[1] // groups
    w = helper.create_parameter(
        param_attr, filter_shape, _data_type(input),
        default_initializer=Normal(0.0, (2.0 / fan) ** 0.5))
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="conv2d", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": _pair_list(stride),
               "paddings": _pair_list(padding),
               "dilations": _pair_list(dilation), "groups": groups,
               "data_format": data_format})
    out = _append_bias(helper, out, bias_attr,
                       channel_dim=-1 if data_format == "NHWC" else 1)
    return helper.append_activation(out, act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True, adaptive=False,
           data_format="NCHW"):
    helper = LayerHelper("pool2d", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": _pair_list(pool_size),
               "strides": _pair_list(pool_stride),
               "paddings": _pair_list(pool_padding),
               "global_pooling": global_pooling, "ceil_mode": ceil_mode,
               "exclusive": exclusive, "adaptive": adaptive,
               "data_format": data_format})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=False,
               use_global_stats=False):
    """Batch norm over the channel axis (1 for NCHW, the last for NHWC):
    scale (1) and bias (0) parameters, and the running mean (0) and
    variance (1) as persistable, stop_gradient vars the op updates."""
    helper = LayerHelper("batch_norm", **locals())
    dtype = _data_type(input)
    ch = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(param_attr, [ch], dtype,
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(bias_attr, [ch], dtype, is_bias=True)
    mean = _create_persistable_stat(helper, moving_mean_name, [ch], dtype,
                                    0.0)
    var = _create_persistable_stat(helper, moving_variance_name, [ch],
                                   dtype, 1.0)
    out = helper.create_variable_for_type_inference(input.dtype)
    saved_mean = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [var]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [var],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(out, act)


def _create_persistable_stat(helper, name, shape, dtype, init_val):
    name = name or unique_name.generate(helper.name_prefix + ".stat")
    var = helper.main_program.global_block().create_var(
        name=name, shape=shape, dtype=dtype, persistable=True,
        stop_gradient=True)
    sb = helper.startup_program.global_block()
    sv = sb.create_var(name=name, shape=shape, dtype=dtype, persistable=True,
                       stop_gradient=True)
    Constant(init_val)(sv, sb)
    return var


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", **locals())
    dtype = _data_type(input)
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        inputs["Scale"] = [helper.create_parameter(
            param_attr, norm_shape, dtype, default_initializer=Constant(1.0))]
    if shift:
        inputs["Bias"] = [helper.create_parameter(bias_attr, norm_shape,
                                                  dtype, is_bias=True)]
    out = helper.create_variable_for_type_inference(input.dtype)
    mean = helper.create_variable_for_type_inference(dtype,
                                                     stop_gradient=True)
    var = helper.create_variable_for_type_inference(dtype,
                                                    stop_gradient=True)
    helper.append_op(type="layer_norm", inputs=inputs,
                     outputs={"Y": [out], "Mean": [mean],
                              "Variance": [var]},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out, act)


def _reduce_layer(op_type, input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper(op_type, **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is None:
        attrs = {"reduce_all": True, "dim": [0], "keep_dim": keep_dim}
    else:
        attrs = {"reduce_all": False,
                 "dim": dim if isinstance(dim, (list, tuple)) else [dim],
                 "keep_dim": keep_dim}
    helper.append_op(type=op_type, inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_mean", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_min", input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_prod", input, dim, keep_dim, name)


def reduce_all(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_all", input, dim, keep_dim, name)


def reduce_any(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_any", input, dim, keep_dim, name)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference(x.dtype,
                                                     stop_gradient=True)
    helper.append_op(
        type="dropout", inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "dropout_implementation": dropout_implementation})
    return out


def softmax(input, use_cudnn=False, name=None, axis=-1):
    helper = LayerHelper("softmax", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="softmax", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0,
           name=None):
    helper = LayerHelper("matmul", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="matmul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y,
                            "alpha": float(alpha)})
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", **locals())
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    return values, indices


def mean(x, name=None):
    helper = LayerHelper("mean", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def _unary_layer(op_type, x, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={})
    return out


def relu(x, name=None):
    return _unary_layer("relu", x, name)


def sign(x):
    return _unary_layer("sign", x)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="transpose", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": list(perm)})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False,
            name=None):
    helper = LayerHelper("reshape", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="reshape", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"shape": list(shape)})
    return helper.append_activation(out, act)


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="unsqueeze", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axes": list(axes)})
    return out


def gather(input, index, overwrite=True):
    helper = LayerHelper("gather", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="gather", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="scale", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out, act)


def _elementwise_layer(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return helper.append_activation(out, act)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_div", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_min", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_max", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_pow", x, y, axis, act, name)


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="squeeze", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axes": list(axes)})
    return out


def stack(x, axis=0):
    helper = LayerHelper("stack", **locals())
    x = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op(type="stack", inputs={"X": x}, outputs={"Y": [out]},
                     attrs={"axis": axis})
    return out


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="expand", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"expand_times": list(expand_times)})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    """``num_or_sections`` equal parts (an int) or parts of the listed
    sizes along ``dim``: a list of outputs."""
    helper = LayerHelper("split", **locals())
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "sections": [], "axis": dim}
    else:
        n = len(num_or_sections)
        attrs = {"num": 0, "sections": list(num_or_sections), "axis": dim}
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(n)]
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs}, attrs=attrs)
    return outs


def sum(x):
    helper = LayerHelper("sum", **locals())
    x = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op(type="sum", inputs={"X": x}, outputs={"Out": [out]})
    return out


def logical_or(x, y, out=None, name=None):
    helper = LayerHelper("logical_or", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="logical_or", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="clip", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"min": float(min), "max": float(max)})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="clip_by_norm", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"max_norm": float(max_norm)})
    return out


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable int64 [1] counter (``@STEP_COUNTER@`` unless named)
    that the startup program sets to ``begin - step`` and one
    ``increment`` op a run advances by ``step`` in place, so the first
    run reads ``begin``."""
    helper = LayerHelper("global_step_counter")
    name = counter_name or "@STEP_COUNTER@"
    counter = helper.main_program.global_block().create_var(
        name=name, shape=(1,), dtype="int64", persistable=True,
        stop_gradient=True)
    sb = helper.startup_program.global_block()
    sv = sb.create_var(name=name, shape=(1,), dtype="int64",
                       persistable=True)
    Constant(begin - step)(sv, sb)
    helper.append_op(type="increment", inputs={"X": [counter]},
                     outputs={"Out": [counter]}, attrs={"step": float(step)})
    counter.stop_gradient = True
    return counter


def fused_attention(q, k, v, attn_bias=None, scale=None, dropout_prob=0.0,
                    is_test=False, name=None):
    """softmax(q·kᵀ·scale + bias)·v over [B, H, S, d] heads as one
    ``fused_multihead_attention`` op: the fused CUDA kernels on the card
    (``kernels/attention.py``)."""
    helper = LayerHelper("fused_multihead_attention", **locals())
    out = helper.create_variable_for_type_inference(q.dtype)
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if attn_bias is not None:
        inputs["Bias"] = [attn_bias]
    attrs = {"dropout_prob": float(dropout_prob), "is_test": is_test}
    if scale is not None:
        attrs["scale"] = float(scale)
    helper.append_op(type="fused_multihead_attention", inputs=inputs,
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def fused_attention_packed(q, k, v, n_heads, attn_bias=None, scale=None,
                           dropout_prob=0.0, is_test=False, name=None):
    """Multi-head attention on packed [B, S, H*d] q, k, v, the layout the
    q/k/v projections write, as one ``fused_multihead_attention_packed``
    op: the fused CUDA kernels read the heads through their strides, so
    the program carries no head split or merge (``kernels/attention.py``).
    Returns [B, S, H*d]."""
    helper = LayerHelper("fused_multihead_attention_packed", **locals())
    out = helper.create_variable_for_type_inference(q.dtype)
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if attn_bias is not None:
        inputs["Bias"] = [attn_bias]
    attrs = {"dropout_prob": float(dropout_prob), "is_test": is_test,
             "n_heads": int(n_heads)}
    if scale is not None:
        attrs["scale"] = float(scale)
    helper.append_op(type="fused_multihead_attention_packed", inputs=inputs,
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def einsum(equation, *operands, name=None):
    helper = LayerHelper("einsum", name=name)
    out = helper.create_variable_for_type_inference(operands[0].dtype)
    helper.append_op(type="einsum", inputs={"Operands": list(operands)},
                     outputs={"Out": [out]}, attrs={"equation": equation})
    return out


def im2sequence(input, filter_size=1, stride=1, padding=0,
                input_image_size=None, out_stride=1, name=None):
    """Image [N, C, H, W] -> a LoD value of kernel patches, one sequence
    of output positions an image."""
    helper = LayerHelper("im2sequence", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="im2sequence", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"kernels": _pair_list(filter_size),
               "strides": _pair_list(stride),
               "paddings": [padding] * 4 if isinstance(padding, int)
               else list(padding)})
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    """Lookahead convolution over each sequence's next
    ``future_context_size`` rows."""
    helper = LayerHelper("row_conv", **locals())
    w = helper.create_parameter(
        param_attr, [future_context_size + 1, input.shape[-1]],
        _data_type(input))
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="row_conv", inputs={"X": [input], "Filter": [w]},
                     outputs={"Out": [out]})
    return helper.append_activation(out, act)


def one_hot(input, depth, allow_out_of_range=False):
    """float32 one-hot rows of ``depth`` (a trailing ids dim of 1 is
    dropped)."""
    helper = LayerHelper("one_hot", **locals())
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="one_hot", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"depth": depth})
    return out


def linear_chain_crf(input, label, param_attr=None, length=None):
    """The linear-chain CRF's log-likelihood [n, 1] of each LoD label
    sequence under the emissions ``input`` [rows, K]; the transition
    parameter [K + 2, K] holds the start and end weights in rows 0 and
    1."""
    helper = LayerHelper("linear_chain_crf", **locals())
    num_tags = int(input.shape[-1])
    trans = helper.create_parameter(param_attr, [num_tags + 2, num_tags],
                                    "float32")
    ll = helper.create_variable_for_type_inference("float32")
    alpha = helper.create_variable_for_type_inference("float32")
    eexp = helper.create_variable_for_type_inference("float32")
    texp = helper.create_variable_for_type_inference("float32")
    ll.shape = (-1, 1)
    helper.append_op(
        type="linear_chain_crf",
        inputs={"Emission": [input], "Transition": [trans],
                "Label": [label]},
        outputs={"LogLikelihood": [ll], "Alpha": [alpha],
                 "EmissionExps": [eexp], "TransitionExps": [texp]})
    return ll


def crf_decoding(input, param_attr, label=None, length=None):
    """The Viterbi tag path [rows, 1] (int64, the input's lengths) under
    the transition parameter ``param_attr`` names (one a
    ``linear_chain_crf`` trained). A program without that parameter (a
    standalone decode program) declares it, so it resolves from the
    scope."""
    helper = LayerHelper("crf_decoding", **locals())
    name = param_attr.name if hasattr(param_attr, "name") else str(param_attr)
    block = helper.main_program.global_block()
    if block._find_var_recursive(name) is not None:
        trans = block.var(name)
    else:
        num_tags = int(input.shape[-1])
        trans = helper.create_parameter(param_attr,
                                        [num_tags + 2, num_tags], "float32")
    path = helper.create_variable_for_type_inference("int64")
    path.shape = (-1, 1)
    path.lod_level = 1
    helper.append_op(
        type="crf_decoding",
        inputs={"Emission": [input], "Transition": [trans]},
        outputs={"ViterbiPath": [path]})
    return path


def ctc_greedy_decoder(input, blank, name=None):
    """Greedy CTC decode of LoD class scores: each step's argmax, repeats
    collapsed, blanks dropped (``arg_max`` + ``ctc_align``)."""
    helper = LayerHelper("ctc_greedy_decoder", **locals())
    idx = helper.create_variable_for_type_inference("int64")
    idx.shape = (-1, 1)
    idx.lod_level = 1
    helper.append_op(type="arg_max", inputs={"X": [input]},
                     outputs={"Out": [idx]},
                     attrs={"axis": -1, "keepdims": True})
    out = helper.create_variable_for_type_inference("int64")
    out.shape = (-1, 1)
    out.lod_level = 1
    helper.append_op(type="ctc_align", inputs={"Input": [idx]},
                     outputs={"Output": [out]},
                     attrs={"blank": int(blank)})
    return out
