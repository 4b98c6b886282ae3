"""NN layers (counterparts in ``paddle_tpu/fluid/layers/nn.py``): the
subset the BERT pretraining program emits. Each validates its arguments,
creates parameters through LayerHelper and appends its ops; the math is
in the op lowerings (``fluid/ops``)."""

import numpy as np

from .. import framework
from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = [
    "fc", "embedding", "layer_norm", "dropout", "fused_attention",
    "reshape", "transpose", "unsqueeze", "scale", "gather", "matmul",
    "reduce_sum", "elementwise_add", "elementwise_mul", "elementwise_div",
    "softmax", "einsum",
]


def _data_type(x):
    return framework.dtype_str(x.dtype)


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully connected: input flattened to 2-D at ``num_flatten_dims``,
    times an [in, size] weight, plus bias, then the activation."""
    helper = LayerHelper("fc", **locals())
    inputs = input if isinstance(input, (list, tuple)) else [input]
    if len(inputs) != 1:
        raise NotImplementedError("fc over several inputs (a sum op) is "
                                  "not ported yet")
    inp = inputs[0]
    in_features = int(np.prod(inp.shape[num_flatten_dims:]))
    w = helper.create_parameter(param_attr, [in_features, size],
                                _data_type(inp))
    pre_bias = helper.create_variable_for_type_inference(inp.dtype)
    helper.append_op(type="mul", inputs={"X": [inp], "Y": [w]},
                     outputs={"Out": [pre_bias]},
                     attrs={"x_num_col_dims": num_flatten_dims,
                            "y_num_col_dims": 1})
    pre_act = _append_bias(helper, pre_bias, bias_attr,
                           dim_start=num_flatten_dims)
    return helper.append_activation(pre_act, act)


def _append_bias(helper, x, bias_attr, dim_start=1):
    if bias_attr is False:
        return x
    bias_size = [int(np.prod(x.shape[dim_start:]))] if x.shape else [1]
    b = helper.create_parameter(bias_attr, bias_size, _data_type(x),
                                is_bias=True)
    if b is None:
        return x
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="elementwise_add", inputs={"X": [x], "Y": [b]},
                     outputs={"Out": [out]}, attrs={"axis": dim_start})
    return out


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """Dense embedding lookup. The sparse engine, host tables and the PS
    tier are not ported yet."""
    if is_sparse or is_distributed:
        raise NotImplementedError("sparse and distributed embeddings are "
                                  "not ported yet")
    helper = LayerHelper("embedding", **locals())
    w = helper.create_parameter(param_attr, size, dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="lookup_table", inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [out]},
        attrs={"is_sparse": is_sparse, "is_distributed": is_distributed,
               "padding_idx": -1 if padding_idx is None else padding_idx})
    return out


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


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_div", x, y, axis, act, name)


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
