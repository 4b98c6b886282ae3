"""Sequence layers (counterpart of
``paddle_tpu/fluid/layers/sequence_lod.py``). Each appends one sequence
op whose lowering does static-shape segment arithmetic over bounded-LoD
values (``fluid/ops/sequence_ops.py``; the design in ``fluid/lod.py``).
``sequence_mask`` is a dense op over lengths, which
``layers.rnn(sequence_length=)`` also uses."""

import numpy as np

from ..layer_helper import LayerHelper

__all__ = [
    "sequence_conv", "sequence_softmax", "sequence_pool", "sequence_concat",
    "sequence_first_step", "sequence_last_step", "sequence_slice",
    "sequence_expand", "sequence_expand_as", "sequence_pad", "sequence_unpad",
    "sequence_reshape", "sequence_scatter", "sequence_enumerate",
    "sequence_mask", "sequence_reverse", "sequence_erase",
]


def _out(helper, x, dtype=None, lod_level=1, shape=None):
    v = helper.create_variable_for_type_inference(dtype or x.dtype)
    v.lod_level = lod_level
    # static shapes are set here: the lowerings need an @LOD binding,
    # which shape inference on meta tensors does not have
    v.shape = tuple(shape) if shape is not None else \
        (-1,) + tuple(x.shape[1:] if len(x.shape) > 1 else ())
    return v


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, padding_start=None, bias_attr=None,
                  param_attr=None, act=None, name=None):
    helper = LayerHelper("sequence_conv", **locals())
    d = int(np.prod(input.shape[1:])) if len(input.shape) > 1 else 1
    filter_shape = [filter_size * d, num_filters]
    w = helper.create_parameter(param_attr, filter_shape, input.dtype)
    out = _out(helper, input, shape=(-1, num_filters))
    if padding_start is None:
        padding_start = -int(filter_size // 2)
    helper.append_op(
        type="sequence_conv",
        inputs={"X": [input], "Filter": [w]},
        outputs={"Out": [out]},
        attrs={"contextStart": int(padding_start),
               "contextLength": int(filter_size),
               "contextStride": int(filter_stride)})
    b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                is_bias=True)
    if b is not None:
        tmp = _out(helper, input, shape=(-1, num_filters))
        helper.append_op(type="elementwise_add",
                         inputs={"X": [out], "Y": [b]},
                         outputs={"Out": [tmp]}, attrs={"axis": -1})
        out = tmp
    return helper.append_activation(out, act)


def sequence_softmax(input, use_cudnn=False, name=None):
    helper = LayerHelper("sequence_softmax", **locals())
    out = _out(helper, input)
    helper.append_op(type="sequence_softmax", inputs={"X": [input]},
                     outputs={"Out": [out]})
    return out


def sequence_pool(input, pool_type, is_test=False, pad_value=0.0):
    helper = LayerHelper("sequence_pool", **locals())
    out = _out(helper, input, lod_level=0)
    max_index = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="sequence_pool",
        inputs={"X": [input]},
        outputs={"Out": [out], "MaxIndex": [max_index]},
        attrs={"pooltype": pool_type.upper(), "is_test": is_test,
               "pad_value": float(pad_value)})
    return out


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_last_step(input):
    return sequence_pool(input, "last")


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat", **locals())
    out = _out(helper, input[0])
    helper.append_op(type="sequence_concat",
                     inputs={"X": [x for x in input]},
                     outputs={"Out": [out]})
    return out


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper("sequence_slice", **locals())
    out = _out(helper, input)
    helper.append_op(
        type="sequence_slice",
        inputs={"X": [input], "Offset": [offset], "Length": [length]},
        outputs={"Out": [out]})
    return out


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper("sequence_expand", **locals())
    out = _out(helper, x)
    helper.append_op(type="sequence_expand", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"ref_level": int(ref_level)})
    return out


def sequence_expand_as(x, y, name=None):
    helper = LayerHelper("sequence_expand_as", **locals())
    out = _out(helper, x)
    helper.append_op(type="sequence_expand_as", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def sequence_pad(x, pad_value, maxlen=None, name=None):
    helper = LayerHelper("sequence_pad", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    length = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="sequence_pad",
        inputs={"X": [x], "PadValue": [pad_value]},
        outputs={"Out": [out], "Length": [length]},
        attrs={"padded_length": -1 if maxlen is None else int(maxlen)})
    return out, length


def sequence_unpad(x, length, name=None):
    helper = LayerHelper("sequence_unpad", **locals())
    out = _out(helper, x)
    helper.append_op(type="sequence_unpad",
                     inputs={"X": [x], "Length": [length]},
                     outputs={"Out": [out]})
    return out


def sequence_reshape(input, new_dim):
    helper = LayerHelper("sequence_reshape", **locals())
    out = _out(helper, input, shape=(-1, int(new_dim)))
    helper.append_op(type="sequence_reshape", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"new_dim": int(new_dim)})
    return out


def sequence_scatter(input, index, updates, name=None):
    helper = LayerHelper("sequence_scatter", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="sequence_scatter",
        inputs={"X": [input], "Ids": [index], "Updates": [updates]},
        outputs={"Out": [out]})
    return out


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    helper = LayerHelper("sequence_enumerate", **locals())
    out = _out(helper, input, dtype=input.dtype)
    helper.append_op(type="sequence_enumerate", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"win_size": int(win_size),
                            "pad_value": pad_value})
    return out


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """[n, maxlen] of ``dtype``: 1 below each row's length in ``x``.
    ``maxlen`` is an int (static, as a captured program needs) or a
    Variable (``MaxLenTensor``)."""
    helper = LayerHelper("sequence_mask", **locals())
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [x]}
    attrs = {"out_dtype": dtype}
    if maxlen is not None and hasattr(maxlen, "name"):
        inputs["MaxLenTensor"] = [maxlen]
        attrs["maxlen"] = -1
    else:
        attrs["maxlen"] = -1 if maxlen is None else int(maxlen)
    helper.append_op(type="sequence_mask", inputs=inputs,
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def sequence_reverse(x, name=None):
    helper = LayerHelper("sequence_reverse", **locals())
    out = _out(helper, x)
    helper.append_op(type="sequence_reverse", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def sequence_erase(x, tokens, name=None):
    helper = LayerHelper("sequence_erase", **locals())
    out = _out(helper, x)
    helper.append_op(type="sequence_erase", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"tokens": list(tokens)})
    return out
