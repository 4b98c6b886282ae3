"""Tensor layers (counterparts in ``paddle_tpu/fluid/layers/tensor.py``)."""

import numpy as np

from .. import framework
from ..framework import Variable
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["create_parameter", "fill_constant",
           "fill_constant_batch_size_like", "cast", "concat", "assign",
           "argmin", "argmax", "range", "tensor_array_to_tensor"]


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter", **locals())
    attr = ParamAttr._to_attr(attr)
    if name:
        attr.name = name
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="fill_constant", outputs={"Out": [out]},
        attrs={"shape": list(shape),
               "dtype": framework.dtype_str(framework.convert_dtype(dtype)),
               "value": float(value)})
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    """A ``shape`` tensor of ``value`` whose dim ``output_dim_idx`` is
    ``input``'s dim ``input_dim_idx`` (the batch)."""
    helper = LayerHelper("fill_constant_batch_size_like", **locals())
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="fill_constant_batch_size_like", inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={"shape": list(shape),
               "dtype": framework.dtype_str(framework.convert_dtype(dtype)),
               "value": float(value), "input_dim_idx": input_dim_idx,
               "output_dim_idx": output_dim_idx})
    return out


def cast(x, dtype):
    helper = LayerHelper("cast", x=x, dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
        attrs={"out_dtype": framework.dtype_str(
            framework.convert_dtype(dtype))})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", **locals())
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="concat", inputs={"X": input},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def assign(input, output=None):
    """``input`` (a Variable, or a numpy value through ``assign_value``)
    into ``output`` (a new var by default)."""
    helper = LayerHelper("assign", **locals())
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op(type="assign", inputs={"X": [input]},
                         outputs={"Out": [output]})
    else:
        arr = np.asarray(input)
        if output is None:
            output = helper.create_variable_for_type_inference(arr.dtype)
        helper.append_op(
            type="assign_value", outputs={"Out": [output]},
            attrs={"shape": list(arr.shape),
                   "dtype": framework.dtype_str(arr.dtype),
                   "values": arr.ravel().tolist()})
    return output


def argmin(x, axis=0):
    helper = LayerHelper("arg_min", **locals())
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="arg_min", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def argmax(x, axis=0):
    helper = LayerHelper("arg_max", **locals())
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="arg_max", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def range(start, end, step, dtype):
    """[start, end) by step. The length must be static: python scalars
    ride as attrs, and a Variable bound must come from an
    ``assign_value`` or a ``fill_constant`` of the block."""
    helper = LayerHelper("range")
    inputs, attrs = {}, {"dtype": framework.dtype_str(
        framework.convert_dtype(dtype))}
    for key, val in (("Start", start), ("End", end), ("Step", step)):
        if isinstance(val, Variable):
            inputs[key] = [val]
        else:
            attrs[key.lower()] = float(val)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="range", inputs=inputs, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def tensor_array_to_tensor(input, axis=1, name=None, use_stack=False):
    """Every slot of a bounded tensor array (unwritten slots are zeros)
    concatenated, or stacked, along ``axis``: (out, out_index), where
    out_index holds each slot's size along ``axis``."""
    helper = LayerHelper("tensor_array_to_tensor", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out_index = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="tensor_array_to_tensor", inputs={"X": [input]},
        outputs={"Out": [out], "OutIndex": [out_index]},
        attrs={"axis": int(axis), "use_stack": bool(use_stack)})
    return out, out_index
