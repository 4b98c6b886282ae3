"""Tensor layers (counterparts in ``paddle_tpu/fluid/layers/tensor.py``)."""

from .. import framework
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["create_parameter", "fill_constant",
           "fill_constant_batch_size_like", "cast", "concat"]


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
