"""The ops behind ``Variable``'s operator sugar (counterpart of
``paddle_tpu/fluid/layers/math_op_patch.py``): ``x + c`` for a scalar
``c`` is one ``scale`` op (bias c); any other scalar becomes a [1]
``fill_constant`` of x's dtype; the op gets ``axis`` -1, and a
comparison's output is bool."""

from .. import framework

_COMPARISONS = ("less_than", "less_equal", "greater_than", "greater_equal",
                "equal", "not_equal")


def binary_op(x, other, op_type, reverse=False):
    from ..layer_helper import LayerHelper
    from .tensor import fill_constant

    helper = LayerHelper(op_type)
    if not isinstance(other, framework.Variable):
        val = float(other)
        if op_type == "elementwise_add" and not reverse:
            from .nn import scale

            return scale(x, scale=1.0, bias=val)
        other = fill_constant([1], framework.dtype_str(x.dtype), val)
    a, b = (other, x) if reverse else (x, other)
    out = helper.create_variable_for_type_inference(
        "bool" if op_type in _COMPARISONS else a.dtype)
    helper.append_op(type=op_type, inputs={"X": [a], "Y": [b]},
                     outputs={"Out": [out]}, attrs={"axis": -1})
    return out
