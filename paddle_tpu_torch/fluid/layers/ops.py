"""Unary activation layers (counterparts in
``paddle_tpu/fluid/layers/ops.py``, which generates them from the op
registry's unary list): the subset the port's models use."""

from ..layer_helper import LayerHelper

__all__ = ["sigmoid"]


def sigmoid(x, name=None):
    helper = LayerHelper("sigmoid", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sigmoid", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={})
    return out
