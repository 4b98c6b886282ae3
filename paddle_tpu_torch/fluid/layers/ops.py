"""Unary activation layers (counterparts in
``paddle_tpu/fluid/layers/ops.py``, which generates them from the op
registry's unary list): the subset the port's models, learning-rate
schedules and gradient clips use, and ``cos_sim``."""

from ..layer_helper import LayerHelper

_UNARY_LAYERS = ["sigmoid", "tanh", "exp", "sqrt", "ceil", "floor", "cos",
                 "square"]

__all__ = list(_UNARY_LAYERS) + ["cos_sim"]


def _make_layer(op_type):
    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out

    layer.__name__ = op_type
    layer.__doc__ = "Elementwise %s." % op_type
    return layer


for _name in _UNARY_LAYERS:
    globals()[_name] = _make_layer(_name)


def cos_sim(X, Y):
    """Row-wise cosine similarity [..., 1] of X and Y."""
    helper = LayerHelper("cos_sim")
    out = helper.create_variable_for_type_inference(X.dtype)
    helper.append_op(type="cos_sim", inputs={"X": [X], "Y": [Y]},
                     outputs={"Out": [out]})
    return out
