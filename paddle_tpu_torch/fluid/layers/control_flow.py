"""Control-flow layers (counterpart of
``paddle_tpu/fluid/layers/control_flow.py``): the comparisons and
``increment``. The block-structured constructs (``While``,
``while_loop``, ``cond``, ``case``, ``switch_case``, ``Switch``,
``StaticRNN``), the tensor arrays, ``is_empty`` and ``Print`` need
sub-blocks, which the port's IR and executor do not run yet: they raise,
naming ROADMAP queue 1 item 4 (control flow)."""

from ..layer_helper import LayerHelper
from .unported import unported

__all__ = ["While", "Switch", "cond", "case", "switch_case", "while_loop",
           "StaticRNN", "increment", "less_than", "less_equal",
           "greater_than", "greater_equal", "equal", "not_equal",
           "is_empty", "Print", "array_write", "array_read", "array_length",
           "create_array"]


def _compare(op_type, x, y, cond=None):
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def less_than(x, y, force_cpu=None, cond=None):
    return _compare("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _compare("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _compare("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _compare("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _compare("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _compare("not_equal", x, y, cond)


def increment(x, value=1.0, in_place=True):
    """x + value; in place (Out is X) by default."""
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(
        x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


_WHY = ("needs control-flow sub-blocks, which are not ported yet (ROADMAP "
        "queue 1 item 4, control flow)")
for _name in ("While", "Switch", "StaticRNN", "cond", "case", "switch_case",
              "while_loop", "is_empty", "Print", "array_write", "array_read",
              "array_length", "create_array"):
    globals()[_name] = unported(_name, _WHY)
