"""BackwardStrategy (the port's copy of
``paddle_tpu/fluid/dygraph/backward_strategy.py``; a bound C++ struct
with one knob in the reference)."""

__all__ = ["BackwardStrategy"]


class BackwardStrategy:
    """``sort_sum_gradient``: the reference sums a var's gradient
    contributions in a sorted, deterministic order when True. Autograd
    sums them in its graph's fixed order, so both settings give the same
    result; the knob is accepted and recorded for parity."""

    def __init__(self):
        self.sort_sum_gradient = False
