"""Feed slots (counterpart of ``paddle_tpu/fluid/layers/io.py``)."""

from ..layer_helper import LayerHelper

__all__ = ["data"]


def data(name, shape, dtype="float32", append_batch_size=True,
         stop_gradient=True):
    """Declare a feed slot; ``append_batch_size`` prepends -1."""
    helper = LayerHelper("data", name=name)
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return helper.main_program.current_block().create_var(
        name=name, shape=shape, dtype=dtype, stop_gradient=stop_gradient,
        is_data=True)
