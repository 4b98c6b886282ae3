"""Feed slots (counterpart of ``paddle_tpu/fluid/layers/io.py``)."""

from ..layer_helper import LayerHelper

__all__ = ["data"]


def data(name, shape, dtype="float32", append_batch_size=True,
         lod_level=0, stop_gradient=True):
    """Declare a feed slot; ``append_batch_size`` prepends -1 like the
    reference's ``fluid.layers.data`` (``fluid.data`` passes shapes
    verbatim). A ragged slot (``lod_level`` > 0) takes a ``LoDTensor``
    feed: flat rows plus lengths (``fluid/lod.py``)."""
    helper = LayerHelper("data", name=name)
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return helper.main_program.current_block().create_var(
        name=name, shape=shape, dtype=dtype, stop_gradient=stop_gradient,
        lod_level=lod_level, is_data=True)
