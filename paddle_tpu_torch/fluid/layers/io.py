"""Feed slots (counterpart of ``paddle_tpu/fluid/layers/io.py``)."""

from ..layer_helper import LayerHelper

__all__ = ["data"]


def data(name, shape, dtype="float32", append_batch_size=True,
         lod_level=0, stop_gradient=True):
    """Declare a feed slot; ``append_batch_size`` prepends -1. A ragged
    slot (``lod_level`` > 0) needs LoD feeds, which are not ported yet
    (ROADMAP queue 1 item 4, sequence/LoD)."""
    if lod_level:
        raise NotImplementedError(
            "layers.data(%r, lod_level=%d): LoD feeds are not ported yet "
            "(ROADMAP queue 1 item 4, sequence/LoD)" % (name, lod_level))
    helper = LayerHelper("data", name=name)
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return helper.main_program.current_block().create_var(
        name=name, shape=shape, dtype=dtype, stop_gradient=stop_gradient,
        is_data=True)
