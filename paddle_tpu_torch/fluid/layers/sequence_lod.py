"""Sequence layers (counterpart of
``paddle_tpu/fluid/layers/sequence_lod.py``). ``sequence_mask`` is
ported: a dense op over lengths, which ``layers.rnn(sequence_length=)``
uses. The LoD layers wait for the LoD half of ROADMAP queue 1 item 4
(sequence/LoD) and raise, naming it."""

from ..layer_helper import LayerHelper
from .unported import unported

_LOD_LAYERS = [
    "sequence_conv", "sequence_softmax", "sequence_pool", "sequence_concat",
    "sequence_first_step", "sequence_last_step", "sequence_slice",
    "sequence_expand", "sequence_expand_as", "sequence_pad",
    "sequence_unpad", "sequence_reshape", "sequence_scatter",
    "sequence_enumerate", "sequence_reverse", "sequence_erase",
]

__all__ = _LOD_LAYERS + ["sequence_mask"]


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """[n, maxlen] of ``dtype``: 1 below each row's length in ``x``.
    ``maxlen`` is an int (static, as a captured program needs) or a
    Variable (``MaxLenTensor``)."""
    helper = LayerHelper("sequence_mask", **locals())
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [x]}
    attrs = {"out_dtype": dtype}
    if maxlen is not None and hasattr(maxlen, "name"):
        inputs["MaxLenTensor"] = [maxlen]
        attrs["maxlen"] = -1
    else:
        attrs["maxlen"] = -1 if maxlen is None else int(maxlen)
    helper.append_op(type="sequence_mask", inputs=inputs,
                     outputs={"Out": [out]}, attrs=attrs)
    return out


for _name in _LOD_LAYERS:
    globals()[_name] = unported(
        _name, "runs on LoD (ragged) sequences, which are not ported yet "
        "(ROADMAP queue 1 item 4, sequence/LoD)")
