"""SelectedRows and LoD-rebinding layers (counterparts in
``paddle_tpu/fluid/layers/extras.py``)."""

from ..layer_helper import LayerHelper

__all__ = ["lod_reset", "lod_append", "merge_selected_rows",
           "get_tensor_from_selected_rows"]


def lod_reset(x, y=None, target_lod=None):
    """``x`` with new lengths: ``y``'s LoD (or its int offsets), or the
    ``target_lod`` offsets."""
    helper = LayerHelper("lod_reset", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.lod_level = 1
    inputs = {"X": [x]}
    attrs = {}
    if y is not None:
        inputs["Y"] = [y]
    elif target_lod is not None:
        attrs["target_lod"] = [int(v) for v in target_lod]
    else:
        raise ValueError("lod_reset needs y or target_lod")
    helper.append_op(type="lod_reset", inputs=inputs,
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def lod_append(x, level):
    """``x`` with a deeper LoD level (``level``'s offsets)."""
    helper = LayerHelper("lod_append", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.lod_level = getattr(x, "lod_level", 0) + 1
    helper.append_op(type="lod_append", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"level": [int(v) for v in level]})
    return out


def merge_selected_rows(x, name=None):
    """The SelectedRows ``x`` with its duplicate rows summed (at its
    static size: each id's first occurrence carries the sum)."""
    helper = LayerHelper("merge_selected_rows", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.type = "selected_rows"
    out.shape = tuple(x.shape)  # keeps the dense height downstream
    helper.append_op(type="merge_selected_rows", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def get_tensor_from_selected_rows(x, height=None, name=None):
    """The SelectedRows ``x`` as a dense tensor of ``height`` rows
    (default: the var's declared dense height, which static shapes need
    at build time)."""
    helper = LayerHelper("get_tensor_from_selected_rows", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    if height is None:
        if x.shape and int(x.shape[0]) > 0:
            height = int(x.shape[0])
        else:
            raise ValueError("pass height=: %r declares no static dense "
                             "height" % (x.name,))
    helper.append_op(type="get_tensor_from_selected_rows",
                     inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"height": int(height)})
    return out
