"""Dygraph checkpoints (the port's counterpart of
``paddle_tpu/fluid/dygraph/checkpoint.py``): ``save_dygraph`` and
``load_dygraph`` through the port's PTC1 codec (``core/tensor_io.py``,
``fluid/io.py::_load_combined``), the reference's on-disk format, so
each package reads the other's files."""

import os

import numpy as np

from .base import VarBase

__all__ = ["save_dygraph", "load_dygraph"]


def save_dygraph(state_dict, model_path):
    """A dict whose first value is a VarBase (a layer's ``state_dict``)
    saves as ``<model_path>.pdparams``; any other (an optimizer's, of
    plain arrays) as ``.pdopt``: the reference's suffix rule."""
    from ..core import tensor_io

    if not state_dict:
        raise ValueError("state_dict is empty, nothing to save (an "
                         "SGD-with-float-LR optimizer has no state)")
    first = next(iter(state_dict.values()))
    suffix = ".pdparams" if isinstance(first, VarBase) else ".pdopt"
    arrays = {k: v.numpy() if isinstance(v, VarBase) else np.asarray(v)
              for k, v in state_dict.items()}
    os.makedirs(os.path.dirname(model_path) or ".", exist_ok=True)
    tensor_io.save_combine(model_path + suffix, arrays)


def load_dygraph(model_path):
    """``(param_dict, opt_dict)`` of numpy arrays; either is None when
    its file is absent (both absent raises)."""
    from ..io import _load_combined

    paths = [model_path + ".pdparams", model_path + ".pdopt"]
    para, opti = (_load_combined(p) if os.path.exists(p) else None
                  for p in paths)
    if para is None and opti is None:
        raise FileNotFoundError(paths[0])
    return para, opti
