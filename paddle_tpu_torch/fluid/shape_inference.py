"""Static shape/dtype inference by running op lowering rules on ``meta``
tensors.

The port's counterpart of ``paddle_tpu/fluid/shape_inference.py``, which
runs the JAX rules under ``jax.eval_shape``: the lowering rule is the
shape function, and meta tensors carry shapes and dtypes without memory
or arithmetic. Unknown (batch) dims are -1 in the IR; they are replaced
by a distinctive dummy extent for the run and mapped back afterwards.

Recorded dtypes follow the reference, which runs with 64-bit types off:
an int64 or float64 result is recorded as int32 or float32, so the two
packages build the same program desc. At run time the port's tensors
keep torch's types (int64 indices).
"""

import numpy as np
import torch

from .registry import LowerCtx, registry, to_numpy_dtype, to_torch_dtype

_DUMMY = 1097  # unlikely to appear as a real static dim
_RECORDED = {np.dtype("int64"): np.dtype("int32"),
             np.dtype("float64"): np.dtype("float32")}
_META = torch.device("meta")


def infer_op_shapes(op):
    block = op.block
    if not registry.has(op.type):
        return
    env = {}
    had_dummy = False
    for name in op.input_arg_names():
        v = block._find_var_recursive(name)
        if v is None:
            return
        shape = []
        for s in v.shape:
            had_dummy |= s == -1
            shape.append(_DUMMY if s == -1 else int(s))
        env[name] = torch.empty(shape, dtype=to_torch_dtype(v.dtype),
                                device=_META)
    ctx = LowerCtx(block, env, None, _META)
    registry.get(op.type)(ctx, op)
    for n in op.output_arg_names():
        v = block._find_var_recursive(n)
        if v is None or n not in env:
            continue
        t = env[n]
        v.shape = tuple(-1 if (had_dummy and s % _DUMMY == 0 and s > 0)
                        else int(s) for s in t.shape)
        dt = to_numpy_dtype(t.dtype)
        v.dtype = _RECORDED.get(dt, dt)
