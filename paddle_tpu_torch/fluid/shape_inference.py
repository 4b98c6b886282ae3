"""Static shape/dtype inference by running op lowering rules on ``meta``
tensors.

The port's counterpart of ``paddle_tpu/fluid/shape_inference.py``, which
runs the JAX rules under ``jax.eval_shape``: the lowering rule is the
shape function, and meta tensors carry shapes and dtypes without memory
or arithmetic. Unknown (batch) dims are -1 in the IR; they are replaced
by a distinctive dummy extent for the run and mapped back afterwards.

A control-flow op's sub-blocks read outer vars the op does not declare
(a ``while`` declares only its condition), so its meta environment is
seeded from its transitive reads (``framework.transitive_args``); its
lowering never reads a predicate on meta tensors (it traces every
branch, one trip, one step). Its outputs take the inferred shapes only
where every outer var its sub-blocks read is one it declares: the
reference's abstract run sees the declared inputs alone, and otherwise
fails and leaves the shapes the layer declared (a StaticRNN whose step
reads a parameter keeps its (-1, ...) outputs), so both packages
record the same desc.

Recorded dtypes follow the reference, which runs with 64-bit types off:
an int64 or float64 result is recorded as int32 or float32, so the two
packages build the same program desc. At run time the port's tensors
keep torch's types (int64 indices).
"""

import numpy as np
import torch

from .framework import sub_block_ids, transitive_args
from .registry import LowerCtx, registry, to_numpy_dtype, to_torch_dtype

_DUMMY = 1097  # unlikely to appear as a real static dim
_RECORDED = {np.dtype("int64"): np.dtype("int32"),
             np.dtype("float64"): np.dtype("float32")}
_META = torch.device("meta")


def infer_op_shapes(op):
    block = op.block
    if not registry.has(op.type):
        return
    nested = bool(sub_block_ids(op))
    names = op.input_arg_names()
    record = True
    if nested:
        names = sorted(transitive_args(op)[0])
        declared = set(op.input_arg_names())
        record = all(n in declared for n in names
                     if block._find_var_recursive(n) is not None)
    env = {}
    had_dummy = False
    for name in names:
        v = block._find_var_recursive(name)
        if v is None:
            if nested:      # a sub-block's own var
                continue
            return
        shape = []
        for s in v.shape:
            had_dummy |= s == -1
            shape.append(_DUMMY if s == -1 else int(s))
        env[name] = torch.empty(shape, dtype=to_torch_dtype(v.dtype),
                                device=_META)
    ctx = LowerCtx(block, env, None, _META)
    registry.get(op.type)(ctx, op)
    if not record:
        return
    for n in op.output_arg_names():
        v = block._find_var_recursive(n)
        if v is None or n not in env:
            continue
        t = env[n]
        v.shape = tuple(-1 if (had_dummy and s % _DUMMY == 0 and s > 0)
                        else int(s) for s in t.shape)
        dt = to_numpy_dtype(t.dtype)
        v.dtype = _RECORDED.get(dt, dt)
