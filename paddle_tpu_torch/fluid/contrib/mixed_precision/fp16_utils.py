"""AMP program rewrite: insert ``cast`` ops around white- and
black-listed ops (the port's copy of
``paddle_tpu/fluid/contrib/mixed_precision/fp16_utils.py``).

Parameters stay fp32 (master weights); the casts are ops of the
program, so autograd differentiates through them and the gradients
arrive fp32. A white op's fp32 float inputs are cast down and its
outputs declared low; a black op's low inputs are cast back to fp32; a
gray op with a low input pulls its other fp32 float inputs down (except
the norms' Scale/Bias) and its outputs run low, though their declared
dtype stays what it was, as in the reference.
"""

import numpy as np

from ... import framework
from ...framework import BFLOAT16, convert_dtype

__all__ = ["rewrite_program", "cast_model_to_fp16"]

_FLOAT32 = np.dtype("float32")


def _is_float(dtype):
    d = convert_dtype(dtype)
    return d == BFLOAT16 or np.issubdtype(d, np.floating)


def _is_fp32(var):
    return var is not None and var.dtype is not None and \
        convert_dtype(var.dtype) == _FLOAT32


def _insert_cast(block, new_ops, cache, name, dest_dtype, suffix):
    """Emit (or reuse) a cast of var ``name`` to ``dest_dtype``; returns
    the cast var's name."""
    key = (name, suffix)
    if key in cache:
        return cache[key]
    src = block._find_var_recursive(name)
    cast_name = name + suffix
    # not stop_gradient: the casts sit on the parameters' path to the loss
    block.create_var(name=cast_name, shape=list(src.shape), dtype=dest_dtype,
                     persistable=False, stop_gradient=False)
    new_ops.append(framework.Operator(
        block, "cast", {"X": [name]}, {"Out": [cast_name]},
        {"out_dtype": framework.dtype_str(dest_dtype)}))
    cache[key] = cast_name
    return cast_name


# gray ops whose state inputs stay fp32: the norms' scale and bias are
# optimizer-owned parameters (and batch_norm's running statistics)
_KEEP_FP32_SLOTS = {
    "batch_norm": ("Scale", "Bias", "Mean", "Variance"),
    "layer_norm": ("Scale", "Bias"),
}

# gray ops of which only some outputs run low: the norms' statistics stay
# fp32, only Y follows X
_LOW_OUTPUT_SLOTS = {
    "batch_norm": ("Y",),
    "layer_norm": ("Y",),
}


def _cast_inputs(block, op, new_ops, cache, want_cast, dest_dtype, suffix,
                 skip=()):
    for slot, names in op.inputs.items():
        if slot in skip:
            continue
        op.inputs[slot] = [
            _insert_cast(block, new_ops, cache, n, dest_dtype, suffix)
            if want_cast(n) else n for n in names]


def rewrite_program(main_program, amp_lists, dest_dtype="bfloat16"):
    """Walk the forward block: white ops get low-precision inputs, black
    ops fp32 inputs, gray ops follow their inputs."""
    low = convert_dtype(dest_dtype)
    block = main_program.global_block()
    low_suffix = ".cast_" + dest_dtype
    cache, new_ops, low_vars = {}, [], set()

    def fp32_not_low(n):
        return n not in low_vars and _is_fp32(block._find_var_recursive(n))

    for op in list(block.ops):
        if op.type == "autodiff":
            new_ops.append(op)
            continue
        if op.type in amp_lists.white_list and not (
                set(op.input_arg_names()) & amp_lists.black_varnames):
            _cast_inputs(block, op, new_ops, cache, fp32_not_low, low,
                         low_suffix)
            for out in op.output_arg_names():
                v = block._find_var_recursive(out)
                if _is_fp32(v):
                    v.dtype = low
                    low_vars.add(out)
        elif op.type in amp_lists.black_list:
            _cast_inputs(block, op, new_ops, cache, low_vars.__contains__,
                         _FLOAT32, ".cast_fp32")
        elif any(n in low_vars for n in op.input_arg_names()):
            _cast_inputs(block, op, new_ops, cache, fp32_not_low, low,
                         low_suffix, skip=_KEEP_FP32_SLOTS.get(op.type, ()))
            low_slots = _LOW_OUTPUT_SLOTS.get(op.type)
            for slot, names in op.outputs.items():
                if low_slots is not None and slot not in low_slots:
                    continue
                for out in names:
                    v = block._find_var_recursive(out)
                    if v is not None and v.dtype is not None and \
                            _is_float(v.dtype):
                        low_vars.add(out)
        new_ops.append(op)
    block.ops = new_ops
    return main_program


def cast_model_to_fp16(program, amp_lists=None, dest_dtype="bfloat16"):
    """Inference-side whole-model cast: the same rewrite, no backward."""
    from .fp16_lists import AutoMixedPrecisionLists

    return rewrite_program(program, amp_lists or AutoMixedPrecisionLists(),
                           dest_dtype)
