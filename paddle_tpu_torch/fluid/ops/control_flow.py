"""Control-flow op lowerings: ``cond``, ``while``, ``while_loop``,
``switch``, ``static_rnn``, the bounded tensor arrays and ``print``
(counterparts of ``paddle_tpu/fluid/ops/control_flow.py`` and of the ops
``paddle_tpu/fluid/layers/control_flow.py`` registers).

The reference traces each sub-block into ``lax.cond`` /
``lax.while_loop`` / ``lax.scan``. Here a sub-block is lowered op by op
(``registry.lower_block``) on a copy of the environment, so a branch's
or a trip's locals never reach the parent; what reaches it is what the
reference's carry keeps:

- ``cond``: the taken branch's ``*_outs``, bound to ``out_names``;
- ``while``: the names the body writes that exist outside (and the
  condition), with their ``@ALEN`` / ``@LOD`` / ``@ROWS`` side-bindings;
- ``switch``: the names any branch writes that exist outside;
- ``static_rnn``: the stacked step outputs and the final memories;
- ``while_loop``: the loop vars, bound to ``out_names``.

``cond``, ``switch``, ``while`` and the unbounded ``while_loop`` read a
predicate on the host each time they decide (``_truth``), which a CUDA
graph cannot capture: the executor runs programs holding them eagerly
(its ``control_flow`` rule). ``static_rnn`` and the bounded
``while_loop`` (``maximum_trip_count``: every trip runs the body and
keeps its result where the condition held, ``torch.where``) read
nothing on the host and are captured like any step; so are the arrays,
whose indices stay on the device.

Under shape inference (meta tensors, ``ctx.abstract``) no predicate is
read: ``cond`` and ``switch`` trace every branch, ``while`` and
``while_loop`` trace one trip and keep their carry's shapes, and
``static_rnn`` traces one step and stacks it.
"""

import numpy as np
import torch

from ..registry import lower_block, register, to_torch_dtype

# side-bindings that ride with a carried var: an array's length, a LoD
# var's lengths, a SelectedRows var's rows
_SIDE = ("@ALEN", "@LOD", "@ROWS")


def _block_writes(block):
    """Var names written by the block's ops, in order, once each."""
    seen = []
    for op in block.ops:
        for n in op.output_arg_names():
            if n not in seen:
                seen.append(n)
    return seen


def _truth(pred):
    """A one-element predicate's value, read on the host."""
    return bool(pred.reshape(()).item())


@register("cond")
def _cond(ctx, op):
    """One branch on a copy of the environment; its ``*_outs`` are bound
    to ``out_names``."""
    branches = [(op.attr("true_block"), op.attr("true_outs")),
                (op.attr("false_block"), op.attr("false_outs"))]

    def run(idx, outs):
        env = lower_block(ctx, ctx.program.block(idx), dict(ctx.env))
        return [env[n] for n in outs]

    if ctx.abstract:
        vals = [run(*b) for b in branches][0]
    else:
        vals = run(*branches[0 if _truth(ctx.get_input(op, "Cond")) else 1])
    for name, val in zip(op.attr("out_names"), vals):
        ctx.set(name, val)


def _carried(ctx, names):
    """``names`` with the side-bindings of each that the environment
    holds."""
    out = list(names)
    for n in names:
        for suf in _SIDE:
            if n + suf in ctx.env and n + suf not in out:
                out.append(n + suf)
    return out


@register("while")
def _while(ctx, op):
    """The body runs while the condition var, which it reassigns, holds.
    Each trip starts from the environment before the loop plus the
    carry."""
    block = ctx.program.block(op.attr("sub_block"))
    cond_name = op.input("Condition")[0]
    carried = [n for n in _block_writes(block) if n in ctx.env]
    if cond_name not in carried:
        carried.insert(0, cond_name)
    carried = _carried(ctx, carried)
    snapshot = {k: v for k, v in ctx.env.items() if k not in carried}
    carry = {n: ctx.env[n] for n in carried}

    def trip(carry):
        env = dict(snapshot)
        env.update(carry)
        lower_block(ctx, block, env)
        return {n: env[n] for n in carried}

    if ctx.abstract:
        trip(carry)
    else:
        while _truth(carry[cond_name]):
            carry = trip(carry)
    for n in carried:
        ctx.set(n, carry[n])


@register("while_loop")
def _while_loop(ctx, op):
    """The functional loop: ``cond_block`` computes ``cond_out`` from the
    loop vars, ``body_block`` their next values (``body_out_names``).
    With ``maximum_trip_count`` every one of that many trips runs the
    body and keeps its values where the condition held, with no host
    read; without it the condition is read on the host each trip."""
    cond_block = ctx.program.block(op.attr("cond_block"))
    body_block = ctx.program.block(op.attr("body_block"))
    names = op.attr("loop_var_names")
    body_outs = op.attr("body_out_names")
    cond_out = op.attr("cond_out")
    snapshot = dict(ctx.env)

    def run(block, carry):
        env = dict(snapshot)
        env.update(zip(names, carry))
        return lower_block(ctx, block, env)

    def cond_fn(carry):
        return run(cond_block, carry)[cond_out].reshape(())

    def body_fn(carry):
        env = run(body_block, carry)
        return [env[n] for n in body_outs]

    carry = [ctx.get(n) for n in names]
    max_trips = int(op.attr("maximum_trip_count", 0) or 0)
    if ctx.abstract:
        cond_fn(carry)
        body_fn(carry)
    elif max_trips:
        for _ in range(max_trips):
            active = cond_fn(carry)
            carry = [torch.where(active, new, old)
                     for new, old in zip(body_fn(carry), carry)]
    else:
        while _truth(cond_fn(carry)):
            carry = body_fn(carry)
    for name, val in zip(op.attr("out_names"), carry):
        ctx.set(name, val)


@register("switch")
def _switch(ctx, op):
    """The first branch whose condition holds, else the default (the
    last block) where there is one; the names any branch writes that
    exist outside are carried."""
    blocks = [ctx.program.block(i) for i in op.attr("blocks")]
    carried = []
    for blk in blocks:
        for n in _block_writes(blk):
            if n in ctx.env and n not in carried:
                carried.append(n)

    def run(blk):
        env = lower_block(ctx, blk, dict(ctx.env))
        for n in carried:
            ctx.set(n, env[n])

    if ctx.abstract:
        for blk in blocks:
            lower_block(ctx, blk, dict(ctx.env))
        return
    conds = ctx.get_inputs(op, "Conds")
    for cond, blk in zip(conds, blocks):
        if _truth(cond):
            return run(blk)
    if op.attr("has_default"):
        run(blocks[-1])


@register("static_rnn")
def _static_rnn(ctx, op):
    """StaticRNN: the step block once a time step over the time-major
    ``seq_inputs``, memories carried from ``mem_pre`` to ``mem_post``,
    the ``step_outputs`` stacked along a new leading time axis; the
    final memories are bound to ``final_mem_names``."""
    block = ctx.program.block(op.attr("sub_block"))
    xs = [ctx.get(n) for n in op.attr("seq_inputs")]
    step_inputs = op.attr("step_inputs")
    mem_pre, mem_post = op.attr("mem_pre"), op.attr("mem_post")
    step_outputs = op.attr("step_outputs")
    snapshot = dict(ctx.env)

    def step(carry, t):
        env = dict(snapshot)
        env.update(zip(mem_pre, carry))
        env.update((n, x[t]) for n, x in zip(step_inputs, xs))
        lower_block(ctx, block, env)
        return [env[n] for n in mem_post], [env[n] for n in step_outputs]

    carry = [ctx.get(n) for n in op.attr("mem_init")]
    T = xs[0].shape[0]
    if ctx.abstract:
        carry, outs = step(carry, 0)
        stacked = [o.unsqueeze(0).expand((T,) + tuple(o.shape))
                   for o in outs]
    else:
        steps = []
        for t in range(T):
            carry, outs = step(carry, t)
            steps.append(outs)
        stacked = [torch.stack(col) for col in zip(*steps)] if steps else []
    for name, val in zip(op.attr("out_names"), stacked):
        ctx.set(name, val)
    for name, val in zip(op.attr("final_mem_names") or [], carry):
        ctx.set(name, val)


# -- the bounded tensor array ------------------------------------------------
#
# The reference's LoDTensorArray is a growing list of tensors; the JAX
# package bounds it for static shapes, and the port keeps its layout: a
# [bound, ...element] buffer under the array's name plus an int32 length
# under ``name@ALEN``. Writes and reads index with a device integer (no
# host read, so a captured loop can write), clamped into the buffer as
# XLA's dynamic slices clamp: an out-of-range write lands in the last
# slot. Unwritten slots are zeros.

ALEN_SUFFIX = "@ALEN"


def _array_len(ctx, name):
    key = name + ALEN_SUFFIX
    if key not in ctx.env:
        ctx.env[key] = torch.zeros((), dtype=torch.int32, device=ctx.device)
    return ctx.env[key]


def _slot(arr, i):
    """The index ``i`` as a [1] int64 tensor clamped into ``arr``'s
    slots."""
    return i.reshape(1).to(torch.int64).clamp(0, arr.shape[0] - 1)


@register("create_array")
def _create_array(ctx, op):
    """A zero buffer of ``bound`` elements of ``element_shape``, or,
    without one, a 0-size sentinel that the first write sizes."""
    out = op.output("Out")[0]
    dtype = to_torch_dtype(op.attr("dtype", "float32"))
    shape = op.attr("element_shape", None)
    bound = int(op.attr("bound", 0))
    ctx.set(out, torch.zeros(
        (bound,) + tuple(int(s) for s in shape) if shape else (0,),
        dtype=dtype, device=ctx.device))
    ctx.env[out + ALEN_SUFFIX] = torch.zeros((), dtype=torch.int32,
                                             device=ctx.device)


@register("array_write")
def _array_write(ctx, op):
    """X into slot I (clamped); the length becomes max(length, I + 1)."""
    x = ctx.get_input(op, "X")
    i = ctx.get_input(op, "I")
    name = op.output("Out")[0]
    arr = ctx.get(name)
    if arr.dim() == 1 and arr.shape[0] == 0:       # the lazy sentinel
        bound = int(op.attr("bound", 0)) or 128
        arr = torch.zeros((bound,) + tuple(x.shape), dtype=arr.dtype,
                          device=arr.device)
    arr = arr.index_copy(0, _slot(arr, i), x.to(arr.dtype).unsqueeze(0))
    ctx.set(name, arr)
    ctx.env[name + ALEN_SUFFIX] = torch.maximum(
        _array_len(ctx, name), i.reshape(()).to(torch.int32) + 1)


@register("array_read")
def _array_read(ctx, op):
    arr = ctx.get_input(op, "X")
    i = ctx.get_input(op, "I")
    ctx.set_output(op, "Out", arr.index_select(0, _slot(arr, i))[0])


@register("array_length")
def _array_length(ctx, op):
    ctx.set_output(op, "Out", _array_len(ctx, op.input("X")[0]).reshape(1))


@register("tensor_array_to_tensor")
def _tensor_array_to_tensor(ctx, op):
    """All ``bound`` slots (unwritten ones are zeros) concatenated, or
    stacked, along ``axis``; ``OutIndex`` holds each slot's size along
    it."""
    arr = ctx.get_input(op, "X")
    axis = int(op.attr("axis", 1))
    T = arr.shape[0]
    moved = torch.movedim(arr, 0, axis)
    if op.attr("use_stack", False):
        out = moved
        per_entry = arr.shape[1:][axis] if axis < arr.dim() - 1 else 1
    else:
        shape = list(moved.shape)
        per_entry = shape[axis + 1]
        out = moved.reshape(shape[:axis] + [T * per_entry]
                            + shape[axis + 2:])
    ctx.set_output(op, "Out", out)
    ctx.set_output(op, "OutIndex", torch.full(
        (T,), per_entry, dtype=torch.int32, device=arr.device))


@register("print")
def _print(ctx, op):
    """Prints ``message`` and the value on the host (a host op: the
    executor runs its program eagerly); Out is In."""
    x = ctx.get_input(op, "In")
    if not ctx.abstract:
        t = x.detach()
        print(op.attr("message", "") + str(np.asarray(
            (t.float() if t.dtype == torch.bfloat16 else t).cpu())),
            flush=True)
    ctx.set_output(op, "Out", x)
