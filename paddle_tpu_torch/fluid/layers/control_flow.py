"""Control-flow layers (counterpart of
``paddle_tpu/fluid/layers/control_flow.py``): the comparisons and
``increment``, and the block-structured constructs: ``While``,
``while_loop``, ``cond``, ``case``, ``switch_case``, ``Switch``,
``StaticRNN``, the bounded tensor arrays, ``is_empty`` and ``Print``.
Each construct builds its body or branches in sub-blocks of the program
(``Program._create_block``) and appends one op that names them; the ops
lower in ``fluid/ops/control_flow.py``. ``IfElse`` and ``DynamicRNN``
are in ``extras.py``."""

import contextlib

import numpy as np

from ..layer_helper import LayerHelper

__all__ = ["While", "Switch", "cond", "case", "switch_case", "while_loop",
           "StaticRNN", "increment", "less_than", "less_equal",
           "greater_than", "greater_equal", "equal", "not_equal",
           "is_empty", "Print", "array_write", "array_read", "array_length",
           "create_array"]


def _compare(op_type, x, y, cond=None):
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def less_than(x, y, force_cpu=None, cond=None):
    return _compare("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _compare("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _compare("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _compare("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _compare("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _compare("not_equal", x, y, cond)


def increment(x, value=1.0, in_place=True):
    """x + value; in place (Out is X) by default."""
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(
        x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def is_empty(x, cond=None):
    """Whether ``x`` has no elements: a build-time constant (static
    shapes), written with ``assign``."""
    from . import tensor

    helper = LayerHelper("is_empty")
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    empty = int(np.prod([d for d in x.shape if d >= 0])) == 0
    return tensor.assign(np.asarray([empty]), cond)


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """Prints ``message`` and the value when the program runs (the
    ``print`` op, a host op); returns the value unchanged."""
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="print", inputs={"In": [input]},
                     outputs={"Out": [out]},
                     attrs={"message": message or ""})
    return out


@contextlib.contextmanager
def _sub_block(program):
    """Build into a new sub-block of ``program``; yields the block."""
    blk = program._create_block()
    try:
        yield blk
    finally:
        program._rollback()


class While:
    """The body mutates outer vars, and must reassign the condition var:

        cond = layers.less_than(i, n)
        w = layers.While(cond)
        with w.block():
            ...
            layers.increment(i)
            layers.less_than(i, n, cond=cond)

    No gradient flows through it (use ``while_loop(...,
    maximum_trip_count=)``)."""

    def __init__(self, cond, is_test=False, name=None):
        self.cond_var = cond
        self.helper = LayerHelper("while", name=name)

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        with _sub_block(program) as sub_block:
            yield
        program.current_block().append_op(
            "while", inputs={"Condition": [self.cond_var]}, outputs={},
            attrs={"sub_block": sub_block.idx})


def while_loop(cond, body, loop_vars, is_test=False, name=None,
               maximum_trip_count=None):
    """Functional while: ``cond(*loop_vars)`` and ``body(*loop_vars)``
    build sub-blocks; returns the loop vars' final values.
    ``maximum_trip_count``: a bounded loop of that many trips, each
    masked by the condition, which gradients flow through and which a
    CUDA graph captures; without it the loop is unbounded (no
    gradient, run eagerly)."""
    helper = LayerHelper("while_loop", name=name)
    program = helper.main_program
    with _sub_block(program) as cond_block:
        cond_out = cond(*loop_vars)
    with _sub_block(program) as body_block:
        body_outs = body(*loop_vars)
    body_outs = body_outs if isinstance(body_outs, (list, tuple)) \
        else [body_outs]
    out_vars = [
        helper.block.create_var(
            name=helper.name_prefix + ".out%d" % i, shape=v.shape,
            dtype=v.dtype)
        for i, v in enumerate(loop_vars)]
    helper.append_op(
        type="while_loop", inputs={"LoopVars": list(loop_vars)},
        outputs={"Out": out_vars},
        attrs={"cond_block": cond_block.idx,
               "body_block": body_block.idx,
               "cond_out": cond_out.name,
               "loop_var_names": [v.name for v in loop_vars],
               "body_out_names": [v.name for v in body_outs],
               "out_names": [v.name for v in out_vars],
               "maximum_trip_count": maximum_trip_count or 0})
    return out_vars


def cond(pred, true_fn=None, false_fn=None, name=None):
    """``true_fn()`` if ``pred`` else ``false_fn()``, each built in its
    own sub-block; both must return the same number of vars."""
    helper = LayerHelper("cond", name=name)
    program = helper.main_program
    with _sub_block(program) as true_block:
        true_out = true_fn() if true_fn is not None else None
    with _sub_block(program) as false_block:
        false_out = false_fn() if false_fn is not None else None

    def _flat(o):
        if o is None:
            return []
        return list(o) if isinstance(o, (list, tuple)) else [o]

    t_outs, f_outs = _flat(true_out), _flat(false_out)
    assert len(t_outs) == len(f_outs), "cond branches must return same arity"
    outs = [helper.block.create_var(name=helper.name_prefix + ".out%d" % i,
                                    shape=v.shape, dtype=v.dtype)
            for i, v in enumerate(t_outs)]
    helper.append_op(
        type="cond", inputs={"Cond": [pred]}, outputs={"Out": outs},
        attrs={"true_block": true_block.idx,
               "false_block": false_block.idx,
               "true_outs": [v.name for v in t_outs],
               "false_outs": [v.name for v in f_outs],
               "out_names": [v.name for v in outs]})
    if true_out is None:
        return None
    if isinstance(true_out, (list, tuple)):
        return outs
    return outs[0]


def case(pred_fn_pairs, default=None, name=None):
    """The fn of the first pair whose pred holds, else ``default`` (the
    last pair's fn where there is none): nested ``cond``s."""
    if not pred_fn_pairs:
        raise ValueError("case needs at least one (pred, fn) pair")
    pred, fn = pred_fn_pairs[0]
    rest = pred_fn_pairs[1:]
    if rest:
        return cond(pred, fn, lambda: case(rest, default))
    if default is None:
        default = fn
    return cond(pred, fn, default)


def switch_case(branch_index, branch_fns, default=None, name=None):
    """Dispatch on an integer index: ``case`` over ``branch_index ==
    key`` for each key of ``branch_fns`` (a dict or a list)."""
    from . import tensor

    pairs = []
    items = branch_fns.items() if isinstance(branch_fns, dict) \
        else enumerate(branch_fns)
    for idx, fn in items:
        iv = tensor.fill_constant([1], "int64", int(idx))
        pairs.append((equal(branch_index, iv), fn))
    return case(pairs, default)


class Switch:
    """Branches that assign outer vars, the first whose condition holds
    running (the learning-rate schedules' idiom):

        with layers.Switch() as switch:
            with switch.case(cond):
                layers.assign(a, out)
            with switch.default():
                layers.assign(b, out)
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self._cases = []  # (cond var or None, block idx)

    @contextlib.contextmanager
    def case(self, condition):
        with _sub_block(self.helper.main_program) as blk:
            yield
        self._cases.append((condition, blk.idx))

    @contextlib.contextmanager
    def default(self):
        with _sub_block(self.helper.main_program) as blk:
            yield
        self._cases.append((None, blk.idx))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        self.helper.append_op(
            type="switch",
            inputs={"Conds": [c for c, _ in self._cases if c is not None]},
            outputs={},
            attrs={"blocks": [b for _, b in self._cases],
                   "has_default": any(c is None for c, _ in self._cases)})
        return False


class StaticRNN:
    """An RNN over time-major inputs of a static length:

        rnn = StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)          # x: (T, B, D)
            h_prev = rnn.memory(init=h0)     # or shape=, value=
            h = layers.fc([x_t, h_prev], ...)
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        outs = rnn()                         # (T, B, ...) stacked
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self._block = None
        self._seq_inputs = []  # (outer var, in-block var)
        self._memories = []    # [init outer var, pre var, post var]
        self._outputs = []

    @contextlib.contextmanager
    def step(self):
        program = self.helper.main_program
        self._block = program._create_block()
        try:
            yield
        finally:
            program._rollback()
            self._append_op()

    def step_input(self, x):
        """The step's slice of ``x`` (time-major)."""
        v = self._block.create_var(
            name=self.helper.name_prefix + ".x%d" % len(self._seq_inputs),
            shape=tuple(x.shape[1:]), dtype=x.dtype)
        self._seq_inputs.append((x, v))
        return v

    def memory(self, init=None, shape=None, value=0.0, batch_ref=None,
               dtype="float32"):
        """A state carried across steps, from ``init`` or a ``shape``
        filled with ``value`` (built in the parent block)."""
        from . import tensor

        if init is None:
            assert shape is not None
            program = self.helper.main_program
            cur = program.current_block_idx
            program.current_block_idx = self._block.parent_idx
            init = tensor.fill_constant(shape, dtype, value)
            program.current_block_idx = cur
        pre = self._block.create_var(
            name=self.helper.name_prefix + ".mem%d" % len(self._memories),
            shape=init.shape, dtype=init.dtype)
        self._memories.append([init, pre, None])
        return pre

    def update_memory(self, mem, new):
        for m in self._memories:
            if m[1] is mem:
                m[2] = new
                return
        raise ValueError("update_memory: unknown memory var")

    def step_output(self, o):
        self._outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _append_op(self):
        helper = self.helper
        self._out_vars = [
            helper.block.create_var(
                name=helper.name_prefix + ".out%d" % i,
                shape=(-1,) + tuple(o.shape), dtype=o.dtype)
            for i, o in enumerate(self._outputs)]
        helper.append_op(
            type="static_rnn",
            inputs={"SeqIn": [x for x, _ in self._seq_inputs],
                    "MemInit": [m[0] for m in self._memories]},
            outputs={"Out": self._out_vars},
            attrs={"sub_block": self._block.idx,
                   "seq_inputs": [x.name for x, _ in self._seq_inputs],
                   "step_inputs": [v.name for _, v in self._seq_inputs],
                   "mem_init": [m[0].name for m in self._memories],
                   "mem_pre": [m[1].name for m in self._memories],
                   "mem_post": [m[2].name for m in self._memories],
                   "step_outputs": [o.name for o in self._outputs],
                   "out_names": [v.name for v in self._out_vars],
                   "final_mem_names": []})

    def __call__(self):
        if len(self._out_vars) == 1:
            return self._out_vars[0]
        return self._out_vars


# -- the bounded tensor array --------------------------------------------------
# a [bound, ...element] buffer plus its int32 length under name@ALEN
# (fluid/ops/control_flow.py). An array written inside a loop must be
# created with ``element_shape`` (and ``bound``), so it has its final
# shape before the first trip.

DEFAULT_TENSOR_ARRAY_BOUND = 128


def create_array(dtype, element_shape=None, bound=None):
    """A bounded tensor array of ``bound`` slots (128 by default).
    Without ``element_shape``, the first write sizes the buffer."""
    helper = LayerHelper("create_array")
    out = helper.create_variable_for_type_inference(dtype)
    out.is_tensor_array = True
    out._ta_bound = int(bound or DEFAULT_TENSOR_ARRAY_BOUND)
    helper.append_op(
        type="create_array", inputs={}, outputs={"Out": [out]},
        attrs={"dtype": dtype,
               "element_shape": [int(s) for s in element_shape]
               if element_shape else [],
               "bound": out._ta_bound})
    return out


def _as_index_var(i):
    from . import tensor

    if isinstance(i, int):
        return tensor.fill_constant([1], "int32", i)
    return i


def array_write(x, i, array=None):
    """Write ``x`` into slot ``i`` (a python int or an int var); returns
    the array. An index past the bound writes the last slot."""
    if array is None:
        array = create_array(x.dtype)
    helper = LayerHelper("array_write")
    helper.append_op(
        type="array_write",
        inputs={"X": [x], "I": [_as_index_var(i)], "Array": [array]},
        outputs={"Out": [array]},
        attrs={"bound": getattr(array, "_ta_bound",
                                DEFAULT_TENSOR_ARRAY_BOUND)})
    return array


def array_read(array, i):
    """Slot ``i`` of ``array``."""
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op(type="array_read",
                     inputs={"X": [array], "I": [_as_index_var(i)]},
                     outputs={"Out": [out]})
    return out


def array_length(array):
    """The number of slots written, int32 [1] (the highest index written
    plus one)."""
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference("int32")
    out.shape = (1,)
    helper.append_op(type="array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    return out
