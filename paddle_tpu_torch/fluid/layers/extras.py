"""SelectedRows and LoD-rebinding layers, and the row-wise control flow
``IfElse`` and ``DynamicRNN`` (counterparts in
``paddle_tpu/fluid/layers/extras.py``)."""

import contextlib

from ..layer_helper import LayerHelper

__all__ = ["lod_reset", "lod_append", "merge_selected_rows",
           "get_tensor_from_selected_rows", "IfElse", "DynamicRNN"]


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


def _select(cond, x, y):
    """Row-wise select (the ``where`` op's 3-input form): where ``cond``
    holds ``x``, else ``y``; the branch a row did not take cannot leak a
    NaN or an Inf into it."""
    helper = LayerHelper("where")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="where",
                     inputs={"Condition": [cond], "X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


class IfElse:
    """Row-wise conditional: rows where ``cond`` ([B, 1] bool) holds take
    the true block's outputs, the others the false block's. As in the
    reference's redesign, both blocks run on the whole batch and ``ie()``
    merges with a select (the same result for the row-independent
    computations IfElse takes), so nothing is read on the host.

        ie = IfElse(cond)
        with ie.true_block():
            ie.output(true_fn(ie.input(x)))
        with ie.false_block():
            ie.output(false_fn(ie.input(x)))
        out, = ie()
    """

    def __init__(self, cond, name=None):
        self._cond = cond
        self._outs = {True: [], False: []}
        self._in_branch = None

    @contextlib.contextmanager
    def true_block(self):
        self._in_branch = True
        try:
            yield
        finally:
            self._in_branch = None

    @contextlib.contextmanager
    def false_block(self):
        self._in_branch = False
        try:
            yield
        finally:
            self._in_branch = None

    def input(self, x):
        assert self._in_branch is not None, \
            "IfElse.input() only inside true_block()/false_block()"
        return x

    def output(self, *outs):
        assert self._in_branch is not None, \
            "IfElse.output() only inside true_block()/false_block()"
        self._outs[self._in_branch].extend(outs)

    def __call__(self):
        t, f = self._outs[True], self._outs[False]
        assert len(t) == len(f) and t, (
            "IfElse: both blocks must emit the same number of outputs")
        return [_select(self._cond, tv, fv) for tv, fv in zip(t, f)]


class DynamicRNN:
    """A variable-length RNN over LoD sequences, as the reference's
    redesign builds it: a ``StaticRNN`` over ``sequence_pad``'s [T, B,
    ...] view of ``maxlen`` steps, whose ``update_memory`` keeps a row's
    state once its sequence has ended and whose outputs are zero past
    each row's length. No host read; outputs come back [B, T, ...].

        drnn = DynamicRNN(maxlen=T)
        with drnn.block():
            x_t = drnn.step_input(x)          # x: LoD [rows, D]
            h_prev = drnn.memory(shape=[H], value=0.0)
            h = some_layers(x_t, h_prev)
            drnn.update_memory(h_prev, h)
            drnn.output(h)
        out = drnn()                          # [B, T, H]
    """

    def __init__(self, name=None, maxlen=None):
        from .control_flow import StaticRNN

        self._rnn = StaticRNN(name=name or "dynamic_rnn")
        self._maxlen = maxlen
        self._lengths = None       # [B] int32 lengths (outer block)
        self._padded_ref = None    # [B, T, D] padded view (outer block)
        self._t = None             # [1] step counter (step block)
        self._mask = None          # [B] in-step validity mask
        self._helper = LayerHelper(name or "dynamic_rnn")

    @contextlib.contextmanager
    def block(self):
        with self._rnn.step():
            yield

    def _step_mask(self):
        from .control_flow import less_than

        if self._mask is None:
            assert self._t is not None, "call step_input() first"
            self._mask = less_than(self._t, self._lengths)
        return self._mask

    def _rowwise_mask(self, ref):
        """The [B] mask, [B, 1] for operands of rank 2 or more."""
        from . import nn

        mask = self._step_mask()
        if len(ref.shape) >= 2 or not ref.shape:
            mask = nn.unsqueeze(mask, [1])
        return mask

    def step_input(self, x, level=0):
        """The step's [B, D] slice of the LoD sequence ``x``."""
        from . import nn, sequence_lod, tensor

        assert self._maxlen is not None, (
            "DynamicRNN(maxlen=T) is required: the step count is static")
        program = self._helper.main_program
        blk_idx = program.current_block_idx
        # the padded view and the step counter are built in the parent
        program.current_block_idx = self._rnn._block.parent_idx
        pad0 = tensor.fill_constant([1], x.dtype, 0.0)
        padded, length = sequence_lod.sequence_pad(
            x, pad0, maxlen=self._maxlen)
        if self._lengths is None:
            self._lengths = tensor.cast(length, "int32")
            self._padded_ref = padded
        rank = len(x.shape) + 1
        tm = nn.transpose(padded, [1, 0] + list(range(2, rank)))
        if self._t is None:
            T = int(self._maxlen)
            counter = nn.reshape(tensor.range(0, T, 1, "int32"), [T, 1])
            self._t = self._rnn.step_input(counter)
        program.current_block_idx = blk_idx
        return self._rnn.step_input(tm)

    def static_input(self, x):
        """A non-sequence input every step sees (the step block reads
        outer vars directly)."""
        return x

    def memory(self, init=None, shape=None, value=0.0, need_reorder=False,
               dtype="float32", batch_ref=None):
        from . import tensor

        if init is None and shape is not None:
            assert self._padded_ref is not None, (
                "call step_input() before memory(shape=...)")
            program = self._helper.main_program
            cur = program.current_block_idx
            program.current_block_idx = self._rnn._block.parent_idx
            init = tensor.fill_constant_batch_size_like(
                self._padded_ref, shape=[1] + list(shape), dtype=dtype,
                value=value, input_dim_idx=0, output_dim_idx=0)
            program.current_block_idx = cur
            return self._rnn.memory(init=init)
        return self._rnn.memory(init=init, shape=shape, value=value,
                                dtype=dtype)

    def update_memory(self, ex_mem, new_mem):
        """Rows whose sequence has ended keep their state."""
        merged = _select(self._rowwise_mask(new_mem), new_mem, ex_mem)
        self._rnn.update_memory(ex_mem, merged)

    def output(self, *outputs):
        """Per-step outputs, zero past each row's length."""
        from . import tensor

        for o in outputs:
            zero = tensor.fill_constant([1], o.dtype, 0.0)
            self._rnn.step_output(
                _select(self._rowwise_mask(o), o, zero))

    def __call__(self):
        from . import nn

        outs = self._rnn()
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        dense = [nn.transpose(o, [1, 0] +
                              list(range(2, max(len(o.shape), 2))))
                 for o in outs]
        return dense[0] if len(dense) == 1 else dense
