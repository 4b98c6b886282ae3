"""Recurrent and decoding layers (counterpart of
``paddle_tpu/fluid/layers/rnn.py``): the cells (``GRUCell``,
``LSTMCell``), ``rnn`` unrolled over a padded batch, the one-step
layers ``gru_unit`` and ``lstm_unit``, and beam search
(``BeamSearchDecoder``, ``dynamic_decode``, ``beam_search``,
``beam_search_decode``, ``gather_tree``).

- ``rnn(cell, inputs)`` unrolls the cell over the static time axis at
  build time, one cell call a step; ``sequence_length`` holds each
  row's state past its length (a ``sequence_mask`` blend).
- A cell creates its parameters once, at its first call, and every step
  shares them; a named cell pins their names, so a decode program built
  apart resolves the training program's parameters from the scope.
- ``dynamic_decode`` unrolls ``max_step_num`` steps; a finished beam
  keeps offering ``end_id`` at its own score (``ops/rnn_ops.py``). The
  whole loop is static-shaped device work, so it is captured into one
  CUDA graph on the card.

``dynamic_lstm``, ``dynamic_lstmp`` and ``dynamic_gru`` run an LSTM
or a GRU over LoD sequences (``ops/rnn_ops.py``: time-major over the
input's time bound); ``lstm`` runs the cudnn LSTM's stacked layers over
a padded ``[T, B, I]`` batch from one flat weight blob.
"""

import copy

from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from . import control_flow, nn, sequence_lod, tensor

__all__ = [
    "RNNCell", "GRUCell", "LSTMCell", "Decoder", "BeamSearchDecoder", "rnn",
    "dynamic_decode", "dynamic_lstm", "dynamic_lstmp", "dynamic_gru",
    "gru_unit", "lstm_unit", "lstm", "beam_search", "beam_search_decode",
    "gather_tree",
]


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """An LSTM over LoD sequences (the reference's ``dynamic_lstm``):
    ``input`` is the projected [rows, 4H] gates (an fc before it),
    ``size`` 4H. Returns (hidden, cell), each [rows, H] with the
    input's lengths."""
    helper = LayerHelper("dynamic_lstm", **locals())
    H = size // 4
    w = helper.create_parameter(param_attr, [H, 4 * H], dtype)
    bias_size = 7 * H if use_peepholes else 4 * H
    b = helper.create_parameter(bias_attr, [1, bias_size], dtype,
                                is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    hidden.shape = cell.shape = (-1, H)
    hidden.lod_level = cell.lod_level = 1
    inputs = {"Input": [input], "Weight": [w], "Bias": [b]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    helper.append_op(
        type="dynamic_lstm", inputs=inputs,
        outputs={"Hidden": [hidden], "Cell": [cell]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation})
    return hidden, cell


def dynamic_lstmp(input, size, proj_size, h_0=None, c_0=None,
                  param_attr=None, bias_attr=None, use_peepholes=True,
                  is_reverse=False, gate_activation="sigmoid",
                  cell_activation="tanh", candidate_activation="tanh",
                  proj_activation="tanh", dtype="float32",
                  cell_clip=None, proj_clip=None, name=None):
    """``dynamic_lstm`` with a recurrent projection [H, proj_size]
    (``proj_activation``) and ``cell_clip``. Returns (projection,
    cell)."""
    helper = LayerHelper("dynamic_lstmp", **locals())
    H = size // 4
    w = helper.create_parameter(param_attr, [proj_size, 4 * H], dtype)
    wp = helper.create_parameter(None, [H, proj_size], dtype)
    bias_size = 7 * H if use_peepholes else 4 * H
    b = helper.create_parameter(bias_attr, [1, bias_size], dtype,
                                is_bias=True)
    proj = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    proj.shape, cell.shape = (-1, proj_size), (-1, H)
    proj.lod_level = cell.lod_level = 1
    inputs = {"Input": [input], "Weight": [w], "ProjWeight": [wp],
              "Bias": [b]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    helper.append_op(
        type="dynamic_lstmp", inputs=inputs,
        outputs={"Projection": [proj], "Cell": [cell]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation,
               "proj_activation": proj_activation,
               "cell_clip": float(cell_clip or 0.0)})
    return proj, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None,
                origin_mode=False, name=None):
    """A GRU over LoD sequences (the reference's ``dynamic_gru``):
    ``input`` is the projected [rows, 3H] gates (an fc before it),
    ``size`` H. Returns the hidden [rows, H] with the input's
    lengths."""
    helper = LayerHelper("dynamic_gru", **locals())
    dtype = "float32"
    w = helper.create_parameter(param_attr, [size, 3 * size], dtype)
    b = helper.create_parameter(bias_attr, [1, 3 * size], dtype,
                                is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    hidden.shape = (-1, size)
    hidden.lod_level = 1
    inputs = {"Input": [input], "Weight": [w], "Bias": [b]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    helper.append_op(
        type="dynamic_gru", inputs=inputs, outputs={"Hidden": [hidden]},
        attrs={"is_reverse": is_reverse, "gate_activation": gate_activation,
               "activation": candidate_activation,
               "origin_mode": origin_mode})
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid",
             origin_mode=False):
    """One GRU step: ``input`` is the projected [B, 3H] gates, ``size``
    3H. Returns (hidden, reset hidden, gate)."""
    helper = LayerHelper("gru_unit", **locals())
    H = size // 3
    dtype = "float32"
    w = helper.create_parameter(param_attr, [H, 3 * H], dtype)
    b = helper.create_parameter(bias_attr, [1, 3 * H], dtype, is_bias=True)
    gate = helper.create_variable_for_type_inference(dtype)
    reset_h = helper.create_variable_for_type_inference(dtype)
    updated = helper.create_variable_for_type_inference(dtype)
    gate.shape = (-1, 3 * H)
    reset_h.shape = updated.shape = (-1, H)
    helper.append_op(
        type="gru_unit",
        inputs={"Input": [input], "HiddenPrev": [hidden], "Weight": [w],
                "Bias": [b]},
        outputs={"Gate": [gate], "ResetHiddenPrev": [reset_h],
                 "Hidden": [updated]},
        attrs={"activation": activation, "gate_activation": gate_activation,
               "origin_mode": origin_mode})
    return updated, reset_h, gate


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step: [x_t, h_prev] projected to the 4H gates by an fc,
    then the cell. Returns (h, c)."""
    helper = LayerHelper("lstm_unit", **locals())
    H = hidden_t_prev.shape[-1]
    concat = tensor.concat([x_t, hidden_t_prev], axis=1)
    gates = nn.fc(concat, size=4 * H, param_attr=param_attr,
                  bias_attr=bias_attr)
    c = helper.create_variable_for_type_inference(x_t.dtype)
    h = helper.create_variable_for_type_inference(x_t.dtype)
    c.shape = h.shape = (-1, H)
    helper.append_op(
        type="lstm_unit", inputs={"X": [gates], "C_prev": [cell_t_prev]},
        outputs={"C": [c], "H": [h]},
        attrs={"forget_bias": float(forget_bias)})
    return h, c


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    """The cudnn LSTM (the reference's ``layers.lstm``): ``num_layers``
    stacked LSTMs over a padded [T, B, I] ``input`` from ``init_h`` /
    ``init_c`` [num_layers, B, H], all weights in one flat parameter;
    ``dropout_prob`` between layers in training. Returns (out [T, B, H],
    last_h, last_c [num_layers, B, H])."""
    if is_bidirec:
        raise NotImplementedError("bidirectional cudnn-style lstm: compose "
                                  "two dynamic_lstm(is_reverse=) passes")
    helper = LayerHelper("cudnn_lstm", **locals())
    dtype = "float32"
    I = input.shape[-1]
    size = 0
    for layer in range(num_layers):
        in_dim = I if layer == 0 else hidden_size
        size += (in_dim + hidden_size + 1) * 4 * hidden_size
    w = helper.create_parameter(ParamAttr(initializer=default_initializer)
                                if default_initializer else None,
                                [size], dtype)
    out = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    last_c = helper.create_variable_for_type_inference(dtype)
    out.shape = (-1, -1, hidden_size)
    helper.append_op(
        type="cudnn_lstm",
        inputs={"Input": [input], "InitH": [init_h], "InitC": [init_c],
                "W": [w]},
        outputs={"Out": [out], "LastH": [last_h], "LastC": [last_c]},
        attrs={"hidden_size": int(hidden_size),
               "num_layers": int(num_layers),
               "dropout_prob": float(dropout_prob), "is_test": is_test})
    return out, last_h, last_c


# -- cells and rnn() ---------------------------------------------------------------


class RNNCell:
    """A cell: ``call(inputs, states)`` appends one step's ops and returns
    (outputs, new_states)."""

    def call(self, inputs, states):
        raise NotImplementedError

    def __call__(self, inputs, states):
        return self.call(inputs, states)

    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0, batch_dim_idx=0):
        shape = list(shape or [self.hidden_size])
        return tensor.fill_constant_batch_size_like(
            batch_ref, [-1] + shape, dtype, init_value,
            input_dim_idx=batch_dim_idx)

    @property
    def state_shape(self):
        return [self.hidden_size]


class GRUCell(RNNCell):
    """A GRU step as ``mul`` (x Wx) then ``gru_unit`` (with Wh and the
    bias). Parameters ``<name>.wx`` [in, 3H], ``<name>.wh`` [H, 3H] and
    ``<name>.b`` [1, 3H] when the cell is named."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 gate_activation="sigmoid", activation="tanh",
                 origin_mode=False, name=None):
        self.hidden_size = hidden_size
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self._gate_act = gate_activation
        self._act = activation
        self._origin = origin_mode
        self._name = name
        self._wx = self._wh = self._b = None

    def _named(self, attr, suffix):
        """``attr`` with the pinned name ``<cell name>.<suffix>`` filled
        in when the cell is named and the attr names nothing (an attr's
        own name wins; ``False``, no parameter, passes through)."""
        if self._name is None:
            return attr
        pinned = "%s.%s" % (self._name, suffix)
        if attr is None:
            return ParamAttr(name=pinned)
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return attr
        if getattr(attr, "name", None) is None:
            attr = copy.copy(attr)
            attr.name = pinned
        return attr

    def _ensure_params(self, in_dim):
        if self._wx is not None:
            return
        helper = LayerHelper("gru_cell")
        H = self.hidden_size
        self._wx = helper.create_parameter(
            self._named(self._param_attr, "wx"), [in_dim, 3 * H], "float32")
        self._wh = helper.create_parameter(self._named(None, "wh"),
                                           [H, 3 * H], "float32")
        self._b = helper.create_parameter(
            self._named(self._bias_attr, "b"), [1, 3 * H], "float32",
            is_bias=True)

    def call(self, inputs, states):
        self._ensure_params(int(inputs.shape[-1]))
        helper = LayerHelper("gru_cell_step")
        H = self.hidden_size
        gates = helper.create_variable_for_type_inference("float32")
        gates.shape = (-1, 3 * H)
        helper.append_op(type="mul",
                         inputs={"X": [inputs], "Y": [self._wx]},
                         outputs={"Out": [gates]},
                         attrs={"x_num_col_dims": 1, "y_num_col_dims": 1})
        gate = helper.create_variable_for_type_inference("float32")
        reset_h = helper.create_variable_for_type_inference("float32")
        updated = helper.create_variable_for_type_inference("float32")
        gate.shape = (-1, 3 * H)
        reset_h.shape = updated.shape = (-1, H)
        unit_inputs = {"Input": [gates], "HiddenPrev": [states],
                       "Weight": [self._wh]}
        if self._b is not None:
            unit_inputs["Bias"] = [self._b]
        helper.append_op(
            type="gru_unit", inputs=unit_inputs,
            outputs={"Gate": [gate], "ResetHiddenPrev": [reset_h],
                     "Hidden": [updated]},
            attrs={"activation": self._act,
                   "gate_activation": self._gate_act,
                   "origin_mode": self._origin})
        return updated, updated


class LSTMCell(RNNCell):
    """An LSTM step as ``concat`` [x, h], ``mul`` by W [in + H, 4H], the
    bias, then ``lstm_unit`` (``forget_bias`` 1.0 by default, where the
    ``lstm_unit`` layer's is 0.0). States are [h, c]."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 gate_activation="sigmoid", activation="tanh",
                 forget_bias=1.0, name=None):
        self.hidden_size = hidden_size
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self._forget_bias = forget_bias
        self._name = name
        self._w = self._b = None

    _named = GRUCell._named

    def _ensure_params(self, in_dim):
        if self._w is not None:
            return
        helper = LayerHelper("lstm_cell")
        H = self.hidden_size
        self._w = helper.create_parameter(
            self._named(self._param_attr, "w"), [in_dim + H, 4 * H],
            "float32")
        self._b = helper.create_parameter(
            self._named(self._bias_attr, "b"), [1, 4 * H], "float32",
            is_bias=True)

    def call(self, inputs, states):
        h, c = states
        self._ensure_params(int(inputs.shape[-1]))
        helper = LayerHelper("lstm_cell_step")
        H = self.hidden_size
        concat = tensor.concat([inputs, h], axis=1)
        gates = helper.create_variable_for_type_inference("float32")
        gates.shape = (-1, 4 * H)
        helper.append_op(type="mul",
                         inputs={"X": [concat], "Y": [self._w]},
                         outputs={"Out": [gates]},
                         attrs={"x_num_col_dims": 1, "y_num_col_dims": 1})
        if self._b is not None:
            biased = helper.create_variable_for_type_inference("float32")
            biased.shape = (-1, 4 * H)
            helper.append_op(type="elementwise_add",
                             inputs={"X": [gates], "Y": [self._b]},
                             outputs={"Out": [biased]}, attrs={"axis": -1})
            gates = biased
        new_c = helper.create_variable_for_type_inference("float32")
        new_h = helper.create_variable_for_type_inference("float32")
        new_c.shape = new_h.shape = (-1, H)
        helper.append_op(
            type="lstm_unit", inputs={"X": [gates], "C_prev": [c]},
            outputs={"C": [new_c], "H": [new_h]},
            attrs={"forget_bias": float(self._forget_bias)})
        return new_h, [new_h, new_c]

    @property
    def state_shape(self):
        return [[self.hidden_size], [self.hidden_size]]

    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0, batch_dim_idx=0):
        return [tensor.fill_constant_batch_size_like(
            batch_ref, [-1, self.hidden_size], dtype, init_value,
            input_dim_idx=batch_dim_idx) for _ in range(2)]


def _map_state(states, fn):
    if isinstance(states, (list, tuple)):
        return [_map_state(s, fn) for s in states]
    return fn(states)


def _flatten(s):
    if isinstance(s, (list, tuple)):
        return [x for item in s for x in _flatten(item)]
    return [s]


def _zip_apply(new, old, fn):
    if isinstance(new, (list, tuple)):
        return [_zip_apply(a, b, fn) for a, b in zip(new, old)]
    return fn(new, old)


def rnn(cell, inputs, initial_states=None, sequence_length=None,
        time_major=False, is_reverse=False, **kwargs):
    """The cell over a padded batch, [B, T, ...] (or [T, B, ...] when
    ``time_major``), unrolled over the static T. Returns (outputs
    stacked on the time axis, final states). Past a row's
    ``sequence_length`` its state stays as it was."""
    t_axis = 0 if time_major else 1
    T = inputs.shape[t_axis]
    if T is None or int(T) < 0:
        raise ValueError("rnn() needs a static time dimension")
    T = int(T)
    if initial_states is None:
        initial_states = cell.get_initial_states(
            inputs, batch_dim_idx=1 if time_major else 0)
    mask = None
    if sequence_length is not None:
        mask = sequence_lod.sequence_mask(sequence_length, maxlen=T,
                                          dtype="float32")  # [B, T]
    states = initial_states
    outputs = []
    for t in (range(T - 1, -1, -1) if is_reverse else range(T)):
        x_t = nn.squeeze(nn.slice(inputs, [t_axis], [t], [t + 1]),
                         [t_axis])
        out, new_states = cell(x_t, states)
        if mask is not None:
            m = nn.slice(mask, [1], [t], [t + 1])  # [B, 1]

            def gate(new, old, _m=m):
                return nn.elementwise_add(
                    nn.elementwise_mul(new, _m, axis=0),
                    nn.elementwise_mul(
                        old, nn.scale(_m, scale=-1.0, bias=1.0), axis=0))

            new_states = _zip_apply(new_states, states, gate)
        outputs.append(out)
        states = new_states
    if is_reverse:
        outputs = outputs[::-1]
    return nn.stack(outputs, axis=t_axis), states


# -- decoding ------------------------------------------------------------------


class Decoder:
    """A decoder ``dynamic_decode`` drives: ``initialize``, ``step``,
    ``finalize``."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        return outputs, final_states

    @property
    def tracks_own_finished(self):
        return False


class BeamSearchDecoder(Decoder):
    """Beam search over [batch * beam] rows: each step runs the cell,
    ``output_fn`` and a softmax, selects with the ``beam_search`` op,
    gathers the cell states by parent row and marks beams that emitted
    ``end_token``; ``finalize`` backtracks the sequences with
    ``gather_tree``."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """[B, ...] -> [B*beam, ...], each row repeated ``beam_size``
        times."""
        expanded = nn.unsqueeze(x, [1])
        tiled = nn.expand(expanded,
                          [1, beam_size] + [1] * (len(x.shape) - 1))
        return nn.reshape(tiled, [-1] + [int(s) for s in x.shape[1:]])

    def initialize(self, initial_cell_states):
        b = self.beam_size
        states = _map_state(initial_cell_states,
                            lambda s: self.tile_beam_merge_with_batch(s, b))
        ref = _flatten(states)[0]
        start = tensor.fill_constant_batch_size_like(
            ref, [-1, 1], "int64", self.start_token)
        # log-prob 0 for each group's first beam and -1e9 for the rest, so
        # the first selection draws every candidate from beam 0
        not_first = tensor.cast(_beam_pos(ref, b) > _zeros_i64(ref),
                                "float32")
        init_scores = nn.scale(not_first, scale=-1e9)
        inputs = self.embedding_fn(start) if self.embedding_fn else start
        finished = tensor.cast(
            tensor.fill_constant_batch_size_like(ref, [-1, 1], "int64", 0),
            "bool")
        return inputs, {"cell": states, "scores": init_scores,
                        "ids": start, "finished": finished}

    def step(self, time, inputs, states, **kwargs):
        cell_out, next_cell = self.cell(inputs, states["cell"])
        logits = self.output_fn(cell_out) if self.output_fn else cell_out
        probs = nn.softmax(logits)
        sel_ids, sel_scores, parent = beam_search(
            pre_ids=states["ids"], pre_scores=states["scores"], ids=None,
            scores=probs, beam_size=self.beam_size, end_id=self.end_token,
            is_accumulated=False)
        next_cell = _map_state(next_cell, lambda s: nn.gather(s, parent))
        next_inputs = (self.embedding_fn(sel_ids)
                       if self.embedding_fn else sel_ids)
        finished = nn.gather(states["finished"], parent)
        now_end = tensor.cast(
            control_flow.equal(tensor.cast(sel_ids, "int64"),
                               _const_like_i64(sel_ids, self.end_token)),
            "bool")
        finished = nn.logical_or(finished, now_end)
        next_states = {"cell": next_cell, "scores": sel_scores,
                       "ids": sel_ids, "finished": finished}
        outputs = {"ids": sel_ids, "parents": parent, "scores": sel_scores}
        return outputs, next_states, next_inputs, finished

    def finalize(self, outputs, final_states, sequence_lengths):
        """{"sequences": [T, B*beam] backtracked ids, "scores": the last
        step's scores}, and the final states."""
        ids = nn.squeeze(outputs["ids"], [2])
        parents = nn.squeeze(outputs["parents"], [2]) \
            if len(outputs["parents"].shape) > 2 else outputs["parents"]
        seqs = gather_tree(ids, parents, end_token=self.end_token,
                           beam_size=self.beam_size)
        return {"sequences": seqs, "scores": final_states["scores"]}, \
            final_states


def _zeros_i64(ref):
    return tensor.fill_constant_batch_size_like(ref, [-1, 1], "int64", 0)


def _beam_pos(ref, beam):
    """[B*beam, 1] int64: each row's position in its beam group."""
    helper = LayerHelper("beam_pos")
    out = helper.create_variable_for_type_inference("int64")
    out.shape = (-1, 1)
    helper.append_op(type="beam_pos", inputs={"X": [ref]},
                     outputs={"Out": [out]}, attrs={"beam_size": int(beam)})
    return out


def _const_like_i64(ref, v):
    return tensor.fill_constant_batch_size_like(ref, [-1, 1], "int64", int(v))


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, **kwargs):
    """``max_step_num`` decoder steps, unrolled (a static trip count); a
    finished beam keeps emitting ``end_id``. Returns the decoder's
    ``finalize`` of the step outputs stacked on a leading time axis."""
    if max_step_num is None:
        raise ValueError("dynamic_decode needs max_step_num (a static trip "
                         "count)")
    inputs, states = decoder.initialize(inits)[:2]
    step_outputs = {}
    for t in range(int(max_step_num)):
        outputs, states, inputs, _ = decoder.step(t, inputs, states)
        for k, v in outputs.items():
            step_outputs.setdefault(k, []).append(v)
    stacked = {k: nn.stack(v, axis=0) for k, v in step_outputs.items()}
    return decoder.finalize(stacked, states, None)


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=True):
    """One selection step over [batch * beam] rows grouped every
    ``beam_size``: the top ``beam_size`` (id, score) of each group and
    the row each came from (``parent_idx``, int32)."""
    helper = LayerHelper("beam_search", **locals())
    sel_ids = helper.create_variable_for_type_inference("int64")
    sel_scores = helper.create_variable_for_type_inference("float32")
    parent = helper.create_variable_for_type_inference("int32")
    sel_ids.shape = (-1, 1)
    sel_scores.shape = (-1, 1)
    parent.shape = (-1,)
    inputs = {"pre_ids": [pre_ids], "pre_scores": [pre_scores],
              "scores": [scores]}
    if ids is not None:
        inputs["ids"] = [ids]
    helper.append_op(
        type="beam_search", inputs=inputs,
        outputs={"selected_ids": [sel_ids], "selected_scores": [sel_scores],
                 "parent_idx": [parent]},
        attrs={"beam_size": int(beam_size), "end_id": int(end_id),
               "level": int(level), "is_accumulated": bool(is_accumulated)})
    if return_parent_idx:
        return sel_ids, sel_scores, parent
    return sel_ids, sel_scores


def beam_search_decode(ids, scores, beam_size, end_id, parents=None,
                       name=None):
    """The [T, B*beam] stacked ids backtracked through ``parents`` when
    given, and the scores."""
    helper = LayerHelper("beam_search_decode", **locals())
    out_ids = helper.create_variable_for_type_inference("int64")
    out_scores = helper.create_variable_for_type_inference("float32")
    inputs = {"Ids": [ids], "Scores": [scores]}
    if parents is not None:
        inputs["Parents"] = [parents]
    helper.append_op(
        type="beam_search_decode", inputs=inputs,
        outputs={"SentenceIds": [out_ids], "SentenceScores": [out_scores]},
        attrs={"beam_size": int(beam_size), "end_id": int(end_id)})
    return out_ids, out_scores


def gather_tree(ids, parents, end_token=None, beam_size=None):
    """Full sequences from [T, B*beam] step ids and parent rows."""
    helper = LayerHelper("gather_tree", **locals())
    out = helper.create_variable_for_type_inference(ids.dtype)
    out.shape = tuple(ids.shape)
    helper.append_op(type="gather_tree",
                     inputs={"Ids": [ids], "Parents": [parents]},
                     outputs={"Out": [out]},
                     attrs={"beam_size": -1 if beam_size is None
                            else int(beam_size)})
    return out
