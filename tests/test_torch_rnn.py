"""The port's recurrent, beam-search and small tensor ops
(paddle_tpu_torch/fluid/ops/rnn_ops.py, sequence_ops.py and the ops the
recurrent layers, schedules and clips lower to), its ``layers.rnn`` over
GRUCell and LSTMCell, and its refusals, held to the JAX package on the
CPU.

- Ops: the same seeded numpy inputs through both registries' lowerings
  of one op. Integer outputs (ids, parents, masks) exactly; fp32 at
  rtol 1e-5, atol 1e-6 (the same math in another order). The
  reference runs with 64-bit types off, so its int64 ids come back as
  int32: values are compared, not types.
- ``beam_search``: finished beams, ``is_accumulated`` both ways, and
  planted ties (equal scores within and across beams, the -1e9 of
  step 0's beams), where the selection order decides the parents: the
  port's order (score descending, then candidate index ascending) must
  give the reference's ``jax.lax.top_k`` ids and parents exactly.
- Gradients of ``gru_unit`` (both modes) and ``lstm_unit`` through each
  package's ``autodiff`` op (``append_backward``), a cotangent on every
  output, rtol 1e-5.
- ``rnn``: the same program desc in both packages inside
  ``unique_name.guard()``; outputs and final states from the
  reference's startup state at rtol 1e-5, with ``sequence_length``,
  ``is_reverse`` and ``time_major``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import framework as JF
from paddle_tpu.fluid import registry as JR
import paddle_tpu_torch.fluid as pfluid
from paddle_tpu_torch.fluid import framework as PF
from paddle_tpu_torch.fluid import registry as PR

RTOL, ATOL = 1e-5, 1e-6

_R = np.random.RandomState(20)


def _f(*shape, scale=1.0, shift=0.0):
    return (_R.randn(*shape) * scale + shift).astype(np.float32)


def _desc(op_type, inputs, outputs, attrs):
    """A one-op program desc: ``inputs`` {slot: {name: array}},
    ``outputs`` {slot: [name]}."""
    vars_ = {}
    for items in inputs.values():
        for name, arr in items.items():
            vars_[name] = dict(name=name, shape=list(arr.shape),
                               dtype=str(arr.dtype), persistable=False,
                               stop_gradient=False, is_data=False,
                               is_parameter=False, trainable=False)
    for names in outputs.values():
        for name in names:
            vars_.setdefault(name, dict(
                name=name, shape=[], dtype="float32", persistable=False,
                stop_gradient=False, is_data=False, is_parameter=False,
                trainable=False))
    op = dict(type=op_type, inputs={s: list(d) for s, d in inputs.items()},
              outputs=dict(outputs), attrs=dict(attrs))
    return dict(version=1, random_seed=0, param_grad_map={},
                blocks=[dict(idx=0, parent_idx=-1, vars=list(vars_.values()),
                             ops=[op])])


def _lower_both(op_type, inputs, outputs, attrs):
    """{output name: (reference's, port's)} as numpy."""
    desc = _desc(op_type, inputs, outputs, attrs)
    feeds = {n: a for d in inputs.values() for n, a in d.items()}
    jblock = JF.Program.from_desc(desc).global_block()
    jenv = {n: jnp.asarray(a) for n, a in feeds.items()}
    JR.lower_op(JR.LowerCtx(jblock, jenv, jax.random.PRNGKey(0)),
                jblock.ops[0])
    pblock = PF.Program.from_desc(desc).global_block()
    penv = {n: torch.tensor(a) for n, a in feeds.items()}
    PR.lower_op(PR.LowerCtx(pblock, penv, torch.Generator().manual_seed(0),
                            "cpu"), pblock.ops[0])
    return {n: (np.asarray(jenv[n]), penv[n].numpy())
            for names in outputs.values() for n in names}


def _check(pairs, exact=()):
    for name, (want, got) in pairs.items():
        assert got.shape == want.shape, name
        if name in exact:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got.astype(np.float32),
                                       want.astype(np.float32), rtol=RTOL,
                                       atol=ATOL, err_msg=name)


# -- the small tensor ops -----------------------------------------------------------

I64 = np.int64
SMALL_CASES = [
    ("split", {"X": {"x": _f(4, 6)}}, {"Out": ["a", "b", "c"]},
     {"axis": 1, "num": 3, "sections": []}, ()),
    ("split", {"X": {"x": _f(5, 3)}}, {"Out": ["a", "b"]},
     {"axis": 0, "num": 0, "sections": [2, 3]}, ()),
    ("slice", {"Input": {"x": _f(3, 5, 4)}}, {"Out": ["o"]},
     {"axes": [1, 2], "starts": [1, -3], "ends": [4, 100]}, ()),
    ("stack", {"X": {"x": _f(2, 3), "y": _f(2, 3)}}, {"Y": ["o"]},
     {"axis": 1}, ()),
    ("squeeze", {"X": {"x": _f(3, 1, 4, 1)}}, {"Out": ["o"]},
     {"axes": [1, 2, -1]}, ()),
    ("squeeze", {"X": {"x": _f(1, 3, 1)}}, {"Out": ["o"]}, {"axes": []}, ()),
    ("expand", {"X": {"x": _f(2, 1, 3)}}, {"Out": ["o"]},
     {"expand_times": [1, 4, 2]}, ()),
    ("increment", {"X": {"x": np.array([5], I64)}}, {"Out": ["o"]},
     {"step": 1.0}, ("o",)),
    ("increment", {"X": {"x": _f(2)}}, {"Out": ["x"]}, {"step": 2.5}, ()),
    ("fill_constant_batch_size_like", {"Input": {"x": _f(3, 7)}},
     {"Out": ["o"]}, {"shape": [-1, 1, 2], "dtype": "int64", "value": 4.0,
                      "input_dim_idx": 1, "output_dim_idx": 0}, ("o",)),
    ("logical_or", {"X": {"x": _R.rand(4, 3) > 0.5},
                    "Y": {"y": _R.rand(4, 3) > 0.5}}, {"Out": ["o"]}, {},
     ("o",)),
    ("elementwise_min", {"X": {"x": _f(3, 4)}, "Y": {"y": _f(4)}},
     {"Out": ["o"]}, {"axis": -1}, ()),
    ("elementwise_max", {"X": {"x": _f(3, 4)}, "Y": {"y": _f(3)}},
     {"Out": ["o"]}, {"axis": 0}, ()),
    ("elementwise_pow", {"X": {"x": np.abs(_f(3, 4)) + 0.1},
                         "Y": {"y": _f(1)}}, {"Out": ["o"]}, {"axis": -1},
     ()),
    ("clip", {"X": {"x": _f(5, 4)}}, {"Out": ["o"]},
     {"min": -0.3, "max": 0.5}, ()),
    ("clip_by_norm", {"X": {"x": _f(5, 4)}}, {"Out": ["o"]},
     {"max_norm": 1.0}, ()),
    ("clip_by_norm", {"X": {"x": _f(5, 4, scale=0.01)}}, {"Out": ["o"]},
     {"max_norm": 1.0}, ()),
    ("sequence_mask", {"X": {"x": np.array([0, 3, 5, 1], I64)}},
     {"Out": ["o"]}, {"maxlen": 5, "out_dtype": "float32"}, ("o",)),
    ("sequence_mask", {"X": {"x": np.array([[2], [4]], I64)}},
     {"Out": ["o"]}, {"maxlen": 6, "out_dtype": "int64"}, ("o",)),
] + [(name, {"X": {"x": np.abs(_f(4, 5)) + 0.01 if name == "sqrt"
                   else _f(4, 5, scale=3.0)}}, {"Out": ["o"]}, {}, ())
      for name in ("exp", "floor", "ceil", "cos", "sqrt", "square")]


@pytest.mark.parametrize("op_type,inputs,outputs,attrs,exact", SMALL_CASES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(SMALL_CASES)])
def test_small_ops_match_reference(op_type, inputs, outputs, attrs, exact):
    _check(_lower_both(op_type, inputs, outputs, attrs), exact)


def _probs(*shape):
    x = _f(*shape)
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("soft,ignore", [(False, -100), (False, 2),
                                         (True, -100)])
def test_cross_entropy_matches_reference(soft, ignore):
    p = _probs(6, 5)
    p[0, 3] = 0.0          # a zero probability: clipped at 1e-20
    if soft:
        label = _probs(6, 5)
    else:
        label = np.array([[3], [1], [2], [0], [2], [4]], I64)
    _check(_lower_both("cross_entropy", {"X": {"p": p}, "Label": {"l": label}},
                       {"Y": ["y"]},
                       {"soft_label": soft, "ignore_index": ignore}))


# -- recurrent units ----------------------------------------------------------------

GRU_MODES = [("tanh", "sigmoid", False), ("tanh", "sigmoid", True),
             (2, 1, False), (3, 1, True), ("identity", "sigmoid", False)]


@pytest.mark.parametrize("act,gate_act,origin", GRU_MODES)
def test_gru_unit_matches_reference(act, gate_act, origin):
    B, H = 4, 6
    _check(_lower_both(
        "gru_unit",
        {"Input": {"g": _f(B, 3 * H)}, "HiddenPrev": {"h": _f(B, H)},
         "Weight": {"w": _f(H, 3 * H, scale=0.5)},
         "Bias": {"b": _f(1, 3 * H)}},
        {"Gate": ["gate"], "ResetHiddenPrev": ["reset"], "Hidden": ["hid"]},
        {"activation": act, "gate_activation": gate_act,
         "origin_mode": origin}))


@pytest.mark.parametrize("forget_bias", [0.0, 1.0])
def test_lstm_unit_matches_reference(forget_bias):
    B, H = 3, 5
    _check(_lower_both("lstm_unit",
                       {"X": {"g": _f(B, 4 * H)}, "C_prev": {"c": _f(B, H)}},
                       {"C": ["c_out"], "H": ["h_out"]},
                       {"forget_bias": forget_bias}))


def _unit_grads(fluid, op_type, inputs, outputs, attrs, cots):
    """Gradients of sum_o(out_o * cot_o) with respect to every input
    (each a parameter set to the given array), through the package's
    ``append_backward`` (one ``autodiff`` op) and executor."""
    from_fluid = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        params = {n: from_fluid.create_parameter(list(a.shape), "float32",
                                                 name=n)
                  for d in inputs.values() for n, a in d.items()}
        helper = fluid.layer_helper.LayerHelper(op_type)
        outs = {slot: [helper.create_variable_for_type_inference("float32")
                       for _ in names] for slot, names in outputs.items()}
        helper.append_op(
            type=op_type,
            inputs={s: [params[n] for n in d] for s, d in inputs.items()},
            outputs=outs, attrs=attrs)
        terms = []
        for slot, (var,) in outs.items():
            cot = from_fluid.data("cot_" + slot, list(cots[slot].shape),
                                  append_batch_size=False)
            terms.append(from_fluid.reduce_sum(
                from_fluid.elementwise_mul(var, cot)))
        loss = from_fluid.sum(terms) if len(terms) > 1 else terms[0]
        pg = fluid.backward.append_backward(loss)
    scope = fluid.Scope()
    exe = fluid.Executor() if fluid is jfluid else fluid.Executor("cpu")
    exe.run(startup, scope=scope)
    for d in inputs.values():
        for n, a in d.items():
            scope.set_var(n, a if fluid is jfluid else torch.tensor(a))
    feed = {"cot_" + s: c for s, c in cots.items()}
    got = exe.run(main, feed=feed, fetch_list=[g for _, g in pg],
                  scope=scope)
    return {p.name: np.asarray(g) for (p, _), g in zip(pg, got)}


@pytest.mark.parametrize("op_type,origin", [("gru_unit", False),
                                            ("gru_unit", True),
                                            ("lstm_unit", None)])
def test_unit_gradients_through_autodiff_match_reference(op_type, origin):
    B, H = 3, 4
    if op_type == "gru_unit":
        inputs = {"Input": {"g": _f(B, 3 * H)}, "HiddenPrev": {"h": _f(B, H)},
                  "Weight": {"w": _f(H, 3 * H, scale=0.5)},
                  "Bias": {"b": _f(1, 3 * H)}}
        outputs = {"Gate": ["gate"], "ResetHiddenPrev": ["reset"],
                   "Hidden": ["hid"]}
        cots = {"Gate": _f(B, 3 * H), "ResetHiddenPrev": _f(B, H),
                "Hidden": _f(B, H)}
        attrs = {"activation": "tanh", "gate_activation": "sigmoid",
                 "origin_mode": origin}
    else:
        inputs = {"X": {"g": _f(B, 4 * H)}, "C_prev": {"c": _f(B, H)}}
        outputs = {"C": ["c_out"], "H": ["h_out"]}
        cots = {"C": _f(B, H), "H": _f(B, H)}
        attrs = {"forget_bias": 1.0}
    want = _unit_grads(jfluid, op_type, inputs, outputs, attrs, cots)
    got = _unit_grads(pfluid, op_type, inputs, outputs, attrs, cots)
    assert sorted(got) == sorted(want) and len(got) == sum(
        len(d) for d in inputs.values())
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=RTOL,
                                   atol=ATOL * max(1.0, np.abs(want[n]).max()),
                                   err_msg=n)


# -- beam search ----------------------------------------------------------------------


def _beam_inputs(batch, beam, V, end_id, finished_rows, ties, accumulated):
    bw = batch * beam
    pre_ids = _R.randint(2, V, (bw, 1)).astype(I64)
    pre_ids[list(finished_rows), 0] = end_id
    pre_scores = _f(bw, 1, scale=2.0)
    if accumulated:
        scores = np.log(_probs(bw, V)) + pre_scores
    else:
        scores = _probs(bw, V)
    if ties:
        # few distinct values: many equal candidates within a row and
        # across the beams of a group; equal previous scores too
        scores = np.round(scores * 4) / 4 if accumulated else \
            (np.round(scores * 8) / 8 + 1e-3).astype(np.float32)
        scores[:, -1] = scores.max(-1)      # each row's best, twice
        pre_scores[:] = np.round(pre_scores[0:1] * 2) / 2
        if not accumulated:
            # step 0: every beam but a group's first at -1e9
            pre_scores[np.arange(bw) % beam != 0] = -1e9
    return {"pre_ids": {"pre_ids": pre_ids},
            "pre_scores": {"pre_scores": pre_scores.astype(np.float32)},
            "scores": {"scores": scores.astype(np.float32)}}


BEAM_CASES = [
    # batch, beam, V, end_id, finished rows, ties, is_accumulated
    (3, 4, 7, 1, (), False, False),
    (3, 4, 7, 1, (1, 5, 6), False, False),
    (2, 3, 6, 0, (0, 1, 2), False, True),
    (3, 4, 5, 1, (2,), True, False),
    (2, 4, 5, 1, (1, 3), True, True),
    (4, 2, 9, 3, (), True, False),
]


@pytest.mark.parametrize("batch,beam,V,end_id,finished,ties,accumulated",
                         BEAM_CASES)
def test_beam_search_matches_reference(batch, beam, V, end_id, finished,
                                       ties, accumulated):
    inputs = _beam_inputs(batch, beam, V, end_id, finished, ties,
                          accumulated)
    out = _lower_both("beam_search", inputs,
                      {"selected_ids": ["ids"],
                       "selected_scores": ["scores_out"],
                       "parent_idx": ["parent"]},
                      {"beam_size": beam, "end_id": end_id, "level": 0,
                       "is_accumulated": accumulated})
    _check(out, exact=("ids", "parent"))
    if ties:   # the planted ties reached the selection
        sel = out["scores_out"][1].reshape(batch, beam)
        assert any(len(set(row)) < beam for row in sel.tolist())
    assert out["parent"][1].dtype == np.int32


def test_beam_pos_matches_reference():
    _check(_lower_both("beam_pos", {"X": {"x": _f(12, 3)}}, {"Out": ["o"]},
                       {"beam_size": 4}), exact=("o",))


def _tree_inputs(T, batch, beam):
    ids = _R.randint(0, 50, (T, batch * beam)).astype(I64)
    base = np.repeat(np.arange(batch) * beam, beam)
    parents = (base[None, :] + _R.randint(0, beam, (T, batch * beam))
               ).astype(np.int32)
    return ids, parents


def test_gather_tree_matches_reference():
    ids, parents = _tree_inputs(6, 3, 4)
    _check(_lower_both("gather_tree", {"Ids": {"ids": ids},
                                       "Parents": {"parents": parents}},
                       {"Out": ["o"]}, {"beam_size": 4}), exact=("o",))


@pytest.mark.parametrize("with_parents", [True, False])
def test_beam_search_decode_matches_reference(with_parents):
    ids, parents = _tree_inputs(5, 2, 3)
    inputs = {"Ids": {"ids": ids}, "Scores": {"s": _f(5, 6)}}
    if with_parents:
        inputs["Parents"] = {"parents": parents}
    _check(_lower_both("beam_search_decode", inputs,
                       {"SentenceIds": ["out_ids"],
                        "SentenceScores": ["out_scores"]},
                       {"beam_size": 3, "end_id": 1}), exact=("out_ids",))


# -- rnn over the cells ---------------------------------------------------------------


def _rnn_program(fluid, cell_kind, time_major, is_reverse, with_len):
    B, T, I, H = 3, 5, 4, 6
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        layers = fluid.layers
        x = layers.data("x", [T, B, I] if time_major else [B, T, I],
                        append_batch_size=False)
        seq_len = layers.data("len", [B], dtype="int64",
                              append_batch_size=False) if with_len else None
        cell = (layers.GRUCell(H, name="g") if cell_kind == "gru"
                else layers.LSTMCell(H, name="l"))
        outs, final = layers.rnn(cell, x, sequence_length=seq_len,
                                 time_major=time_major,
                                 is_reverse=is_reverse)
        finals = final if isinstance(final, list) else [final]
    return main, startup, [outs] + finals


RNN_CASES = [("gru", False, False, False), ("gru", True, True, True),
             ("gru", False, False, True), ("lstm", False, False, True),
             ("lstm", True, False, False), ("lstm", False, True, True)]


@pytest.mark.parametrize("cell_kind,time_major,is_reverse,with_len",
                         RNN_CASES)
def test_rnn_over_cells_matches_reference(cell_kind, time_major, is_reverse,
                                          with_len):
    jm, js, jout = _rnn_program(jfluid, cell_kind, time_major, is_reverse,
                                with_len)
    pm, ps, pout = _rnn_program(pfluid, cell_kind, time_major, is_reverse,
                                with_len)
    assert pm.to_desc() == jm.to_desc() and ps.to_desc() == js.to_desc()
    jscope, jexe = jfluid.Scope(), jfluid.Executor()
    jexe.run(js, scope=jscope)
    pscope = pfluid.Scope()
    pfluid.copy_scope(jscope, pscope,
                      [v.name for v in jm.list_vars() if v.persistable],
                      device="cpu")
    feed = {"x": _f(5, 3, 4) if time_major else _f(3, 5, 4)}
    if with_len:
        feed["len"] = np.array([5, 2, 0], I64)
    want = jexe.run(jm, feed=feed, fetch_list=jout, scope=jscope)
    got = pfluid.Executor("cpu").run(pm, feed=feed, fetch_list=pout,
                                     scope=pscope)
    for w, g, v in zip(want, got, pout):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=v.name)


# -- refusals -------------------------------------------------------------------------


def _refusals():
    L = pfluid.layers
    return {
        "While": lambda: L.While(None),
        "cond": lambda: L.cond(None),
        "StaticRNN": lambda: L.StaticRNN(),
        "array_write": lambda: L.array_write(None, None),
    }


@pytest.mark.parametrize("name", sorted(_refusals()))
def test_unported_layers_raise_naming_item_4(name):
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue 1 item 4"):
        _refusals()[name]()
