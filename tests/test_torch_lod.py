"""The port's LoD substrate (paddle_tpu_torch/fluid/lod.py,
lod_tensor.py), its LoD feeds, ``propagate_lod``, the sequence ops
(fluid/ops/sequence_ops.py), ``dynamic_lstm`` / ``dynamic_lstmp``
(fluid/ops/rnn_ops.py) and the dataset's ragged slots, held to the JAX
package on the CPU.

- Host types: lengths, offsets, data and errors equal to the
  reference's; ``create_random_int_lodtensor`` draws the same ids from
  numpy's seeded generator.
- Ops: the same seeded numpy inputs through both registries' lowerings
  of one op, with a zero-length sequence and padding rows past
  ``sum(lengths)`` that hold random values (which every op must mask).
  Outputs, output lengths, and the gradients of every float input under
  a random cotangent, at rtol 1e-5, atol 1e-6; ids exactly. The port
  runs each op twice: over the flat row bound (the reference's) and at
  a tight time bound (``@LOD_BOUND``); both equal the reference.
- ``dynamic_lstm`` / ``dynamic_lstmp``: forward and reverse, with and
  without peepholes, H0/C0, cell_clip and other activations, at the
  flat bound, a tight one and the executor's bucket.
- A lowering of every op on ``meta`` tensors: no op reads a length (or
  any value) on the host, so a step of them captures into a CUDA graph.
- Feeds: a LoDTensor's data and lengths reach the step as the
  reference's; the step is keyed by the time bound's bucket; ``iters>1``
  refuses a LoDTensor in the reference's words.
- Ragged dataset slots: batches equal to the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import framework as JF
from paddle_tpu.fluid import lod as JL
from paddle_tpu.fluid import lod_tensor as JLT
from paddle_tpu.fluid import registry as JR
import paddle_tpu_torch.fluid as pfluid
from paddle_tpu_torch.fluid import framework as PF
from paddle_tpu_torch.fluid import lod as PL
from paddle_tpu_torch.fluid import lod_tensor as PLT
from paddle_tpu_torch.fluid import monitor as PM
from paddle_tpu_torch.fluid import registry as PR

RTOL, ATOL = 1e-5, 1e-6
I32, I64 = np.int32, np.int64

_R = np.random.RandomState(21)


def _f(*shape):
    return _R.randn(*shape).astype(np.float32)


# lengths with an empty sequence; 9 tokens in 12 rows
LENS = np.array([3, 0, 4, 2], I32)
ROWS = 12


# -- host types -------------------------------------------------------------------


def test_lod_tensor_matches_reference():
    data = _f(7, 2)
    for rsl in ([[3, 0, 4]], [3, 0, 4], [[2, 1], [1, 2, 0, 4]], None):
        want = JL.LoDTensor(data, rsl)
        got = PL.LoDTensor(data, rsl)
        assert got.recursive_sequence_lengths() == \
            want.recursive_sequence_lengths()
        assert got.lod() == want.lod()
        np.testing.assert_array_equal(got.lengths(), want.lengths())
        assert got.lengths().dtype == want.lengths().dtype == I32
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert got.shape == want.shape and got.data() is data
    msgs = []
    for mod in (JL, PL):
        with pytest.raises(ValueError) as e:
            mod.create_lod_tensor(data, [[4, 4]])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert PL.lod_name("x") == JL.lod_name("x") == "x" + JL.LOD_SUFFIX
    assert PL.LOD_SUFFIX == JL.LOD_SUFFIX
    assert pfluid.LoDTensor is PL.LoDTensor
    assert pfluid.create_lod_tensor is PL.create_lod_tensor


def test_lod_tensor_array_coerces_as_reference():
    arrays = [_f(2, 3), PL.LoDTensor(_f(3, 3), [[1, 2]])]
    got = pfluid.LoDTensorArray(arrays)
    want = jfluid.LoDTensorArray([a if not isinstance(a, PL.LoDTensor)
                                  else JL.LoDTensor(a.data(), [[1, 2]])
                                  for a in arrays])
    got.append(_f(1, 3))
    want.append(got[-1].data())
    got.insert(0, _f(4, 3))
    want.insert(0, got[0].data())
    got[1] = _f(5, 3)
    want[1] = got[1].data()
    got.extend([_f(2, 3)])
    want.extend([got[-1].data()])
    got[0:1] = [_f(6, 3)]
    want[0:1] = [got[0].data()]
    assert all(isinstance(t, PL.LoDTensor) for t in got)
    assert [t.recursive_sequence_lengths() for t in got] == \
        [t.recursive_sequence_lengths() for t in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_create_random_int_lodtensor_draws_as_reference():
    np.random.seed(5)
    want = JLT.create_random_int_lodtensor([[2, 3], [1, 4, 0, 2, 1]], [1],
                                           low=3, high=9)
    np.random.seed(5)
    got = PLT.create_random_int_lodtensor([[2, 3], [1, 4, 0, 2, 1]], [1],
                                          low=3, high=9)
    np.testing.assert_array_equal(got.data(), want.data())
    assert got.lod() == want.lod()


@pytest.mark.parametrize("longest,rows,bound", [
    (0, 64, 16), (16, 64, 16), (17, 64, 20), (31, 64, 32), (33, 512, 40),
    (398, 32768, 448), (449, 32768, 512), (500, 600, 512), (40, 24, 24)])
def test_length_bound_buckets(longest, rows, bound):
    assert PL.length_bound(longest, rows) == bound


# -- one op through both registries -----------------------------------------------


def _desc(op_type, inputs, outputs, attrs):
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


def _lower_both(op_type, inputs, outputs, attrs, lods, bounds_list=(None,),
                wrt=()):
    """For each time-bound map in ``bounds_list``: {name: (reference's,
    port's)} of each output and output @LOD, and of each input in
    ``wrt``'s gradient (``name@GRAD``) under one random cotangent on
    every float output. The reference runs once, over its flat bound."""
    desc = _desc(op_type, inputs, outputs, attrs)
    feeds = {n: a for d in inputs.values() for n, a in d.items()}
    out_names = [n for names in outputs.values() for n in names]
    jblock = JF.Program.from_desc(desc).global_block()
    pblock = PF.Program.from_desc(desc).global_block()

    def jrun(args):
        env = {n: jnp.asarray(a) for n, a in feeds.items()}
        env.update(zip(wrt, args))
        env.update((JL.lod_name(n), jnp.asarray(v)) for n, v in lods.items())
        JR.lower_op(JR.LowerCtx(jblock, env, jax.random.PRNGKey(0)),
                    jblock.ops[0])
        return env

    def prun(args, bounds):
        env = {n: torch.tensor(a) for n, a in feeds.items()}
        env.update(zip(wrt, args))
        env.update((PL.lod_name(n), torch.tensor(v)) for n, v in lods.items())
        env.update((PL.bound_name(n), b) for n, b in (bounds or {}).items())
        PR.lower_op(PR.LowerCtx(pblock, env, torch.Generator(), "cpu"),
                    pblock.ops[0])
        return env

    jenv = jrun([jnp.asarray(feeds[n]) for n in wrt])
    outs = [n for n in out_names if n in jenv]
    want = {n: np.asarray(jenv[n]) for n in outs}
    want.update((JL.lod_name(n), np.asarray(jenv[JL.lod_name(n)]))
                for n in outs if JL.lod_name(n) in jenv)
    fl = [n for n in outs if np.issubdtype(want[n].dtype, np.floating)]
    cot = {n: _R.randn(*want[n].shape).astype(np.float32) for n in fl}
    if wrt:
        def f(*args):
            env = jrun(list(args))
            return tuple(env[n] for n in fl)

        _, vjp = jax.vjp(f, *[jnp.asarray(feeds[n]) for n in wrt])
        want.update((n + "@GRAD", np.asarray(g)) for n, g in zip(
            wrt, vjp(tuple(jnp.asarray(cot[n]) for n in fl))))
    results = []
    for bounds in bounds_list:
        pargs = [torch.tensor(feeds[n], requires_grad=True) for n in wrt]
        penv = prun(pargs, bounds)
        got = {}
        for n in want:
            if n.endswith("@GRAD"):
                continue
            assert n in penv, n
            got[n] = penv[n].detach().numpy()
        if wrt:
            grads = torch.autograd.grad(
                [penv[n] for n in fl], pargs,
                [torch.tensor(cot[n]) for n in fl], allow_unused=True)
            got.update((n + "@GRAD", np.zeros_like(feeds[n]) if g is None
                        else g.numpy()) for n, g in zip(wrt, grads))
        results.append({n: (want[n], got[n]) for n in want})
    return results


def _check(pairs, exact=()):
    for name, (want, got) in pairs.items():
        assert got.shape == want.shape, (name, got.shape, want.shape)
        if name in exact or name.endswith(JL.LOD_SUFFIX) or \
                not np.issubdtype(want.dtype, np.floating):
            np.testing.assert_array_equal(got.astype(np.int64),
                                          want.astype(np.int64),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=name)


def _ids(rows, high, seed):
    return np.random.RandomState(seed).randint(0, high, (rows, 1)).astype(I64)


LENS2 = np.array([1, 2, 0, 3], I32)
SEQ_CASES = {
    **{"pool_" + t.lower(): (
        "sequence_pool", {"X": {"x": _f(ROWS, 3)}},
        {"Out": ["o"], **({"MaxIndex": ["mi"]} if t == "MAX" else {})},
        {"pooltype": t, "pad_value": 0.5}, {"x": LENS}, ["x"])
       for t in ("SUM", "AVERAGE", "SQRT", "MAX", "FIRST", "LAST")},
    "softmax": ("sequence_softmax", {"X": {"x": _f(ROWS, 2)}},
                {"Out": ["o"]}, {}, {"x": LENS}, ["x"]),
    "reverse": ("sequence_reverse", {"X": {"x": _f(ROWS, 3)}},
                {"Out": ["o"]}, {}, {"x": LENS}, ["x"]),
    "expand_dense": ("sequence_expand", {"X": {"x": _f(4, 3)},
                                         "Y": {"y": _f(ROWS, 2)}},
                     {"Out": ["o"]}, {"ref_level": -1}, {"y": LENS},
                     ["x"]),
    "expand_ragged": ("sequence_expand", {"X": {"x": _f(ROWS, 3)},
                                          "Y": {"y": _f(ROWS, 2)}},
                      {"Out": ["o"]}, {"ref_level": -1},
                      {"x": LENS, "y": LENS}, ["x"]),
    "expand_as": ("sequence_expand_as", {"X": {"x": _f(4, 3)},
                                         "Y": {"y": _f(ROWS, 2)}},
                  {"Out": ["o"]}, {}, {"y": LENS}, ["x"]),
    "pad": ("sequence_pad", {"X": {"x": _f(ROWS, 3)},
                             "PadValue": {"pv": np.array([0.25], np.float32)}},
            {"Out": ["o"], "Length": ["ln"]}, {"padded_length": -1},
            {"x": LENS}, ["x"]),
    "pad_cut": ("sequence_pad", {"X": {"x": _f(ROWS, 3)},
                                 "PadValue": {"pv": np.array([-1.0],
                                                             np.float32)}},
                {"Out": ["o"], "Length": ["ln"]}, {"padded_length": 3},
                {"x": LENS}, ["x"]),
    "unpad": ("sequence_unpad", {"X": {"x": _f(4, 5, 3)},
                                 "Length": {"ln": LENS.astype(I64)}},
              {"Out": ["o"]}, {}, {}, ["x"]),
    "reshape": ("sequence_reshape", {"X": {"x": _f(ROWS, 4)}},
                {"Out": ["o"]}, {"new_dim": 2}, {"x": LENS}, ["x"]),
    "concat": ("sequence_concat", {"X": {"a": _f(ROWS, 3),
                                         "b": _f(8, 3)}},
               {"Out": ["o"]}, {}, {"a": LENS, "b": LENS2}, ["a", "b"]),
    "slice": ("sequence_slice", {"X": {"x": _f(ROWS, 3)},
                                 "Offset": {"off": np.array(
                                     [[1], [0], [2], [0]], I64)},
                                 "Length": {"len": np.array(
                                     [[2], [0], [2], [1]], I64)}},
              {"Out": ["o"]}, {}, {"x": LENS}, ["x"]),
    "enumerate": ("sequence_enumerate", {"X": {"x": _ids(ROWS, 9, 1)}},
                  {"Out": ["o"]}, {"win_size": 3, "pad_value": 0},
                  {"x": LENS}, []),
    "scatter": ("sequence_scatter", {"X": {"x": _f(4, 6)},
                                     "Ids": {"ids": np.array(
                                         [[1], [4], [1], [0], [5], [5],
                                          [2], [3], [0], [1], [2], [3]],
                                         I64)},
                                     "Updates": {"u": _f(ROWS, 1)}},
                {"Out": ["o"]}, {}, {"ids": LENS}, ["x", "u"]),
    "conv": ("sequence_conv", {"X": {"x": _f(ROWS, 3)},
                               "Filter": {"w": _f(9, 5)}},
             {"Out": ["o"]}, {"contextStart": -1, "contextLength": 3,
                              "contextStride": 1}, {"x": LENS},
             ["x", "w"]),
    "conv_wide": ("sequence_conv", {"X": {"x": _f(ROWS, 2)},
                                    "Filter": {"w": _f(8, 3)}},
                  {"Out": ["o"]}, {"contextStart": -2, "contextLength": 4,
                                   "contextStride": 1}, {"x": LENS},
                  ["x", "w"]),
    "erase": ("sequence_erase", {"X": {"x": _ids(ROWS, 6, 2)}},
              {"Out": ["o"]}, {"tokens": [2, 5]}, {"x": LENS}, []),
    "im2sequence": ("im2sequence", {"X": {"x": _f(2, 2, 5, 5)}},
                    {"Out": ["o"]}, {"kernels": [2, 3], "strides": [1, 2],
                                     "paddings": [0, 1, 1, 0]}, {}, ["x"]),
    "row_conv": ("row_conv", {"X": {"x": _f(ROWS, 3)},
                              "Filter": {"w": _f(3, 3)}},
                 {"Out": ["o"]}, {}, {"x": LENS}, ["x", "w"]),
    "row_conv_dense": ("row_conv", {"X": {"x": _f(2, 5, 3)},
                                    "Filter": {"w": _f(2, 3)}},
                       {"Out": ["o"]}, {}, {}, ["x", "w"]),
}


@pytest.mark.parametrize("case", sorted(SEQ_CASES))
def test_sequence_op_and_gradient_match_reference(case):
    """Over the flat bound and at the tight time bound."""
    op_type, inputs, outputs, attrs, lods, wrt = SEQ_CASES[case]
    tight = {n: int(v.max()) for n, v in lods.items()}
    for pairs in _lower_both(op_type, inputs, outputs, attrs, lods,
                             (None, tight), wrt=wrt):
        assert "o" in pairs
        _check(pairs, exact=("mi", "ln"))


def test_sequence_ops_cover_the_reference():
    """Every op of the reference's sequence_ops module has a case here
    (``sequence_mask``'s are in test_torch_rnn.py)."""
    ops = {SEQ_CASES[c][0] for c in SEQ_CASES} | {"sequence_mask"}
    ref = {t for t, d in JR.registry._ops.items()
           if getattr(d, "lower", d).__module__.endswith(
               "fluid.ops.sequence_ops")}
    assert len(ref) == 17 and ref <= ops
    assert all(PR.registry.has(t) for t in ref)


# -- dynamic_lstm / dynamic_lstmp ---------------------------------------------------

H, P = 4, 3
LSTM_LENS = np.array([3, 0, 5, 2], I32)
LSTM_ROWS = 14


def _lstm_case(proj=False, peep=True, h0=False, reverse=False, clip=0.0,
               acts=None):
    n = LSTM_LENS.shape[0]
    ins = {"Input": {"x": _f(LSTM_ROWS, 4 * H) * 0.5},
           "Weight": {"w": _f(P if proj else H, 4 * H) * 0.5},
           "Bias": {"b": _f(1, (7 if peep else 4) * H) * 0.5}}
    if proj:
        ins["ProjWeight"] = {"wp": _f(H, P) * 0.5}
    if h0:
        ins["H0"] = {"h0": _f(n, P if proj else H) * 0.5}
        ins["C0"] = {"c0": _f(n, H) * 0.5}
    attrs = {"use_peepholes": peep, "is_reverse": reverse,
             "gate_activation": "sigmoid", "cell_activation": "tanh",
             "candidate_activation": "tanh"}
    attrs.update(acts or {})
    if proj:
        attrs.update(proj_activation=(acts or {}).get("proj_activation",
                                                      "tanh"),
                     cell_clip=clip)
    outs = {"Projection" if proj else "Hidden": ["h"], "Cell": ["c"]}
    wrt = [n for d in ins.values() for n in d]
    return ("dynamic_lstmp" if proj else "dynamic_lstm", ins, outs, attrs,
            {"x": LSTM_LENS}, wrt)


LSTM_CASES = {
    "forward": _lstm_case(),
    "reverse": _lstm_case(reverse=True),
    "no_peepholes": _lstm_case(peep=False),
    "h0_c0_reverse": _lstm_case(h0=True, reverse=True),
    "activations": _lstm_case(acts={"gate_activation": "sigmoid",
                                    "cell_activation": "relu",
                                    "candidate_activation": "identity"}),
    "lstmp": _lstm_case(proj=True),
    "lstmp_clip_h0_reverse": _lstm_case(proj=True, h0=True, reverse=True,
                                        clip=0.3),
    "lstmp_identity_no_peepholes": _lstm_case(
        proj=True, peep=False, acts={"proj_activation": "identity"}),
}


@pytest.mark.parametrize("case", sorted(LSTM_CASES))
def test_dynamic_lstm_matches_reference_over_its_flat_bound(case):
    """The port's recurrence over the flat bound, at the host's time
    bound (the longest length) and at the executor's bucket
    (``length_bound``) equals the reference's run over the flat row
    bound, with its gradients."""
    op_type, inputs, outputs, attrs, lods, wrt = LSTM_CASES[case]
    longest = int(LSTM_LENS.max())
    for pairs in _lower_both(
            op_type, inputs, outputs, attrs, lods,
            (None, {"x": longest},
             {"x": PL.length_bound(longest, LSTM_ROWS)}), wrt=wrt):
        assert {"h", "c", "h@LOD", "c@LOD"} <= set(pairs)
        _check(pairs)


def test_no_op_reads_a_value_on_the_host():
    """Every sequence op and the LSTM lower on ``meta`` tensors (which
    hold no values: a read on the host raises), lengths included."""
    cases = dict(SEQ_CASES, **{"lstm_" + k: v for k, v in
                               LSTM_CASES.items()})
    meta = torch.device("meta")
    for case, (op_type, inputs, outputs, attrs, lods, _) in cases.items():
        desc = _desc(op_type, inputs, outputs, attrs)
        block = PF.Program.from_desc(desc).global_block()
        env = {n: torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                              device=meta)
               for d in inputs.values() for n, a in d.items()}
        env.update((PL.lod_name(n), torch.empty(v.shape, dtype=torch.int32,
                                                device=meta))
                   for n, v in lods.items())
        env.update((PL.bound_name(n), int(v.max())) for n, v in lods.items())
        PR.lower_op(PR.LowerCtx(block, env, None, meta), block.ops[0])
        for names in outputs.values():
            assert all(env[n].device.type == "meta" for n in names), case


# -- feeds, propagation and the step's key ---------------------------------------


def _emb_program(fluid, layers):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 1
    with fluid.program_guard(main, startup):
        ids = layers.data("ids", shape=[1], dtype="int64", lod_level=1)
        emb = layers.embedding(ids, size=[20, 4])
        emb = layers.reshape(emb, [-1, 4])
        hid = layers.fc(emb, size=3, act="tanh")
        pooled = layers.sequence_pool(hid, "average")
        loss = layers.mean(pooled)
    return main, startup, ids, hid, pooled, loss


def test_lod_propagates_through_embedding_and_fc():
    """The reference's ShareLoD rule (its
    ``test_lod_propagates_through_embedding_and_fc``): token-aligned ops
    carry @LOD forward, so a sequence op composes with embedding and fc;
    the pooled values and the propagated lengths equal the reference's
    from its state."""
    idv = np.array([[1], [2], [3], [4], [5], [0], [0], [0]], I64)
    with jfluid.unique_name.guard():
        jm, js, _, jhid, jp, _ = _emb_program(jfluid, jfluid.layers)
    with pfluid.unique_name.guard():
        pm, ps, _, phid, pp, _ = _emb_program(pfluid, pfluid.layers)
    assert pm.to_desc() == jm.to_desc()
    assert pm.global_block().var("ids").lod_level == 1
    jscope, pscope = jfluid.Scope(), pfluid.Scope()
    jexe, pexe = jfluid.Executor(), pfluid.Executor("cpu")
    jexe.run(js, scope=jscope)
    pexe.run(ps, scope=pscope)
    names = [v.name for v in jm.list_vars() if v.persistable]
    pfluid.copy_scope(jscope, pscope, names, device="cpu")
    fetch = [jp.name, jhid.name + "@LOD", "ids@LOD"]
    want = jexe.run(jm, feed={"ids": jfluid.create_lod_tensor(
        idv, [[3, 2]])}, fetch_list=fetch, scope=jscope)
    got = pexe.run(pm, feed={"ids": pfluid.create_lod_tensor(
        idv, [[3, 2]])}, fetch_list=fetch, scope=pscope)
    assert np.asarray(got[0]).shape == (2, 3)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=RTOL,
                               atol=ATOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_propagate_lod_holds_inside_recompute_segments():
    """propagate_lod runs on the environment a recompute segment lowers
    in (a copy): the trajectory equals the plain program's."""
    def build():
        with pfluid.unique_name.guard():
            main, startup, ids, hid, pooled, loss = _emb_program(
                pfluid, pfluid.layers)
            with pfluid.program_guard(main, startup):
                opt = pfluid.optimizer.RecomputeOptimizer(
                    pfluid.optimizer.SGD(0.1))
                opt._set_checkpoints([hid])
                opt.minimize(loss)
        return main, startup, loss

    def build_plain():
        with pfluid.unique_name.guard():
            main, startup, ids, hid, pooled, loss = _emb_program(
                pfluid, pfluid.layers)
            with pfluid.program_guard(main, startup):
                pfluid.optimizer.SGD(0.1).minimize(loss)
        return main, startup, loss

    idv = _ids(16, 20, 3)
    feed = {"ids": pfluid.create_lod_tensor(idv, [[5, 0, 6, 2]])}
    losses = []
    for main, startup, loss in (build(), build_plain()):
        scope, exe = pfluid.Scope(), pfluid.Executor("cpu")
        exe.run(startup, scope=scope)
        losses.append([exe.run(main, feed=feed, fetch_list=[loss],
                               scope=scope)[0] for _ in range(3)])
    np.testing.assert_array_equal(losses[0], losses[1])


def test_lod_feed_keys_the_step_by_its_time_bound():
    """A LoDTensor feed: data under its name, int32 lengths under @LOD,
    both fed like any array; a batch whose longest sequence stays in the
    bucket reuses the step, one in another bucket builds a new one."""
    with pfluid.unique_name.guard():
        main, startup, ids, hid, pooled, loss = _emb_program(
            pfluid, pfluid.layers)
    scope, exe = pfluid.Scope(), pfluid.Executor("cpu")
    exe.run(startup, scope=scope)
    hits = PM.counter("executor_compile_cache_hit_total")
    misses = PM.counter("executor_compile_cache_miss_total")
    steps = []
    for lens in ([5, 0, 6, 2], [3, 1, 4, 5], [17, 1, 2, 3]):
        feed = {"ids": pfluid.create_lod_tensor(_ids(32, 20, 4), [lens])}
        h, m = hits.value, misses.value
        data, lod = exe.run(main, feed=feed, fetch_list=["ids", "ids@LOD"],
                            scope=scope)
        steps.append((hits.value - h, misses.value - m))
        np.testing.assert_array_equal(data, feed["ids"].data())
        np.testing.assert_array_equal(lod, np.asarray(lens, I32))
    # bounds 16, 16, 20
    assert steps == [(0, 1), (1, 0), (0, 1)]


def test_iters_refuses_a_lod_feed_in_the_reference_words():
    msgs = []
    for fluid, exe in ((jfluid, jfluid.Executor()),
                       (pfluid, pfluid.Executor("cpu"))):
        with fluid.unique_name.guard():
            main, startup, ids, hid, pooled, loss = _emb_program(
                fluid, fluid.layers)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        with pytest.raises(ValueError) as e:
            exe.run(main, feed={"ids": fluid.create_lod_tensor(
                _ids(8, 20, 5), [[3, 5]])}, fetch_list=[loss], scope=scope,
                iters=2)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# -- ragged dataset slots -------------------------------------------------------------


def _write_ragged(path, n_lines, seed):
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(n_lines):
        n = int(rng.randint(1, 7))
        parts = [str(n)] + [str(rng.randint(0, 30)) for _ in range(n)]
        parts += ["2"] + ["%.4f" % v for v in rng.rand(2)]
        parts += ["1", str(rng.randint(0, 2))]
        rows.append(" ".join(parts))
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def _ragged_vars(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        words = fluid.layers.data("words", [1], dtype="int64", lod_level=1)
        dense = fluid.layers.data("dense", [2])
        label = fluid.layers.data("label", [1], dtype="int64")
    return [words, dense, label]


@pytest.mark.parametrize("batch", [4, 7])
def test_ragged_dataset_batches_match_reference(tmp_path, batch):
    f = str(tmp_path / "ragged.txt")
    _write_ragged(f, 19, seed=batch)
    out = []
    for fluid in (jfluid, pfluid):
        ds = fluid.DatasetFactory().create_dataset("InMemoryDataset")
        ds.set_batch_size(batch)
        ds.set_use_var(_ragged_vars(fluid))
        ds.set_filelist([f])
        ds.load_into_memory()
        out.append(list(ds.batch_reader()()))
    want, got = out
    assert len(got) == len(want) == -(-19 // batch)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert isinstance(g["words"], PL.LoDTensor)
        assert g["words"].recursive_sequence_lengths() == \
            w["words"].recursive_sequence_lengths()
        np.testing.assert_array_equal(g["words"].data(), w["words"].data())
        for k in ("dense", "label"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
