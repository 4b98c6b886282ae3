"""The port's control flow (paddle_tpu_torch/fluid/ops/control_flow.py,
layers/control_flow.py, the IfElse and DynamicRNN of layers/extras.py,
sub-blocks in framework.py, the executor's bookkeeping) held to the JAX
package on the CPU.

- The reference's 11 programs of ``tests/test_control_flow.py`` (cond,
  While, while_loop, case / switch_case, StaticRNN, the bounded
  while_loop's gradient, the array round trip, an array in a While,
  DynamicRNN at equal and variable lengths, IfElse), each built in both
  packages inside ``unique_name.guard()``: the same desc, and the same
  seeded feeds give the reference's fetches at rtol 1e-5, and the
  reference test's own expectations. The reference builds the gradient
  program with ``fluid.gradients``, which the port does not carry; here
  both packages differentiate a parameter through ``append_backward``.
- Switch, is_empty, Print and the small layers control flow needs
  (assign, range, argmax / argmin, logical_and / xor / not).
- The arrays' edges: an out-of-range write clamps to the last slot,
  tensor_array_to_tensor of a partly written array, array_length.
- The refusals, in both packages: a gradient through While and through
  an unbounded while_loop, a save op inside a sub-block.
- The executor's liveness and commits, the desc's bytes and pruning,
  shape inference of every control-flow op on meta tensors.
"""

import contextlib
import io
import os
import tempfile

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as pfluid
from paddle_tpu_torch.fluid import framework as PF
from paddle_tpu_torch.fluid import shape_inference as PS

RTOL, ATOL = 1e-5, 1e-6


def _build(fluid, build):
    """``build(fluid)`` -> (fetches, ...) inside fresh programs and
    ``unique_name.guard()``: (main, startup, fetches)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        fetches = build(fluid)
    return main, startup, fetches


def _run_both(build, feeds):
    """The program of ``build`` in both packages: equal descs and block
    counts; from the reference's startup state, each feed's fetches in
    both at RTOL / ATOL. ``feeds``: a list, or ``fn(fluid)`` giving one
    a package (LoDTensors are each package's own). Returns [(reference
    fetches, port fetches)] a feed, and the two scopes."""
    jm, js, jout = _build(jfluid, build)
    pm, ps, pout = _build(pfluid, build)
    assert pm.to_desc() == jm.to_desc()
    assert pm.num_blocks == jm.num_blocks
    jscope, pscope = jfluid.Scope(), pfluid.Scope()
    jexe, pexe = jfluid.Executor(), pfluid.Executor("cpu")
    jexe.run(js, scope=jscope)
    pexe.run(ps, scope=pscope)
    names = [v.name for v in jm.list_vars()
             if v.persistable and jscope.find_var(v.name) is not None]
    pfluid.copy_scope(jscope, pscope, names, device="cpu")
    jfeeds, pfeeds = (feeds(jfluid), feeds(pfluid)) if callable(feeds) \
        else (feeds, feeds)
    runs = []
    for jf, pf in zip(jfeeds, pfeeds):
        want = [np.asarray(w) for w in jexe.run(
            jm, feed=jf, fetch_list=jout, scope=jscope)]
        got = pexe.run(pm, feed=pf, fetch_list=pout, scope=pscope)
        for w, g, v in zip(want, got, pout):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=str(v))
        runs.append((want, got))
    return runs, (jscope, pscope)


# -- the reference's 11 programs -------------------------------------------------


def _cond(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[4], dtype="float32")
    pred = L.reduce_sum(x) > 0.0
    return [L.cond(pred, lambda: L.scale(x, scale=2.0),
                   lambda: L.scale(x, scale=-1.0))]


def _while_accumulate(fluid):
    L = fluid.layers
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 10)
    acc = L.fill_constant([1], "float32", 0.0)
    cond = L.less_than(i, n)
    w = L.While(cond)
    with w.block():
        L.assign(L.scale(acc, scale=1.0, bias=2.0), acc)
        L.increment(i, value=1)
        L.less_than(i, n, cond=cond)
    return [acc, i]


def _while_loop_functional(fluid):
    L = fluid.layers
    i = L.fill_constant([1], "int64", 0)
    s = L.fill_constant([1], "float32", 1.0)

    def cond_fn(i, s):
        return L.less_than(i, L.fill_constant([1], "int64", 5))

    def body_fn(i, s):
        return [L.scale(i, scale=1.0, bias=1.0), L.scale(s, scale=2.0)]

    return L.while_loop(cond_fn, body_fn, [i, s])


def _switch_case(fluid):
    L = fluid.layers
    idx = L.data(name="idx", shape=[1], dtype="int64",
                 append_batch_size=False)
    return [L.switch_case(
        idx, {0: lambda: L.fill_constant([2], "float32", 10.0),
              1: lambda: L.fill_constant([2], "float32", 20.0)},
        default=lambda: L.fill_constant([2], "float32", -1.0))]


T_RNN, B_RNN, D_RNN, H_RNN = 6, 2, 3, 4


def _static_rnn(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[T_RNN, B_RNN, D_RNN], dtype="float32",
               append_batch_size=False)
    h0 = L.data(name="h0", shape=[B_RNN, H_RNN], dtype="float32",
                append_batch_size=False)
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        h_prev = rnn.memory(init=h0)
        h = L.fc([x_t, h_prev], size=H_RNN, act="tanh", bias_attr=False)
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    return [rnn()] + [p.name for p in
                      fluid.default_main_program().all_parameters()]


def _bounded_loop_gradient(fluid):
    L = fluid.layers
    w = L.create_parameter([1, 3], "float32", name="w",
                           default_initializer=fluid.initializer.Constant(
                               1.1))

    def cond_fn(i, s):
        return L.less_than(i, L.fill_constant([1], "int64", 3))

    def body_fn(i, s):
        return [L.scale(i, scale=1.0, bias=1.0), L.elementwise_mul(s, s)]

    i0 = L.fill_constant([1], "int64", 0)
    _, s_out = L.while_loop(cond_fn, body_fn, [i0, w], maximum_trip_count=4)
    loss = L.reduce_sum(s_out)
    fluid.backward.append_backward(loss)
    return [loss, "w@GRAD"]


def _array_roundtrip(fluid):
    L = fluid.layers
    x = L.data("x", shape=[2, 3], dtype="float32", append_batch_size=False)
    arr = L.create_array("float32")
    arr = L.array_write(x, 0, arr)
    arr = L.array_write(x * 2.0, 1, arr)
    return [L.array_length(arr), L.array_read(arr, 0), L.array_read(arr, 1)]


T_ARR = 4


def _array_in_while(fluid):
    L = fluid.layers
    x = L.data("x", shape=[2, 3], dtype="float32", append_batch_size=False)
    arr = L.create_array("float32", element_shape=[2, 3], bound=T_ARR)
    i = L.fill_constant([1], "int32", 0)
    limit = L.fill_constant([1], "int32", T_ARR)
    cond = L.less_than(i, limit)
    w = L.While(cond)
    with w.block():
        L.array_write(x * L.cast(i, "float32"), i, arr)
        L.increment(i, 1)
        L.less_than(i, limit, cond=cond)
    stacked, sidx = L.tensor_array_to_tensor(arr, axis=0, use_stack=True)
    cat, cidx = L.tensor_array_to_tensor(arr, axis=1)
    return [L.array_length(arr), stacked, sidx, cat, cidx]


B_DR, T_DR, D_DR = 3, 5, 4


def _dynamic_vs_static(fluid):
    L = fluid.layers
    x = L.data("x", shape=[-1, D_DR], dtype="float32",
               append_batch_size=False, lod_level=1)
    drnn = L.DynamicRNN(maxlen=T_DR)
    with drnn.block():
        xt = drnn.step_input(x)
        h = drnn.memory(shape=[D_DR], value=0.0, batch_ref=xt)
        nh = L.elementwise_add(h, xt)
        drnn.update_memory(h, nh)
        drnn.output(nh)
    out = drnn()
    xs = L.data("xs", shape=[T_DR, B_DR, D_DR], dtype="float32",
                append_batch_size=False)
    srnn = L.StaticRNN()
    with srnn.step():
        xt2 = srnn.step_input(xs)
        h2 = srnn.memory(shape=[B_DR, D_DR], value=0.0)
        nh2 = L.elementwise_add(h2, xt2)
        srnn.update_memory(h2, nh2)
        srnn.step_output(nh2)
    return [out, srnn()]


def _dynamic_rnn(fluid):
    L = fluid.layers
    x = L.data("x", shape=[-1, D_DR], dtype="float32",
               append_batch_size=False, lod_level=1)
    drnn = L.DynamicRNN(maxlen=5)
    with drnn.block():
        xt = drnn.step_input(x)
        h = drnn.memory(shape=[D_DR], value=0.0, batch_ref=xt)
        nh = L.elementwise_add(h, xt)
        drnn.update_memory(h, nh)
        drnn.output(nh)
    return [drnn()]


B_IE, D_IE = 4, 3


def _ifelse(fluid):
    L = fluid.layers
    x = L.data("x", shape=[B_IE, D_IE], dtype="float32",
               append_batch_size=False)
    thr = L.fill_constant([B_IE, 1], "float32", 0.0)
    row = L.reduce_sum(x, dim=1, keep_dim=True)
    ie = L.IfElse(L.greater_than(row, thr))
    with ie.true_block():
        ie.output(ie.input(x) * 2.0)
    with ie.false_block():
        ie.output(ie.input(x) - 1.0)
    return ie()


def _lod(fluid, flat, lens):
    return fluid.create_lod_tensor(flat, [lens])


def _expect_cond(runs):
    xv = np.ones((2, 4), np.float32)
    np.testing.assert_allclose(runs[0][1][0], 2 * xv)
    np.testing.assert_allclose(runs[1][1][0], xv)


def _expect_static_rnn(runs):
    out, wx, wh = runs[0][1]
    xv = np.random.RandomState(0).rand(T_RNN, B_RNN, D_RNN).astype(
        np.float32)
    h = np.zeros((B_RNN, H_RNN), np.float32)
    for t in range(T_RNN):
        h = np.tanh(xv[t] @ wx + h @ wh)
        np.testing.assert_allclose(out[t], h, rtol=1e-4, atol=1e-5)


def _expect_array_in_while(runs):
    nv, sv, siv, cv, civ = runs[0][1]
    xv = np.arange(6, dtype=np.float32).reshape(2, 3)
    want = np.stack([xv * t for t in range(T_ARR)])
    assert nv[0] == T_ARR and list(siv) == [2] * T_ARR
    np.testing.assert_allclose(sv, want)
    np.testing.assert_allclose(cv, np.concatenate(list(want), axis=1))
    assert list(civ) == [3] * T_ARR


def _expect_dynamic_rnn(runs, lens, flat):
    (ov,) = runs[0][1]
    ptr = 0
    for b, n in enumerate(lens):
        np.testing.assert_allclose(
            ov[b, :n], np.cumsum(flat[ptr:ptr + n], axis=0), atol=1e-5)
        np.testing.assert_allclose(ov[b, n:], 0.0)
        ptr += n


_FLAT_EQ = np.random.RandomState(0).randn(B_DR * T_DR, D_DR).astype(
    np.float32)
_LENS = [5, 3, 5]
_FLAT_VAR = np.random.RandomState(1).randn(sum(_LENS), D_DR).astype(
    np.float32)
_XV_IE = np.random.RandomState(2).randn(B_IE, D_IE).astype(np.float32)


def _cases():
    """name -> (build, feeds as fn(fluid) -> [feed], check(runs))."""
    ones = np.ones((2, 4), np.float32)
    arr_x = np.arange(6, dtype=np.float32).reshape(2, 3)
    return {
        "cond": (_cond, lambda f: [{"x": ones}, {"x": -ones}], _expect_cond),
        "while_accumulate": (
            _while_accumulate, lambda f: [{}],
            lambda r: (r[0][1][0][0] == 20.0 and r[0][1][1][0] == 10)
            or pytest.fail(str(r))),
        "while_loop_functional": (
            _while_loop_functional, lambda f: [{}],
            lambda r: (r[0][1][0][0] == 5 and r[0][1][1][0] == 32.0)
            or pytest.fail(str(r))),
        "case_and_switch_case": (
            _switch_case,
            lambda f: [{"idx": np.array([k], np.int64)} for k in (1, 0, 7)],
            lambda r: [np.testing.assert_allclose(run[1][0], [v, v])
                       for run, v in zip(r, (20.0, 10.0, -1.0))]),
        "static_rnn": (
            _static_rnn,
            lambda f: [{"x": np.random.RandomState(0).rand(
                T_RNN, B_RNN, D_RNN).astype(np.float32),
                "h0": np.zeros((B_RNN, H_RNN), np.float32)}],
            _expect_static_rnn),
        "bounded_while_loop_gradient": (
            _bounded_loop_gradient, lambda f: [{}],
            lambda r: np.testing.assert_allclose(
                r[0][1][1], np.full((1, 3), 8 * 1.1 ** 7, np.float32),
                rtol=1e-4)),
        "array_roundtrip": (
            _array_roundtrip, lambda f: [{"x": arr_x}],
            lambda r: (r[0][1][0][0] == 2 and np.array_equal(
                r[0][1][1], arr_x) and np.array_equal(r[0][1][2], 2 * arr_x))
            or pytest.fail(str(r))),
        "array_in_while_and_to_tensor": (
            _array_in_while, lambda f: [{"x": arr_x}],
            _expect_array_in_while),
        "dynamic_rnn_equal_lengths": (
            _dynamic_vs_static,
            lambda f: [{"x": _lod(f, _FLAT_EQ, [T_DR] * B_DR),
                        "xs": _FLAT_EQ.reshape(B_DR, T_DR, D_DR).transpose(
                            1, 0, 2)}],
            lambda r: np.testing.assert_allclose(
                r[0][1][0], r[0][1][1].transpose(1, 0, 2), atol=1e-5)),
        "dynamic_rnn_variable_lengths": (
            _dynamic_rnn, lambda f: [{"x": _lod(f, _FLAT_VAR, _LENS)}],
            lambda r: _expect_dynamic_rnn(r, _LENS, _FLAT_VAR)),
        "ifelse": (
            _ifelse, lambda f: [{"x": _XV_IE}],
            lambda r: np.testing.assert_allclose(
                r[0][1][0], np.where(_XV_IE.sum(1, keepdims=True) > 0,
                                     _XV_IE * 2.0, _XV_IE - 1.0),
                atol=1e-6)),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_reference_control_flow_program_matches(name):
    build, feeds, check = _cases()[name]
    check(_run_both(build, feeds)[0])


# -- Switch, is_empty, Print, the small layers ----------------------------------


def _switch(fluid):
    L = fluid.layers
    step = L.data("step", shape=[1], dtype="float32",
                  append_batch_size=False)
    lr = L.fill_constant([1], "float32", 0.0)
    with L.Switch() as switch:
        with switch.case(L.less_than(step, L.fill_constant(
                [1], "float32", 10.0))):
            L.assign(L.fill_constant([1], "float32", 1.0), lr)
        with switch.case(L.less_than(step, L.fill_constant(
                [1], "float32", 20.0))):
            L.assign(L.fill_constant([1], "float32", 0.5), lr)
        with switch.default():
            L.assign(L.scale(step, scale=0.001), lr)
    return [lr]


def test_switch_first_true_case_wins_and_default_is_last():
    runs, _ = _run_both(_switch, [
        {"step": np.array([s], np.float32)} for s in (3.0, 10.0, 15.0, 30.0)])
    np.testing.assert_allclose([r[1][0][0] for r in runs],
                               [1.0, 0.5, 0.5, 0.03], rtol=1e-6)


def _small_layers(fluid):
    L = fluid.layers
    x = L.data("x", shape=[3, 4], dtype="float32", append_batch_size=False)
    a = L.data("a", shape=[4], dtype="bool", append_batch_size=False)
    b = L.data("b", shape=[4], dtype="bool", append_batch_size=False)
    const = L.assign(np.arange(6, dtype=np.float32).reshape(2, 3))
    copied = L.assign(x)
    end = L.fill_constant([1], "int64", 7)
    return [L.is_empty(x), const, copied,
            L.range(1, 9, 2, "float32"), L.range(0, end, 1, "int64"),
            L.argmax(x, axis=1), L.argmin(x, axis=0),
            L.logical_and(a, b), L.logical_xor(a, b), L.logical_not(a),
            L.Print(x, message="x: ")]


def test_small_layers_and_print_match_reference():
    xv = np.random.RandomState(3).randn(3, 4).astype(np.float32)
    av = np.array([True, True, False, False])
    bv = np.array([True, False, True, False])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runs, _ = _run_both(_small_layers, [{"x": xv, "a": av, "b": bv}])
    got = runs[0][1]
    assert got[0].tolist() == [False]
    np.testing.assert_array_equal(got[2], xv)
    np.testing.assert_array_equal(got[3], [1, 3, 5, 7])
    np.testing.assert_array_equal(got[4], np.arange(7))
    np.testing.assert_array_equal(got[5], xv.argmax(1))
    np.testing.assert_array_equal(got[6], xv.argmin(0))
    np.testing.assert_array_equal(got[7], av & bv)
    np.testing.assert_array_equal(got[8], av ^ bv)
    np.testing.assert_array_equal(got[9], ~av)
    np.testing.assert_array_equal(got[10], xv)       # Print: Out is In
    assert "x: " in out.getvalue()


def test_is_empty_of_an_empty_var_is_true():
    def build(fluid):
        x = fluid.layers.data("x", shape=[0, 4], dtype="float32",
                              append_batch_size=False)
        return [fluid.layers.is_empty(x)]

    runs, _ = _run_both(build, [{"x": np.zeros((0, 4), np.float32)}])
    assert runs[0][1][0].tolist() == [True]


# -- the arrays' edges ---------------------------------------------------------


def _array_edges(fluid):
    L = fluid.layers
    x = L.data("x", shape=[2, 3], dtype="float32", append_batch_size=False)
    arr = L.create_array("float32", element_shape=[2, 3], bound=4)
    L.array_write(x, 1, arr)
    L.array_write(x * 3.0, 9, arr)        # past the bound: the last slot
    n = L.array_length(arr)
    cat, idx = L.tensor_array_to_tensor(arr, axis=0)
    stacked, _ = L.tensor_array_to_tensor(arr, axis=1, use_stack=True)
    return [n, L.array_read(arr, 3), cat, idx, stacked]


def test_array_out_of_range_write_clamps_and_unwritten_slots_are_zero():
    xv = np.arange(1, 7, dtype=np.float32).reshape(2, 3)
    runs, _ = _run_both(_array_edges, [{"x": xv}])
    n, last, cat, idx, stacked = runs[0][1]
    assert n.tolist() == [10]                # the highest index + 1
    np.testing.assert_array_equal(last, 3 * xv)
    want = np.stack([np.zeros_like(xv), xv, np.zeros_like(xv), 3 * xv])
    np.testing.assert_array_equal(cat, want.reshape(8, 3))
    assert idx.tolist() == [2] * 4
    np.testing.assert_array_equal(stacked, want.transpose(1, 0, 2))


# -- refusals --------------------------------------------------------------------


def _grad_through_while(fluid):
    L = fluid.layers
    w = L.create_parameter([1], "float32", name="w",
                           default_initializer=fluid.initializer.Constant(
                               1.5))
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 3)
    acc = L.fill_constant([1], "float32", 1.0)
    cond = L.less_than(i, n)
    loop = L.While(cond)
    with loop.block():
        L.assign(L.elementwise_mul(acc, w), acc)
        L.increment(i, value=1)
        L.less_than(i, n, cond=cond)
    loss = L.reduce_sum(acc)
    fluid.backward.append_backward(loss)
    return [loss]


def _grad_through_unbounded_loop(fluid):
    L = fluid.layers
    w = L.create_parameter([1, 3], "float32", name="w",
                           default_initializer=fluid.initializer.Constant(
                               1.1))
    i0 = L.fill_constant([1], "int64", 0)
    _, s = L.while_loop(
        lambda i, s: L.less_than(i, L.fill_constant([1], "int64", 3)),
        lambda i, s: [L.scale(i, scale=1.0, bias=1.0),
                      L.elementwise_mul(s, s)], [i0, w])
    loss = L.reduce_sum(s)
    fluid.backward.append_backward(loss)
    return [loss]


def _save_in_branch(fluid):
    L = fluid.layers
    x = L.data("x", shape=[2], dtype="float32", append_batch_size=False)

    def branch():
        y = L.scale(x, scale=2.0)
        fluid.default_main_program().current_block().append_op(
            "save", inputs={"X": [y]}, outputs={},
            attrs={"file_path": os.path.join(tempfile.gettempdir(),
                                             "never_written")})
        return y

    return [L.cond(L.reduce_sum(x) > 0.0, branch,
                   lambda: L.scale(x, scale=1.0))]


@pytest.mark.parametrize("build, feed, match", [
    (_grad_through_while, {}, "while"),
    (_grad_through_unbounded_loop, {}, "while"),
    (_save_in_branch, {"x": np.ones(2, np.float32)}, "sub-block"),
], ids=["while_gradient", "unbounded_while_loop_gradient",
        "save_in_sub_block"])
def test_refusals_in_both_packages(build, feed, match):
    jm, js, jout = _build(jfluid, build)
    pm, ps, pout = _build(pfluid, build)
    jscope, pscope = jfluid.Scope(), pfluid.Scope()
    jexe, pexe = jfluid.Executor(), pfluid.Executor("cpu")
    jexe.run(js, scope=jscope)
    pexe.run(ps, scope=pscope)
    with pytest.raises(Exception, match=match):
        jexe.run(jm, feed=feed, fetch_list=jout, scope=jscope)
    ran = []
    pfluid.executor.register_run_hook(ran.append)
    try:
        with pytest.raises((ValueError, RuntimeError), match=match):
            pexe.run(pm, feed=feed, fetch_list=pout, scope=pscope)
    finally:
        pfluid.executor.unregister_run_hook(ran.append)
    assert not ran


# -- the executor's bookkeeping ----------------------------------------------------


def _read_only_in_sub_blocks(fluid):
    """An fc output read only inside a StaticRNN body, and a scaled feed
    read only inside a cond branch."""
    L = fluid.layers
    x = L.data("x", shape=[3, 2, 4], dtype="float32",
               append_batch_size=False)
    y = L.data("y", shape=[2, 4], dtype="float32", append_batch_size=False)
    bias = L.fc(y, size=4, bias_attr=False)         # [2, 4]
    doubled = L.scale(y, scale=2.0)
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        h = rnn.memory(shape=[2, 4], value=0.0)
        nh = L.tanh(L.elementwise_add(L.elementwise_add(h, x_t), bias))
        rnn.update_memory(h, nh)
        rnn.step_output(nh)
    out = rnn()
    picked = L.cond(L.reduce_sum(y) > 0.0, lambda: L.scale(doubled, 3.0),
                    lambda: L.scale(y, scale=-1.0))
    return [out, picked]


def test_activations_read_only_inside_sub_blocks_survive():
    rng = np.random.RandomState(4)
    feed = {"x": rng.randn(3, 2, 4).astype(np.float32),
            "y": np.abs(rng.randn(2, 4)).astype(np.float32)}
    runs, _ = _run_both(_read_only_in_sub_blocks, [feed])
    np.testing.assert_allclose(runs[0][1][1], 6 * feed["y"], rtol=1e-6)


def _persistable_counter(fluid):
    L = fluid.layers
    main, startup = fluid.default_main_program(), \
        fluid.default_startup_program()
    counter = main.global_block().create_var(
        name="counter", shape=[1], dtype="float32", persistable=True)
    sc = startup.global_block().create_var(
        name="counter", shape=[1], dtype="float32", persistable=True)
    startup.global_block().append_op(
        "fill_constant", outputs={"Out": [sc]},
        attrs={"shape": [1], "dtype": "float32", "value": 0.0})
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 4)
    cond = L.less_than(i, n)
    loop = L.While(cond)
    with loop.block():
        L.increment(counter, value=1.5)
        L.increment(i, value=1)
        L.less_than(i, n, cond=cond)
    return [i]


def test_persistable_written_in_a_while_body_is_committed():
    runs, (jscope, pscope) = _run_both(_persistable_counter, [{}, {}])
    assert float(np.asarray(pscope.find_var("counter"))[0]) == 12.0
    np.testing.assert_array_equal(np.asarray(pscope.find_var("counter")),
                                  np.asarray(jscope.find_var("counter")))
    pm, _, _ = _build(pfluid, _persistable_counter)
    from paddle_tpu_torch.fluid.executor import _Plan

    assert _Plan(pm, ["counter"]).written == ["counter"]


def test_reference_protobuf_bytes_of_a_multi_block_program_run_in_the_port():
    jm, js, jout = _build(jfluid, _static_rnn)
    data = jm.serialize_to_string()
    pm = pfluid.Program.parse_from_string(data)
    assert pm.num_blocks == 2 and pm.serialize_to_string() == data
    jscope, pscope = jfluid.Scope(), pfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(js, scope=jscope)
    names = [v.name for v in jm.list_vars() if v.persistable]
    pfluid.copy_scope(jscope, pscope, names, device="cpu")
    feed = _cases()["static_rnn"][1](jfluid)[0]
    want = jexe.run(jm, feed=feed, fetch_list=jout[:1], scope=jscope)
    got = pfluid.Executor("cpu").run(pm, feed=feed, fetch_list=[
        jout[0].name], scope=pscope)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=RTOL,
                               atol=ATOL)
    # and the port's own bytes equal the reference's, clone included
    pm2, _, _ = _build(pfluid, _static_rnn)
    assert pm2.serialize_to_string() == data
    assert pm2.clone().to_desc() == jm.clone().to_desc()
    assert PF.Program.from_desc(pm2.to_desc()).to_desc() == pm2.to_desc()


def _cond_on_fc(fluid):
    L = fluid.layers
    x = L.data("x", shape=[4], dtype="float32")
    y = L.fc(x, size=3)
    out = L.cond(L.reduce_sum(x) > 0.0, lambda: L.scale(y, scale=2.0),
                 lambda: L.scale(y, scale=-1.0))
    loss = L.reduce_mean(out)
    fluid.optimizer.SGD(0.1).minimize(loss)
    return [out]


def test_inference_model_keeps_a_branch_s_parent_block_inputs(tmp_path):
    jm, js, jout = _build(jfluid, _cond_on_fc)
    pm, ps, pout = _build(pfluid, _cond_on_fc)
    jscope, pscope = jfluid.Scope(), pfluid.Scope()
    jexe, pexe = jfluid.Executor(), pfluid.Executor("cpu")
    jexe.run(js, scope=jscope)
    names = [v.name for v in jm.list_vars() if v.persistable]
    pfluid.copy_scope(jscope, pscope, names, device="cpu")
    pruned = pm._prune(pout)
    kept = [op.type for op in pruned.global_block().ops]
    assert kept == [op.type for op in jm._prune(jout).global_block().ops]
    assert "mul" in kept and "cond" in kept and "sgd" not in kept
    with pfluid.scope_guard(pscope):
        pfluid.io.save_inference_model(str(tmp_path), ["x"], pout, pexe,
                                       main_program=pm)
    scope = pfluid.Scope()
    with pfluid.scope_guard(scope):
        prog, feeds, fetches = pfluid.io.load_inference_model(
            str(tmp_path), pexe)
    xv = np.random.RandomState(5).rand(2, 4).astype(np.float32)
    for sign in (1.0, -1.0):
        got = pexe.run(prog, feed={"x": sign * xv}, fetch_list=fetches,
                       scope=scope)
        want = jexe.run(jm._prune(jout), feed={"x": sign * xv},
                        fetch_list=jout, scope=jscope)
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=RTOL,
                                   atol=ATOL)


# -- shape inference on meta tensors -----------------------------------------------


def test_every_control_flow_op_infers_on_meta_without_reading_a_predicate(
        monkeypatch):
    progs = [_build(pfluid, b)[0] for b in (
        _cond, _while_accumulate, _while_loop_functional, _switch_case,
        _static_rnn, _bounded_loop_gradient, _array_roundtrip,
        _array_in_while, _switch, _small_layers)]

    def no_read(self):
        raise AssertionError("a predicate was read under shape inference")

    monkeypatch.setattr(torch.Tensor, "item", no_read)
    seen = set()
    for prog in progs:
        for blk in prog.blocks:
            for op in blk.ops:
                if op.type in ("cond", "while", "while_loop", "switch",
                               "static_rnn", "create_array", "array_write",
                               "array_read", "array_length",
                               "tensor_array_to_tensor", "print", "range",
                               "assign_value", "arg_min", "logical_xor",
                               "logical_not"):
                    shapes = {n: blk._find_var_recursive(n).shape
                              for n in op.output_arg_names()}
                    PS.infer_op_shapes(op)
                    seen.add(op.type)
                    if PF.sub_block_ids(op):
                        # what the build recorded, again
                        assert shapes == {
                            n: blk._find_var_recursive(n).shape
                            for n in op.output_arg_names()}
    assert len(seen) == 16
    # StaticRNN's output: (T, B, H) declared as (-1, B, H)
    srnn = _build(pfluid, _static_rnn)[0]
    op = next(o for o in srnn.global_block().ops if o.type == "static_rnn")
    assert srnn.global_block().var(op.output("Out")[0]).shape == (
        -1, B_RNN, H_RNN)
