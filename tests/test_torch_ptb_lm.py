"""The PTB language model of PaddlePaddle/models' ``lm_model.py``
(``rnn_model="static"``: two LSTM layers written as matmul / split /
sigmoid / tanh inside one StaticRNN, SGD under a global-norm clip), as
``chip_smoke.ptb_lm_program`` builds it from ``fluid.layers``, held to
the JAX package on the CPU at small widths (vocabulary 50, hidden 16, 5
steps, batch 4, 2 layers): the same desc inside ``unique_name.guard()``;
from the reference's startup state, 10 steps whose last hidden and cell
are fed back as the next step's initial state give the reference's
losses at rtol 1e-4; then greedy decodes from the trained state, through
``layers.While`` and through ``while_loop(maximum_trip_count=)``, give
the reference's tokens. Dropout inside a StaticRNN step at p 0.5 (the
reference's parity runs at p 0): its keep rate and scale, a mask a step,
and the gradient taken through the masks the forward drew."""

import os
import sys

import numpy as np
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as pfluid

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

TRAJ_RTOL = 1e-4
STEPS = 10
SMALL = dict(vocab=50, layers=2, hidden=16, steps=5, batch=4,
             init_scale=0.1, dropout=0.0)
DECODE = 6


def _programs(fluid):
    with fluid.unique_name.guard():
        lm = chip_smoke.ptb_lm_program(fluid, **SMALL)
    decodes = {}
    for bounded in (False, True):
        with fluid.unique_name.guard():
            decodes[bounded] = chip_smoke.ptb_decode_program(
                fluid, n=DECODE, bounded=bounded, **SMALL)
    return lm, decodes


def test_ptb_lm_trajectory_and_decodes_match_reference():
    (jm, js, jloss, jh, jc), jdec = _programs(jfluid)
    (pm, ps, ploss, ph, pc), pdec = _programs(pfluid)
    assert pm.to_desc() == jm.to_desc()
    for bounded in (False, True):
        assert pdec[bounded][0].to_desc() == jdec[bounded][0].to_desc()
    assert [op.type for op in pm.global_block().ops].count(
        "static_rnn") == 1
    jscope, pscope = jfluid.Scope(), pfluid.Scope()
    jexe, pexe = jfluid.Executor(), pfluid.Executor("cpu")
    jexe.run(js, scope=jscope)
    names = [v.name for v in jm.list_vars()
             if v.persistable and jscope.find_var(v.name) is not None]
    pfluid.copy_scope(jscope, pscope, names, device="cpu")
    want, got = [], []
    jstate = pstate = None
    for step in range(STEPS):
        feed = chip_smoke.ptb_feed(seed=step, **SMALL)
        jfeed, pfeed = dict(feed), dict(feed)
        if step:
            jfeed["init_hidden"], jfeed["init_cell"] = jstate
            pfeed["init_hidden"], pfeed["init_cell"] = pstate
        jl, jhv, jcv = jexe.run(jm, feed=jfeed, fetch_list=[jloss, jh, jc],
                                scope=jscope)
        pl, phv, pcv = pexe.run(pm, feed=pfeed, fetch_list=[ploss, ph, pc],
                                scope=pscope)
        jstate = (np.asarray(jhv), np.asarray(jcv))
        pstate = (phv, pcv)
        assert phv.shape == (SMALL["layers"], SMALL["batch"],
                             SMALL["hidden"])
        want.append(float(np.asarray(jl).reshape(-1)[0]))
        got.append(float(pl.reshape(-1)[0]))
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
    assert all(np.isfinite(got))

    rng = np.random.RandomState(11)
    feed = {"first": rng.randint(0, SMALL["vocab"],
                                 (SMALL["batch"], 1)).astype(np.int64),
            "init_hidden": pstate[0], "init_cell": pstate[1]}
    tokens = {}
    for bounded in (False, True):
        jprog, jseq, jfirst = jdec[bounded]
        pprog, pseq, pfirst = pdec[bounded]
        fetch = [v for v in (jseq, jfirst) if v is not None]
        pfetch = [v for v in (pseq, pfirst) if v is not None]
        jfeed = dict(feed, init_hidden=jstate[0], init_cell=jstate[1])
        jout = jexe.run(jprog, feed=jfeed, fetch_list=fetch, scope=jscope)
        pout = pexe.run(pprog, feed=feed, fetch_list=pfetch, scope=pscope)
        assert pout[0].shape == (SMALL["batch"], DECODE + 1)
        np.testing.assert_array_equal(pout[0], np.asarray(jout[0]))
        np.testing.assert_array_equal(pout[0][:, :1], feed["first"])
        if pfirst is not None:
            np.testing.assert_allclose(pout[1], np.asarray(jout[1]),
                                       rtol=1e-4, atol=1e-5)
        tokens[bounded] = pout[0]
    np.testing.assert_array_equal(tokens[False], tokens[True])


def _dropout_rnn(fluid, T, B, D, p):
    """out_t = dropout(x_t * w) in a StaticRNN step; the loss sums it."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data("x", shape=[T, B, D], dtype="float32",
                   append_batch_size=False)
        w = L.create_parameter([D], "float32", name="w",
                               default_initializer=fluid.initializer
                               .Constant(1.0))
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            rnn.step_output(L.dropout(
                L.elementwise_mul(x_t, w), dropout_prob=p,
                dropout_implementation="upscale_in_train"))
        out = rnn()
        fluid.backward.append_backward(L.reduce_sum(out))
    return main, startup, out


def test_dropout_inside_static_rnn_keep_rate_scale_and_one_mask():
    """At p 0.5 each step draws its own mask from the scope's generator:
    about half the elements kept, each scaled by 1 / (the realised keep
    rate), the steps' masks different; the gradient of w is the sum of
    the very masks the forward applied; and a second run from the same
    generator state repeats the run to the bit."""
    T, B, D, p = 4, 64, 64, 0.5
    main, startup, out = _dropout_rnn(pfluid, T, B, D, p)
    scope = pfluid.Scope()
    exe = pfluid.Executor("cpu")
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((T, B, D), np.float32)}
    state = scope.generator.get_state()
    o, g = exe.run(main, feed=feed, fetch_list=[out, "w@GRAD"], scope=scope)
    scale = 1.0 / (round((1 - p) * 256) / 256)
    assert set(np.unique(o)) <= {0.0, np.float32(scale)}
    rate = (o != 0).mean()
    assert abs(rate - (1 - p)) < 0.02, rate
    assert all(not np.array_equal(o[0], o[t]) for t in range(1, T))
    np.testing.assert_allclose(g, o.sum(axis=(0, 1)), rtol=1e-6)
    scope.generator.set_state(state)
    scope.set_var("w", torch.ones(D))
    o2, g2 = exe.run(main, feed=feed, fetch_list=[out, "w@GRAD"],
                     scope=scope)
    np.testing.assert_array_equal(o2, o)
    np.testing.assert_array_equal(g2, g)
