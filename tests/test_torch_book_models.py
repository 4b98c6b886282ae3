"""The port's book models (paddle_tpu_torch/models/word2vec.py and vgg.py),
``fluid.nets``, the static learning-rate schedules, the gradient clips
and the Variable operator sugar, held to the JAX package on the CPU.

- Programs: built by both packages inside ``unique_name.guard()``, the
  same desc (word2vec; VGG16-BN at width 0.125 with its dropout at the
  built rates; each ``nets`` block; each schedule and clip; the sugar).
- word2vec: 10 Adam steps on one batch from the reference's startup
  state, losses at rtol 1e-4, falling. VGG16-BN: the dropout rates set to 0 in both descs (the
  parity protocol: the two packages draw different masks), 5 steps at
  batch 8, losses at rtol 1e-4. At batch 16 both packages' fp32 runs
  leave the float64 run of the same program by 1-2% by step 5 (the
  last stage's batch norm normalises 16 numbers a channel at 1x1), so
  no fp32 trajectory there says anything about the port.
- ``nets``: each block's forward from the reference's state, rtol 1e-5.
- Schedules: each of the eight drives SGD on a small linear model for 6
  steps; the learning rate each step at rtol 1e-6 and the weights after
  the last at rtol 1e-5. Clips: by value, by norm, by global norm (the
  reference's ``set_gradient_clip``; the port's optimizer
  ``grad_clip=``, the same ops) and one attached to a parameter, 6 SGD
  steps, the clipped gradients each step and the weights at rtol 1e-5.
- Sugar: ``+ - * / **``, unary minus, the comparisons and ``astype``,
  with scalars on either side, append the reference's ops; their values
  agree.
- ``grad_clip`` in dygraph mode raises, naming ROADMAP queue 1 item 6.
"""

import math

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import framework as JF
from paddle_tpu.models import vgg as JV
from paddle_tpu.models import word2vec as JW
import paddle_tpu_torch.fluid as pfluid
from paddle_tpu_torch.fluid import dygraph
from paddle_tpu_torch.fluid import framework as PF
from paddle_tpu_torch.models import vgg as PV
from paddle_tpu_torch.models import word2vec as PW


def _persistables(main):
    return [v.name for v in main.list_vars() if v.persistable]


def _start_both(jm, js, pm):
    """The reference's scope after its startup program, and the port's
    scope holding a copy of it."""
    jscope = jfluid.Scope()
    jfluid.Executor().run(js, scope=jscope)
    pscope = pfluid.Scope()
    pfluid.copy_scope(jscope, pscope, _persistables(jm), device="cpu")
    return jscope, pscope


def _run_both(jm, pm, jscope, pscope, feeds, fetch):
    """Each feed through both programs; the fetches (names) as numpy."""
    jexe, pexe = jfluid.Executor(), pfluid.Executor("cpu")
    want, got = [], []
    for f in feeds:
        want.append([np.asarray(x) for x in jexe.run(
            jm, feed=f, fetch_list=fetch, scope=jscope)])
        got.append([np.asarray(x) for x in pexe.run(
            pm, feed=f, fetch_list=fetch, scope=pscope)])
    return want, got


def _loss_values(runs):
    return [float(r[0].reshape(-1)[0]) for r in runs]


# -- word2vec and VGG16-BN ------------------------------------------------------------


def test_word2vec_matches_reference():
    with jfluid.unique_name.guard():
        jm, js, jl, _ = JW.build_train_program()
    with pfluid.unique_name.guard():
        pm, ps, pl, _ = PW.build_train_program()
    assert pm.to_desc() == jm.to_desc() and ps.to_desc() == js.to_desc()
    jscope, pscope = _start_both(jm, js, pm)
    rng = np.random.RandomState(0)
    feeds = [JW.synthetic_ngrams(rng, 32)] * 10      # memorised: falls
    want, got = _run_both(jm, pm, jscope, pscope, feeds, [jl.name])
    want, got = _loss_values(want), _loss_values(got)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def _no_dropout(framework, program):
    desc = program.to_desc()
    for op in desc["blocks"][0]["ops"]:
        if op["type"] == "dropout":
            op["attrs"]["dropout_prob"] = 0.0
    return framework.Program.from_desc(desc)


def test_vgg16_bn_matches_reference():
    with jfluid.unique_name.guard():
        jm, js, jl, _ = JV.build_train_program(width_mult=0.125)
    with pfluid.unique_name.guard():
        pm, ps, pl, _ = PV.build_train_program(width_mult=0.125)
    assert pm.to_desc() == jm.to_desc() and ps.to_desc() == js.to_desc()
    rates = [op.attr("dropout_prob") for op in pm.global_block().ops
             if op.type == "dropout"]
    assert rates == [0.3, 0.4, 0.4, 0.4, 0.4, 0.4, 0.4, 0.4, 0.5, 0.5]
    jm, pm = _no_dropout(JF, jm), _no_dropout(PF, pm)
    jscope, pscope = _start_both(jm, js, pm)
    rng = np.random.RandomState(0)
    feeds = [JV.synthetic_cifar(rng, 8) for _ in range(5)]
    want, got = _run_both(jm, pm, jscope, pscope, feeds, [jl.name])
    np.testing.assert_allclose(_loss_values(got), _loss_values(want),
                               rtol=1e-4)


# -- nets -------------------------------------------------------------------------------


def _nets_program(fluid, kind):
    """A program of one ``nets`` block; the feed's shapes."""
    shapes = {"x": (3, 12, 12)} if "img" in kind else \
        {"x": (4, 6)} if kind == "glu" else \
        {"x": (5, 8), "k": (7, 8), "v": (7, 6)}
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L, nets = fluid.layers, fluid.nets
        ins = {n: L.data(n, list(s)) for n, s in shapes.items()}
        if kind == "simple_img_conv_pool":
            out = nets.simple_img_conv_pool(ins["x"], 4, 3, 2, 2, act="relu")
        elif kind == "img_conv_group":
            out = nets.img_conv_group(
                ins["x"], [4, 6], 2, conv_act="relu", pool_stride=2,
                conv_with_batchnorm=[True, False])
        elif kind == "glu":
            out = nets.glu(ins["x"], dim=-1)
        else:
            out = nets.scaled_dot_product_attention(
                ins["x"], ins["k"], ins["v"],
                num_heads=1 if kind == "attention_1" else 2)
    return main, startup, out, shapes


NETS = ["simple_img_conv_pool", "img_conv_group", "glu", "attention_1",
        "attention_2"]


@pytest.mark.parametrize("kind", NETS)
def test_nets_match_reference(kind):
    jm, js, jout, shapes = _nets_program(jfluid, kind)
    pm, ps, _, _ = _nets_program(pfluid, kind)
    assert pm.to_desc() == jm.to_desc() and ps.to_desc() == js.to_desc()
    rng = np.random.RandomState(3)
    feed = {n: rng.randn(2, *s).astype(np.float32)
            for n, s in shapes.items()}
    jscope, pscope = _start_both(jm, js, pm)
    want, got = _run_both(jm, pm, jscope, pscope, [feed], [jout.name])
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=1e-5, atol=1e-6)


# -- learning-rate schedules and gradient clips ----------------------------------------

SCHEDULES = {
    "noam": lambda L: L.noam_decay(64, 3),
    "exponential": lambda L: L.exponential_decay(0.5, 2, 0.7,
                                                 staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.5, 3, 0.4),
    "inverse_time": lambda L: L.inverse_time_decay(0.5, 2, 0.6,
                                                   staircase=True),
    "polynomial": lambda L: L.polynomial_decay(0.5, 4, 0.01, power=2.0),
    "polynomial_cycle": lambda L: L.polynomial_decay(0.5, 2, 0.01,
                                                     power=1.5, cycle=True),
    "piecewise": lambda L: L.piecewise_decay([2, 4], [0.3, 0.2, 0.1]),
    "cosine": lambda L: L.cosine_decay(0.5, 2, 4),
    "linear_warmup": lambda L: L.linear_lr_warmup(
        L.exponential_decay(0.5, 2, 0.7), 3, 0.01, 0.5),
}


def _linear_program(fluid, lr=None, clip=None, param_clip=None):
    """y = fc(x) with a mean-square loss, SGD at ``lr`` (a float or a
    schedule built here) with ``clip``: the reference's global clip
    (``set_gradient_clip``), the port's optimizer ``grad_clip=``;
    ``param_clip`` attached to the weight alone."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", [4])
        y = L.fc(x, size=3)
        loss = L.mean(L.elementwise_mul(y, y))
        rate = lr(L) if callable(lr) else 0.1
        kw = {}
        if param_clip is not None:
            fluid.clip.set_gradient_clip(
                param_clip(fluid.clip),
                param_list=[main.all_parameters()[0].name])
        if clip is not None and fluid is pfluid:
            kw["grad_clip"] = clip(fluid.clip)
        elif clip is not None:
            fluid.clip.set_gradient_clip(clip(fluid.clip))
        try:
            fluid.optimizer.SGD(rate, **kw).minimize(loss)
        finally:
            fluid.clip.set_gradient_clip(None)
    return main, startup, loss, rate


def _clipped_grads(main):
    """The gradient var each ``sgd`` op applies, in parameter order."""
    ops = [op for op in main.global_block().ops if op.type == "sgd"]
    return [op.input("Grad")[0] for op in ops]


def _six_steps(jm, js, pm, fetch):
    jscope, pscope = _start_both(jm, js, pm)
    rng = np.random.RandomState(1)
    feeds = [{"x": rng.randn(5, 4).astype(np.float32) * 3}
             for _ in range(6)]
    want, got = _run_both(jm, pm, jscope, pscope, feeds, fetch)
    params = [p.name for p in pm.all_parameters()]
    return want, got, [np.asarray(jscope.find_var(n)) for n in params], \
        [pscope.find_var(n).numpy() for n in params]


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    jm, js, _, jlr = _linear_program(jfluid, SCHEDULES[name])
    pm, ps = _linear_program(pfluid, SCHEDULES[name])[:2]
    assert pm.to_desc() == jm.to_desc() and ps.to_desc() == js.to_desc()
    want, got, wparams, gparams = _six_steps(jm, js, pm, [jlr.name])
    lrs = [float(g[0].reshape(-1)[0]) for g in got]
    np.testing.assert_allclose(lrs, [float(w[0].reshape(-1)[0])
                                     for w in want], rtol=1e-6)
    assert len(set(lrs)) > 1          # the counter advanced
    for w, g in zip(wparams, gparams):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)


def test_exponential_decay_follows_its_closed_form():
    pm, ps, _, plr = _linear_program(pfluid, SCHEDULES["exponential"])
    scope, exe = pfluid.Scope(), pfluid.Executor("cpu")
    exe.run(ps, scope=scope)
    feed = {"x": np.ones((2, 4), np.float32)}
    for step in range(6):
        lr = exe.run(pm, feed=feed, fetch_list=[plr], scope=scope)[0]
        assert math.isclose(float(lr.reshape(-1)[0]),
                            0.5 * 0.7 ** (step // 2), rel_tol=1e-6)
        assert int(scope.find_var("@LR_STEP@")[0]) == step


CLIPS = {
    "value": (lambda c: c.GradientClipByValue(0.05, -0.02), None),
    "norm": (lambda c: c.GradientClipByNorm(0.1), None),
    "global_norm": (lambda c: c.GradientClipByGlobalNorm(0.1), None),
    "param_and_global": (lambda c: c.GradientClipByGlobalNorm(0.2),
                         lambda c: c.GradientClipByValue(0.01)),
}


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_gradient_clip_matches_reference(name):
    clip, param_clip = CLIPS[name]
    jm, js = _linear_program(jfluid, clip=clip, param_clip=param_clip)[:2]
    pm, ps = _linear_program(pfluid, clip=clip, param_clip=param_clip)[:2]
    assert pm.to_desc() == jm.to_desc() and ps.to_desc() == js.to_desc()
    grads = _clipped_grads(pm)
    assert not any(g.endswith("@GRAD") for g in grads)     # clipped
    want, got, wparams, gparams = _six_steps(jm, js, pm, grads)
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-8)
    if name == "value":
        assert all(g.max() <= 0.05 and g.min() >= -0.02 for g in got[0])
    for w, g in zip(wparams, gparams):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)


def test_grad_clip_in_dygraph_mode_raises_naming_item_6():
    clip = pfluid.clip.GradientClipByGlobalNorm(1.0)
    with dygraph.guard("cpu"):
        model = dygraph.nn.Linear(2, 1)
        out = model(dygraph.to_variable(np.ones((2, 2), np.float32)))
        loss = pfluid.layers.mean(out)
        with pytest.raises(NotImplementedError,
                           match="ROADMAP queue 1 item 6"):
            pfluid.optimizer.SGD(0.1, grad_clip=clip).minimize(
                loss, parameter_list=model.parameters())
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 6"):
        pfluid.optimizer.Adam(0.1, grad_clip=lambda pg: pg)


# -- the Variable operator sugar -------------------------------------------------------


def _sugar_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", [3])
        y = L.data("y", [3])
        outs = [x + 2.0, 2.0 + x, x + y, x - y, 3.0 - x, x - 1.5, x * 0.5,
                0.5 * x, x * y, x / y, 1.0 / x, x / 4.0, x ** 2, x ** y, -x,
                (x < y).astype("float32"), L.cast(x >= 0.5, "float32"),
                L.cast(x > y, "float32"), L.cast(1.0 <= x, "float32"),
                L.cast(L.less_than(x, y), "float32"),
                L.cast(L.less_equal(x, y), "float32"),
                L.cast(L.greater_than(x, y), "float32"),
                L.cast(L.greater_equal(x, y), "float32"),
                L.cast(L.equal(x, x), "float32"),
                L.cast(L.not_equal(x, y), "float32")]
    return main, startup, outs


def test_operator_sugar_matches_reference():
    jm, js, jouts = _sugar_program(jfluid)
    pm, ps, pouts = _sugar_program(pfluid)
    assert pm.to_desc() == jm.to_desc()
    types = [op.type for op in pm.global_block().ops]
    assert types[:2] == ["scale", "fill_constant"]    # x + c, then c + x
    assert all(v.dtype == np.dtype("bool") for v in pm.list_vars()
               if v.op is not None and v.op.type in (
                   "less_than", "less_equal", "greater_than",
                   "greater_equal", "equal", "not_equal"))
    rng = np.random.RandomState(4)
    feed = {"x": rng.rand(2, 3).astype(np.float32) + 0.1,
            "y": rng.rand(2, 3).astype(np.float32) + 0.1}
    jscope, pscope = _start_both(jm, js, pm)
    want, got = _run_both(jm, pm, jscope, pscope, [feed],
                          [v.name for v in pouts])
    for v, w, g in zip(pouts, want[0], got[0]):
        np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=v.name)
