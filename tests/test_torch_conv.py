"""The port's convolutional ops (paddle_tpu_torch/fluid/ops/nn.py: conv2d,
depthwise_conv2d, pool2d, batch_norm; activations, math, metrics and the
momentum update) and its regularizers held to the JAX package on the CPU.

- Ops: the same seeded numpy inputs through both registries. fp32
  outputs at rtol 1e-5, atol 1e-6 (the same math, another summation
  order); the gradients of a random cotangent through jax.grad and
  torch autograd at rtol 1e-5, atol 1e-6 of the largest gradient.
- bf16 (AMP): both round their outputs to bf16, but at other points
  inside (the reference normalises a bf16 batch in bf16 arithmetic, the
  port in fp32 with one rounding), so outputs agree within two bf16
  steps, 2^-7 of the output's magnitude.
- Regularizers: the same program with ``Momentum(regularization=...)``
  in both packages, the same desc, and every persistable after two
  steps at rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
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
BF16_TOL = 2.0 ** -7

_R = np.random.RandomState(11)


def _f(*shape, scale=1.0, shift=0.0):
    return (_R.randn(*shape) * scale + shift).astype(np.float32)


def _desc(op_type, inputs, outputs, attrs):
    """A one-op program desc: ``inputs`` {slot: {name: array}},
    ``outputs`` {slot: [name]} (declared float32)."""
    vars_ = {}
    for items in inputs.values():
        for name, arr in items.items():
            dtype = "bfloat16" if arr.dtype == ml_dtypes.bfloat16 \
                else str(arr.dtype)
            vars_[name] = dict(name=name, shape=list(arr.shape), dtype=dtype,
                               persistable=False, stop_gradient=False,
                               is_data=False, is_parameter=False,
                               trainable=False)
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


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def _numpy(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _lower_both(op_type, inputs, outputs, attrs, wrt=(), cotangent=None):
    """Each package's outputs (float32 numpy) and, for the names in
    ``wrt``, the gradients of sum(first output * cotangent)."""
    desc = _desc(op_type, inputs, outputs, attrs)
    feeds = {n: a for d in inputs.values() for n, a in d.items()}
    out_names = [n for names in outputs.values() for n in names]
    jblock = JF.Program.from_desc(desc).global_block()

    def jrun(*vals):
        env = {n: jnp.asarray(a) for n, a in feeds.items()}
        env.update(zip(wrt, vals))
        JR.lower_op(JR.LowerCtx(jblock, env, jax.random.PRNGKey(0)),
                    jblock.ops[0])
        return env

    jenv = jrun(*[jnp.asarray(feeds[n]) for n in wrt])
    want = {n: np.asarray(jenv[n], dtype=np.float32) for n in out_names}
    pblock = PF.Program.from_desc(desc).global_block()
    penv = {n: _torch(a) for n, a in feeds.items()}
    for n in wrt:
        penv[n].requires_grad_(True)
    leaves = [penv[n] for n in wrt]
    PR.lower_op(PR.LowerCtx(pblock, penv, torch.Generator().manual_seed(0),
                            "cpu"), pblock.ops[0])
    got = {n: _numpy(penv[n]) for n in out_names}
    if not wrt:
        return want, got, None, None
    first = out_names[0]
    jgrad = jax.grad(lambda *v: jnp.sum(
        jrun(*v)[first].astype(jnp.float32) * cotangent),
        argnums=tuple(range(len(wrt))))(*[jnp.asarray(feeds[n])
                                          for n in wrt])
    pgrad = torch.autograd.grad(
        (penv[first].float() * torch.from_numpy(cotangent)).sum(), leaves)
    return want, got, [np.asarray(g, np.float32) for g in jgrad], \
        [_numpy(g) for g in pgrad]


def _check(want, got, rtol=RTOL, atol=ATOL):
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol, err_msg=name)


def _check_grads(jgrad, pgrad, wrt):
    for name, w, g in zip(wrt, jgrad, pgrad):
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=ATOL * max(1.0, np.abs(w).max()),
                                   err_msg=name)


def _conv_attrs(strides=1, paddings=0, dilations=1, groups=1, fmt="NCHW"):
    pair = (lambda v: [v, v] if isinstance(v, int) else list(v))
    return {"strides": pair(strides), "paddings": pair(paddings),
            "dilations": pair(dilations), "groups": groups,
            "data_format": fmt}


CONV_CASES = [
    # (op, x shape, w shape, attrs)
    ("conv2d", (2, 3, 9, 9), (4, 3, 3, 3), _conv_attrs()),
    ("conv2d", (2, 3, 11, 10), (5, 3, 3, 2),
     _conv_attrs(strides=[2, 1], paddings=[1, 2])),
    ("conv2d", (2, 4, 12, 12), (6, 4, 3, 3),
     _conv_attrs(paddings=2, dilations=2)),
    ("conv2d", (2, 6, 8, 8), (4, 3, 3, 3), _conv_attrs(groups=2, paddings=1)),
    ("conv2d", (2, 16, 7, 7), (8, 16, 1, 1), _conv_attrs(strides=2)),
    ("conv2d", (2, 12, 13, 3), (4, 3, 7, 7),
     _conv_attrs(strides=2, paddings=3, fmt="NHWC")),
    ("conv2d", (2, 6, 6, 8), (8, 4, 3, 3),
     _conv_attrs(paddings=1, groups=2, fmt="NHWC")),
    ("depthwise_conv2d", (2, 5, 8, 8), (5, 1, 3, 3),
     _conv_attrs(paddings=1)),
    ("depthwise_conv2d", (2, 8, 8, 5), (5, 1, 3, 3),
     _conv_attrs(strides=2, paddings=1, fmt="NHWC")),
]


@pytest.mark.parametrize("op_type,xs,ws,attrs", CONV_CASES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(CONV_CASES)])
def test_conv2d_matches_reference(op_type, xs, ws, attrs):
    x, w = _f(*xs), _f(*ws, scale=0.3)
    want, got, _, _ = _lower_both(op_type, {"Input": {"x": x},
                                            "Filter": {"w": w}},
                                  {"Output": ["out"]}, attrs)
    cot = _f(*want["out"].shape)
    want, got, jg, pg = _lower_both(op_type, {"Input": {"x": x},
                                              "Filter": {"w": w}},
                                    {"Output": ["out"]}, attrs,
                                    wrt=("x", "w"), cotangent=cot)
    _check(want, got)
    _check_grads(jg, pg, ("x", "w"))


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_conv2d_bf16_matches_reference(fmt):
    """AMP: bf16 input and filter (the rewrite's casts), bf16 output."""
    xs = (2, 8, 10, 10) if fmt == "NCHW" else (2, 10, 10, 8)
    x = _f(*xs).astype(ml_dtypes.bfloat16)
    w = _f(16, 8, 3, 3, scale=0.2).astype(ml_dtypes.bfloat16)
    want, got, _, _ = _lower_both("conv2d", {"Input": {"x": x},
                                             "Filter": {"w": w}},
                                  {"Output": ["out"]},
                                  _conv_attrs(strides=2, paddings=1, fmt=fmt))
    scale = np.abs(want["out"]).max()
    _check(want, got, rtol=BF16_TOL, atol=BF16_TOL * scale)


def _pool_attrs(ptype="max", ksize=2, strides=2, paddings=0, ceil=False,
                exclusive=True, global_pooling=False, adaptive=False,
                fmt="NCHW"):
    pair = (lambda v: [v, v] if isinstance(v, int) else list(v))
    return {"pooling_type": ptype, "ksize": pair(ksize),
            "strides": pair(strides), "paddings": pair(paddings),
            "ceil_mode": ceil, "exclusive": exclusive,
            "global_pooling": global_pooling, "adaptive": adaptive,
            "data_format": fmt}


POOL_CASES = [
    ((2, 3, 8, 8), _pool_attrs()),
    ((2, 3, 9, 9), _pool_attrs(ksize=3, strides=2, paddings=1)),  # ResNet stem
    ((2, 3, 9, 9), _pool_attrs("avg", ksize=3, strides=2, paddings=1)),
    ((2, 3, 9, 9), _pool_attrs("avg", ksize=3, strides=2, paddings=1,
                               exclusive=False)),
    ((2, 3, 9, 8), _pool_attrs("max", ksize=2, strides=2, ceil=True)),
    ((2, 3, 9, 8), _pool_attrs("avg", ksize=3, strides=2, ceil=True,
                               exclusive=False)),
    # ceil mode where the last window starts in the padding: torch drops
    # that window, the reference keeps it (all padding: -inf)
    ((2, 3, 5, 5), _pool_attrs("max", ksize=2, strides=2, paddings=1,
                               ceil=True)),
    # padding past half a window, which torch's pooling refuses
    ((2, 3, 7, 7), _pool_attrs("max", ksize=2, strides=1, paddings=2)),
    ((2, 3, 7, 7), _pool_attrs("avg", ksize=2, strides=1, paddings=2,
                               exclusive=False)),
    ((2, 3, 7, 7), _pool_attrs("avg", ksize=2, strides=1, paddings=2)),
    ((2, 8, 7, 7), _pool_attrs("avg", global_pooling=True)),
    ((2, 8, 7, 5), _pool_attrs("max", global_pooling=True)),
    ((2, 3, 8, 6), _pool_attrs("avg", ksize=[2, 3], adaptive=True)),
    ((2, 3, 8, 6), _pool_attrs("max", ksize=[4, 2], adaptive=True)),
    ((2, 9, 9, 3), _pool_attrs(ksize=3, strides=2, paddings=1, fmt="NHWC")),
    ((2, 7, 7, 8), _pool_attrs("avg", global_pooling=True, fmt="NHWC")),
    ((2, 9, 8, 3), _pool_attrs("avg", ksize=3, strides=2, ceil=True,
                               fmt="NHWC")),
]


@pytest.mark.parametrize("xs,attrs", POOL_CASES,
                         ids=["%s-%d" % (c[1]["pooling_type"], i)
                              for i, c in enumerate(POOL_CASES)])
def test_pool2d_matches_reference(xs, attrs):
    x = _f(*xs)
    want, _, _, _ = _lower_both("pool2d", {"X": {"x": x}}, {"Out": ["out"]},
                                attrs)
    cot = _f(*want["out"].shape)
    finite = np.isfinite(want["out"])
    cot[~finite] = 0.0
    want, got, jg, pg = _lower_both("pool2d", {"X": {"x": x}},
                                    {"Out": ["out"]}, attrs, wrt=("x",),
                                    cotangent=cot)
    np.testing.assert_array_equal(np.isfinite(got["out"]), finite)
    _check({"out": np.where(finite, want["out"], 0.0)},
           {"out": np.where(finite, got["out"], 0.0)})
    _check_grads(jg, pg, ("x",))


def _bn_inputs(xs, ch_axis, x_dtype=np.float32):
    c = xs[ch_axis]
    return {"X": {"x": _f(*xs, scale=2.0, shift=0.5).astype(x_dtype)},
            "Scale": {"s": _f(c, scale=0.5, shift=1.0)},
            "Bias": {"b": _f(c, scale=0.5)},
            "Mean": {"m": _f(c, scale=0.2)},
            "Variance": {"v": np.abs(_f(c)) + 0.5}}


BN_OUTS = {"Y": ["y"], "MeanOut": ["m"], "VarianceOut": ["v"],
           "SavedMean": ["sm"], "SavedVariance": ["sv"]}

BN_CASES = [
    # (x shape, layout, is_test, use_global_stats)
    ((4, 3, 5, 6), "NCHW", False, False),
    ((6, 5), "NCHW", False, False),
    ((4, 5, 6, 3), "NHWC", False, False),
    ((4, 3, 5, 6), "NCHW", True, False),
    ((4, 5, 6, 3), "NHWC", True, False),
    ((4, 3, 5, 6), "NCHW", False, True),
]


@pytest.mark.parametrize("xs,layout,is_test,global_stats", BN_CASES,
                         ids=["%s-train" % c[1] if not (c[2] or c[3]) else
                              "%s-%s" % (c[1], "test" if c[2] else "global")
                              for c in BN_CASES])
def test_batch_norm_matches_reference(xs, layout, is_test, global_stats):
    """Training: Y, the running statistics moved toward the BIASED batch
    variance, SavedMean and SavedVariance (1/sqrt(var + eps)); test mode
    and use_global_stats: Y from the running statistics, which stay."""
    ins = _bn_inputs(xs, 1 if layout == "NCHW" else len(xs) - 1)
    attrs = {"epsilon": 1e-5, "momentum": 0.9, "is_test": is_test,
             "data_layout": layout, "use_global_stats": global_stats}
    training = not (is_test or global_stats)
    outs = BN_OUTS if training else {"Y": ["y"]}
    cot = _f(*xs)
    want, got, jg, pg = _lower_both("batch_norm", ins, outs, attrs,
                                    wrt=("x", "s", "b"), cotangent=cot)
    _check(want, got)
    _check_grads(jg, pg, ("x", "s", "b"))
    if training:
        x = ins["X"]["x"].astype(np.float64)
        axes = tuple(i for i in range(x.ndim)
                     if i != (1 if layout == "NCHW" else x.ndim - 1))
        biased = x.var(axis=axes)
        np.testing.assert_allclose(
            got["v"], 0.9 * ins["Variance"]["v"] + 0.1 * biased, rtol=1e-5)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_batch_norm_bf16_x_fp32_statistics(layout):
    """AMP: a bf16 X with fp32 Scale, Bias and running statistics (the
    rewrite keeps them fp32): Y in bf16 within two bf16 steps; the
    statistics fp32 at rtol 1e-5 (both take them in fp32 from the same
    bf16 values)."""
    xs = (4, 6, 5, 5) if layout == "NCHW" else (4, 5, 5, 6)
    ins = _bn_inputs(xs, 1 if layout == "NCHW" else 3, ml_dtypes.bfloat16)
    attrs = {"epsilon": 1e-5, "momentum": 0.9, "is_test": False,
             "data_layout": layout, "use_global_stats": False}
    want, got, _, _ = _lower_both("batch_norm", ins, BN_OUTS, attrs)
    scale = np.abs(want["y"]).max()
    _check({"y": want["y"]}, {"y": got["y"]}, rtol=BF16_TOL,
           atol=BF16_TOL * scale)
    _check({n: want[n] for n in ("m", "v", "sm", "sv")},
           {n: got[n] for n in ("m", "v", "sm", "sv")})


OP_CASES = [
    ("relu", {"X": {"x": _f(3, 7)}}, {"Out": ["out"]}, {}),
    ("sign", {"X": {"x": np.array([-2.0, 0.0, 3.0, -0.5], np.float32)}},
     {"Out": ["out"]}, {}),
    ("mean", {"X": {"x": _f(4, 5, 6)}}, {"Out": ["out"]}, {}),
    ("sum", {"X": {"a": _f(3, 4), "b": _f(3, 4), "c": _f(3, 4)}},
     {"Out": ["out"]}, {}),
    ("top_k", {"X": {"x": _f(6, 20)}}, {"Out": ["v"], "Indices": ["i"]},
     {"k": 5}),
    ("momentum", {"Param": {"p": _f(4, 3)}, "Grad": {"g": _f(4, 3)},
                  "Velocity": {"vel": _f(4, 3, scale=0.1)},
                  "LearningRate": {"lr": np.array([0.1], np.float32)}},
     {"ParamOut": ["p"], "VelocityOut": ["vel"]},
     {"mu": 0.9, "use_nesterov": False}),
    ("momentum", {"Param": {"p": _f(4, 3)}, "Grad": {"g": _f(4, 3)},
                  "Velocity": {"vel": _f(4, 3, scale=0.1)},
                  "LearningRate": {"lr": np.array([0.1], np.float32)}},
     {"ParamOut": ["p"], "VelocityOut": ["vel"]},
     {"mu": 0.9, "use_nesterov": True}),
]


@pytest.mark.parametrize("op_type,inputs,outputs,attrs", OP_CASES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(OP_CASES)])
def test_op_matches_reference(op_type, inputs, outputs, attrs):
    want, got, _, _ = _lower_both(op_type, inputs, outputs, attrs)
    _check(want, got)
    if op_type == "mean":
        assert got["out"].shape == ()
    if op_type == "top_k":
        assert got["i"].dtype == np.int64


@pytest.mark.parametrize("k", [1, 5])
def test_accuracy_matches_reference(k):
    """top_k + accuracy on fp32 scores (no ties): Accuracy, Correct and
    Total; Total is made on the device as an int32 scalar."""
    scores = _f(64, 10)
    label = _R.randint(0, 10, (64, 1)).astype(np.int64)
    vals, idx = torch.topk(torch.from_numpy(scores), k)
    inputs = {"Out": {"vals": vals.numpy()}, "Indices": {"idx": idx.numpy()},
              "Label": {"label": label}}
    outs = {"Accuracy": ["acc"], "Correct": ["correct"], "Total": ["total"]}
    want, got, _, _ = _lower_both("accuracy", inputs, outs, {})
    _check(want, got)
    assert got["total"] == 64 and got["correct"] == want["correct"]
    # the layer: the same desc in both packages and the same value
    progs = []
    for fluid in (jfluid, pfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data("x", shape=[10], dtype="float32")
            lab = fluid.layers.data("label", shape=[1], dtype="int64")
            acc = fluid.layers.accuracy(x, lab, k=k)
        progs.append((main, acc))
    assert progs[1][0].to_desc() == progs[0][0].to_desc()
    feed = {"x": scores, "label": label}
    want = jfluid.Executor().run(progs[0][0], feed=feed,
                                 fetch_list=[progs[0][1]])[0]
    got = pfluid.Executor("cpu").run(progs[1][0], feed=feed,
                                     fetch_list=[progs[1][1]])[0]
    np.testing.assert_allclose(got, want, rtol=RTOL)


def _decay_program(fluid, regularizer, nesterov=False):
    """conv2d (no bias: the norm would cancel its gradient) ->
    batch_norm(relu) -> global avg pool -> fc -> mean, trained by
    Momentum with ``regularizer``."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        L = fluid.layers
        img = L.data("img", shape=[3, 8, 8], dtype="float32")
        h = L.conv2d(img, num_filters=4, filter_size=3, padding=1,
                     bias_attr=False)
        h = L.batch_norm(h, act="relu")
        h = L.pool2d(h, pool_type="avg", global_pooling=True)
        loss = L.mean(L.fc(h, size=3))
        fluid.optimizer.Momentum(
            learning_rate=0.1, momentum=0.9, use_nesterov=nesterov,
            regularization=regularizer).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("kind,nesterov", [("L2Decay", False),
                                           ("L1Decay", False),
                                           ("L2DecayRegularizer", True)])
def test_regularizer_matches_reference(kind, nesterov):
    """Weight decay on every parameter (the norm's scale and bias too):
    the same desc, and every persistable after two steps."""
    jm, js, jl = _decay_program(jfluid, getattr(jfluid.regularizer, kind)(
        0.05), nesterov)
    pm, ps, pl = _decay_program(pfluid, getattr(pfluid.regularizer, kind)(
        0.05), nesterov)
    assert pm.to_desc() == jm.to_desc()
    types = [op.type for op in pm.global_block().ops]
    n_params = len(pm.all_parameters())
    assert types.count("momentum") == n_params == 5
    assert types.count("scale") == n_params
    assert types.count("sign") == (n_params if kind == "L1Decay" else 0)
    jscope, jexe = jfluid.Scope(), jfluid.Executor()
    jexe.run(js, scope=jscope)
    names = [v.name for v in jm.list_vars() if v.persistable]
    pscope = pfluid.Scope()
    pfluid.copy_scope(jscope, pscope, names, device="cpu")
    pexe = pfluid.Executor("cpu")
    feed = {"img": _f(4, 3, 8, 8)}
    for _ in range(2):
        jexe.run(jm, feed=feed, fetch_list=[jl], scope=jscope)
        pexe.run(pm, feed=feed, fetch_list=[pl], scope=pscope)
    for n in names:
        np.testing.assert_allclose(pscope.find_var(n).numpy(),
                                   np.asarray(jscope.find_var(n)),
                                   rtol=RTOL, atol=ATOL, err_msg=n)
