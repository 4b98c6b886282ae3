"""The port's dygraph layer (paddle_tpu_torch/fluid/dygraph/ and the
eager branch of fluid/optimizer.py) held to the JAX package's on the CPU:
the same numpy inputs through both, the reference's parameters copied
across by path. VarBase arithmetic and gradients, accumulation into a
leaf, ``stop_gradient`` and ``no_grad`` (tests/test_dygraph.py:14,
:148); the eager SGD, Momentum and Adam with L2Decay over 3 steps,
parameters and accumulators within rtol 1e-5; every learning-rate decay
object, value for value and driving an optimizer (:171, :216);
``state_dict`` / ``set_dict`` round trips and ``.pdparams`` / ``.pdopt``
files crossing both ways; ``Sequential``; a Conv2D + Pool2D + BatchNorm
+ FC net stepping Adam (:74); ``jit.trace``'s desc against the
reference's (the ``eager_var_N`` names mapped); a traced model saved and
served by the port's ``Predictor``. Every port call runs on "cpu"."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import dygraph as jdy
from paddle_tpu.fluid import optimizer as jopt
from paddle_tpu.fluid import regularizer as jreg
from paddle_tpu.fluid import unique_name as juniq
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import inference
from paddle_tpu_torch.fluid import dygraph, optimizer, regularizer, unique_name

CPU = "cpu"
EAGER_RTOL = 1e-5


def _to_np(v):
    return np.asarray(v.numpy())


def assert_close(got, want, rtol, name=""):
    """Within ``rtol`` of each element, or of the tensor's largest
    magnitude for elements near zero (gradient sums taken in another
    order differ there in absolute terms)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=name)


def _copy_params(ref_layer, port_layer):
    """The reference layer's parameters, by path, into the port's."""
    port_layer.set_dict({n: np.array(p.numpy())
                         for n, p in ref_layer.named_parameters()})


_EAGER = re.compile(r"^(eager_var_\d+)(.*)$")


def mapped_desc(program):
    """``program``'s desc with each ``eager_var_N`` renamed by its first
    appearance (vars in table order, then op slots), also where it begins
    a derived name (``eager_var_N.cast_bfloat16``, ``eager_var_N@GRAD``),
    so descs traced in two processes compare."""
    desc = program.to_desc()
    names = {}

    def m(n):
        hit = _EAGER.match(n)
        if hit:
            base = names.setdefault(hit.group(1), "traced_%d" % len(names))
            return base + hit.group(2)
        return n

    for blk in desc["blocks"]:
        for v in blk["vars"]:
            v["name"] = m(v["name"])
        for op in blk["ops"]:
            for key in ("inputs", "outputs"):
                op[key] = {s: [m(n) for n in ns]
                           for s, ns in op[key].items()}
    return desc


# -- VarBase, the tape, stop_gradient, no_grad -------------------------------

def _sum_of_squares_grad(dy, fw):
    with dy.guard(**({} if fw is jfluid else {"place": CPU})):
        x = dy.to_variable(np.array([[1.0, 2.0], [3.0, 4.0]], np.float32))
        x.stop_gradient = False
        y = x * x + x
        z = y._binary(y, "elementwise_mul")
        (s,) = fw.framework._dygraph_tracer().trace_op(
            "reduce_sum", {"X": [z]}, ["Out"],
            {"reduce_all": True, "dim": [0], "keep_dim": False})
        s.backward()
        return x.gradient(), _to_np(s)


def test_varbase_arithmetic_and_backward():
    want_g, want_s = _sum_of_squares_grad(jdy, jfluid)
    got_g, got_s = _sum_of_squares_grad(dygraph, fluid)
    xv = np.array([[1.0, 2.0], [3.0, 4.0]])
    np.testing.assert_allclose(got_g, 2 * (xv * xv + xv) * (2 * xv + 1),
                               rtol=1e-6)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-6)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6)


@pytest.mark.parametrize("expr", [
    lambda a, b: a + b, lambda a, b: a - b, lambda a, b: a * b,
    lambda a, b: a / b, lambda a, b: -a, lambda a, b: 2.0 + a,
    lambda a, b: 3.0 - a, lambda a, b: 0.5 * a, lambda a, b: a * 4.0,
    lambda a, b: (a * 3.0).astype("int32") + 1,
], ids=["add", "sub", "mul", "div", "neg", "radd", "rsub", "rmul",
        "mul_scalar", "astype"])
def test_varbase_sugar_matches_reference(expr):
    rng = np.random.RandomState(3)
    av = rng.rand(3, 4).astype(np.float32) + 0.5
    bv = rng.rand(3, 4).astype(np.float32) + 0.5
    with jdy.guard():
        want = _to_np(expr(jdy.to_variable(av), jdy.to_variable(bv)))
    with dygraph.guard(CPU):
        out = expr(dygraph.to_variable(av), dygraph.to_variable(bv))
        got = _to_np(out)
        assert isinstance(out, dygraph.VarBase) and out.name.startswith(
            "eager_var_")
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _accumulated(dy, place):
    with dy.guard(**place):
        w = dy.to_variable(np.array([1.0, -2.0, 3.0], np.float32))
        w.stop_gradient = False
        for k in (1.0, 2.0):
            (w * w * k).backward()
        return w.gradient()


def test_backward_accumulates_into_a_leaf():
    """Two backward passes add into the leaf's gradient; clear_gradient
    drops it."""
    want = _accumulated(jdy, {})
    got = _accumulated(dygraph, {"place": CPU})
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, 6.0 * np.array([1.0, -2.0, 3.0]))
    with dygraph.guard(CPU):
        w = dygraph.to_variable(np.ones(2, np.float32))
        w.stop_gradient = False
        (w * w).backward()
        assert w.gradient() is not None
        w.clear_gradient()
        assert w.gradient() is None


def test_stop_gradient_records_nothing():
    """An op whose inputs all stop the gradient gives an output that
    stops it (no autograd record); one live input makes it live."""
    with dygraph.guard(CPU):
        a = dygraph.to_variable(np.ones((2, 2), np.float32))
        b = dygraph.to_variable(np.ones((2, 2), np.float32))
        c = a * b
        assert a.stop_gradient and c.stop_gradient
        assert c._ivar.grad_fn is None
        tracer = fluid.framework._dygraph_tracer()
        assert not tracer._recorded
        b.stop_gradient = False
        d = a * b
        assert not d.stop_gradient and d._ivar.grad_fn is not None
        assert tracer._recorded
        d.stop_gradient = True
        assert d.stop_gradient and d._ivar.grad_fn is None


def test_no_grad_records_nothing():
    with dygraph.guard(CPU):
        x = dygraph.to_variable(np.ones((2, 2), np.float32))
        x.stop_gradient = False
        with dygraph.no_grad():
            y = x * x
        z = x * x
    assert y.stop_gradient and y._ivar.grad_fn is None
    assert not z.stop_gradient
    with jdy.guard():
        xj = jdy.to_variable(np.ones((2, 2), np.float32))
        xj.stop_gradient = False
        with jdy.no_grad():
            yj = xj * xj
        assert yj.stop_gradient or not jfluid.framework._dygraph_tracer()._tape


def test_guard_needs_a_card_unless_the_cpu_is_asked():
    with dygraph.guard(fluid.CPUPlace()):
        assert fluid.in_dygraph_mode()
        assert fluid.framework._dygraph_tracer().device.type == "cpu"
        assert dygraph.nn.Linear(2, 2).weight.device.type == "cpu"
    assert not fluid.in_dygraph_mode()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        with dygraph.guard():
            pass


def test_tracer_seed_drives_dropout():
    """Random ops draw from the tracer's own generator: one seed, one
    mask."""
    def masks(seed):
        with dygraph.guard(CPU):
            fluid.framework._dygraph_tracer().seed(seed)
            x = dygraph.to_variable(np.ones((64, 64), np.float32))
            return [_to_np(dygraph.nn.Dropout(0.5)(x)) for _ in range(2)]

    a, b = masks(7), masks(7)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert not np.array_equal(a[0], a[1])
    assert not np.array_equal(a[0], masks(8)[0])


# -- the eager optimizers ------------------------------------------------------

def _mlp(dy, nn_mod, **kw):
    """Linear(6, 5, relu) -> LayerNorm -> Linear(5, 3)."""
    return dy.Sequential(nn_mod.Linear(6, 5, act="relu", **kw),
                         nn_mod.LayerNorm(normalized_shape=[5], **kw),
                         nn_mod.Linear(5, 3, **kw))


def _mean_square(fw, out):
    sq = out * out
    (loss,) = fw.framework._dygraph_tracer().trace_op(
        "mean", {"X": [sq]}, ["Out"], {})
    return loss


OPTIMIZERS = {
    "sgd": lambda o, r: o.SGD(learning_rate=0.1, regularization=r),
    "momentum": lambda o, r: o.Momentum(learning_rate=0.1, momentum=0.9,
                                        regularization=r),
    "nesterov": lambda o, r: o.Momentum(learning_rate=0.1, momentum=0.9,
                                        use_nesterov=True, regularization=r),
    "adam": lambda o, r: o.Adam(learning_rate=0.01, regularization=r),
}


def _train(dy, fw, opt_mod, reg_mod, kind, xv, steps=3, init=None,
           place=None):
    """``steps`` eager steps of the MLP; returns (losses, params by path,
    optimizer state)."""
    kw = {} if place is None else {"device": place}
    with dy.guard(**({} if place is None else {"place": place})), \
            (juniq if fw is jfluid else unique_name).guard():
        model = _mlp(dy, dy.nn, **kw)
        if init is not None:
            _copy_params(init, model)
        opt = OPTIMIZERS[kind](opt_mod, reg_mod.L2Decay(1e-2))
        losses = []
        for _ in range(steps):
            loss = _mean_square(fw, model(dy.to_variable(xv)))
            model.clear_gradients()
            opt.minimize(loss, parameter_list=model.parameters())
            losses.append(float(_to_np(loss)))
        params = {n: np.array(p.numpy()) for n, p in model.named_parameters()}
        return losses, params, opt.state_dict(), model


@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_eager_optimizer_matches_reference(kind):
    xv = np.random.RandomState(5).randn(8, 6).astype(np.float32)
    with jdy.guard(), juniq.guard():
        init = _mlp(jdy, jdy.nn)
    want = _train(jdy, jfluid, jopt, jreg, kind, xv, init=init)
    got = _train(dygraph, fluid, optimizer, regularizer, kind, xv,
                 init=init, place=CPU)
    np.testing.assert_allclose(got[0], want[0], rtol=EAGER_RTOL)
    for g, w in ((got[1], want[1]), (got[2], want[2])):
        assert sorted(g) == sorted(w)
        for n in w:
            assert_close(g[n], w[n], EAGER_RTOL, n)


def test_optimizer_without_an_eager_update_raises():
    with dygraph.guard(CPU):
        model = dygraph.nn.Linear(2, 1)
        loss = _mean_square(fluid, model(dygraph.to_variable(
            np.ones((2, 2), np.float32))))
        with pytest.raises(NotImplementedError, match="no eager update"):
            optimizer.Adagrad(0.1).minimize(
                loss, parameter_list=model.parameters())


def test_grad_clip_and_shard_raise_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item"):
        optimizer.SGD(0.1).minimize(None, grad_clip=object())
    with pytest.raises(NotImplementedError, match="ROADMAP queue 7"):
        fluid.ParamAttr(shard=(None, "model"))


# -- learning-rate decay -------------------------------------------------------

DECAYS = {
    "noam": lambda d: d.NoamDecay(64, 4),
    "exponential": lambda d: d.ExponentialDecay(0.5, 3, 0.7, staircase=True),
    "natural_exp": lambda d: d.NaturalExpDecay(0.5, 3, 0.7),
    "inverse_time": lambda d: d.InverseTimeDecay(0.5, 3, 0.7),
    "polynomial": lambda d: d.PolynomialDecay(0.5, 4, 0.01, power=2.0,
                                              cycle=True),
    "cosine": lambda d: d.CosineDecay(0.5, 2, 4),
    "piecewise": lambda d: d.PiecewiseDecay([2, 5], [0.3, 0.2, 0.1],
                                            begin=0),
}


@pytest.mark.parametrize("kind", sorted(DECAYS))
def test_lr_decay_matches_reference(kind):
    """Value for value over 9 steps, then a state_dict round trip, then
    one decay object driving an SGD step each (the update's size)."""
    ref, port = DECAYS[kind](jdy), DECAYS[kind](dygraph)
    want = [ref() for _ in range(9)]
    got = [port() for _ in range(9)]
    np.testing.assert_allclose(got, want, rtol=1e-12)
    again = DECAYS[kind](dygraph)
    again.set_state_dict(port.state_dict())
    assert again.step_num == port.step_num == ref.step_num

    def deltas(dy, opt_mod, place):
        sched = DECAYS[kind](dy)
        with dy.guard(**place):
            p = dy.to_variable(np.zeros((1,), np.float32))
            p.stop_gradient = False
            opt = opt_mod.SGD(learning_rate=sched)
            out = []
            for _ in range(4):
                before = _to_np(p).copy()
                p.clear_gradient()
                opt.minimize(p * dy.to_variable(np.ones((1,), np.float32)),
                             parameter_list=[p])
                out.append(float(np.abs(_to_np(p) - before)[0]))
        return out

    np.testing.assert_allclose(deltas(dygraph, optimizer, {"place": CPU}),
                               deltas(jdy, jopt, {}), rtol=1e-6)


def test_lr_decay_object_refuses_static_mode():
    with pytest.raises(TypeError, match="piecewise_decay"):
        float(dygraph.PiecewiseDecay([2], [0.5, 0.125], begin=0))


# -- state dicts and checkpoint files ----------------------------------------

def test_layer_state_dict_round_trip():
    with dygraph.guard(CPU):
        m1, m2 = dygraph.nn.Linear(3, 2), dygraph.nn.Linear(3, 2)
        sd = m1.state_dict()
        assert sorted(sd) == ["bias", "weight"]
        assert all(isinstance(v, dygraph.VarBase) for v in sd.values())
        w2 = m2.weight
        m2.set_dict(sd)
        assert m2.weight is w2          # copied in place
        for (n1, p1), (n2, p2) in zip(m1.named_parameters(),
                                      m2.named_parameters()):
            np.testing.assert_array_equal(p1.numpy(), p2.numpy())


def _adam_state(dy, fw, opt_mod, uniq, place, xv, steps):
    with dy.guard(**place), uniq.guard():
        model = dy.nn.Linear(6, 2, **({"device": CPU} if place else {}))
        opt = opt_mod.Adam(learning_rate=dy.NoamDecay(8, 2))
        for _ in range(steps):
            loss = _mean_square(fw, model(dy.to_variable(xv)))
            model.clear_gradients()
            opt.minimize(loss, parameter_list=model.parameters())
        return model, opt, opt.state_dict()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_files_cross_between_packages(tmp_path, writer):
    """A .pdparams / .pdopt pair written by one package loads in the
    other: the layer's parameters, the Adam moments by "<param>@<slot>"
    and the decay object's step, and training resumed from it equals
    training that never stopped."""
    xv = np.random.RandomState(1).randn(4, 6).astype(np.float32)
    path = str(tmp_path / "ckpt")
    ref_model, ref_opt, want_o = _adam_state(jdy, jfluid, jopt, juniq, {},
                                             xv, 2)
    port_model, port_opt, _ = _adam_state(dygraph, fluid, optimizer,
                                          unique_name, {"place": CPU}, xv, 2)
    if writer == "port":
        _copy_params(ref_model, port_model)
        port_opt.set_dict(want_o)
        with dygraph.guard(CPU):
            dygraph.save_dygraph(port_model.state_dict(), path)
            dygraph.save_dygraph(port_opt.state_dict(), path)
        with jdy.guard():
            para, opti = jdy.load_dygraph(path)
    else:
        with jdy.guard():
            jdy.save_dygraph(ref_model.state_dict(), path)
            jdy.save_dygraph(want_o, path)
        para, opti = dygraph.load_dygraph(path)
    assert os.path.exists(path + ".pdparams") and os.path.exists(
        path + ".pdopt")
    want_p = {n: np.array(p.numpy()) for n, p in
              ref_model.named_parameters()}
    assert sorted(para) == sorted(want_p) and sorted(opti) == sorted(want_o)
    for n in want_p:
        np.testing.assert_array_equal(np.asarray(para[n]), want_p[n])
    for n in want_o:
        np.testing.assert_array_equal(np.asarray(opti[n]),
                                      np.asarray(want_o[n]))
    # resumed in the port from the loaded files, one more step each
    with dygraph.guard(CPU), unique_name.guard():
        model = dygraph.nn.Linear(6, 2, device=CPU)
        model.set_dict(para)
        opt = optimizer.Adam(learning_rate=dygraph.NoamDecay(8, 2))
        opt.set_dict(opti)
        assert opt._learning_rate.step_num == 3
        loss = _mean_square(fluid, model(dygraph.to_variable(xv)))
        opt.minimize(loss, parameter_list=model.parameters())
        got = {n: np.array(p.numpy()) for n, p in model.named_parameters()}
    with jdy.guard():
        loss = _mean_square(jfluid, ref_model(jdy.to_variable(xv)))
        ref_model.clear_gradients()
        ref_opt.minimize(loss, parameter_list=ref_model.parameters())
    for n, p in ref_model.named_parameters():
        assert_close(got[n], p.numpy(), EAGER_RTOL, n)


def test_empty_state_dict_refused(tmp_path):
    with pytest.raises(ValueError, match="empty"):
        dygraph.save_dygraph({}, str(tmp_path / "x"))


# -- containers and convolutional modules ------------------------------------

def test_sequential():
    with dygraph.guard(CPU):
        seq = dygraph.Sequential(("fc1", dygraph.nn.Linear(4, 3)),
                                 ("fc2", dygraph.nn.Linear(3, 2)))
        assert len(seq) == 2 and seq["fc1"] is seq[("fc1")]
        assert [n for n, _ in seq.named_parameters()] == [
            "fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"]
        x = dygraph.to_variable(np.ones((5, 4), np.float32))
        want = seq["fc2"](seq["fc1"](x))
        np.testing.assert_array_equal(_to_np(seq(x)), _to_np(want))
        seq["fc3"] = dygraph.nn.Linear(2, 1)
        assert len(seq) == 3 and _to_np(seq(x)).shape == (5, 1)
        del seq["fc3"]
        assert len(seq) == 2
        assert len(dygraph.Sequential(dygraph.nn.Linear(2, 2),
                                      dygraph.nn.Linear(2, 2)).sublayers()) == 2


def _conv_net(dy):
    class Net(dy.Layer):
        def __init__(self, **kw):
            super().__init__()
            self.conv = dy.nn.Conv2D(num_channels=1, num_filters=4,
                                     filter_size=3, padding=1, act="relu",
                                     **kw)
            self.bn = dy.nn.BatchNorm(num_channels=4, **kw)
            self.pool = dy.nn.Pool2D(pool_size=2, pool_stride=2,
                                     pool_type="max")
            self.fc = dy.nn.FC(size=10, input_dim=4 * 4 * 4, **kw)

        def forward(self, x):
            return self.fc(self.pool(self.bn(self.conv(x))))
    return Net


def _conv_steps(dy, fw, opt_mod, place, xv, labels, init=None):
    with dy.guard(**place):
        model = _conv_net(dy)(**({"device": CPU} if place else {}))
        if init is not None:
            _copy_params(init, model)
        opt = opt_mod.Adam(learning_rate=1e-2)
        tracer = fw.framework._dygraph_tracer()
        losses = []
        for _ in range(3):
            logits = model(dy.to_variable(xv))
            _, ce = tracer.trace_op(
                "softmax_with_cross_entropy",
                {"Logits": [logits], "Label": [dy.to_variable(labels)]},
                ["Softmax", "Loss"], {})
            (loss,) = tracer.trace_op("mean", {"X": [ce]}, ["Out"], {})
            model.clear_gradients()
            opt.minimize(loss, parameter_list=model.parameters())
            losses.append(float(_to_np(loss)))
        return losses, {n: np.array(p.numpy())
                        for n, p in model.named_parameters()}, model


def test_conv_pool_batch_norm_net_matches_reference():
    """Conv2D(relu) -> BatchNorm -> Pool2D -> FC, Adam 3 steps: losses,
    parameters and the running statistics (parameters that stop the
    gradient, under the reference's paths) against the reference."""
    rng = np.random.RandomState(1)
    xv = rng.rand(8, 1, 8, 8).astype(np.float32)
    labels = rng.randint(0, 10, (8, 1)).astype(np.int64)
    with jdy.guard():
        init = _conv_net(jdy)()
    want = _conv_steps(jdy, jfluid, jopt, {}, xv, labels, init=init)
    got = _conv_steps(dygraph, fluid, optimizer, {"place": CPU}, xv, labels,
                      init=init)
    assert "bn._mean" in got[1] and "bn._variance" in got[1]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert sorted(got[1]) == sorted(want[1])
    for n in want[1]:
        assert_close(got[1][n], want[1][n], 1e-4, n)
    model = got[2]
    model.eval()
    with dygraph.guard(CPU):
        before = _to_np(model.bn._mean).copy()
        model(dygraph.to_variable(xv))
    np.testing.assert_array_equal(before, _to_np(model.bn._mean))


# -- jit.trace ------------------------------------------------------------------

def _traced(dy, fw, uniq, place, xv):
    kw = {"device": CPU} if place else {}
    with dy.guard(**place), uniq.guard():
        model = dy.Sequential(dy.nn.Linear(4, 6, act="relu", **kw),
                              dy.nn.LayerNorm(normalized_shape=[6], **kw),
                              dy.nn.Linear(6, 2, **kw))
        x = dy.to_variable(xv)
        out, traced = dy.jit.trace(model, [x])
        return model, _to_np(out), traced


def test_jit_trace_desc_matches_reference():
    """The traced program's desc equals the reference's in op types,
    slots, attrs, shapes, dtypes and parameter names, up to the
    ``eager_var_N`` names."""
    xv = np.random.RandomState(2).rand(3, 4).astype(np.float32)
    _, _, jt = _traced(jdy, jfluid, juniq, {}, xv)
    _, _, pt = _traced(dygraph, fluid, unique_name, {"place": CPU}, xv)
    want, got = mapped_desc(jt.program), mapped_desc(pt.program)
    assert [op["type"] for op in got["blocks"][0]["ops"]] == [
        "matmul", "elementwise_add", "relu", "layer_norm", "matmul",
        "elementwise_add"]
    assert got == want


def test_traced_layer_runs_and_serves(tmp_path):
    """The traced program through the executor equals the eager output;
    saved with ``save_inference_model``, the port's Predictor serves it
    and equals it too; the traced scope binds the layer's own tensors."""
    xv = np.random.RandomState(4).rand(3, 4).astype(np.float32)
    model, eager, traced = _traced(dygraph, fluid, unique_name,
                                   {"place": CPU}, xv)
    (static,) = traced([xv])
    np.testing.assert_allclose(static, eager, rtol=1e-6, atol=1e-7)
    for _, p in model.named_parameters():
        assert traced._scope.find_var(p.name).data_ptr() == p.data_ptr()
    traced.save_inference_model(str(tmp_path / "m"))
    pred = inference.create_predictor(inference.Config(str(tmp_path / "m"),
                                                       place=CPU))
    (served,) = pred.run({traced._feed_names[0]: xv})
    np.testing.assert_allclose(served, eager, rtol=1e-6, atol=1e-7)


def test_dygraph_modules_import_without_jax():
    """The dygraph package, the eager optimizer and the traced model
    import in a fresh interpreter without jax or any paddle_tpu
    module."""
    code = (
        "import sys\n"
        "import paddle_tpu_torch.fluid.dygraph as d\n"
        "import paddle_tpu_torch.fluid.dygraph.jit\n"
        "import paddle_tpu_torch.fluid.dygraph.checkpoint\n"
        "import paddle_tpu_torch.fluid.dygraph.learning_rate_scheduler\n"
        "import paddle_tpu_torch.fluid.optimizer\n"
        "from paddle_tpu_torch.models.transformer import loss_fn\n"
        "import tools.profile_transformer_train\n"
        "bad = [m for m in sys.modules if m in ('jax', 'triton') or\n"
        "       m == 'paddle_tpu' or m.startswith(('paddle_tpu.', 'jax.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
