"""The port's convolutional models (paddle_tpu_torch/models/resnet.py and
lenet.py, BASELINE configs 2 and 1) held to the JAX package on the CPU.

- Programs: inside ``unique_name.guard()`` both packages build the same
  ResNet-50 (NCHW, NHWC, AMP, inference) and LeNet programs, compared as
  ProgramDesc protobuf bytes (``fluid/core/proto_io.py``).
- LeNet (full width, batch 32): a 10-step Adam trajectory from the
  reference's startup state at rtol 1e-4.
- ResNet-18 fp32, NCHW and NHWC, batch 4, lr 0.01, a fresh seeded batch
  each step. A deep batch-norm network on four images is ill-conditioned
  in fp32: the reference's own fp32 losses leave its float64 run by
  1.7e-3 within 5 steps at 64x64 (by 2.7e-3 at step 3 and 0.42 at step
  4 at 32x32, where the last stage normalises four numbers a channel),
  while the port's stay within 5e-7 at 64x64. So the 5-step trajectory is
  held at rtol 1e-4 to the reference's program run in float64
  (``jax.enable_x64``: the reference's lowerings on a copy of its desc
  whose float32 vars are float64), at 64x64, and so is every
  persistable after one step (1e-4 of its largest magnitude; the
  reference's own fp32 gradients are off by up to 1e-3 there). Each
  step's loss, the port's started from the reference's fp32 state before
  it, is held to the reference's fp32 step at rtol 1e-5. The two
  layouts' trajectories agree within 2e-4, as in the reference's own
  tests/test_models.py.
- The same losses under ``use_amp=True``, each step from the
  reference's state, at rtol 4e-3 (one bf16 step: both round to bf16 at
  the same casts, but the reference's batch norm normalises in bf16
  arithmetic, the port's in fp32).
- Inference: ResNet-18 saved by either package's ``save_inference_model``
  (the same ``__model__`` bytes) and served by the other's Predictor.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import inference as JI
from paddle_tpu.fluid import framework as JF
from paddle_tpu.models import lenet as JL
from paddle_tpu.models import resnet as JRN
import paddle_tpu_torch.fluid as pfluid
from paddle_tpu_torch import inference as PI
from paddle_tpu_torch.models import lenet as PL
from paddle_tpu_torch.models import resnet as PRN

STEPS, BATCH, LR = 5, 4, 0.01
IMG = 64


def _programs(fluid, M, kind, **kw):
    with fluid.unique_name.guard():
        if kind == "infer":
            return M.build_infer_program(**kw)[:2]
        return M.build_train_program(**kw)[:2]


DESC_CASES = [
    ("lenet", "train", {}),
    ("lenet", "infer", {}),
    ("resnet50", "train", {}),
    ("resnet50", "train", {"data_format": "NHWC"}),
    ("resnet50", "train", {"use_amp": True}),
    ("resnet50", "infer", {}),
]


@pytest.mark.parametrize("model,kind,kw", DESC_CASES,
                         ids=["%s-%s-%d" % (c[0], c[1], i)
                              for i, c in enumerate(DESC_CASES)])
def test_program_bytes_match_reference(model, kind, kw):
    mods = (JL, PL) if model == "lenet" else (JRN, PRN)
    if model == "resnet50":
        kw = dict(kw, depth=50)
    ref = _programs(jfluid, mods[0], kind, **kw)
    port = _programs(pfluid, mods[1], kind, **kw)
    for want, got in zip(ref, port):
        assert got.serialize_to_string() == want.serialize_to_string()
    if kw.get("use_amp"):
        casts = [op for op in port[0].global_block().ops
                 if op.type == "cast"]
        filters = {op.input("Filter")[0] for op in port[0].global_block().ops
                   if op.type == "conv2d"}
        # one cast a conv filter a step, in the forward only
        assert len(filters) == 53
        assert sum(op.input("X")[0] in {f.split(".cast_")[0]
                                        for f in filters}
                   for op in casts) == 53


def _start(main, startup):
    """The reference's startup state of ``main``'s persistables."""
    scope, exe = jfluid.Scope(), jfluid.Executor()
    exe.run(startup, scope=scope)
    names = [v.name for v in main.list_vars() if v.persistable]
    return {n: np.asarray(scope.find_var(n)) for n in names}


def _feeds(steps, batch, channels, size, classes, seed=0):
    rng = np.random.RandomState(seed)
    return [{"img": rng.rand(batch, channels, size, size).astype(np.float32),
             "label": rng.randint(0, classes, (batch, 1)).astype(np.int64)}
            for _ in range(steps)]


def _port_scope(state):
    scope = pfluid.Scope()
    for n, a in state.items():
        scope.set_var(n, torch.from_numpy(np.array(a)))
    return scope


def _loss(out):
    return float(np.asarray(out[0]).reshape(-1)[0])


def _port_trajectory(main, loss, state, feeds):
    scope, exe = _port_scope(state), pfluid.Executor("cpu")
    return [_loss(exe.run(main, feed=f, fetch_list=[loss], scope=scope))
            for f in feeds]


def _float64_run(main, loss, state, feeds):
    """The reference's lowerings on ``main`` with every float32 var and
    fill made float64, from ``state``, under jax.enable_x64: the losses
    and the persistables after the last step."""
    desc = main.to_desc()
    for v in desc["blocks"][0]["vars"]:
        if v["dtype"] == "float32":
            v["dtype"] = "float64"
    for op in desc["blocks"][0]["ops"]:
        if op["attrs"].get("dtype") == "float32":
            op["attrs"]["dtype"] = "float64"
    with jax.enable_x64(True):
        prog = JF.Program.from_desc(desc)
        scope, exe = jfluid.Scope(), jfluid.Executor()
        for n, a in state.items():
            scope.set_var(n, a.astype(np.float64)
                          if a.dtype == np.float32 else a)
        losses = []
        for f in feeds:
            f = dict(f, img=f["img"].astype(np.float64))
            losses.append(_loss(exe.run(prog, feed=f, fetch_list=[loss.name],
                                        scope=scope)))
        return losses, {n: np.asarray(scope.find_var(n)) for n in state}


def _resnet18(fluid, M, **kw):
    with fluid.unique_name.guard():
        return M.build_train_program(depth=18, image_size=IMG, lr=LR, **kw)


@pytest.fixture(scope="module")
def resnet18_start():
    main, startup, _, _ = _resnet18(jfluid, JRN)
    return _start(main, startup), _feeds(STEPS, BATCH, 3, IMG, 1000)


@pytest.fixture(scope="module")
def port_trajectories(resnet18_start):
    state, feeds = resnet18_start
    out = {}
    for fmt in ("NCHW", "NHWC"):
        main, _, loss, _ = _resnet18(pfluid, PRN, data_format=fmt)
        out[fmt] = _port_trajectory(main, loss, state, feeds)
    return out


def test_resnet18_trajectory_matches_float64_reference(resnet18_start,
                                                       port_trajectories):
    state, feeds = resnet18_start
    main, _, loss, _ = _resnet18(jfluid, JRN)
    want, _ = _float64_run(main, loss, state, feeds)
    for fmt, got in port_trajectories.items():
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=fmt)
    assert np.all(np.isfinite(want))


def test_resnet18_layouts_agree(port_trajectories):
    np.testing.assert_allclose(port_trajectories["NHWC"],
                               port_trajectories["NCHW"], rtol=2e-4)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_resnet18_step_matches_float64_reference(resnet18_start, fmt):
    """One step from the startup state: every persistable (parameters,
    velocities, running statistics) within 1e-4 of its largest magnitude
    of the float64 reference's (1.1e-5 read here)."""
    state, feeds = resnet18_start
    main, _, loss, _ = _resnet18(jfluid, JRN)
    _, want = _float64_run(main, loss, state, feeds[:1])
    pm, _, pl, _ = _resnet18(pfluid, PRN, data_format=fmt)
    scope = _port_scope(state)
    pfluid.Executor("cpu").run(pm, feed=feeds[0], fetch_list=[pl],
                               scope=scope)
    for n, w in want.items():
        np.testing.assert_allclose(scope.find_var(n).numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=n)


def _stepwise_losses(resnet18_start, fmt, rtol, **kw):
    """Each step's loss, the port's started from the reference's state
    before it, against the reference's step."""
    state, feeds = resnet18_start
    jm, _, jl, _ = _resnet18(jfluid, JRN, data_format=fmt, **kw)
    pm, _, pl, _ = _resnet18(pfluid, PRN, data_format=fmt, **kw)
    jscope, jexe = jfluid.Scope(), jfluid.Executor()
    for n, a in state.items():
        jscope.set_var(n, a)
    pexe = pfluid.Executor("cpu")
    got, want = [], []
    for feed in feeds:
        pscope = _port_scope({n: np.asarray(jscope.find_var(n))
                              for n in state})
        got.append(_loss(pexe.run(pm, feed=feed, fetch_list=[pl],
                                  scope=pscope)))
        want.append(_loss(jexe.run(jm, feed=feed, fetch_list=[jl],
                                   scope=jscope)))
    np.testing.assert_allclose(got, want, rtol=rtol)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_resnet18_steps_match_reference(resnet18_start, fmt):
    _stepwise_losses(resnet18_start, fmt, 1e-5)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_resnet18_amp_steps_match_reference(resnet18_start, fmt):
    _stepwise_losses(resnet18_start, fmt, 4e-3, use_amp=True)


def test_lenet_trajectory_matches_reference():
    with jfluid.unique_name.guard():
        jm, js, jl, _ = JL.build_train_program()
    with pfluid.unique_name.guard():
        pm, _, pl, _ = PL.build_train_program()
    state = _start(jm, js)
    feeds = _feeds(1, 32, 1, 28, 10) * 10        # memorised: losses fall
    scope, exe = jfluid.Scope(), jfluid.Executor()
    for n, a in state.items():
        scope.set_var(n, a)
    want = [_loss(exe.run(jm, feed=f, fetch_list=[jl], scope=scope))
            for f in feeds]
    got = _port_trajectory(pm, pl, state, feeds)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def _save_resnet18(fluid, M, dirname, exe):
    with fluid.unique_name.guard():
        main, startup, logits = M.build_infer_program(depth=18,
                                                      image_size=32)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup, scope=scope)
        fluid.io.save_inference_model(str(dirname), ["img"], [logits], exe,
                                      main_program=main)


def test_resnet18_inference_model_crosses_both_ways(tmp_path):
    """Saved by either package and served by the other's Predictor: the
    same ``__model__`` bytes, batch norm in test mode (the prune's
    for_test clone), the same logits at rtol 1e-5."""
    _save_resnet18(jfluid, JRN, tmp_path / "ref", jfluid.Executor())
    _save_resnet18(pfluid, PRN, tmp_path / "port", pfluid.Executor("cpu"))
    assert (tmp_path / "ref" / "__model__").read_bytes() == \
        (tmp_path / "port" / "__model__").read_bytes()
    feed = {"img": np.random.RandomState(3).rand(3, 3, 32, 32).astype(
        np.float32)}
    for src in ("ref", "port"):
        d = str(tmp_path / src)
        pred = PI.create_predictor(PI.Config(d, place="cpu"))
        assert all(op.attr("is_test") for op in pred.program.global_block().ops
                   if op.type == "batch_norm")
        want = JI.create_predictor(JI.Config(d)).run(feed)[0]
        got = pred.run(feed)[0]
        assert got.shape == (3, 1000)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=src)
