"""The port's static-graph training slice (paddle_tpu_torch.fluid and
models/bert.py) held to the JAX package on the CPU.

- Programs: inside ``unique_name.guard()`` both packages build the same
  BERT-tiny program desc (ops, slots, attrs; var names, shapes, dtypes).
- Ops: each op type of the two programs (and the einsum chain's) is
  lowered through both registries on the same numpy inputs; rtol 1e-5,
  atol 1e-6 (fp32, another summation order). Random ops are compared at
  p = 0 or by their range: the packages draw different numbers.
- Training: BERT-tiny (fused attention, seq 64, batch 2, dropout 0) from
  the reference's startup state, copied into the port's scope: a 10-step
  loss trajectory at rtol 1e-4, and every persistable after step 1 at
  rtol 1e-5, atol 1e-6 (1% of the first Adam step, lr 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import framework as JF
from paddle_tpu.fluid import registry as JR
from paddle_tpu.models import bert as JB
import paddle_tpu_torch.fluid as pfluid
from paddle_tpu_torch.fluid import framework as PF
from paddle_tpu_torch.fluid import registry as PR
from paddle_tpu_torch.models import bert as PB

SEQ, BATCH, STEPS = 64, 2, 10


def _cfg(B, fused=True, dropout=0.0):
    cfg = B.BertConfig.tiny()
    cfg.use_fused_attention = fused
    cfg.hidden_dropout = cfg.attn_dropout = dropout
    return cfg


def _build(B, unique_name, **kw):
    with unique_name.guard():
        return B.build_pretrain_program(_cfg(B, **kw), seq_len=SEQ)


@pytest.mark.parametrize("fused", [True, False],
                         ids=["fused_attention", "einsum_chain"])
def test_program_desc_matches_reference(fused):
    jm, js, jl = _build(JB, jfluid.unique_name, fused=fused, dropout=0.1)
    pm, ps, pl = _build(PB, pfluid.unique_name, fused=fused, dropout=0.1)
    assert pl.name == jl.name
    assert ps.to_desc() == js.to_desc()
    want, got = jm.to_desc(), pm.to_desc()
    assert [o["type"] for o in got["blocks"][0]["ops"]] == \
        [o["type"] for o in want["blocks"][0]["ops"]]
    assert got == want


# -- each op through both registries -------------------------------------------
def _desc(op_type, inputs, outputs, attrs):
    """A one-op program desc: ``inputs`` {slot: {name: array}},
    ``outputs`` {slot: [name]} (declared float32)."""
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
    desc = _desc(op_type, inputs, outputs, attrs)
    feeds = {n: a for d in inputs.values() for n, a in d.items()}
    out_names = [n for names in outputs.values() for n in names]
    jblock = JF.Program.from_desc(desc).global_block()
    jenv = {n: jnp.asarray(a) for n, a in feeds.items()}
    JR.lower_op(JR.LowerCtx(jblock, jenv, jax.random.PRNGKey(0)),
                jblock.ops[0])
    pblock = PF.Program.from_desc(desc).global_block()
    penv = {n: torch.tensor(a) for n, a in feeds.items()}   # copies
    PR.lower_op(PR.LowerCtx(pblock, penv, torch.Generator().manual_seed(0),
                            "cpu"), pblock.ops[0])
    return ({n: np.asarray(jenv[n]) for n in out_names},
            {n: penv[n].detach().numpy() for n in out_names})


_R = np.random.RandomState(0)


def _f(*shape):
    return np.asarray(_R.randn(*shape), dtype=np.float32)


def _i(high, *shape):
    return _R.randint(0, high, shape).astype(np.int64)


_IDS = _i(16, 2, 5)
_IDS[0, :2] = 3                    # hits padding_idx
_LABEL = _i(9, 6, 1)
_LABEL[2, 0] = -100                # ignore_index

OP_CASES = [
    ("lookup_table", {"W": {"w": _f(16, 8)}, "Ids": {"ids": _IDS}},
     {"Out": ["out"]}, {"is_sparse": False, "is_distributed": False,
                        "padding_idx": 3}),
    ("lookup_table", {"W": {"w": _f(16, 8)},
                      "Ids": {"ids": _i(16, 2, 5, 1)}},
     {"Out": ["out"]}, {"padding_idx": -1}),
    ("elementwise_add", {"X": {"x": _f(2, 3, 4)}, "Y": {"y": _f(2, 3, 4)}},
     {"Out": ["out"]}, {"axis": -1}),
    ("elementwise_add", {"X": {"x": _f(2, 3, 4)}, "Y": {"y": _f(4)}},
     {"Out": ["out"]}, {"axis": 2}),
    ("elementwise_mul", {"X": {"x": _f(6, 1)}, "Y": {"y": _f(6, 1)}},
     {"Out": ["out"]}, {"axis": -1}),
    ("elementwise_div", {"X": {"x": _f()},
                         "Y": {"y": np.abs(_f(1)) + 0.5}},
     {"Out": ["out"]}, {"axis": -1}),
    ("layer_norm", {"X": {"x": _f(2, 3, 8) * 3 + 1},
                    "Scale": {"s": _f(8)}, "Bias": {"b": _f(8)}},
     {"Y": ["y"], "Mean": ["mean"], "Variance": ["var"]},
     {"epsilon": 1e-5, "begin_norm_axis": 2}),
    ("dropout", {"X": {"x": _f(4, 6)}}, {"Out": ["out"]},
     {"dropout_prob": 0.1, "is_test": True,
      "dropout_implementation": "downgrade_in_infer"}),
    ("dropout", {"X": {"x": _f(4, 6)}}, {"Out": ["out"], "Mask": ["mask"]},
     {"dropout_prob": 0.0, "is_test": False,
      "dropout_implementation": "upscale_in_train"}),
    ("transpose", {"X": {"x": _f(2, 3, 4)}}, {"Out": ["out"]},
     {"axis": [0, 2, 1]}),
    ("scale", {"X": {"x": _f(2, 3)}}, {"Out": ["out"]},
     {"scale": 1e4, "bias": -1e4, "bias_after_scale": True}),
    ("scale", {"X": {"x": _f(2, 3)}}, {"Out": ["out"]},
     {"scale": 0.5, "bias": 2.0, "bias_after_scale": False}),
    ("unsqueeze", {"X": {"x": _f(2, 1, 5)}}, {"Out": ["out"]},
     {"axes": [1]}),
    ("mul", {"X": {"x": _f(2, 3, 4)}, "Y": {"y": _f(4, 5)}},
     {"Out": ["out"]}, {"x_num_col_dims": 2, "y_num_col_dims": 1}),
    ("reshape", {"X": {"x": _f(2, 3, 8)}}, {"Out": ["out"]},
     {"shape": [0, 0, 2, 4]}),
    ("reshape", {"X": {"x": _i(50, 2, 9)}}, {"Out": ["out"]},
     {"shape": [-1]}),
    ("fused_multihead_attention",
     {"Q": {"q": _f(2, 2, 16, 8)}, "K": {"k": _f(2, 2, 16, 8)},
      "V": {"v": _f(2, 2, 16, 8)}, "Bias": {"b": _f(2, 1, 1, 16)}},
     {"Out": ["out"]}, {"dropout_prob": 0.1, "is_test": True}),
    ("fused_multihead_attention",
     {"Q": {"q": _f(2, 2, 16, 8)}, "K": {"k": _f(2, 2, 16, 8)},
      "V": {"v": _f(2, 2, 16, 8)}},
     {"Out": ["out"]}, {"dropout_prob": 0.0, "is_test": False,
                        "scale": 0.3}),
    ("gelu", {"X": {"x": _f(3, 5) * 2}}, {"Out": ["out"]}, {}),
    ("gelu", {"X": {"x": _f(3, 5) * 2}}, {"Out": ["out"]},
     {"approximate": True}),
    ("gather", {"X": {"x": _f(10, 4)}, "Index": {"i": _i(10, 6)}},
     {"Out": ["out"]}, {}),
    ("matmul", {"X": {"x": _f(6, 4)}, "Y": {"y": _f(9, 4)}},
     {"Out": ["out"]}, {"transpose_X": False, "transpose_Y": True,
                        "alpha": 1.0}),
    ("softmax_with_cross_entropy",
     {"Logits": {"logits": _f(6, 9) * 3}, "Label": {"label": _LABEL}},
     {"Softmax": ["softmax"], "Loss": ["loss"]},
     {"soft_label": False, "ignore_index": -100, "axis": -1}),
    ("reduce_sum", {"X": {"x": _f(6, 1)}}, {"Out": ["out"]},
     {"reduce_all": True, "dim": [0], "keep_dim": False}),
    ("reduce_sum", {"X": {"x": _f(3, 4, 5)}}, {"Out": ["out"]},
     {"reduce_all": False, "dim": [1, -1], "keep_dim": True}),
    ("fill_constant", {}, {"Out": ["out"]},
     {"shape": [1], "dtype": "float32", "value": 1e-6}),
    ("adam", {"Param": {"p": _f(4, 3)}, "Grad": {"g": _f(4, 3)},
              "Moment1": {"m1": _f(4, 3) * 0.1},
              "Moment2": {"m2": np.abs(_f(4, 3)) * 0.01},
              "Beta1Pow": {"b1p": np.array([0.81], np.float32)},
              "Beta2Pow": {"b2p": np.array([0.998], np.float32)},
              "LearningRate": {"lr": np.array([1e-3], np.float32)}},
     {"ParamOut": ["p"], "Moment1Out": ["m1"], "Moment2Out": ["m2"],
      "Beta1PowOut": ["b1p"], "Beta2PowOut": ["b2p"]},
     {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    ("einsum", {"Operands": {"a": _f(2, 3, 2, 4), "b": _f(2, 5, 2, 4)}},
     {"Out": ["out"]}, {"equation": "bqhd,bkhd->bhqk"}),
    ("softmax", {"X": {"x": _f(2, 3, 5)}}, {"Out": ["out"]}, {"axis": -1}),
]


@pytest.mark.parametrize("op_type,inputs,outputs,attrs", OP_CASES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(OP_CASES)])
def test_op_matches_reference(monkeypatch, op_type, inputs, outputs,
                              attrs):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    want, got = _lower_both(op_type, inputs, outputs, attrs)
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_uniform_random_matches_reference_range():
    """The packages draw different numbers: same shape, type and range,
    and both means within 0.01 of the middle."""
    attrs = {"shape": [200, 50], "dtype": "float32", "min": -0.5,
             "max": 0.5, "seed": 0}
    want, got = _lower_both("uniform_random", {}, {"Out": ["out"]}, attrs)
    for out in (want["out"], got["out"]):
        assert out.shape == (200, 50) and out.dtype == np.float32
        assert out.min() >= -0.5 and out.max() < 0.5
        assert abs(out.mean()) < 0.01


def test_gaussian_random_matches_reference_moments():
    """Different numbers again: over 10^4 draws both means are within
    0.06 of 1 and both standard deviations within 0.06 of 2 (three
    standard errors of the mean)."""
    attrs = {"shape": [100, 100], "dtype": "float32", "mean": 1.0,
             "std": 2.0, "seed": 0}
    want, got = _lower_both("gaussian_random", {}, {"Out": ["out"]}, attrs)
    for out in (want["out"], got["out"]):
        assert out.shape == (100, 100) and out.dtype == np.float32
        assert abs(out.mean() - 1.0) < 0.06 and abs(out.std() - 2.0) < 0.06


def test_dropout_op_keep_rate_and_scale():
    """8-bit words: kept where the word is below round(0.9 * 256) = 230,
    scaled by 256 / 230 (the realised keep rate)."""
    x = np.ones((64, 256), np.float32)
    block = PF.Program.from_desc(_desc(
        "dropout", {"X": {"x": x}}, {"Out": ["out"], "Mask": ["mask"]},
        {"dropout_prob": 0.1, "is_test": False,
         "dropout_implementation": "upscale_in_train"})).global_block()
    env = {"x": torch.from_numpy(x)}
    PR.lower_op(PR.LowerCtx(block, env, torch.Generator().manual_seed(1),
                            "cpu"), block.ops[0])
    mask = env["mask"].numpy()
    assert set(np.unique(mask)) == {0.0, 1.0}
    assert abs(mask.mean() - 230 / 256) < 0.01
    np.testing.assert_allclose(env["out"].numpy(), mask * 256 / 230,
                               rtol=1e-6)


def test_autodiff_op_matches_reference():
    """fc + gelu + weighted sum, append_backward: the gradients of every
    parameter through each package's executor from one copied state."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data("x", shape=[5], dtype="float32")
            h = fluid.layers.fc(x, 4, act="gelu")
            h = fluid.layers.fc(h, 3)
            loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(h, h))
            pg = fluid.append_backward(loss) if fluid is pfluid else \
                jfluid.backward.append_backward(loss)
        return main, startup, [g.name for _, g in pg]

    jm, js, grads = build(jfluid)
    pm, ps, pgrads = build(pfluid)
    assert grads == pgrads
    feed = {"x": np.random.RandomState(1).randn(3, 5).astype(np.float32)}
    jscope, pscope = jfluid.Scope(), pfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(js, scope=jscope)
    pfluid.copy_scope(jscope, pscope, [p.name for p in jm.all_parameters()],
                      device="cpu")
    want = jexe.run(jm, feed=feed, fetch_list=grads, scope=jscope)
    got = pfluid.Executor("cpu").run(pm, feed=feed, fetch_list=grads,
                                     scope=pscope)
    for name, g, w in zip(grads, got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)


# -- BERT-tiny training --------------------------------------------------------
@pytest.fixture(scope="module")
def reference_run():
    """The reference's startup state, its 10 losses, and its persistables
    after step 1."""
    main, startup, loss = _build(JB, jfluid.unique_name)
    feed = JB.synthetic_batch(_cfg(JB), BATCH, SEQ, seed=0)
    scope, exe = jfluid.Scope(), jfluid.Executor()
    exe.run(startup, scope=scope)
    names = [v.name for v in main.list_vars() if v.persistable]
    start = {n: np.array(scope.find_var(n)) for n in names}
    losses, after_one = [], None
    for _ in range(STEPS):
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0][0]))
        if after_one is None:
            after_one = {n: np.array(scope.find_var(n)) for n in names}
    return dict(main=main, startup=startup, feed=feed, start=start,
                losses=losses, after_one=after_one)


def _port_scope(start):
    scope = pfluid.Scope()
    for n, a in start.items():
        scope.set_var(n, torch.tensor(a))
    return scope


def test_bert_tiny_trajectory_matches_reference(reference_run):
    main, startup, loss = _build(PB, pfluid.unique_name)
    scope = _port_scope(reference_run["start"])
    exe = pfluid.Executor("cpu")
    losses = []
    for i in range(STEPS):
        losses.append(float(exe.run(main, feed=reference_run["feed"],
                                    fetch_list=[loss], scope=scope)[0][0]))
        if i == 0:
            for n, want in reference_run["after_one"].items():
                np.testing.assert_allclose(scope.find_var(n).numpy(), want,
                                           rtol=1e-5, atol=1e-6, err_msg=n)
    np.testing.assert_allclose(losses, reference_run["losses"], rtol=1e-4)
    assert losses[-1] < losses[0]


def test_reference_built_program_runs_in_port(reference_run):
    """Program.from_desc of the reference's descs: the startup program
    makes every persistable the main program reads, and the main program
    trains from the reference's state along the reference's losses."""
    main = PF.Program.from_desc(reference_run["main"].to_desc())
    startup = PF.Program.from_desc(reference_run["startup"].to_desc())
    exe = pfluid.Executor("cpu")
    fresh = pfluid.Scope()
    exe.run(startup, scope=fresh)
    for n, a in reference_run["start"].items():
        assert tuple(fresh.find_var(n).shape) == a.shape, n
    loss = main.global_block().ops[-1 - len(main.param_grad_map)].attr(
        "loss")
    scope = _port_scope(reference_run["start"])
    losses = [float(exe.run(main, feed=reference_run["feed"],
                            fetch_list=[loss], scope=scope)[0][0])
              for _ in range(3)]
    np.testing.assert_allclose(losses, reference_run["losses"][:3],
                               rtol=1e-4)


def test_dropout_program_trains_on_cpu():
    """BERT-tiny with its dropouts (0.1) on: finite losses that fall on a
    memorised batch, and two scopes seeded alike give the same losses."""
    main, startup, loss = _build(PB, pfluid.unique_name, dropout=0.1)
    feed = PB.synthetic_batch(_cfg(PB), BATCH, SEQ, seed=0)
    runs = []
    for _ in range(2):
        scope, exe = pfluid.Scope(), pfluid.Executor("cpu")
        exe.run(startup, scope=scope)
        runs.append([float(exe.run(main, feed=feed, fetch_list=[loss],
                                   scope=scope)[0][0]) for _ in range(4)])
    assert runs[0] == runs[1]
    assert np.all(np.isfinite(runs[0])) and runs[0][-1] < runs[0][0]


def test_executor_defaults_to_the_card():
    if torch.cuda.is_available():
        assert pfluid.Executor().place.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            pfluid.Executor()
