"""The port's bf16 mixed precision (paddle_tpu_torch.fluid.contrib.
mixed_precision, the ``cast`` and dynamic-loss-scaling lowerings, the
``autodiff`` op's ``loss_scale_var``) held to the JAX package on the CPU.

- Programs: inside ``unique_name.guard()`` both packages build the same
  AMP program desc, for BERT-tiny (fused and einsum attention) and for a
  small program under dynamic loss scaling; a reference-built AMP desc
  runs in the port.
- Ops: ``cast`` and each op of dynamic loss scaling through both
  registries on the same inputs, exactly (selects, comparisons and casts
  round alike).
- Training: BERT-tiny AMP (fused attention, S 64, batch 2, dropout 0) from
  the reference's startup state copied into the port's scope: the
  10-step loss trajectory within rtol 4e-3, one bf16 rounding step
  (2^-8): both packages round to bf16 at the same casts, but their bf16
  products and GELUs round at other points inside (4e-4 read here).
  Dynamic scaling: the scale, its counters and the parameters follow the
  reference's over overflow and clean steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import framework as JF
from paddle_tpu.fluid import registry as JR
from paddle_tpu.fluid.contrib import mixed_precision as JMP
from paddle_tpu.models import bert as JB
import paddle_tpu_torch.fluid as pfluid
from paddle_tpu_torch.fluid import framework as PF
from paddle_tpu_torch.fluid import registry as PR
from paddle_tpu_torch.fluid.contrib import mixed_precision as PMP
from paddle_tpu_torch.models import bert as PB

SEQ, BATCH, STEPS = 64, 2, 10
AMP_RTOL = 4e-3


def _cfg(B, fused=True):
    cfg = B.BertConfig.tiny()
    cfg.use_fused_attention = fused
    cfg.hidden_dropout = cfg.attn_dropout = 0.0
    return cfg


def _build_bert(B, unique_name, fused=True):
    with unique_name.guard():
        return B.build_pretrain_program(_cfg(B, fused), seq_len=SEQ,
                                        use_amp=True)


@pytest.mark.parametrize("fused", [True, False],
                         ids=["fused_attention", "einsum_chain"])
def test_amp_bert_desc_matches_reference(fused):
    jm, js, jl = _build_bert(JB, jfluid.unique_name, fused)
    pm, ps, pl = _build_bert(PB, pfluid.unique_name, fused)
    assert pl.name == jl.name
    assert ps.to_desc() == js.to_desc()
    want, got = jm.to_desc(), pm.to_desc()
    assert [o["type"] for o in got["blocks"][0]["ops"]] == \
        [o["type"] for o in want["blocks"][0]["ops"]]
    assert got == want
    dtypes = {v["dtype"] for v in got["blocks"][0]["vars"]}
    assert "bfloat16" in dtypes
    casts = [o for o in got["blocks"][0]["ops"] if o["type"] == "cast"]
    assert {o["attrs"]["out_dtype"] for o in casts} == {"bfloat16",
                                                        "float32"}


def _small_program(fluid, mp, **amp):
    """fc -> gelu -> fc -> sum of squares, Adam under ``decorate``
    (``amp`` its keyword arguments)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[6], dtype="float32")
        h = fluid.layers.fc(x, 8, act="gelu")
        h = fluid.layers.fc(h, 4)
        loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(h, h))
        opt = mp.decorate(fluid.optimizer.Adam(learning_rate=1e-2), **amp)
        opt.minimize(loss)
    return main, startup, loss, opt


DYNAMIC = dict(use_dynamic_loss_scaling=True, incr_every_n_steps=2,
               decr_every_n_nan_or_inf=2)


def test_dynamic_scaling_desc_matches_reference():
    jm, js, _, _ = _small_program(jfluid, JMP, init_loss_scaling=1024.0,
                                  **DYNAMIC)
    pm, ps, _, _ = _small_program(pfluid, PMP, init_loss_scaling=1024.0,
                                  **DYNAMIC)
    assert ps.to_desc() == js.to_desc()
    assert pm.to_desc() == jm.to_desc()
    types = {o.type for o in pm.global_block().ops}
    assert {"isfinite", "logical_and", "where", "zeros_like",
            "greater_equal", "assign", "cast"} <= types


@pytest.mark.parametrize("init,finite_steps", [
    (1024.0, [True] * 4),           # two clean steps double the scale
    (3e38, [False, False]),         # two overflow steps halve it
])
def test_dynamic_scaling_follows_reference(init, finite_steps):
    """Scale, counters and every persistable after each step, port vs
    reference from one state; an overflow step leaves the parameters as
    they were (zero gradients through the select), and the scale moves
    by the incr/decr ratios after two steps. ``mul`` is kept fp32 here,
    so the two run the same fp32 arithmetic (rtol 1e-5) and the test
    sees the scaling alone."""
    progs = {}
    for name, fluid, mp in (("jax", jfluid, JMP), ("port", pfluid, PMP)):
        progs[name] = _small_program(
            fluid, mp, init_loss_scaling=init, **DYNAMIC,
            amp_lists=mp.AutoMixedPrecisionLists(custom_black_list=["mul"]))
    jmain, jstartup, jloss, jopt = progs["jax"]
    sname = jopt.get_loss_scaling().name
    jscope, jexe = jfluid.Scope(), jfluid.Executor()
    jexe.run(jstartup, scope=jscope)
    names = [v.name for v in jmain.list_vars() if v.persistable]
    params = {p.name for p in jmain.all_parameters()}
    pscope = pfluid.Scope()
    pfluid.copy_scope(jscope, pscope, names, device="cpu")
    pexe = pfluid.Executor("cpu")
    feed = {"x": np.random.RandomState(0).randn(5, 6).astype(np.float32)}
    scales = []
    for finite in finite_steps:
        before = {n: np.array(jscope.find_var(n)) for n in names}
        jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)
        pexe.run(progs["port"][0], feed=feed, fetch_list=[progs["port"][2]],
                 scope=pscope)
        for n in names:
            want = np.array(jscope.find_var(n))
            np.testing.assert_allclose(pscope.find_var(n).numpy(), want,
                                       rtol=1e-5, atol=1e-6, err_msg=n)
            if not finite and n in params:
                np.testing.assert_array_equal(want, before[n], err_msg=n)
                np.testing.assert_array_equal(pscope.find_var(n).numpy(),
                                              before[n], err_msg=n)
        scales.append(float(pscope.find_var(sname)[0]))
    want = [init, 2 * init, 2 * init, 4 * init] if finite_steps[0] else \
        [init, init / 2]
    assert scales == [float(np.float32(x)) for x in want]


def test_loss_scale_var_scales_the_gradients():
    """The autodiff op multiplies the objective by the variable's value:
    every gradient is 8 times the unscaled one, as in the reference."""
    def build(fluid, scaled):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data("x", shape=[5], dtype="float32")
            h = fluid.layers.fc(x, 3, act="gelu")
            loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(h, h))
            s = fluid.layers.fill_constant([1], "float32", 8.0)
            pg = (fluid.append_backward if fluid is pfluid
                  else jfluid.backward.append_backward)(loss)
            if scaled:
                main.global_block().ops[-1].attrs["loss_scale_var"] = s.name
        return main, startup, [g.name for _, g in pg]

    feed = {"x": np.random.RandomState(2).randn(4, 5).astype(np.float32)}
    got = {}
    for name, fluid, exe in (("jax", jfluid, jfluid.Executor()),
                             ("port", pfluid, pfluid.Executor("cpu"))):
        main, startup, grads = build(fluid, False)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        if name == "port":
            pfluid.copy_scope(jscope, scope, [p.name for p in
                                              main.all_parameters()],
                              device="cpu")
        else:
            jscope = scope
        plain = exe.run(main, feed=feed, fetch_list=grads, scope=scope)
        got[name] = exe.run(build(fluid, True)[0], feed=feed,
                            fetch_list=grads, scope=scope)
        for g, p in zip(got[name], plain):
            np.testing.assert_allclose(g, 8 * p, rtol=1e-6, err_msg=name)
    for g, w in zip(got["port"], got["jax"]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


# -- cast and the dynamic-scaling ops through both registries ----------------
def _lower_both(op_type, inputs, outputs, attrs, bf16=()):
    """One op through both registries: ``inputs`` {slot: {name: array}}
    (names in ``bf16`` enter as bfloat16), ``outputs`` {slot: [name]}.
    Returns ({name: array}, {name: array}), bfloat16 results as float32."""
    vars_ = {}
    for items in inputs.values():
        for name, arr in items.items():
            vars_[name] = dict(
                name=name, shape=list(arr.shape),
                dtype="bfloat16" if name in bf16 else str(arr.dtype),
                persistable=False, stop_gradient=False, is_data=False,
                is_parameter=False, trainable=False)
    for names in outputs.values():
        for name in names:
            vars_.setdefault(name, dict(
                name=name, shape=[], dtype="float32", persistable=False,
                stop_gradient=False, is_data=False, is_parameter=False,
                trainable=False))
    desc = dict(version=1, random_seed=0, param_grad_map={}, blocks=[dict(
        idx=0, parent_idx=-1, vars=list(vars_.values()), ops=[dict(
            type=op_type, inputs={s: list(d) for s, d in inputs.items()},
            outputs=dict(outputs), attrs=dict(attrs))])])
    feeds = {n: a for d in inputs.values() for n, a in d.items()}
    out_names = [n for names in outputs.values() for n in names]
    jblock = JF.Program.from_desc(desc).global_block()
    jenv = {n: jnp.asarray(a, jnp.bfloat16 if n in bf16 else None)
            for n, a in feeds.items()}
    JR.lower_op(JR.LowerCtx(jblock, jenv, jax.random.PRNGKey(0)),
                jblock.ops[0])
    pblock = PF.Program.from_desc(desc).global_block()
    penv = {n: torch.tensor(a).to(torch.bfloat16) if n in bf16 else
            torch.tensor(a) for n, a in feeds.items()}
    PR.lower_op(PR.LowerCtx(pblock, penv, torch.Generator(), "cpu"),
                pblock.ops[0])

    def as_np(t, is_jax):
        if is_jax:
            a = np.asarray(t)
            return a.astype(np.float32) if a.dtype.name == "bfloat16" else a
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return ({n: as_np(jenv[n], True) for n in out_names},
            {n: as_np(penv[n], False) for n in out_names},
            {n: (str(np.asarray(jenv[n]).dtype), str(penv[n].dtype))
             for n in out_names})


_R = np.random.RandomState(0)
_X = (_R.randn(3, 5) * 100).astype(np.float32)
_INF = _X.copy()
_INF[1, 2] = np.inf
_NAN = _X.copy()
_NAN[0, 0] = np.nan

OP_CASES = [
    ("cast", {"X": {"x": _X}}, {"Out": ["out"]}, {"out_dtype": "bfloat16"},
     ()),
    ("cast", {"X": {"x": _X}}, {"Out": ["out"]}, {"out_dtype": "float32"},
     ("x",)),
    ("cast", {"X": {"x": np.array(True)}}, {"Out": ["out"]},
     {"out_dtype": "float32"}, ()),
    ("cast", {"X": {"x": np.array([3.0], np.float32)}}, {"Out": ["out"]},
     {"out_dtype": "int32"}, ()),
    ("cast", {"X": {"x": np.array([2], np.int32)}}, {"Out": ["out"]},
     {"out_dtype": "float32"}, ()),
    ("isfinite", {"X": {"x": _X}}, {"Out": ["out"]}, {}, ()),
    ("isfinite", {"X": {"x": _INF}}, {"Out": ["out"]}, {}, ()),
    ("isfinite", {"X": {"x": _NAN}}, {"Out": ["out"]}, {}, ()),
    ("isfinite", {"X": {"x": _INF}}, {"Out": ["out"]}, {}, ("x",)),
    ("logical_and", {"X": {"a": np.array(True)}, "Y": {"b": np.array(False)}},
     {"Out": ["out"]}, {}, ()),
    ("logical_and", {"X": {"a": np.array(True)}, "Y": {"b": np.array(True)}},
     {"Out": ["out"]}, {}, ()),
    ("where", {"Condition": {"c": np.array(False)}, "X": {"x": _X},
               "Y": {"y": np.zeros_like(_X)}}, {"Out": ["out"]}, {}, ()),
    ("where", {"Condition": {"c": np.array(True)}, "X": {"x": _INF},
               "Y": {"y": np.zeros_like(_X)}}, {"Out": ["out"]}, {}, ()),
    ("zeros_like", {"X": {"x": _X}}, {"Out": ["out"]}, {}, ()),
    ("assign", {"X": {"x": _X}}, {"Out": ["out"]}, {}, ()),
] + [
    (cmp, {"X": {"x": np.array([2.0, 3.0, 4.0], np.float32)},
           "Y": {"y": np.array([3.0], np.float32)}}, {"Out": ["out"]}, {}, ())
    for cmp in ("greater_equal", "greater_than", "less_than", "less_equal",
                "equal", "not_equal")
]


@pytest.mark.parametrize("op_type,inputs,outputs,attrs,bf16", OP_CASES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(OP_CASES)])
def test_amp_op_matches_reference(op_type, inputs, outputs, attrs, bf16):
    want, got, dtypes = _lower_both(op_type, inputs, outputs, attrs, bf16)
    for name in want:
        assert got[name].shape == want[name].shape, name
        jt, pt = dtypes[name]
        assert pt == "torch." + jt or (jt, pt) == ("int32", "torch.int64"), \
            (jt, pt)
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_bfloat16_dtype_round_trip():
    assert PF.convert_dtype("bfloat16") is PF.BFLOAT16
    assert PF.convert_dtype(torch.bfloat16) is PF.BFLOAT16
    assert PF.convert_dtype(JF.convert_dtype("bfloat16")) is PF.BFLOAT16
    assert PF.dtype_str(PF.BFLOAT16) == "bfloat16"
    assert PR.to_torch_dtype("bfloat16") is torch.bfloat16
    assert PR.to_numpy_dtype(torch.bfloat16) is PF.BFLOAT16
    assert PF.BFLOAT16 != np.dtype("float32")
    assert np.dtype("float16") != PF.BFLOAT16


def test_bfloat16_feed_is_refused():
    main = PF.Program()
    main.global_block().create_var(name="x", shape=[2], dtype="bfloat16",
                                   is_data=True)
    with pytest.raises(TypeError, match="bfloat16"):
        pfluid.Executor("cpu").run(main, feed={"x": np.zeros(2, np.float32)})


# -- BERT-tiny AMP training --------------------------------------------------
@pytest.fixture(scope="module")
def reference_run():
    main, startup, loss = _build_bert(JB, jfluid.unique_name)
    feed = JB.synthetic_batch(_cfg(JB), BATCH, SEQ, seed=0)
    scope, exe = jfluid.Scope(), jfluid.Executor()
    exe.run(startup, scope=scope)
    names = [v.name for v in main.list_vars() if v.persistable]
    start = {n: np.array(scope.find_var(n)) for n in names}
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0][0]) for _ in range(STEPS)]
    return dict(main=main, startup=startup, feed=feed, start=start,
                losses=losses, loss=loss.name)


def _port_scope(start):
    scope = pfluid.Scope()
    for n, a in start.items():
        scope.set_var(n, torch.tensor(a))
    return scope


def test_amp_bert_tiny_trajectory_matches_reference(reference_run):
    main, _, loss = _build_bert(PB, pfluid.unique_name)
    scope = _port_scope(reference_run["start"])
    exe = pfluid.Executor("cpu")
    losses = [float(exe.run(main, feed=reference_run["feed"],
                            fetch_list=[loss], scope=scope)[0][0])
              for _ in range(STEPS)]
    np.testing.assert_allclose(losses, reference_run["losses"],
                               rtol=AMP_RTOL)
    assert losses[-1] < losses[0]
    # master weights stay fp32
    assert scope.find_var("word_emb").dtype == torch.float32


def test_reference_built_amp_program_runs_in_port(reference_run):
    main = PF.Program.from_desc(reference_run["main"].to_desc())
    startup = PF.Program.from_desc(reference_run["startup"].to_desc())
    assert any(v.dtype == PF.BFLOAT16 for v in main.list_vars())
    exe = pfluid.Executor("cpu")
    fresh = pfluid.Scope()
    exe.run(startup, scope=fresh)
    for n, a in reference_run["start"].items():
        assert tuple(fresh.find_var(n).shape) == a.shape, n
    scope = _port_scope(reference_run["start"])
    losses = [float(exe.run(main, feed=reference_run["feed"],
                            fetch_list=[reference_run["loss"]],
                            scope=scope)[0][0]) for _ in range(3)]
    np.testing.assert_allclose(losses, reference_run["losses"][:3],
                               rtol=AMP_RTOL)
