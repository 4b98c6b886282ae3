"""Config 5's training through the port's dygraph layer, held to the
JAX package's on the CPU at ``Transformer.tiny`` sizes, from the
reference's initial weights (copied across by path; both packages name
the parameters alike under ``unique_name.guard()``):

- eager dygraph Adam, 4 steps at p 0 (tests/test_models.py:66's flow):
  losses within rtol 1e-4, every parameter after the last step within
  1e-4 of its largest magnitude;
- ``jit.trace`` against eager (tests/test_models.py:85), and the traced
  desc against the reference's, the ``eager_var_N`` names mapped, in
  eval and in training mode (dropout 0.1), before and after the loss and
  the optimizer are appended;
- the to-static program of ``bench.py:810-838`` with Adam over 10 steps,
  within 1e-4 in fp32 and 4e-3 under AMP;
- dropout at p 0.1: the keep rate, the scaling, one mask in forward and
  backward;
- the decode methods run no op through a tracer, guard or not.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import dygraph as jdy
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import optimizer as jopt
from paddle_tpu.fluid import unique_name as juniq
from paddle_tpu.fluid.contrib import mixed_precision as jmp
from paddle_tpu.models import transformer as JT
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import dygraph, layers, optimizer, unique_name
from paddle_tpu_torch.fluid.contrib import mixed_precision
from paddle_tpu_torch.models import transformer as PT
from test_torch_dygraph import assert_close, mapped_desc

V, B, S = 512, 2, 16
EAGER_STEPS, STATIC_STEPS = 4, 10
TRAJ_RTOL = {False: 1e-4, True: 4e-3}

REF = dict(fluid=jfluid, dy=jdy, layers=jlayers, opt=jopt, amp=jmp,
           uniq=juniq, T=JT, place={})
PORT = dict(fluid=fluid, dy=dygraph, layers=layers, opt=optimizer,
            amp=mixed_precision, uniq=unique_name, T=PT,
            place={"place": "cpu"})


def _batch():
    src, tgt, labels, pos = JT.synthetic_batch(V, V, B, S)
    return (src, tgt, pos, pos, JT.make_causal_bias(S)), labels


def _model(k, init, dropout=0.0):
    """Transformer.tiny of package ``k`` under a fresh unique-name guard,
    carrying ``init`` (the reference's weights by path)."""
    with k["uniq"].guard():
        model = k["T"].Transformer.tiny(dropout_rate=dropout)
    if k is PORT:
        model.set_dict(init)
    else:
        for n, p in model.named_parameters():
            p.set_value(init[n])
    return model


def assert_params_close(got, want, rtol, moved_by):
    """Every parameter within ``rtol`` of its largest magnitude, but the
    key projections' biases: a key bias adds one q.b to every score of a
    row, which softmax cancels, so its gradient is zero up to rounding
    and Adam moves it by rounding noise alone. Those stay within 1e-2 of
    ``moved_by`` (lr x steps, what a real gradient would move them) of
    zero, in both packages."""
    assert sorted(got) == sorted(want)
    for n in want:
        if n.endswith("k_fc.bias"):
            for v in (got[n], want[n]):
                assert np.abs(v).max() < 1e-2 * moved_by, n
        else:
            assert_close(got[n], want[n], rtol, n)


def _eager(k, init):
    args, labels = _batch()
    with k["dy"].guard(**k["place"]):
        model = _model(k, init)
        opt = k["opt"].Adam(learning_rate=1e-3)
        losses = []
        for _ in range(EAGER_STEPS):
            logits = model(*[k["dy"].to_variable(a) for a in args])
            loss = k["T"].loss_fn(logits, k["dy"].to_variable(labels))
            model.clear_gradients()
            opt.minimize(loss, parameter_list=model.parameters())
            losses.append(float(np.asarray(loss.numpy())))
        return losses, {n: np.array(p.numpy())
                        for n, p in model.named_parameters()}


def _traced(k, init, train, dropout=0.0):
    args, _ = _batch()
    with k["dy"].guard(**k["place"]):
        model = _model(k, init, dropout)
        if not train:
            model.eval()
        xs = [k["dy"].to_variable(a) for a in args]
        eager = np.array(model(*xs).numpy())
        _, traced = k["dy"].jit.trace(model, xs)
    return model, eager, traced


def _static(k, init, amp):
    """bench.py:810-838 at Transformer.tiny: trace in training mode,
    append the loss and Adam(1e-4) (AMP-decorated), run the startup and
    STATIC_STEPS steps. Returns (losses, the traced desc, the full desc,
    the final parameters by name)."""
    args, labels = _batch()
    model, _, traced = _traced(k, init, train=True)
    traced_desc = mapped_desc(traced.program)
    startup = k["fluid"].Program()
    L = k["layers"]
    with k["uniq"].guard(), k["fluid"].program_guard(traced.program,
                                                     startup):
        logits = traced.program.global_block().var(traced._fetch_names[0])
        label = L.data("tfm_label", [S, 1], dtype="int64")
        flat = L.reshape(logits, [-1, V])
        ce = L.softmax_with_cross_entropy(flat, L.reshape(label, [-1, 1]))
        loss = L.mean(ce)
        opt = k["opt"].Adam(learning_rate=1e-4)
        if amp:
            opt = k["amp"].decorate(opt)
        opt.minimize(loss)
    traced._materialize_scope()
    feed = dict(zip(traced._feed_names, args))
    feed["tfm_label"] = labels
    if k is PORT:
        exe = fluid.Executor("cpu")
        exe.run(startup, scope=traced._scope)
        losses = [float(exe.run(traced.program, feed=feed, fetch_list=[loss],
                                scope=traced._scope)[0])
                  for _ in range(STATIC_STEPS)]
    else:
        exe = jfluid.Executor()
        with jfluid.scope_guard(traced._scope):
            exe.run(startup)
            losses = [float(np.asarray(exe.run(
                traced.program, feed=feed, fetch_list=[loss])[0]))
                for _ in range(STATIC_STEPS)]
    # the reference's executor donates the scope's buffers: read the
    # parameters from the scope (the port's binds the model's own)
    params = {n: np.array(traced._scope.find_var(p.name))
              for n, p in model.named_parameters()}
    return losses, traced_desc, mapped_desc(traced.program), params


@pytest.fixture(scope="module")
def ref():
    """The reference's runs, once: its initial weights, the eager
    trajectory, eval and training traces, the fp32 and AMP to-static
    trajectories."""
    with jdy.guard(), juniq.guard():
        init = {n: np.array(p.numpy()) for n, p in
                JT.Transformer.tiny(dropout_rate=0.0).named_parameters()}
    out = {"init": init, "eager": _eager(REF, init)}
    _, out["eval_out"], traced = _traced(REF, init, train=False)
    out["eval_desc"] = mapped_desc(traced.program)
    _, _, traced = _traced(REF, init, train=True, dropout=0.1)
    out["dropout_desc"] = mapped_desc(traced.program)
    for amp in (False, True):
        out["static", amp] = _static(REF, init, amp)
    return out


def test_parameter_names_match_reference(ref):
    with unique_name.guard(), dygraph.guard("cpu"):
        model = PT.Transformer.tiny()
        port = {n: p.name for n, p in model.named_parameters()}
    with juniq.guard(), jdy.guard():
        want = {n: p.name for n, p in JT.Transformer.tiny().named_parameters()}
    assert port == want and sorted(port) == sorted(ref["init"])


def test_eager_dygraph_trajectory_matches_reference(ref):
    want_losses, want_params = ref["eager"]
    losses, params = _eager(PORT, ref["init"])
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    assert losses[-1] < losses[0]
    assert_params_close(params, want_params, 1e-4, 1e-3 * EAGER_STEPS)


def test_jit_trace_matches_eager_and_reference(ref):
    """Eval mode: the traced program through the executor equals the
    eager output, which equals the reference's; the traced desc equals
    the reference's."""
    model, eager, traced = _traced(PORT, ref["init"], train=False)
    args, _ = _batch()
    (static,) = traced(list(args))
    np.testing.assert_allclose(static, eager, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(eager, ref["eval_out"], rtol=2e-4, atol=2e-4)
    assert mapped_desc(traced.program) == ref["eval_desc"]
    for _, p in model.named_parameters():
        assert traced._scope.find_var(p.name).data_ptr() == p.data_ptr()


def test_training_trace_desc_matches_reference(ref):
    """Training mode at dropout 0.1: the reference's ops in its order,
    ``dropout`` (upscale in train) after the embeddings, softmax and
    every residual branch; no fused attention op."""
    _, _, traced = _traced(PORT, ref["init"], train=True, dropout=0.1)
    desc = mapped_desc(traced.program)
    types = [op["type"] for op in desc["blocks"][0]["ops"]]
    # the embeddings; per encoder layer the attention weights, two
    # residual branches and the FFN; per decoder layer two attentions,
    # three residual branches and the FFN
    assert types.count("dropout") == 2 + 2 * 4 + 2 * 6
    assert not any("attention" in t for t in types)
    assert desc == ref["dropout_desc"]


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_to_static_trajectory_matches_reference(ref, amp):
    want_losses, want_traced, want_desc, want_params = ref["static", amp]
    losses, traced_desc, desc, params = _static(PORT, ref["init"], amp)
    assert traced_desc == want_traced
    assert desc == want_desc
    np.testing.assert_allclose(losses, want_losses, rtol=TRAJ_RTOL[amp])
    assert losses[-1] < losses[0]
    if not amp:
        assert_params_close(params, want_params, 1e-4, 1e-4 * STATIC_STEPS)


def test_dropout_keep_rate_scaling_and_one_mask():
    """The traced dropout (p 0.1, upscale in train) keeps about 0.9 of
    the elements, scales the kept ones by 1 / the realised keep rate
    (230 / 256, the port's 8-bit draw), and the backward passes the
    forward's own mask."""
    with dygraph.guard("cpu"):
        x = dygraph.to_variable(np.full((256, 256), 2.0, np.float32))
        x.stop_gradient = False
        out = PT._dropout(x, 0.1, True)
        out.backward()
        y, g = out.numpy(), x.gradient()
    kept = y != 0
    scale = 256.0 / 230.0
    assert abs(kept.mean() - 230.0 / 256.0) < 0.01
    np.testing.assert_allclose(y[kept], 2.0 * scale, rtol=1e-6)
    np.testing.assert_array_equal(g != 0, kept)
    np.testing.assert_allclose(g[kept], scale, rtol=1e-6)


def test_dropout_off_in_eval_and_at_p0():
    with dygraph.guard("cpu"):
        x = dygraph.to_variable(np.ones((4, 4), np.float32))
        assert PT._dropout(x, 0.1, False) is x
        assert PT._dropout(x, 0.0, True) is x


def test_decode_methods_never_reach_a_tracer():
    """Under ``dygraph.guard()`` a model's prefill, decode steps (dense,
    paged, draft) and verify step run in torch: the tracer traces
    nothing, and the tokens equal a run outside the guard."""
    src = np.random.RandomState(0).randint(2, V, (2, 6)).astype(np.int64)
    prompt = np.random.RandomState(1).randint(2, V, (2, 4)).astype(np.int64)
    plens = np.array([4, 3], np.int64)

    def generate(model):
        dense = PT.build_decode_session(model, 2, 6, 4, 16)
        paged = PT.build_paged_decode_session(model, 2, 6, 4, 16,
                                              page_tokens=8)
        spec = PT.build_speculative_session(model, dense, k=2,
                                            draft_layers=1)
        toks = [dense.generate(src, prompt, plens, 5),
                spec.generate(src, prompt, plens, 5)]
        for i in range(2):
            paged.join(src[i:i + 1], prompt[i:i + 1], int(plens[i]),
                       max_new_tokens=3)
        done = []
        while paged.active_count:
            done += paged.step()
        return toks, sorted((s, tuple(t)) for s, t, _ in done)

    model = PT.Transformer.tiny(device="cpu", seed=2)
    want = generate(model)
    with dygraph.guard("cpu"):
        tracer = fluid.framework._dygraph_tracer()
        got = generate(model)
        assert tracer.traced_ops == 0
    for g, w in zip(got[0], want[0]):      # (tokens, finished) each
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert got[1] == want[1]


def test_multi_device_options_raise_naming_the_roadmap():
    for kw in ({"model_axis": "model"}, {"seq_parallel": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 7"):
            PT.Transformer.tiny(device="cpu", **kw)
