"""Recompute (activation checkpointing) in the port:
``RecomputeOptimizer``, the ``autodiff`` op's ``checkpoints``
(``fluid/ops/autodiff.py``: segments under ``torch.utils.checkpoint``),
the replayed draws (``registry.DrawRecord``), the models' checkpoint
vars, and ``Executor.as_function``; held to the JAX package's on the
CPU.

- ``test_recompute_matches_baseline``'s program (tests/test_recompute.py)
  from the reference's startup state: the port's recompute within rtol
  1e-5 of the reference's recompute, and equal to the port's own run
  without recompute exactly;
- rematerialization shown without HLO: the forward's products lowered
  again inside the ``autodiff`` op, and fewer bytes saved for the
  backward outside the recomputed segments
  (``torch.autograd.graph.saved_tensors_hooks``);
- BERT-tiny with dropout 0.1: recompute equals no recompute exactly
  (losses, parameters, moments, generator);
- ``Transformer.tiny``'s and ``EncoderTower``'s ``checkpoint_vars`` name
  the reference's vars (by place in the traced desc);
- ``as_function``: fetches and state equal to ``Executor.run``'s, with
  the scope and its generator untouched.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import dygraph as jdy
from paddle_tpu.fluid import unique_name as juniq
from paddle_tpu.models import transformer as JT
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import dygraph, unique_name
from paddle_tpu_torch.fluid.ops import autodiff
from paddle_tpu_torch.fluid.registry import DrawRecord, LowerCtx, registry
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.models import transformer as PT

RTOL, ATOL = 1e-5, 1e-6


def _build(pkg, use_recompute):
    """tests/test_recompute.py's program, in either package."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = 11
    L = pkg.layers
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = L.data("x", shape=[32], dtype="float32")
        h1 = L.fc(x, 64, act="tanh")
        h2 = L.fc(h1, 64, act="tanh")
        h3 = L.fc(h2, 64, act="tanh")
        loss = L.mean(L.fc(h3, 1))
        opt = pkg.optimizer.SGD(learning_rate=0.1)
        if use_recompute:
            opt = pkg.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints([h1, h2])
        opt.minimize(loss)
    return main, startup, loss


FEED = {"x": np.random.RandomState(3).rand(8, 32).astype(np.float32)}


def _names(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


@pytest.fixture(scope="module")
def ref():
    """The reference's startup state and its losses with and without
    recompute (4 steps)."""
    out = {}
    for rc in (False, True):
        main, startup, loss = _build(jfluid, rc)
        exe, scope = jfluid.Executor(), jfluid.Scope()
        exe.run(startup, scope=scope)
        if not rc:
            out["init"] = {n: np.array(scope.find_var(n))
                           for n in _names(main)}
        out[rc] = [float(np.asarray(exe.run(main, feed=FEED,
                                            fetch_list=[loss],
                                            scope=scope)[0]).ravel()[0])
                   for _ in range(4)]
    return out


def _port(rc, init):
    main, startup, loss = _build(fluid, rc)
    exe, scope = fluid.Executor("cpu"), fluid.Scope()
    exe.run(startup, scope=scope)
    for n, v in init.items():
        scope.set_var(n, torch.from_numpy(v.copy()))
    losses = [float(exe.run(main, feed=FEED, fetch_list=[loss],
                            scope=scope)[0].ravel()[0]) for _ in range(4)]
    return losses, {n: scope.find_var(n).clone() for n in _names(main)}


def test_recompute_matches_baseline(ref):
    base, base_state = _port(False, ref["init"])
    remat, remat_state = _port(True, ref["init"])
    assert remat == base
    for n, t in base_state.items():
        assert torch.equal(remat_state[n], t), n
    np.testing.assert_allclose(remat, ref[True], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ref[True], ref[False], rtol=RTOL, atol=ATOL)


def test_checkpoints_on_the_autodiff_op_as_reference():
    for rc in (False, True):
        descs = [next(op for op in _build(pkg, rc)[0].global_block().ops
                      if op.type == "autodiff").attrs
                 for pkg in (jfluid, fluid)]
        assert descs[0].get("checkpoints") == descs[1].get("checkpoints")
    main = _build(fluid, True)[0]
    ops = main.global_block().ops
    grad_at = [op.type for op in ops].index("autodiff")
    segs = autodiff.checkpoint_segments(
        ops, grad_at, ops[grad_at].attr("checkpoints"))
    # cut after h1's and h2's activations: two recomputed segments, the
    # last (h3, the head, the loss) runs plainly
    assert len(segs) == 2 and segs[0][0] == 0 and segs[1][0] == segs[0][1]
    assert ops[segs[0][1] - 1].type == ops[segs[1][1] - 1].type == "tanh"


def _lowerings_and_saved_bytes(rc, monkeypatch):
    """One step of the program through ``as_function``: (``mul``
    lowerings inside the ``autodiff`` op, bytes autograd saved outside
    recomputed segments)."""
    main, startup, loss = _build(fluid, rc)
    exe, scope = fluid.Executor("cpu"), fluid.Scope()
    exe.run(startup, scope=scope)
    fn, (state, feed, rng) = exe.as_function(main, FEED, [loss],
                                             scope=scope)
    inside, muls = [False], [0]
    ops = dict(registry._ops)

    def grad(ctx, op):
        inside[0] = True
        try:
            ops["autodiff"](ctx, op)
        finally:
            inside[0] = False

    def mul(ctx, op):
        muls[0] += inside[0]
        ops["mul"](ctx, op)

    monkeypatch.setitem(registry._ops, "autodiff", grad)
    monkeypatch.setitem(registry._ops, "mul", mul)
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(state, feed, rng)
    return muls[0], saved[0]


def test_recompute_rematerializes(monkeypatch):
    base_muls, base_bytes = _lowerings_and_saved_bytes(False, monkeypatch)
    muls, saved = _lowerings_and_saved_bytes(True, monkeypatch)
    # the two recomputed segments' products run again in the backward
    assert (base_muls, muls) == (0, 2)
    assert saved < base_bytes, (saved, base_bytes)


def test_draw_record_replays_without_drawing():
    """Recording keeps each op's draws; replaying hands them back in op
    order and leaves the generator where it was; a draw the record does
    not hold raises."""
    gen = torch.Generator().manual_seed(5)
    ctx = LowerCtx(fluid.Program().global_block(), {}, gen, "cpu")
    rec = ctx.draw_record = DrawRecord()
    rec.at_op(3)
    seed, bytes_ = ctx.next_seed(), ctx.random_bytes((4, 5))
    rec.at_op(4)
    u, n = ctx.uniform((3,), -1, 1), ctx.normal((2,), 0, 2)
    after = gen.get_state()
    rec.replaying = True
    rec.at_op(3)
    assert ctx.next_seed() is seed and ctx.random_bytes((4, 5)) is bytes_
    rec.at_op(4)
    assert torch.equal(ctx.uniform((3,), -1, 1), u)
    assert torch.equal(ctx.normal((2,), 0, 2), n)
    assert torch.equal(gen.get_state(), after)
    with pytest.raises(RuntimeError, match="did not make"):
        ctx.next_seed()


def _bert_tiny(rc, steps=4):
    cfg = bert.BertConfig.tiny()
    with unique_name.guard():
        main, startup, loss = bert.build_pretrain_program(
            cfg, seq_len=16, recompute=rc)
    exe, scope = fluid.Executor("cpu"), fluid.Scope()
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed=bert.synthetic_batch(
        cfg, 2, 16, seed=i), fetch_list=[loss], scope=scope)[0].ravel()[0])
        for i in range(steps)]
    return main, losses, {n: scope.find_var(n).clone()
                          for n in scope.local_var_names()}, \
        scope.generator.get_state()


def test_bert_tiny_with_dropout_recompute_equals_plain():
    """Dropout 0.1 in every layer: the recomputed segments replay the
    primal run's masks, so 4 steps equal the plain run's exactly."""
    main, want, state, rng = _bert_tiny(False)
    rmain, got, rstate, rrng = _bert_tiny(True)
    grad = next(op for op in rmain.global_block().ops
                if op.type == "autodiff")
    assert len(grad.attr("checkpoints")) == 2
    assert got == want
    for n, t in state.items():
        assert torch.equal(rstate[n], t), n
    assert torch.equal(rrng, rng)


def test_recompute_under_amp_equals_plain():
    """The AMP decorator around ``RecomputeOptimizer``: the checkpoints
    reach the ``autodiff`` op through the rewrite, and two bf16 steps
    equal the plain AMP steps exactly."""
    out = []
    for rc in (False, True):
        cfg = bert.BertConfig.tiny()
        with unique_name.guard():
            main, startup, loss = bert.build_pretrain_program(
                cfg, seq_len=16, use_amp=True, recompute=rc)
        exe, scope = fluid.Executor("cpu"), fluid.Scope()
        exe.run(startup, scope=scope)
        out.append([float(exe.run(main, feed=bert.synthetic_batch(
            cfg, 2, 16, seed=i), fetch_list=[loss], scope=scope)[0].ravel()[0])
            for i in range(2)])
    assert out[0] == out[1]


def _traced_checkpoints(pkg_dy, uniq, T, kw, tower):
    """Place in the traced program's var table of each checkpoint var of
    a traced ``Transformer.tiny`` or ``EncoderTower`` (eval mode)."""
    src, tgt, labels, pos = JT.synthetic_batch(64, 64, 2, 8)
    with pkg_dy.guard(**kw):
        with uniq.guard():
            model = (T.EncoderTower(64, d_model=16, n_heads=2, d_inner=32,
                                    n_layers=3) if tower
                     else T.Transformer.tiny(64, 64))
        model.eval()
        xs = [pkg_dy.to_variable(a) for a in (
            (src, pos) if tower else
            (src, tgt, pos, pos, JT.make_causal_bias(8)))]
        _, traced = pkg_dy.jit.trace(model, xs)
    names = list(traced.program.global_block().vars)
    if T is PT:
        assert [v.name for v in model.checkpoint_vars(traced.program)] == \
            model.last_checkpoints
    return [names.index(n) for n in model.last_checkpoints]


@pytest.mark.parametrize("tower", [False, True])
def test_checkpoint_vars_name_the_references(tower):
    want = _traced_checkpoints(jdy, juniq, JT, {}, tower)
    got = _traced_checkpoints(dygraph, unique_name, PT, {"place": "cpu"},
                              tower)
    assert got == want and len(got) == (3 if tower else 4)


def test_traced_transformer_trains_with_recompute():
    """A traced ``Transformer.tiny`` (dropout 0.1) with its
    ``checkpoint_vars`` as checkpoints: 2 Adam steps equal the plain
    traced program's exactly."""
    src, tgt, labels, pos = JT.synthetic_batch(64, 64, 2, 8)
    out = []
    for rc in (False, True):
        with dygraph.guard(place="cpu"):
            with unique_name.guard():
                model = PT.Transformer.tiny(64, 64, dropout_rate=0.1)
            xs = [dygraph.to_variable(a) for a in
                  (src, tgt, pos, pos, JT.make_causal_bias(8))]
            _, traced = dygraph.jit.trace(model, xs)
        startup = fluid.Program()
        with unique_name.guard(), fluid.program_guard(traced.program,
                                                      startup):
            logits = traced.program.global_block().var(
                traced._fetch_names[0])
            label = fluid.layers.data("tfm_label", [8, 1], dtype="int64")
            loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
                fluid.layers.reshape(logits, [-1, 64]),
                fluid.layers.reshape(label, [-1, 1])))
            opt = fluid.optimizer.Adam(learning_rate=1e-3)
            if rc:
                opt = fluid.optimizer.RecomputeOptimizer(opt)
                opt._set_checkpoints(model.checkpoint_vars(traced.program))
            opt.minimize(loss)
        traced._materialize_scope()
        traced._scope.generator = None
        exe = fluid.Executor("cpu")
        exe.run(startup, scope=traced._scope)
        feed = dict(zip(traced._feed_names, (src, tgt, pos, pos,
                                             JT.make_causal_bias(8))))
        feed["tfm_label"] = labels
        out.append([float(exe.run(traced.program, feed=feed,
                                  fetch_list=[loss],
                                  scope=traced._scope)[0])
                    for _ in range(2)])
    assert out[0] == out[1]


def test_recompute_with_selected_rows_raises_the_references_words():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), unique_name.guard():
        ids = fluid.layers.data("ids", shape=[2], dtype="int64")
        emb = fluid.layers.embedding(ids, size=[10, 3], is_sparse=True)
        h = fluid.layers.fc(emb, 2)
        loss = fluid.layers.mean(h)
        opt = fluid.optimizer.RecomputeOptimizer(fluid.optimizer.SGD(0.1))
        opt._set_checkpoints([emb])
        opt.minimize(loss)
    exe, scope = fluid.Executor("cpu"), fluid.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(NotImplementedError,
                       match="recompute \\+ sparse embedding grads not "
                             "supported yet"):
        exe.run(main, feed={"ids": np.ones((2, 2), np.int64)},
                fetch_list=[loss], scope=scope)


def test_as_function_is_pure_and_equals_run():
    """``fn(state, feed, rng_state)`` against ``Executor.run`` from the
    same scope: fetches, the new state and the new generator state equal
    to the bit; the scope and its generator untouched by ``fn``."""
    cfg = bert.BertConfig.tiny()
    with unique_name.guard():
        main, startup, loss = bert.build_pretrain_program(cfg, seq_len=16)
    exe, scope = fluid.Executor("cpu"), fluid.Scope()
    exe.run(startup, scope=scope)
    feed = bert.synthetic_batch(cfg, 2, 16, seed=1)
    fn, (state, spec, rng) = exe.as_function(main, feed, [loss],
                                             scope=scope)
    before = {n: t.clone() for n, t in scope.vars.items()}
    assert sorted(state) == _names(main)
    assert torch.equal(rng, scope.generator.get_state())
    fetches, new_state, new_rng = fn(state, spec, rng)
    for n, t in before.items():
        assert torch.equal(scope.find_var(n), t), n
    assert torch.equal(scope.generator.get_state(), rng)
    (want,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                      return_numpy=False)
    assert torch.equal(fetches[0], want)
    for n in _names(main):
        assert torch.equal(new_state[n], scope.find_var(n)), n
    assert torch.equal(new_rng, scope.generator.get_state())
    # a scope with no generator yet: the program's seed
    fn2, (_, _, rng2) = exe.as_function(main, feed, [loss],
                                        scope=fluid.Scope())
    assert torch.equal(rng2, torch.Generator().manual_seed(
        main.random_seed).get_state())
