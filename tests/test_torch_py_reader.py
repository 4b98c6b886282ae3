"""py_reader feeding and the executor's window prefetch in the port
(``paddle_tpu_torch/fluid/layers/py_reader.py``, ``Executor.run``'s
py_reader path and ``_WindowPrefetch``, ``fluid.reader.PyReader``), held
to the JAX package's on the CPU.

Programs are built by both packages inside ``unique_name.guard()``; the
port starts from the reference's startup state (``copy_scope``) and
both read the same numpy batches. Tolerances (fp32): rtol 1e-5 per loss
and per persistable (atol 1e-6). Where both report the same thing
(errors, reader positions, batch counts) the port's must equal the
reference's; the port's prefetched trajectories equal its inline ones
to the bit.
"""

import threading

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import bert as JB
import paddle_tpu_torch.fluid as pfluid
from paddle_tpu_torch.fluid import executor as PE
from paddle_tpu_torch.fluid import monitor as pmonitor
from paddle_tpu_torch.models import bert as PB

RTOL, ATOL = 1e-5, 1e-6
B, D = 4, 3


def _program(fluid, batch=B, dim=D):
    """(main, startup, reader, loss) of a linear model with SGD fed by a
    py_reader of [batch, dim] inputs and [batch, 1] targets."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        reader = fluid.layers.py_reader(
            capacity=8, shapes=[[batch, dim], [batch, 1]],
            dtypes=["float32", "float32"])
        x, y = fluid.layers.read_file(reader)
        h = fluid.layers.fc(x, 6, act="relu")
        pred = fluid.layers.fc(h, 1)
        d = fluid.layers.elementwise_sub(pred, y)
        loss = fluid.layers.mean(fluid.layers.elementwise_mul(d, d))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, reader, loss


def _batches(n, seed=0, batch=B, dim=D):
    rng = np.random.RandomState(seed)
    return [(rng.rand(batch, dim).astype(np.float32),
             rng.rand(batch, 1).astype(np.float32)) for _ in range(n)]


def _persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def _pair(n_batches, seed=0):
    """The model in both packages, their readers on the same batches,
    the port's scope holding the reference's startup state."""
    batches = _batches(n_batches, seed)
    jm, js, jr, jl = _program(jfluid)
    pm, ps, pr, pl = _program(pfluid)
    for r in (jr, pr):
        r.decorate_tensor_provider(lambda: iter(batches))
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    jexe.run(js, scope=jscope)
    pscope = pfluid.Scope()
    pfluid.copy_scope(jscope, pscope, _persistables(jm), device="cpu")
    return ((jm, jr, jl, jexe, jscope),
            (pm, pr, pl, pfluid.Executor("cpu"), pscope))


def _epochs(fluid, main, reader, loss, exe, scope, epochs, **kw):
    """Run ``epochs`` passes to EOF; the losses of every run, flat."""
    out = []
    for _ in range(epochs):
        reader.start()
        while True:
            try:
                (v,) = exe.run(main, fetch_list=[loss], scope=scope, **kw)
            except fluid.core.EOFException:
                reader.reset()
                break
            out.append(np.asarray(v).reshape(-1))
    return np.concatenate(out)


def _state(main, scope):
    return {n: np.array(scope.find_var(n)) for n in _persistables(main)}


def _close(got, want):
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)


def test_loop_matches_reference():
    """Two passes of 6 batches, one step a run: losses, EOF points and
    the final state against the reference's loop."""
    (jm, jr, jl, jexe, jscope), (pm, pr, pl, pexe, pscope) = _pair(6)
    want = _epochs(jfluid, jm, jr, jl, jexe, jscope, 2)
    got = _epochs(pfluid, pm, pr, pl, pexe, pscope, 2)
    assert got.shape == want.shape == (12,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    _close(_state(pm, pscope), _state(jm, jscope))


def test_program_keeps_its_feed_signature():
    """The dequeue op is no host op: a py_reader program's plan has
    none, so on the card it is captured like any other."""
    pm = _program(pfluid)[0]
    assert "py_reader_dequeue" not in PE._HOST_OPS
    assert PE._Plan(pm, []).host_ops == []
    assert [op.type for op in pm.global_block().ops][0] == \
        "py_reader_dequeue"


def _bert_ref(cfg, seq, batch):
    """The reference's BERT pretraining program built by the layer calls
    the port's ``build_pretrain_program(py_reader_batch=)`` makes."""
    main, startup = jfluid.Program(), jfluid.Program()
    main.random_seed = 7
    n = JB.max_predictions(seq)
    with jfluid.program_guard(main, startup), jfluid.unique_name.guard():
        reader = jfluid.layers.py_reader(
            capacity=2, shapes=[[batch, seq]] * 3 + [[batch, seq, 1]] +
            [[batch, n]] * 3, dtypes=["int64"] * 3 + ["float32"] +
            ["int64", "int64", "float32"], name="bert_reader")
        slots = jfluid.layers.read_file(reader)
        enc = JB.bert_encoder(*slots[:4], cfg)
        loss = JB.mlm_loss_masked(enc, *slots[4:], cfg)
        jfluid.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    return main, startup, reader, loss


def _strip_reader_ids(desc):
    for blk in desc["blocks"]:
        for op in blk["ops"]:
            op["attrs"].pop("reader_id", None)
    return desc


def test_bert_tiny_loop_matches_reference():
    """BERT-tiny (dropout 0, S 16, batch 2) fed by a py_reader: the
    port's ``build_pretrain_program(py_reader_batch=2)`` builds the
    reference's desc (but the readers' registry ids), and its loop over
    3 batches matches the reference's, losses and state."""
    cfg = JB.BertConfig.tiny()
    cfg.hidden_dropout = cfg.attn_dropout = 0.0
    jm, js, jr, jl = _bert_ref(cfg, 16, 2)
    pcfg = PB.BertConfig.tiny()
    pcfg.hidden_dropout = pcfg.attn_dropout = 0.0
    with pfluid.unique_name.guard():
        pm, _, pl = PB.build_pretrain_program(pcfg, seq_len=16,
                                              py_reader_batch=2)
    assert _strip_reader_ids(pm.to_desc()) == \
        _strip_reader_ids(jm.to_desc())
    batches = [PB.reader_batch(JB.synthetic_batch(cfg, 2, 16, seed=i))
               for i in range(3)]
    for r in (jr, pm.py_reader):
        r.decorate_tensor_provider(lambda: iter(batches))
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    jexe.run(js, scope=jscope)
    pscope = pfluid.Scope()
    pfluid.copy_scope(jscope, pscope, _persistables(jm), device="cpu")
    want = _epochs(jfluid, jm, jr, jl, jexe, jscope, 1)
    got = _epochs(pfluid, pm, pm.py_reader, pl, pfluid.Executor("cpu"),
                  pscope, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # a key projection's bias shifts every score of a row alike, which
    # softmax cancels: its gradient is rounding noise, and Adam moves it
    # by up to lr a step either way in both packages (PERF.md, PR 15)
    gs, ws = _state(pm, pscope), _state(jm, jscope)
    for n in [n for n in ws if n.endswith("_attn_k.b_0")]:
        assert max(np.abs(gs.pop(n)).max(), np.abs(ws.pop(n)).max()) \
            <= 3 * 1e-4, n
    _close(gs, ws)


def test_iters_pulls_exactly_k_batches():
    """``iters=3`` pulls three batches up front, as the reference: the
    readers' positions and the batch counts after each window, and the
    window's trajectory."""
    (jm, jr, jl, jexe, jscope), (pm, pr, pl, pexe, pscope) = _pair(7)
    counter = pmonitor.counter("py_reader_batches_total")
    for r in (jr, pr):
        r.start()
    for _ in range(2):
        c0 = counter.value
        (want,) = jexe.run(jm, fetch_list=[jl], scope=jscope, iters=3)
        (got,) = pexe.run(pm, fetch_list=[pl], scope=pscope, iters=3)
        assert counter.value - c0 == 3
        assert pr.position == jr.position
        np.testing.assert_allclose(got.reshape(-1),
                                   np.asarray(want).reshape(-1),
                                   rtol=RTOL, atol=ATOL)
    assert pr.position == 6
    for fluid, exe, main, loss, scope in ((jfluid, jexe, jm, jl, jscope),
                                          (pfluid, pexe, pm, pl, pscope)):
        with pytest.raises(fluid.core.EOFException, match="before 3"):
            exe.run(main, fetch_list=[loss], scope=scope, iters=3)
    assert pr.position == jr.position == 0
    _close(_state(pm, pscope), _state(jm, jscope))


@pytest.mark.parametrize("n_batches", [6, 7])
def test_prefetch_equals_inline_across_epochs(n_batches):
    """``iters=2, prefetch=True`` against the inline loop over two
    passes (7 batches: a ragged last window, dropped): the port's
    trajectories equal to the bit, and both within rtol of the
    reference's inline loop."""
    (jm, jr, jl, jexe, jscope), (pm, pr, pl, pexe, pscope) = _pair(
        n_batches)
    want = _epochs(jfluid, jm, jr, jl, jexe, jscope, 2, iters=2)
    runs = {}
    for prefetch in (False, True):
        main, _, reader, loss = _program(pfluid)
        batches = _batches(n_batches)
        reader.decorate_tensor_provider(lambda: iter(batches))
        scope, exe = pfluid.Scope(), pfluid.Executor("cpu")
        pfluid.copy_scope(pscope, scope, _persistables(main), device="cpu")
        runs[prefetch] = _epochs(pfluid, main, reader, loss, exe, scope, 2,
                                 iters=2, prefetch=prefetch,
                                 fetch_mode="async")
        exe.close()
    np.testing.assert_array_equal(runs[True], runs[False])
    np.testing.assert_allclose(runs[True], want, rtol=RTOL, atol=ATOL)


def test_prefetch_counters_and_stall():
    """One miss (the pass's first window) then hits; a stall sample a
    consumed window, the in-flight gauge back at 0."""
    pm, ps, pr, pl = _program(pfluid)
    pr.decorate_tensor_provider(lambda: iter(_batches(6)))
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    exe.run(ps, scope=scope)
    hit = pmonitor.counter("executor_window_overlap_hit_total")
    miss = pmonitor.counter("executor_window_overlap_miss_total")
    stall = pmonitor.histogram("executor_window_stall_seconds")
    h0, m0, s0 = hit.value, miss.value, stall.count
    pr.start()
    for _ in range(3):
        exe.run(pm, fetch_list=[pl], scope=scope, iters=2, prefetch=True)
    exe.close()
    assert (hit.value - h0, miss.value - m0, stall.count - s0) == (2, 1, 2)
    assert pmonitor.gauge("executor_window_prefetch_inflight").value == 0


@pytest.mark.parametrize("prefetch", [False, True])
def test_eof_before_a_step_leaves_the_state(prefetch):
    """5 batches in windows of 2: the third window ends the pass before
    any step; the state is the second window's, the readers reset, and
    the next pass runs from its first batch."""
    pm, ps, pr, pl = _program(pfluid)
    pr.decorate_tensor_provider(lambda: iter(_batches(5)))
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    exe.run(ps, scope=scope)
    pr.start()
    for _ in range(2):
        exe.run(pm, fetch_list=[pl], scope=scope, iters=2,
                prefetch=prefetch)
    before = {n: scope.find_var(n).clone() for n in _persistables(pm)}
    rng = scope.generator.get_state()
    with pytest.raises(pfluid.core.EOFException):
        exe.run(pm, fetch_list=[pl], scope=scope, iters=2,
                prefetch=prefetch)
    for n, t in before.items():
        assert torch.equal(scope.find_var(n), t), n
    assert torch.equal(scope.generator.get_state(), rng)
    assert pr.position == 0
    pr.start()
    (v,) = exe.run(pm, fetch_list=[pl], scope=scope, iters=2,
                   prefetch=prefetch)
    assert np.isfinite(v).all() and pr.position == (4 if prefetch else 2)
    exe.close()


def test_conflicts_raise_as_reference():
    """A pending prefetched window guards its readers: a single-step run
    and a run of another window size are refused with the reference's
    messages; ``close()`` clears it."""
    msgs = []
    for fluid, exe in ((jfluid, jfluid.Executor()),
                       (pfluid, pfluid.Executor("cpu"))):
        main, startup, reader, loss = _program(fluid)
        reader.decorate_tensor_provider(lambda: iter(_batches(10)))
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        reader.start()
        exe.run(main, fetch_list=[loss], scope=scope, iters=2,
                prefetch=True)
        for kw in ({}, {"iters": 3}):
            with pytest.raises(RuntimeError) as e:
                exe.run(main, fetch_list=[loss], scope=scope, **kw)
            msgs.append(str(e.value))
        with pytest.raises(ValueError) as e:
            exe.run(main, fetch_list=[loss], scope=scope, prefetch=True)
        msgs.append(str(e.value))
        exe.close()
        (v,) = exe.run(main, fetch_list=[loss], scope=scope)
        assert np.isfinite(np.asarray(v)).all()
        exe.close()
    assert msgs[:3] == msgs[3:]
    assert "prefetched" in msgs[0] and "mis-windowed" in msgs[1]


def test_prefetch_needs_a_py_reader_program_as_reference():
    msgs = []
    for fluid, exe in ((jfluid, jfluid.Executor()),
                       (pfluid, pfluid.Executor("cpu"))):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data("x", shape=[3], dtype="float32")
            loss = fluid.layers.mean(fluid.layers.fc(x, 1))
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        with pytest.raises(ValueError) as e:
            exe.run(main, feed={"x": np.ones((2, 4, 3), np.float32)},
                    fetch_list=[loss], scope=scope, iters=2, prefetch=True)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "py_reader-fed" in msgs[0]


def test_no_thread_left_after_close():
    """``close()`` joins a pending prefetch of a loop left mid-pass."""
    pm, ps, pr, pl = _program(pfluid)
    pr.decorate_tensor_provider(lambda: iter(_batches(8)))
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    exe.run(ps, scope=scope)
    pr.start()
    exe.run(pm, fetch_list=[pl], scope=scope, iters=2, prefetch=True)
    assert len(exe._window_prefetch) == 1
    exe.close()
    assert not exe._window_prefetch
    alive = [t.name for t in threading.enumerate()
             if t.is_alive() and t.name.startswith("paddle-window-prefetch")]
    assert not alive, alive


def test_prefetch_error_reraises_on_the_consuming_run():
    """A provider that fails while the thread drains: the next run
    raises its error and runs no step."""
    pm, ps, pr, pl = _program(pfluid)
    good = _batches(2)

    def provider():
        yield from good
        raise OSError("disk gone")

    pr.decorate_tensor_provider(provider)
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    exe.run(ps, scope=scope)
    pr.start()
    exe.run(pm, fetch_list=[pl], scope=scope, iters=2, prefetch=True)
    before = {n: scope.find_var(n).clone() for n in _persistables(pm)}
    with pytest.raises(OSError, match="disk gone"):
        exe.run(pm, fetch_list=[pl], scope=scope, iters=2, prefetch=True)
    for n, t in before.items():
        assert torch.equal(scope.find_var(n), t), n
    exe.close()


def test_reader_position_resume_and_rewind():
    """The reference's cursor test (tests/test_fault_tolerance.py:252),
    then the port's rewind: ``resume_at`` below a live pass's position
    restarts the provider."""
    from paddle_tpu.fluid.layers.py_reader import _PyReader as JR
    from paddle_tpu_torch.fluid.layers.py_reader import _PyReader as PR

    batches = [np.full((2, 2), i, np.float32) for i in range(6)]
    seen = []
    for cls in (JR, PR):
        r = cls(["s0"], [(2, 2)], ["float32"])
        r.decorate_tensor_provider(lambda: iter([(b,) for b in batches]))
        r.start()
        r._next(), r._next(), r._next()
        assert r.position == 3
        r.reset()
        r.resume_at(3)
        r.start()
        (nxt,) = r._next()
        seen.append((nxt.copy(), r.position))
    np.testing.assert_array_equal(seen[0][0], seen[1][0])
    assert seen[0][1] == seen[1][1] == 4
    r.resume_at(1)
    assert r.position == 1
    np.testing.assert_array_equal(r._next()[0], batches[1])


def test_reader_errors_match_reference():
    msgs = []
    for fluid in (jfluid, pfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            with pytest.raises(ValueError, match="fully static") as e:
                fluid.layers.py_reader(capacity=2, shapes=[[-1, 3]],
                                       dtypes=["float32"])
            r = fluid.layers.py_reader(capacity=2, shapes=[[2, 3]],
                                       dtypes=["float32"])
        for call in (r.start, r._next):
            with pytest.raises(RuntimeError) as e:
                call()
            msgs.append(str(e.value))
        r.decorate_tensor_provider(lambda: iter([(np.ones((3, 3)),)]))
        r.start()
        with pytest.raises(ValueError) as e:
            r._next()
        msgs.append(str(e.value))
    assert msgs[:3] == msgs[3:]


def test_collected_reader_raises():
    pm, ps, pr, pl = _program(pfluid)
    del pr
    import gc

    gc.collect()
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    exe.run(ps, scope=scope)
    with pytest.raises(RuntimeError, match="garbage-collected"):
        exe.run(pm, fetch_list=[pl], scope=scope)


def test_pyreader_class_matches_reference():
    """``fluid.PyReader`` over a batch generator and a sample generator:
    the same batches as the reference's (the port's on the CPU)."""
    out = []
    for fluid, kw in ((jfluid, {}), (pfluid, {"place": "cpu"})):
        with fluid.program_guard(fluid.Program(), fluid.Program()):
            x = fluid.layers.data("x", shape=[3], dtype="float32")
            y = fluid.layers.data("y", shape=[1], dtype="int64")
        got = []
        r = fluid.PyReader(feed_list=[x, y], capacity=2, **kw)
        r.decorate_batch_generator(lambda: iter(
            [(np.ones((2, 3), np.float32) * i, np.full((2, 1), i, np.int64))
             for i in range(3)]))
        r.start()
        got.extend({k: np.asarray(v) for k, v in b.items()} for b in r)
        r.reset()
        r = fluid.PyReader(feed_list=[x, y], capacity=2, **kw)
        r.decorate_sample_generator(
            lambda: ((np.arange(3, dtype=np.float32) + i, np.int64(i))
                     for i in range(5)), batch_size=2, drop_last=True)
        got.extend({k: np.asarray(v) for k, v in b.items()} for b in r)
        out.append(got)
    assert len(out[0]) == len(out[1]) == 5
    for a, b in zip(*out):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
