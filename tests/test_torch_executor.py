"""The port's executor surface (paddle_tpu_torch/fluid/executor.py,
compiler.py, flags.py, profiler.py) held to the JAX package's on the CPU.

An MLP with Adam (and BERT-tiny for a 10-step window) built by both
packages inside ``unique_name.guard()``; the port starts from the
reference's startup state (``copy_scope``), fed the same numpy arrays.
Tolerances (the ROADMAP parity protocol, fp32): rtol 1e-5 per fetch and
per persistable (atol 1e-6), 1e-4 over a trajectory. Where both
packages report the same thing (hook records, cache hits and misses,
error messages, flags) the port's must equal the reference's.

On the CPU the port runs every step eagerly: its cache holds the op
plan, under the reference's key. Its CUDA graphs are held to its eager
steps on the card (``tests/test_torch_cuda.py``, ``-k graph``).
"""

import threading

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import executor as JE
from paddle_tpu.fluid import flags as jflags
from paddle_tpu.fluid import monitor as jmonitor
from paddle_tpu.fluid import profiler as jprofiler
import paddle_tpu_torch.fluid as pfluid
from paddle_tpu_torch.fluid import executor as PE
from paddle_tpu_torch.fluid import flags as pflags
from paddle_tpu_torch.fluid import monitor as pmonitor
from paddle_tpu_torch.fluid import profiler as pprofiler

RTOL, TRAJ_RTOL, ATOL = 1e-5, 1e-4, 1e-6
B = 5


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = [dict(f._FLAGS) for f in (jflags, pflags)]
    yield
    for f, s in zip((jflags, pflags), saved):
        f._FLAGS.clear()
        f._FLAGS.update(s)


def _mlp(fluid):
    """(main, startup, loss, prediction) of a two-layer gelu MLP with
    Adam on a squared error."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, 8, act="gelu")
        pred = fluid.layers.fc(h, 1)
        d = fluid.layers.elementwise_add(pred, fluid.layers.scale(y, -1.0))
        loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(d, d))
        fluid.optimizer.AdamOptimizer(learning_rate=1e-2).minimize(loss)
    return main, startup, loss, pred


def _persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def _pair():
    """The MLP in both packages, each in a scope holding the reference's
    startup state: (ref, port), each (main, loss, pred, exe, scope)."""
    jm, js, jl, jp = _mlp(jfluid)
    pm, ps, pl, pp = _mlp(pfluid)
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    jexe.run(js, scope=jscope)
    pscope = pfluid.Scope()
    pfluid.copy_scope(jscope, pscope, _persistables(jm), device="cpu")
    return ((jm, jl, jp, jexe, jscope),
            (pm, pl, pp, pfluid.Executor("cpu"), pscope))


def _feeds(n, seed=0, batch=B):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(batch, 4).astype(np.float32),
             "y": rng.randn(batch, 1).astype(np.float32)} for _ in range(n)]


def _stack(feeds):
    return {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}


def _state(main, scope):
    return {n: np.array(scope.find_var(n)) for n in _persistables(main)}


def _close(got, want, rtol=RTOL):
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=rtol, atol=ATOL,
                                   err_msg=n)


# -- iters=k ---------------------------------------------------------------------
def test_mlp_mutation_counter_matches_reference():
    """Program._mutation bumps once per var and op a block adds, as the
    reference's: the two packages' counters agree on the same build."""
    jm, js, _, _ = _mlp(jfluid)
    pm, ps, _, _ = _mlp(pfluid)
    assert (pm._mutation, ps._mutation) == (jm._mutation, js._mutation)
    assert pm._mutation > 0


def test_iters_trajectory_matches_reference_and_single_runs():
    """iters=6 over stacked feeds: the port's trajectory equals the
    reference's iters=6 and the port's 6 single runs; its state after
    the window the reference's."""
    (jm, jl, _, jexe, jscope), (pm, pl, _, pexe, pscope) = _pair()
    feeds = _feeds(6)
    single = pfluid.Scope()
    pfluid.copy_scope(pscope, single, _persistables(pm), device="cpu")
    (want,) = jexe.run(jm, feed=_stack(feeds), fetch_list=[jl], scope=jscope,
                       iters=6)
    (got,) = pexe.run(pm, feed=_stack(feeds), fetch_list=[pl], scope=pscope,
                      iters=6)
    runs = [pexe.run(pm, feed=f, fetch_list=[pl], scope=single)[0]
            for f in feeds]
    assert got.shape == np.asarray(want).shape == (6,)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TRAJ_RTOL)
    np.testing.assert_allclose(got, np.stack(runs), rtol=RTOL)
    _close(_state(pm, pscope), _state(jm, jscope))
    _close(_state(pm, pscope), _state(pm, single))


def test_iters_invariant_feed_matches_reference():
    """A per-step-shaped feed is loop-invariant: y reused every step
    while x is stacked; trajectory and state as the reference's."""
    (jm, jl, _, jexe, jscope), (pm, pl, _, pexe, pscope) = _pair()
    feeds = _feeds(4, seed=3)
    feed = {"x": _stack(feeds)["x"], "y": feeds[0]["y"]}
    (want,) = jexe.run(jm, feed=feed, fetch_list=[jl], scope=jscope, iters=4)
    (got,) = pexe.run(pm, feed=feed, fetch_list=[pl], scope=pscope, iters=4)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TRAJ_RTOL)
    _close(_state(pm, pscope), _state(jm, jscope))


def test_tensor_feeds_match_numpy_feeds_and_reference():
    """Feeds given as torch tensors (a batch already on the place, as
    the reference takes device arrays; float64 cast to the declared
    float32): single runs and an iters=3 window, against the same
    numpy feeds through the reference."""
    (jm, jl, _, jexe, jscope), (pm, pl, _, pexe, pscope) = _pair()
    feeds = _feeds(5, seed=4)
    want = [float(np.asarray(jexe.run(jm, feed=f, fetch_list=[jl],
                                      scope=jscope)[0]).reshape(-1)[0])
            for f in feeds[:2]]
    got = [float(pexe.run(pm, feed={k: torch.from_numpy(v).double()
                                    for k, v in f.items()},
                          fetch_list=[pl], scope=pscope)[0].reshape(-1)[0])
           for f in feeds[:2]]
    np.testing.assert_allclose(got, want, rtol=RTOL)
    stacked = _stack(feeds[2:])
    (want,) = jexe.run(jm, feed=stacked, fetch_list=[jl], scope=jscope,
                       iters=3)
    (got,) = pexe.run(pm, feed={k: torch.from_numpy(v)
                                for k, v in stacked.items()},
                      fetch_list=[pl], scope=pscope, iters=3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TRAJ_RTOL)
    _close(_state(pm, pscope), _state(jm, jscope))


def test_bert_tiny_window_matches_reference():
    """BERT-tiny (fused attention, dropout 0, seq 16): one iters=10
    window of the port against 10 single runs of the reference from one
    state: the loss trajectory within 1e-4."""
    from paddle_tpu.models import bert as JB
    from paddle_tpu_torch.models import bert as PB

    def build(fluid, B_):
        cfg = B_.BertConfig.tiny()
        cfg.use_fused_attention = True
        cfg.hidden_dropout = cfg.attn_dropout = 0.0
        with fluid.unique_name.guard():
            main, startup, loss = B_.build_pretrain_program(cfg, seq_len=16)
        return cfg, main, startup, loss

    cfg, jm, js, jl = build(jfluid, JB)
    _, pm, _, pl = build(pfluid, PB)
    feed = JB.synthetic_batch(cfg, 2, 16, seed=0)
    jexe, jscope, pscope = jfluid.Executor(), jfluid.Scope(), pfluid.Scope()
    jexe.run(js, scope=jscope)
    pfluid.copy_scope(jscope, pscope, _persistables(jm), device="cpu")
    want = [float(np.asarray(jexe.run(jm, feed=feed, fetch_list=[jl],
                                      scope=jscope)[0]).reshape(-1)[0])
            for _ in range(10)]
    stacked = {k: np.stack([v] * 10) for k, v in feed.items()}
    (got,) = pfluid.Executor("cpu").run(pm, feed=stacked, fetch_list=[pl],
                                        scope=pscope, iters=10)
    np.testing.assert_allclose(got.reshape(10, -1)[:, 0], want,
                               rtol=TRAJ_RTOL)


def _static_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        y = fluid.layers.data(name="y", shape=[3, 2], dtype="float32",
                              append_batch_size=False)
        z = fluid.layers.data(name="z", shape=[2], dtype="float32")
        out = fluid.layers.reduce_sum(fluid.layers.elementwise_add(y, z))
    return main, out


@pytest.mark.parametrize("shapes,iters", [
    ({"y": (3, 2), "z": (4, 2)}, 2),      # both per-step: invariant
    ({"y": (2, 3, 2), "z": (2, 4, 2)}, 2),  # both stacked
    ({"y": (3, 3, 2), "z": (3, 2)}, 3),   # z's own leading dim is k
    ({"y": (2, 5, 2), "z": (4, 2)}, 2),   # wrong per-step shape
    ({"y": (7, 2), "z": (4, 2)}, 2),      # neither
])
def test_batched_feed_classification_matches_reference(shapes, iters):
    """_split_batched_feed: the same stacked / invariant split as the
    reference's, or the same ValueError message."""
    jm, _ = _static_program(jfluid)
    pm, _ = _static_program(pfluid)
    feed = {n: np.zeros(s, np.float32) for n, s in shapes.items()}
    try:
        want = JE._split_batched_feed(feed, jm.global_block(), iters)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            PE._split_batched_feed(feed, pm.global_block(), iters)
        assert str(got.value) == str(e)
        return
    got = PE._split_batched_feed(feed, pm.global_block(), iters)
    assert [sorted(d) for d in got] == [sorted(d) for d in want]


@pytest.mark.parametrize("feed,iters", [
    ({"y": np.zeros((2, 5, 2), np.float32),
      "z": np.zeros((4, 2), np.float32)}, 2),
    ({"y": np.zeros((7, 2), np.float32),
      "z": np.zeros((4, 2), np.float32)}, 2),
    ({"y": np.zeros((3, 2), np.float32),
      "z": np.zeros((4, 2), np.float32)}, 0),
])
def test_run_validation_errors_match_reference(feed, iters):
    """Executor.run's refusals of a bad stack and of iters < 1: the same
    ValueError messages as the reference's."""
    jm, jo = _static_program(jfluid)
    pm, po = _static_program(pfluid)
    with pytest.raises(ValueError) as want:
        jfluid.Executor().run(jm, feed=feed, fetch_list=[jo], iters=iters,
                              scope=jfluid.Scope())
    with pytest.raises(ValueError) as got:
        pfluid.Executor("cpu").run(pm, feed=feed, fetch_list=[po],
                                   iters=iters, scope=pfluid.Scope())
    assert str(got.value) == str(want.value)


def test_iters_refuses_a_program_that_creates_state():
    """A startup program under iters=2 is refused with the reference's
    remedy."""
    jm, js, _, _ = _mlp(jfluid)
    pm, ps, _, _ = _mlp(pfluid)
    with pytest.raises(RuntimeError, match="loop-invariant state"):
        jfluid.Executor().run(js, iters=2, scope=jfluid.Scope())
    with pytest.raises(RuntimeError, match="loop-invariant state"):
        pfluid.Executor("cpu").run(ps, iters=2, scope=pfluid.Scope())


# -- the cache ------------------------------------------------------------------
def _cache_sequence(fluid, monitor):
    """The (hit, miss) deltas of one run sequence: startup, a repeat, a
    new batch size, a new fetch list, a window twice, a second scope, and
    the program edited between runs; and the cache's size after it."""
    main, startup, loss, pred = _mlp(fluid)
    hits = monitor.counter("executor_compile_cache_hit_total")
    misses = monitor.counter("executor_compile_cache_miss_total")
    exe = fluid.Executor() if fluid is jfluid else fluid.Executor("cpu")
    scope, other = fluid.Scope(), fluid.Scope()
    f3 = _feeds(3)
    window = _stack(f3[:2])
    runs = [
        lambda: exe.run(startup, scope=scope),
        lambda: exe.run(main, feed=f3[0], fetch_list=[loss], scope=scope),
        lambda: exe.run(main, feed=f3[1], fetch_list=[loss], scope=scope),
        lambda: exe.run(main, feed=_feeds(1, batch=3)[0],
                        fetch_list=[loss], scope=scope),
        lambda: exe.run(main, feed=f3[2], fetch_list=[loss, pred],
                        scope=scope),
        lambda: exe.run(main, feed=window, fetch_list=[loss], scope=scope,
                        iters=2),
        lambda: exe.run(main, feed=window, fetch_list=[loss], scope=scope,
                        iters=2),
        lambda: exe.run(startup, scope=other),
        lambda: exe.run(main, feed=f3[0], fetch_list=[loss], scope=other),
    ]
    out = []
    for run in runs:
        h0, m0 = hits.value, misses.value
        run()
        out.append((hits.value - h0, misses.value - m0))
    with fluid.program_guard(main):
        fluid.layers.scale(loss, 2.0)           # an edit: one op, one var
    h0, m0 = hits.value, misses.value
    exe.run(main, feed=f3[0], fetch_list=[loss], scope=scope)
    out.append((hits.value - h0, misses.value - m0))
    return out, len(exe._cache)


def test_cache_hits_and_misses_match_reference():
    want = _cache_sequence(jfluid, jmonitor)
    got = _cache_sequence(pfluid, pmonitor)
    assert got == want
    assert want[0][-1] == (0, 1) and want[0][2] == (1, 0)


def test_runs_outside_the_step_share_one_compiled_step():
    """iters=k, a CompiledProgram and the skip_step policy are separate
    keys of the reference's cache (each a miss), but what they change
    runs outside the step, so they share one compiled step (one graph on
    the card); a new batch size is another step."""
    (_, _, _, _, _), (pm, pl, _, pexe, pscope) = _pair()
    f = _feeds(3)
    pexe.run(pm, feed=f[0], fetch_list=[pl], scope=pscope)
    pexe.run(pm, feed=_stack(f[:2]), fetch_list=[pl], scope=pscope, iters=2)
    pexe.run(pfluid.CompiledProgram(pm), feed=f[1], fetch_list=[pl],
             scope=pscope)
    pfluid.set_flags({"FLAGS_anomaly_policy": "skip_step"})
    pexe.run(pm, feed=f[2], fetch_list=[pl], scope=pscope)
    assert (len(pexe._cache), len(pexe._steps)) == (4, 1)
    pexe.run(pm, feed=_feeds(1, batch=3)[0], fetch_list=[pl], scope=pscope)
    assert (len(pexe._cache), len(pexe._steps)) == (5, 2)


def test_embedding_backward_restores_the_flag_across_threads():
    """lookup_table's backward sets torch's process-wide deterministic
    flag for its own call: backwards on four threads at once leave the
    flag as it was, off and then on."""
    from paddle_tpu_torch.fluid.ops.tensor_ops import _Embedding

    def backwards():
        rng = np.random.RandomState(0)
        w = torch.tensor(rng.randn(16, 8), dtype=torch.float32,
                         requires_grad=True)
        ids = torch.tensor(rng.randint(0, 16, (4, 32)))
        for _ in range(200):
            _Embedding.apply(w, ids).sum().backward()

    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    try:
        for flag in (False, True):
            torch.use_deterministic_algorithms(flag)
            threads = [threading.Thread(target=backwards) for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert (torch.are_deterministic_algorithms_enabled(),
                    torch.is_deterministic_algorithms_warn_only_enabled()
                    ) == (flag, False)
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])


# -- fetch_mode="async" ----------------------------------------------------------
def test_async_handles_equal_sync_and_reference():
    (jm, jl, _, jexe, jscope), (pm, pl, _, pexe, pscope) = _pair()
    sync_scope = pfluid.Scope()
    pfluid.copy_scope(pscope, sync_scope, _persistables(pm), device="cpu")
    feeds = _feeds(3, seed=5)
    want = [jexe.run(jm, feed=f, fetch_list=[jl], scope=jscope,
                     fetch_mode="async")[0].numpy() for f in feeds]
    handles = [pexe.run(pm, feed=f, fetch_list=[pl], scope=pscope,
                        fetch_mode="async")[0] for f in feeds]
    sync = [pexe.run(pm, feed=f, fetch_list=[pl], scope=sync_scope)[0]
            for f in feeds]
    for h, s, w in zip(handles, sync, want):
        assert isinstance(h, pfluid.FetchHandle)
        np.testing.assert_array_equal(h.numpy(), s)
        np.testing.assert_allclose(h.numpy(), w, rtol=RTOL)
    (traj,) = pexe.run(pm, feed=_stack(feeds), fetch_list=[pl],
                       scope=sync_scope, iters=3, fetch_mode="async")
    assert traj.shape == (3,)


def test_fetch_handle_api_and_sync_gating():
    """shape, dtype, repr and block_until_ready never sync; numpy,
    indexing, __array__ and __float__ do, each observed in
    executor_fetch_sync_seconds (after the reference's test)."""
    _, (pm, pl, _, pexe, pscope) = _pair()
    hist = pmonitor.histogram("executor_fetch_sync_seconds")
    (h,) = pexe.run(pm, feed=_feeds(1)[0], fetch_list=[pl], scope=pscope,
                    fetch_mode="async")
    c0 = hist.count
    assert h.shape == () and h.dtype == torch.float32
    assert "FetchHandle" in repr(h) and h.name == pl.name
    assert h.block_until_ready() is h
    assert hist.count == c0
    v = h.numpy()
    assert hist.count == c0 + 1 and np.isfinite(v).all()
    np.testing.assert_array_equal(np.asarray(h), v)
    assert float(h) == float(v.ravel()[0])
    assert hist.count >= c0 + 3


# -- run hooks -------------------------------------------------------------------
def _hook_records(fluid):
    main, startup, loss, _ = _mlp(fluid)
    exe = fluid.Executor() if fluid is jfluid else fluid.Executor("cpu")
    scope, records = fluid.Scope(), []
    f = _feeds(3)
    fluid.register_run_hook(records.append)
    try:
        exe.run(startup, scope=scope)
        exe.run(main, feed=f[0], fetch_list=[loss], scope=scope)
        exe.run(main, feed=f[1], fetch_list=[loss], scope=scope,
                fetch_mode="async")
        exe.run(main, feed=_stack(f), fetch_list=[loss], scope=scope,
                iters=3)
        exe.run(main, feed=_stack(f), fetch_list=[loss], scope=scope,
                iters=3, fetch_mode="async")
    finally:
        fluid.unregister_run_hook(records.append)
    fluid.unregister_run_hook(records.append)   # absent: a no-op
    return [(sorted(r), r["cache_hit"], r.get("iters"), r.get("async"),
             r["profiler_enabled"], r["fetch_names"]) for r in records]


def test_run_hook_records_match_reference():
    """One record a run, with the reference's keys and values for sync,
    async and iters runs (wall_time apart)."""
    got, want = _hook_records(pfluid), _hook_records(jfluid)
    assert got == want
    assert len(got) == 5 and got[3][2] == 3 and got[2][3] is True


def test_run_hook_errors_are_swallowed():
    main, startup, loss, _ = _mlp(pfluid)

    def bad(record):
        raise RuntimeError("hook failure")

    pfluid.register_run_hook(bad)
    try:
        pfluid.Executor("cpu").run(startup, scope=pfluid.Scope())
    finally:
        pfluid.unregister_run_hook(bad)


# -- the anomaly policy ------------------------------------------------------------
def _nan_feed():
    f = _feeds(1)[0]
    f["x"] = np.full_like(f["x"], np.nan)
    return f


def test_check_nan_inf_names_the_var_as_reference():
    (jm, jl, _, jexe, jscope), (pm, pl, _, pexe, pscope) = _pair()
    jflags.set_flags({"FLAGS_check_nan_inf": True})
    pfluid.set_flags({"FLAGS_check_nan_inf": True})
    with pytest.raises(FloatingPointError, match="check_nan_inf") as want:
        jexe.run(jm, feed=_nan_feed(), fetch_list=[jl], scope=jscope)
    with pytest.raises(FloatingPointError) as got:
        pexe.run(pm, feed=_nan_feed(), fetch_list=[pl], scope=pscope)
    assert str(got.value) == str(want.value)
    assert repr(pl.name) in str(got.value)
    # clean values pass (from a fresh copy: adam updated pscope in place)
    _, (pm, pl, _, pexe, pscope) = _pair()
    assert np.isfinite(pexe.run(pm, feed=_feeds(1)[0], fetch_list=[pl],
                                scope=pscope)[0]).all()


@pytest.mark.parametrize("iters", [1, 2])
def test_skip_step_keeps_every_persistable_and_budget_raises(iters):
    """skip_step: a non-finite step (or window) leaves every persistable
    bit-equal, a clean one trains and resets the count, and past
    FLAGS_anomaly_skip_budget consecutive skips it raises the
    reference's message."""
    (jm, jl, _, jexe, jscope), (pm, pl, _, pexe, pscope) = _pair()
    for f in (jflags, pflags):
        f.set_flags({"FLAGS_anomaly_policy": "skip_step",
                     "FLAGS_anomaly_skip_budget": 2})

    def feed(bad):
        f = _nan_feed() if bad else _feeds(1)[0]
        return f if iters == 1 else {k: np.stack([v] * iters)
                                     for k, v in f.items()}

    before = {n: t.clone() for n, t in pscope.vars.items()}
    skipped = pmonitor.counter("executor_anomaly_skipped_steps_total")
    s0 = skipped.value
    pexe.run(pm, feed=feed(True), fetch_list=[pl], scope=pscope, iters=iters)
    assert skipped.value - s0 == iters
    assert sorted(pscope.vars) == sorted(before)
    for n, t in before.items():
        assert torch.equal(pscope.find_var(n), t), n
    pexe.run(pm, feed=feed(False), fetch_list=[pl], scope=pscope,
             iters=iters)
    jexe.run(jm, feed=feed(False), fetch_list=[jl], scope=jscope,
             iters=iters)
    _close(_state(pm, pscope), _state(jm, jscope))
    msgs = []
    for exe, main, loss, scope in ((jexe, jm, jl, jscope),
                                   (pexe, pm, pl, pscope)):
        for _ in range(2):
            exe.run(main, feed=feed(True), fetch_list=[loss], scope=scope,
                    iters=iters)
        with pytest.raises(FloatingPointError, match="skip_budget") as e:
            exe.run(main, feed=feed(True), fetch_list=[loss], scope=scope,
                    iters=iters)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    _close(_state(pm, pscope), _state(jm, jscope))


def _reader_mlp(fluid):
    """(main, startup, loss, reader) of the MLP fed by a py_reader over
    four batches of ``_feeds``."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        reader = fluid.layers.py_reader(capacity=2, shapes=[[B, 4], [B, 1]],
                                        dtypes=["float32", "float32"])
        x, y = fluid.layers.read_file(reader)
        h = fluid.layers.fc(x, 8, act="gelu")
        d = fluid.layers.elementwise_add(fluid.layers.fc(h, 1),
                                         fluid.layers.scale(y, -1.0))
        loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(d, d))
        fluid.optimizer.AdamOptimizer(learning_rate=1e-2).minimize(loss)
    batches = [(f["x"], f["y"]) for f in _feeds(4)]
    reader.decorate_tensor_provider(lambda: iter(batches))
    return main, startup, loss, reader


# The options earlier slices refused, each now held to the reference:
# ``rollback`` without ``checkpoint=`` raises the reference's error on a
# non-finite step; a malformed ``checkpoint=`` raises as the reference's
# does; ``prefetch=True`` on a py_reader program runs, its windows equal
# to the reference's inline ones.
@pytest.mark.parametrize("kwargs,flag", [
    ({}, "rollback"),
    ({"checkpoint": (object(), 1)}, None),
    ({"iters": 2, "prefetch": True}, None),
])
def test_unported_options_raise_naming_their_queue(kwargs, flag):
    if kwargs.get("prefetch"):
        (jm, js, jl, jr), (pm, ps, pl, pr) = _reader_mlp(jfluid), \
            _reader_mlp(pfluid)
        jexe, jscope, pscope = jfluid.Executor(), jfluid.Scope(), \
            pfluid.Scope()
        jexe.run(js, scope=jscope)
        pfluid.copy_scope(jscope, pscope, _persistables(jm), device="cpu")
        pexe = pfluid.Executor("cpu")
        jr.start()
        pr.start()
        for _ in range(2):
            (want,) = jexe.run(jm, fetch_list=[jl], scope=jscope, iters=2)
            (got,) = pexe.run(pm, fetch_list=[pl], scope=pscope, **kwargs)
            np.testing.assert_allclose(got, np.asarray(want), rtol=TRAJ_RTOL)
        pexe.close()
        _close(_state(pm, pscope), _state(jm, jscope))
        return
    msgs = []
    for fluid, exe, feed in ((jfluid, jfluid.Executor(), _nan_feed()),
                             (pfluid, pfluid.Executor("cpu"), _nan_feed())):
        main, startup, loss, _ = _mlp(fluid)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        if flag:
            fluid.set_flags({"FLAGS_anomaly_policy": flag})
        with pytest.raises((RuntimeError, ValueError)) as e:
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                    **kwargs)
        msgs.append((type(e.value), str(e.value)))
    assert msgs[0] == msgs[1]
    assert ("rollback" if flag else "checkpoint") in msgs[1][1]


def test_fetch_mode_and_prefetch_validation_match_reference():
    for fluid, exe in ((jfluid, jfluid.Executor()),
                       (pfluid, pfluid.Executor("cpu"))):
        with pytest.raises(ValueError, match="fetch_mode"):
            exe.run(fluid.Program(), fetch_mode="banana")
        with pytest.raises(ValueError, match="prefetch=True needs iters"):
            exe.run(fluid.Program(), prefetch=True)


# -- flags ------------------------------------------------------------------------
def test_flags_match_reference():
    for f in (jflags, pflags):
        f.set_flags({"FLAGS_check_nan_inf": True,
                     "FLAGS_anomaly_skip_budget": 5})
    names = ["FLAGS_check_nan_inf", "FLAGS_anomaly_policy",
             "FLAGS_anomaly_skip_budget", "FLAGS_eager_delete_tensor_gb"]
    assert pfluid.get_flags(names) == jfluid.get_flags(names)
    assert pfluid.get_flags("FLAGS_check_nan_inf") == {
        "FLAGS_check_nan_inf": True}
    msgs = []
    for f in (jflags, pflags):
        f.set_flags({"FLAGS_anomaly_policy": "explode"})
        with pytest.raises(ValueError, match="anomaly_policy") as e:
            f.anomaly_policy()
        msgs.append(str(e.value))
        f.set_flags({"FLAGS_anomaly_skip_budget": -1})
        with pytest.raises(ValueError, match="skip_budget"):
            f.anomaly_skip_budget()
    assert msgs[0] == msgs[1]


# -- CompiledProgram ------------------------------------------------------------
def test_compiled_program_on_one_device_equals_its_program():
    """CompiledProgram(main).with_data_parallel on one place runs as
    main: the same losses as main from a copy of the state, and the
    reference's; it keys the cache apart from main."""
    (jm, jl, _, jexe, jscope), (pm, pl, _, pexe, pscope) = _pair()
    plain = pfluid.Scope()
    pfluid.copy_scope(pscope, plain, _persistables(pm), device="cpu")
    compiled = pfluid.CompiledProgram(pm).with_data_parallel(
        loss_name=pl.name)
    feeds = _feeds(3, seed=9)
    n0 = len(pexe._cache)
    got = [pexe.run(compiled, feed=f, fetch_list=[pl], scope=pscope)[0]
           for f in feeds]
    assert len(pexe._cache) == n0 + 1
    same = [pexe.run(pm, feed=f, fetch_list=[pl], scope=plain)[0]
            for f in feeds]
    assert len(pexe._cache) == n0 + 2
    want = [jexe.run(jm, feed=f, fetch_list=[jl], scope=jscope)[0]
            for f in feeds]
    np.testing.assert_array_equal(np.stack(got), np.stack(same))
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=RTOL)


@pytest.mark.parametrize("call", [
    lambda c: c.with_data_parallel(places=[0, 1]),
    lambda c: c.with_data_parallel(places=4),
    lambda c: c.with_data_parallel(mesh_axes=("dp", "tp"),
                                   mesh_shape={"dp": 1, "tp": 2}),
    lambda c: c.with_pipeline(num_microbatches=2),
    lambda c: c.with_explicit_collectives(),
])
def test_compiled_program_past_one_device_raises(call):
    pm, _, _, _ = _mlp(pfluid)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 7"):
        call(pfluid.CompiledProgram(pm))


# -- the profiler -------------------------------------------------------------------
def test_profiler_summary_names_executor_run_as_reference():
    """While the profiler is on, each run records
    executor_run[<fetches>#p<uid>] (and executor_batched_run[...;k=...]
    for a window), as the reference's does."""
    reports = []
    for fluid, prof, exe in ((jfluid, jprofiler, jfluid.Executor()),
                             (pfluid, pprofiler, pfluid.Executor("cpu"))):
        main, startup, loss, _ = _mlp(fluid)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        with prof.profiler(sorted_key="total"):
            for f in _feeds(2):
                exe.run(main, feed=f, fetch_list=[loss], scope=scope)
            exe.run(main, feed=_stack(_feeds(2)), fetch_list=[loss],
                    scope=scope, iters=2)
            with prof.RecordEvent("outside"):
                pass
        report = prof.summary()
        assert "executor_run[%s#p%d]" % (loss.name, main._uid) in report
        assert "executor_batched_run[%s#p%d;k=2]" % (
            loss.name, main._uid) in prof._events
        reports.append({name.replace("#p%d" % main._uid, ""): e[0]
                        for name, e in prof._events.items()})
    assert reports[0] == reports[1]
    assert not pprofiler.is_profiler_enabled()


# -- the card's fault check ---------------------------------------------------------
@pytest.mark.parametrize("name", ["no_write_back", "generator_unregistered",
                                  "handle_aliases_output",
                                  "key_without_scope",
                                  "plain_route_replays"])
def test_graph_faults_still_plant(name, tmp_path):
    """Each fault of tools/graph_fault_check.py still finds its text in
    the current sources, once, and its planted copy still compiles."""
    import importlib.util
    import os
    import shutil

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "graph_fault_check", os.path.join(root, "tools",
                                          "graph_fault_check.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for rel, _, _, _ in tool.FAULTS[name]:
        os.makedirs(os.path.dirname(str(tmp_path / rel)) or str(tmp_path),
                    exist_ok=True)
        shutil.copy(os.path.join(root, rel), str(tmp_path / rel))
    tool.plant(str(tmp_path), name)
    for rel, _, new, _ in tool.FAULTS[name]:
        with open(str(tmp_path / rel)) as f:
            text = f.read()
        assert new in text
        compile(text, rel, "exec")
