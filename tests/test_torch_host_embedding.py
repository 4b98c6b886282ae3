"""The port's host embedding tier (paddle_tpu_torch/embedding/host.py,
its executor hooks, ``host_embedding_lookup``/``host_embedding_init``,
``layers.embedding(residence=...)``), held to the JAX package on the CPU.

Every check feeds the same numpy inputs through both packages; the
tables start from the same rows (both draw them from
``np.random.RandomState(seed)``), programs are built inside
``unique_name.guard()`` and the port starts from the reference's startup
state (``fluid.copy_scope``). Tolerances: residency (slots, LUT,
evictions, counters) equal; fp32 losses, trajectories and flushed host
stores within rtol 1e-6.
"""

import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import embedding as JE
from paddle_tpu.fluid import monitor as JM
from paddle_tpu.models import deepfm as JD
import paddle_tpu_torch as PT
import paddle_tpu_torch.fluid as pfluid
from paddle_tpu_torch import embedding as PE
from paddle_tpu_torch.fluid import monitor as PM
from paddle_tpu_torch.models import deepfm as PD

RTOL = 1e-6
BUDGET = 64


@pytest.fixture(autouse=True)
def _clean_tables():
    JE.reset_tables()
    PE.reset_tables()
    yield
    JE.reset_tables()
    PE.reset_tables()


def _tiny(M):
    # the vocabulary is 10x the budget
    return M.DeepFMConfig(sparse_feature_dim=640, num_fields=4,
                          num_dense=3, embedding_size=4, fc_sizes=(16,))


def _feeds(n, batch=16, seed=0):
    return [JD.synthetic_batch(_tiny(JD), batch, seed=seed + i)
            for i in range(n)]


def _loss(out):
    return float(np.asarray(out[0]).reshape(-1)[0])


def _series(M, name, table):
    kind = {"embedding_lookup_seconds": M.histogram,
            "embedding_unique_ratio": M.gauge,
            "embedding_resident_rows": M.gauge}.get(name, M.counter)
    m = kind(name, labels={"table": table})
    return m.count if kind is M.histogram else m.value


SERIES = ("embedding_lookup_seconds", "embedding_unique_ratio",
          "embedding_prefetch_hit_total", "embedding_prefetch_miss_total",
          "embedding_evictions_total", "embedding_resident_rows")


# -- the table alone -------------------------------------------------------------

def _cache_scope(pkg, table):
    """A scope holding ``<table>@CACHE`` (zeros, budget + 1 rows)."""
    if pkg == "ref":
        import jax.numpy as jnp

        sc = jfluid.Scope()
        sc.set_var(table.name + "@CACHE",
                   jnp.zeros((table.budget + 1, table.dim), jnp.float32))
        return sc
    sc = pfluid.Scope()
    sc.set_var(table.name + "@CACHE",
               torch.zeros(table.budget + 1, table.dim))
    return sc


def _tables(name, *args, **kw):
    return (JE.HostEmbeddingTable(name, *args, register=False, **kw),
            PE.HostEmbeddingTable(name, *args, register=False, **kw))


def test_host_table_validation_matches_reference():
    for E in (JE, PE):
        with pytest.raises(ValueError, match="num_rows and dim"):
            E.HostEmbeddingTable("t0", 0, 4, resident_budget=2,
                                 register=False)
        with pytest.raises(ValueError, match="resident_budget"):
            E.HostEmbeddingTable("t0", 8, 4, resident_budget=0,
                                 register=False)
        with pytest.raises(ValueError, match="ttl_steps"):
            E.HostEmbeddingTable("t0", 8, 4, resident_budget=2,
                                 ttl_steps=0, register=False)
        t = E.HostEmbeddingTable("t0", 8, 4, resident_budget=2)
        with pytest.raises(ValueError, match="already registered"):
            E.HostEmbeddingTable("t0", 8, 4, resident_budget=2)
        with pytest.raises(ValueError, match="load expects shape"):
            t.load(np.zeros((3, 4), np.float32))
        with pytest.raises(ValueError, match="cannot shrink"):
            t.grow(4)
        with pytest.raises(KeyError, match="no host embedding table"):
            E.get_host_table("nope")
    assert PE.has_host_table("t0") and PE.get_host_table("t0").dim == 4


@pytest.mark.parametrize("seed,rows,dim", [(0, 12, 2), (3, 640, 4),
                                           (7, 33, 10)])
def test_initial_rows_and_growth_equal_reference(seed, rows, dim):
    jt, pt = _tables("init_t", rows, dim, resident_budget=4, seed=seed)
    np.testing.assert_array_equal(pt._values, jt._values)
    jt.grow(2 * rows)
    pt.grow(2 * rows)
    np.testing.assert_array_equal(pt._values, jt._values)
    assert pt.num_rows == jt.num_rows == 2 * rows


def _run_sequence(pkg, table, batches, marks=()):
    """prepare() each batch of ids against a zero cache (the port's
    cache a torch tensor, the reference's a jax array); after batch i
    in ``marks``, rows of that batch are set to 7.0 on the device, as an
    update would. Returns (slots per batch, flushed store, cache)."""
    sc = _cache_scope(pkg, table)
    cache = table.name + "@CACHE"
    out = []
    for i, ids in enumerate(batches):
        s = table.prepare(np.asarray(ids), sc, cache, {})
        out.append(s)
        if i in marks:
            if pkg == "ref":
                sc.set_var(cache, sc.find_var(cache).at[
                    s.reshape(-1)].set(7.0))
            else:
                sc.find_var(cache)[torch.from_numpy(
                    s.reshape(-1).astype(np.int64))] = 7.0
    return out, table.snapshot(), np.asarray(sc.find_var(cache))


@pytest.mark.parametrize("case", ["lru", "ttl", "repeat", "window"])
def test_residency_matches_reference(case):
    """LRU with write-back, TTL expiry, repeated ids and an iters-sized
    window: the slots each batch gets, the flushed host store, the cache
    and the evictions counted equal the reference's."""
    kw, marks = {}, ()
    if case == "lru":
        args, batches, marks = (12, 2, 4), [[0, 1], [2, 3], [2, 3], [4, 5],
                                            [0], [1, 6, 7]], (0,)
    elif case == "ttl":
        args, kw = (16, 2, 8), {"ttl_steps": 2}
        batches = [[0, 1], [2], [2], [2], [3, 4, 5], [0]]
    elif case == "repeat":
        args = (40, 3, 8)
        batches = [[[1, 1, 2], [2, 9, 1]], [[9, 9, 9], [30, 1, 2]],
                   [[5, 6, 7], [8, 10, 11]], [[1, 2, 3], [4, 5, 5]]]
        marks = (1,)
    else:
        args = (64, 2, 16)
        rng = np.random.RandomState(0)
        batches = [rng.randint(0, 64, (2, 3, 2)) for _ in range(6)]
        marks = (2,)
    name = "res_" + case
    got = {}
    for pkg, t in zip(("ref", "port"), _tables(name, *args, seed=1, **kw)):
        mon = JM if pkg == "ref" else PM
        before = _series(mon, "embedding_evictions_total", name)
        got[pkg] = _run_sequence(pkg, t, batches, marks) + (
            _series(mon, "embedding_evictions_total", name) - before,
            t.resident_count, t._lut.copy())
    (rs, rstore, rcache, rev, rres, rlut), \
        (ps, pstore, pcache, pev, pres, plut) = got["ref"], got["port"]
    for a, b in zip(rs, ps):
        np.testing.assert_array_equal(b, a)
        assert b.dtype == np.int32
    np.testing.assert_array_equal(pstore, rstore)
    np.testing.assert_array_equal(pcache[:-1], rcache[:-1])
    np.testing.assert_array_equal(plut, rlut)
    assert (pev, pres) == (rev, rres)
    if case in ("lru", "ttl"):
        assert pev > 0


def test_lru_eviction_writes_back_and_readmits():
    """The reference's own LRU case on the port: rows 0/1 updated on
    the device are the LRU victims, their values come back on
    re-admission."""
    t = PE.HostEmbeddingTable("lru_t", 12, 2, resident_budget=4,
                              register=False)
    sc = _cache_scope("port", t)
    cache = "lru_t@CACHE"
    s01 = t.prepare(np.array([0, 1]), sc, cache, {})
    t.prepare(np.array([2, 3]), sc, cache, {})
    assert t.resident_count == 4
    ptr = sc.find_var(cache).data_ptr()
    sc.find_var(cache)[torch.from_numpy(s01.astype(np.int64))] = 7.0
    t.prepare(np.array([2, 3]), sc, cache, {})
    before = _series(PM, "embedding_evictions_total", "lru_t")
    t.prepare(np.array([4, 5]), sc, cache, {})
    assert _series(PM, "embedding_evictions_total", "lru_t") - before == 2
    np.testing.assert_array_equal(t._values[[0, 1]],
                                  np.full((2, 2), 7.0, np.float32))
    s0 = t.prepare(np.array([0]), sc, cache, {})
    np.testing.assert_array_equal(
        sc.find_var(cache)[int(s0[0])].numpy(), np.full(2, 7.0, np.float32))
    # admission wrote in place: the scope holds the same tensor
    assert sc.find_var(cache).data_ptr() == ptr


@pytest.mark.parametrize("case", ["budget", "too_high", "negative",
                                  "empty"])
def test_prepare_errors_match_reference(case):
    ids, budget = {"budget": ([0, 1, 2, 3], 3), "too_high": ([0, 10], 4),
                   "negative": ([-1], 4), "empty": ([], 4)}[case]
    exc, match = {"budget": (RuntimeError, "cannot hold one batch"),
                  "too_high": (IndexError, "id 10 out of range .* 10 rows"),
                  "negative": (IndexError, "out of range"),
                  "empty": (ValueError, "empty ids batch")}[case]
    for pkg, t in zip(("ref", "port"), _tables("err_t", 10, 2,
                                                resident_budget=budget)):
        with pytest.raises(exc, match=match):
            t.prepare(np.array(ids, np.int64), _cache_scope(pkg, t),
                      "err_t@CACHE", {})


def test_prefetch_counters_and_series_match_reference():
    """Cold misses, a prefetched batch (all hits), a stale prefetch
    (misses), with slot stores: every monitor series moves as the
    reference's, and the cache's rows agree."""
    seq = [("prepare", [0, 1]), ("prefetch", [5, 6, 7]),
           ("prepare", [5, 6, 7]), ("prefetch", [8, 9]),
           ("prepare", [10, 11]), ("prefetch", [1, 12, 13]),
           ("prepare", [1, 12, 13, 14])]
    got = {}
    for pkg, t in zip(("ref", "port"), _tables("pf_t", 64, 2,
                                                resident_budget=8)):
        mon = JM if pkg == "ref" else PM
        before = {s: _series(mon, s, "pf_t") for s in SERIES}
        sc = _cache_scope(pkg, t)
        if pkg == "ref":
            import jax.numpy as jnp

            sc.set_var("m1", jnp.zeros((9, 2), jnp.float32))
        else:
            sc.set_var("m1", torch.zeros(9, 2))
        slots = []
        for what, ids in seq:
            if what == "prefetch":
                t.prefetch(np.array(ids))
            else:
                slots.append(t.prepare(np.array(ids), sc, "pf_t@CACHE",
                                       {"m1": "adam:Moment1"}))
        t.close()
        after = {s: _series(mon, s, "pf_t") for s in SERIES}
        got[pkg] = ({s: after[s] - before[s] if s.endswith(
            ("_total", "_seconds")) else after[s] for s in SERIES},
            slots, np.asarray(sc.find_var("pf_t@CACHE")))
    assert got["port"][0] == got["ref"][0]
    # 3 hits, then 2 of a prefetch that missed one row (counted per row)
    assert got["port"][0]["embedding_prefetch_hit_total"] == 5
    for a, b in zip(got["ref"][1], got["port"][1]):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(got["port"][2][:-1], got["ref"][2][:-1])


def test_prefetch_error_surfaces_at_consume_and_close_is_idempotent(
        monkeypatch):
    t = PE.HostEmbeddingTable("pe_t", 32, 2, resident_budget=8)
    sc = _cache_scope("port", t)

    def boom(sources, device):
        raise RuntimeError("staging failed")

    monkeypatch.setattr(PE.HostEmbeddingTable, "_copy_rows",
                        staticmethod(boom))
    t.prepare(np.array([0]), sc, "pe_t@CACHE", {})
    t.prefetch(np.array([1, 2]))
    with pytest.raises(RuntimeError, match="staging failed"):
        t.prepare(np.array([1, 2]), sc, "pe_t@CACHE", {})
    t.close()
    t.close()
    assert t._prefetch_thread is None


# -- through Executor.run --------------------------------------------------------

def _reference_host(cfg_feeds, budget=BUDGET, seed=3, iters=None,
                    prefetch=False):
    """The reference's DeepFM-tiny with fm_emb on a host table: (losses,
    table, startup scope values, initial table)."""
    table = JE.HostEmbeddingTable("fm_emb", 640, 4, resident_budget=budget,
                                  seed=seed)
    init = table.snapshot().copy()
    with jfluid.unique_name.guard():
        main, startup, loss, _ = JD.build_train_program(_tiny(JD),
                                                        residence="host")
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(startup, scope=scope)
    names = [v.name for v in main.list_vars() if v.persistable]
    state = {n: np.array(scope.find_var(n)) for n in names
             if scope.find_var(n) is not None}
    losses = []
    for i, feed in enumerate(cfg_feeds):
        out = exe.run(main, feed=dict(feed), fetch_list=[loss.name],
                      scope=scope, **({"iters": iters} if iters else {}))
        losses.extend(np.asarray(out[0]).reshape(-1).tolist())
        if prefetch and i + 1 < len(cfg_feeds):
            JE.prefetch(main, cfg_feeds[i + 1])
    return losses, table, state, init, scope


def _port_host(state, cfg_feeds, budget=BUDGET, seed=3, iters=None,
               prefetch=False, exe=None):
    table = PE.HostEmbeddingTable("fm_emb", 640, 4, resident_budget=budget,
                                  seed=seed)
    with pfluid.unique_name.guard():
        main, startup, loss, _ = PD.build_train_program(_tiny(PD),
                                                        residence="host")
    exe = exe or pfluid.Executor("cpu")
    scope = pfluid.Scope()
    exe.run(startup, scope=scope)
    for n, a in state.items():
        scope.set_var(n, torch.from_numpy(a.copy()))
    losses = []
    for i, feed in enumerate(cfg_feeds):
        out = exe.run(main, feed=dict(feed), fetch_list=[loss.name],
                      scope=scope, **({"iters": iters} if iters else {}))
        losses.extend(np.asarray(out[0]).reshape(-1).tolist())
        if prefetch and i + 1 < len(cfg_feeds):
            PE.prefetch(main, cfg_feeds[i + 1])
    return losses, table, scope, main


@pytest.mark.parametrize("prefetch", [False, True],
                         ids=["no_prefetch", "prefetch"])
def test_deepfm_host_tier_matches_reference(prefetch):
    """DeepFM-tiny with fm_emb 10x the budget, 5 steps with evictions:
    losses and the flushed host store (values and both Adam moments)
    against the reference's host tier, the device state too."""
    feeds = _feeds(5)
    rl, rt, state, _, rscope = _reference_host(feeds, prefetch=prefetch)
    pl, pt, pscope, main = _port_host(state, feeds, prefetch=prefetch)
    np.testing.assert_allclose(pl, rl, rtol=RTOL)
    assert _series(PM, "embedding_evictions_total", "fm_emb") > 0
    np.testing.assert_allclose(pt.snapshot(), rt.snapshot(), rtol=RTOL,
                               atol=1e-7)
    for key in ("adam:Moment1", "adam:Moment2"):
        np.testing.assert_allclose(pt.slot_snapshot(key),
                                   rt.slot_snapshot(key), rtol=RTOL,
                                   atol=1e-9)
    for n in ("fm_w1", "deep_fc0.w_0", "fm_emb@CACHE_beta1_pow_acc_0"):
        np.testing.assert_allclose(pscope.find_var(n).numpy(),
                                   np.asarray(rscope.find_var(n)),
                                   rtol=RTOL, atol=1e-7)
    if prefetch:
        assert _series(PM, "embedding_prefetch_hit_total", "fm_emb") > 0


def test_host_tier_matches_device_tier():
    """The port's host tier against its own device tier from the same
    initial fm_emb over 5 steps with evictions (the reference's
    test_host_offload_matches_in_hbm_training): losses within 1e-6, and
    after flush() the host store and moments against the device
    table's."""
    feeds = _feeds(5)
    _, _, state, init, _ = _reference_host(feeds[:0])
    JE.reset_tables()
    hl, ht, _, _ = _port_host(state, feeds)
    evictions = _series(PM, "embedding_evictions_total", "fm_emb")
    host = [ht.snapshot()] + [ht.slot_snapshot(k) for k in (
        "adam:Moment1", "adam:Moment2")]
    PE.reset_tables()  # else fm_emb's name routes the lookup to the host
    with pfluid.unique_name.guard():
        main, startup, loss, _ = PD.build_train_program(_tiny(PD))
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    exe.run(startup, scope=scope)
    for n, a in state.items():
        if scope.has_var(n):
            scope.set_var(n, torch.from_numpy(a.copy()))
    scope.set_var("fm_emb", torch.from_numpy(init.copy()))
    dl = [_loss(exe.run(main, feed=dict(f), fetch_list=[loss.name],
                        scope=scope)) for f in feeds]
    assert [o.type for o in main.global_block().ops].count(
        "embedding_lookup") == 2
    np.testing.assert_allclose(hl, dl, rtol=RTOL)
    assert evictions > 0
    for got, dev, atol in zip(host, ("fm_emb", "fm_emb_moment1_0",
                                     "fm_emb_moment2_0"),
                              (1e-7, 1e-9, 1e-9)):
        np.testing.assert_allclose(got, scope.find_var(dev).numpy(),
                                   rtol=RTOL, atol=atol)


def test_grow_adds_no_step_and_no_miss():
    """grow() extends the host store only: ids from the grown range add
    no compile-cache miss and no new step (no capture on the card), and
    the cache tensor stays the scope's own."""
    vocab = 320
    table = PE.HostEmbeddingTable("grow_w", vocab, 4, resident_budget=32,
                                  seed=3)
    main, startup = pfluid.Program(), pfluid.Program()
    main.random_seed = 9
    with pfluid.program_guard(main, startup):
        ids = pfluid.layers.data("ids", shape=[4], dtype="int64")
        emb = pfluid.layers.embedding(
            ids, size=[vocab, 4], is_sparse=True, residence="host",
            param_attr=pfluid.ParamAttr(name="grow_w"))
        loss = pfluid.layers.mean(pfluid.layers.reduce_sum(
            pfluid.layers.elementwise_mul(emb, emb), dim=-1))
        pfluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    rng = np.random.RandomState(2)
    misses = PM.counter("executor_compile_cache_miss_total")
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    exe.run(startup, scope=scope)
    for _ in range(3):
        exe.run(main, feed={"ids": rng.randint(0, vocab, (8, 4))},
                fetch_list=[loss], scope=scope)
    warm, steps = misses.value, len(exe._steps)
    ptr = scope.find_var("grow_w@CACHE").data_ptr()
    table.grow(2 * vocab)
    for _ in range(3):
        out = exe.run(main, feed={"ids": rng.randint(vocab, 2 * vocab,
                                                     (8, 4))},
                      fetch_list=[loss], scope=scope)
        assert np.isfinite(_loss(out))
    assert misses.value == warm and len(exe._steps) == steps
    assert scope.find_var("grow_w@CACHE").data_ptr() == ptr
    assert table.num_rows == 2 * vocab


def test_iters_window_matches_single_steps_and_reference():
    """iters=2 windows (one residency transaction each) equal 4 single
    steps, and the reference's windows."""
    singles = _feeds(4, batch=8)
    windows = [{k: np.stack([p[k] for p in singles[2 * w:2 * w + 2]])
                for k in singles[0]} for w in range(2)]
    rl, _, state, _, _ = _reference_host(windows, iters=2)
    JE.reset_tables()
    pl1, _, _, _ = _port_host(state, singles)
    PE.reset_tables()
    pl2, _, _, _ = _port_host(state, windows, iters=2)
    np.testing.assert_allclose(pl2, pl1, rtol=RTOL)
    np.testing.assert_allclose(pl2, rl, rtol=RTOL)


@pytest.mark.parametrize("case", ["missing_ids", "out_of_range"])
def test_feed_errors_match_reference(case):
    exc, match = {"missing_ids": (KeyError, "sparse_ids"),
                  "out_of_range": (IndexError,
                                   "out of range for table")}[case]
    for fluid, E, M in ((jfluid, JE, JD), (pfluid, PE, PD)):
        E.HostEmbeddingTable("fm_emb", 640, 4, resident_budget=BUDGET)
        with fluid.unique_name.guard():
            main, startup, loss, _ = M.build_train_program(
                _tiny(M), residence="host")
        feed = JD.synthetic_batch(_tiny(JD), 4)
        if case == "missing_ids":
            feed.pop("sparse_ids")
        else:
            feed["sparse_ids"][0, 0] = 640
        exe = fluid.Executor() if fluid is jfluid else fluid.Executor("cpu")
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        with pytest.raises(exc, match=match):
            exe.run(main, feed=feed, fetch_list=[loss.name], scope=scope)


def test_deepfm_host_desc_matches_reference():
    """build_train_program(residence="host"): the same main and startup
    descs and protobuf bytes as the reference's, with fm_emb@CACHE
    (budget + 1 rows), the int32 fm_emb@SLOTS feed, the lookup's attrs
    and host_embedding_init in startup."""
    for E in (JE, PE):
        E.HostEmbeddingTable("fm_emb", 640, 4, resident_budget=BUDGET)
    with jfluid.unique_name.guard():
        ref = JD.build_train_program(_tiny(JD), residence="host")
    with pfluid.unique_name.guard():
        port = PD.build_train_program(_tiny(PD), residence="host")
    for want, got in zip(ref[:2], port[:2]):
        assert got.to_desc() == want.to_desc()
        assert got.serialize_to_string() == want.serialize_to_string()
    block = port[0].global_block()
    assert block.var("fm_emb@CACHE").shape == (BUDGET + 1, 4)
    assert block.var("fm_emb@SLOTS").dtype == np.dtype("int32")
    op = next(o for o in block.ops if o.type == "host_embedding_lookup")
    assert op.input("Ids") == ["fm_emb@SLOTS"]
    assert op.input("RawIds") == ["sparse_ids"]
    assert op.attr("budget") == BUDGET and op.attr("table_name") == "fm_emb"
    assert [o.type for o in port[1].global_block().ops].count(
        "host_embedding_init") == 1
    ad = next(o for o in block.ops if o.type == "autodiff")
    assert ["fm_emb@CACHE", "fm_emb@SLOTS", op.output("Out")[0]] in \
        ad.attr("sparse_wrt")
    assert [o.type for o in PE.find_host_lookup_ops(port[0])] == \
        ["host_embedding_lookup"]


def test_padding_idx_reads_zero_rows_and_matches_reference():
    """padding_idx, read from the raw ids: padded positions read zeros
    on both packages, and a step agrees."""
    got = []
    for fluid, E in ((jfluid, JE), (pfluid, PE)):
        E.HostEmbeddingTable("pad_w", 50, 3, resident_budget=16, seed=5)
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            ids = fluid.layers.data("ids", shape=[3], dtype="int64")
            emb = fluid.layers.embedding(
                ids, size=[50, 3], is_sparse=True, padding_idx=7,
                param_attr=fluid.ParamAttr(name="pad_w"))
            loss = fluid.layers.mean(fluid.layers.reduce_sum(
                fluid.layers.elementwise_mul(emb, emb), dim=-1))
            fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
        exe = fluid.Executor() if fluid is jfluid else fluid.Executor("cpu")
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        feed = {"ids": np.array([[7, 1, 2], [3, 7, 7]], np.int64)}
        out = [np.asarray(v) for v in exe.run(
            main, feed=feed, fetch_list=[emb.name, loss.name], scope=scope)]
        out.append(E.get_host_table("pad_w").snapshot())
        got.append(out)
    assert not got[1][0][0, 0].any() and got[1][0][0, 1].any()
    for a, b in zip(got[0], got[1]):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("case", ["second_lookup", "optimizer",
                                  "no_name", "dim", "vocab"])
def test_binding_errors_match_reference(case):
    """A second lookup of one table with other ids, an optimizer whose
    per-row state cannot be written back, residence="host" with no
    param name, and a size the table does not hold: each raises as the
    reference does."""
    exc, match = {"second_lookup": (NotImplementedError,
                                    "second lookup must reuse"),
                  "optimizer": (NotImplementedError, "cannot be written "
                                                     "back on eviction"),
                  "no_name": (ValueError, "needs param_attr with a name"),
                  "dim": (ValueError, "does not match host table"),
                  "vocab": (ValueError, "exceeds host table")}[case]
    for fluid, E in ((jfluid, JE), (pfluid, PE)):
        E.reset_tables()
        E.HostEmbeddingTable("b_w", 30, 2, resident_budget=8)
        main, startup = fluid.Program(), fluid.Program()
        with pytest.raises(exc, match=match):
            with fluid.program_guard(main, startup), \
                    fluid.unique_name.guard():
                a = fluid.layers.data("a", shape=[2], dtype="int64")
                b = fluid.layers.data("b", shape=[2], dtype="int64")
                size = {"dim": [30, 3], "vocab": [31, 2]}.get(case, [30, 2])
                attr = None if case == "no_name" else \
                    fluid.ParamAttr(name="b_w")
                emb = fluid.layers.embedding(a, size=size, is_sparse=True,
                                             residence="host",
                                             param_attr=attr)
                if case == "second_lookup":
                    fluid.layers.embedding(
                        b, size=size, is_sparse=True,
                        param_attr=fluid.ParamAttr(name="b_w"))
                loss = fluid.layers.mean(emb)
                fluid.optimizer.Adam(learning_rate=0.1).minimize(loss)
                if case == "optimizer":
                    op = next(o for o in main.global_block().ops
                              if o.type == "adam")
                    op.type = "lamb"
                    main._bump()
                    main._embedding_bindings[0]._slot_map(main)


def test_lookup_routing_and_introspection():
    """A param name with a registered table routes to the host tier with
    no residence given; other lookups stay on the device tier; the
    sparse and host lookups are found as the reference finds them."""
    PE.HostEmbeddingTable("h_w", 32, 4, resident_budget=8)
    JE.HostEmbeddingTable("h_w", 32, 4, resident_budget=8)
    found = []
    for fluid, E in ((jfluid, JE), (pfluid, PE)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            ids = fluid.layers.data("ids", shape=[2], dtype="int64")
            fluid.layers.embedding(ids, size=[32, 4], is_sparse=True,
                                   param_attr=fluid.ParamAttr(name="dev_w"))
            fluid.layers.embedding(ids, size=[32, 4], is_sparse=True,
                                   param_attr=fluid.ParamAttr(name="h_w"))
            fluid.layers.embedding(ids, size=[32, 4], is_sparse=False,
                                   param_attr=fluid.ParamAttr(
                                       name="dense_w"))
        found.append((sorted(o.type for o in E.find_sparse_lookup_ops(main)),
                      [o.type for o in E.find_host_lookup_ops(main)],
                      main.to_desc()))
    assert found[1] == found[0]
    assert found[1][0] == ["embedding_lookup", "host_embedding_lookup"]
    assert set(PE.__all__) == set(JE.__all__) - {
        "ShardedEmbeddingTable", "find_distributed_lookup_table",
        "find_distributed_lookup_table_inputs",
        "find_distributed_lookup_table_outputs"}


def test_startup_resets_residency():
    """Running the startup program again (host_embedding_init) forgets
    the cache's contents, as on the reference."""
    feeds = _feeds(2)
    _, _, state, _, _ = _reference_host(feeds[:0])
    _, table, scope, _ = _port_host(state, feeds)
    assert table.resident_count > 0
    with pfluid.unique_name.guard():
        _, startup, _, _ = PD.build_train_program(_tiny(PD),
                                                  residence="host")
    pfluid.Executor("cpu").run(startup, scope=pfluid.Scope())
    assert table.resident_count == 0 and (table._lut < 0).all()
    assert _series(PM, "embedding_resident_rows", "fm_emb") == 0


# -- TF32 flags ------------------------------------------------------------------

def test_importing_the_port_leaves_tf32_flags():
    code = ("import torch\n"
            "torch.backends.cuda.matmul.allow_tf32 = True\n"
            "torch.backends.cudnn.allow_tf32 = True\n"
            "import paddle_tpu_torch.fluid\n"
            "import paddle_tpu_torch.models.transformer\n"
            "import paddle_tpu_torch.inference\n"
            "print(torch.backends.cuda.matmul.allow_tf32,"
            " torch.backends.cudnn.allow_tf32)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=str(
                             __import__("pathlib").Path(__file__).parents[1]))
    assert out.stdout.split() == ["True", "True"]


def test_runs_turn_tf32_off_and_restore_it(monkeypatch):
    """Inside a run (and a dygraph guard) TF32 is off; after it the
    flags are as the user set them; nested and concurrent blocks
    restore once, at the last exit."""
    seen = []
    from paddle_tpu_torch.fluid import registry

    lower = registry.lower_op

    def spy(ctx, op):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return lower(ctx, op)

    monkeypatch.setattr("paddle_tpu_torch.fluid.executor.lower_op", spy)
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        main, startup = pfluid.Program(), pfluid.Program()
        with pfluid.program_guard(main, startup):
            x = pfluid.layers.data("x", shape=[3])
            loss = pfluid.layers.mean(pfluid.layers.fc(x, 2))
        exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
        exe.run(startup, scope=scope)
        exe.run(main, feed={"x": np.ones((2, 3), np.float32)},
                fetch_list=[loss], scope=scope)
        assert seen and all(s == (False, False) for s in seen)
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        inside = []
        gate = threading.Barrier(2)

        def worker():
            with PT.fp32_products():
                gate.wait()
                inside.append(torch.backends.cuda.matmul.allow_tf32)
                gate.wait()

        t = threading.Thread(target=worker)
        t.start()
        with PT.fp32_products():
            gate.wait()
            with PT.fp32_products():
                pass
            inside.append(torch.backends.cuda.matmul.allow_tf32)
            gate.wait()
        t.join()
        assert inside == [False, False]
        assert torch.backends.cuda.matmul.allow_tf32
        from paddle_tpu_torch.fluid import dygraph

        with dygraph.guard("cpu"):
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


@pytest.mark.parametrize("check", ["host_vs_device", "host_dataset"])
def test_smoke_host_checks_on_the_cpu(monkeypatch, check):
    """chip_smoke.py's host-tier checks on the CPU at small sizes: host
    tier against device tier (and graphed against eager, here both
    eager) over steps with evictions, and train_from_dataset against a
    plain loop, each to the bit."""
    import chip_smoke as smoke

    monkeypatch.setattr(smoke, "HOST_VS_DEVICE",
                        dict(batch=32, budget=1024, steps=3))
    monkeypatch.setattr(smoke, "HOST_DATASET",
                        dict(vocab=20000, budget=4096, batch=128,
                             batches=4))
    rec = getattr(smoke, check)(pfluid, PD, PE, PM, torch.device("cpu"))
    if check == "host_vs_device":
        assert rec["losses_equal_to_the_bit"] and not rec["state_unequal"]
    else:
        assert not rec["unequal"] and rec["states"] > 20
