"""The port's dataset feeding (paddle_tpu_torch/fluid/dataset.py,
reader.py, data_feeder.py, ``Executor.train_from_dataset`` /
``infer_from_dataset``), held to the JAX package on the CPU.

The same MultiSlot files, written from a seed, go through both
packages' datasets: parsed samples and batches equal, shuffles under one
seed in the same order; ``train_from_dataset`` on the port equals a plain
``exe.run`` loop over the same batches to the bit, and the reference's
final state within 1e-5 (DeepFM-tiny with its host-tier table, and a
linear model). Each refusal names its ROADMAP item.
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import embedding as JE
from paddle_tpu.fluid import dataset as JDS
from paddle_tpu.models import deepfm as JD
import paddle_tpu_torch.fluid as pfluid
from paddle_tpu_torch import embedding as PE
from paddle_tpu_torch.fluid import dataset as PDS
from paddle_tpu_torch.fluid import faults as PF
from paddle_tpu_torch.fluid import monitor as PM
from paddle_tpu_torch.fluid import reader as PR
from paddle_tpu_torch.models import deepfm as PD

STATE_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _clean():
    JE.reset_tables()
    PE.reset_tables()
    PF.reset()
    yield
    JE.reset_tables()
    PE.reset_tables()
    PF.reset()


def _write_multislot(path, n_lines, seed, dense_dim=3):
    """Lines: a dense float slot [dense_dim], an int64 id slot and a
    float label slot (the reference's test_dataset_engine writer)."""
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(n_lines):
        parts = [str(dense_dim)] + ["%.6f" % v for v in rng.rand(dense_dim)]
        parts += ["1", str(rng.randint(0, 50))]
        parts += ["1", "%.1f" % float(rng.randint(0, 2))]
        rows.append(" ".join(parts))
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return rows


def _use_vars(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        dense = fluid.layers.data("dense", [3])
        ids = fluid.layers.data("ids", [1], dtype="int64")
        label = fluid.layers.data("label", [1])
    return [dense, ids, label]


def _dataset(fluid, kind, files, batch, use_vars=None, seed=None,
             load=True, **kw):
    ds = fluid.DatasetFactory().create_dataset(kind)
    ds.set_batch_size(batch)
    ds.set_use_var(use_vars or _use_vars(fluid))
    ds.set_filelist(files)
    for k, v in kw.items():
        getattr(ds, "set_" + k)(v)
    if seed is not None:
        ds.set_seed(seed)
    if load and kind == "InMemoryDataset":
        ds.load_into_memory()
    return ds


def _batches(ds, drop_last=False):
    return list(ds.batch_reader(drop_last)())


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("kind,batch,drop_last,threads", [
    ("InMemoryDataset", 4, False, 1), ("InMemoryDataset", 3, True, 1),
    ("InMemoryDataset", 5, False, 3), ("QueueDataset", 2, False, 1),
    ("FileInstantDataset", 3, True, 1)])
def test_multislot_batches_equal_reference(tmp_path, kind, batch,
                                           drop_last, threads):
    files = []
    for i, n in enumerate((5, 3, 7)):
        files.append(str(tmp_path / ("f%d.txt" % i)))
        _write_multislot(files[-1], n, seed=i)
    got, want = (_batches(_dataset(f, kind, files, batch, thread=threads),
                          drop_last) for f in (pfluid, jfluid))
    _same_batches(got, want)
    assert got[0]["dense"].shape == (batch, 3)
    assert got[0]["ids"].dtype == np.int64


def test_numpy_parse_equals_reference(tmp_path):
    """The port's parser against the reference's numpy parser and, where
    it builds, the reference's native one."""
    f = str(tmp_path / "c.txt")
    _write_multislot(f, 9, seed=3)
    raw = open(f, "rb").read()
    got = PDS._numpy_parse(raw.decode(), ["f", "u", "f"])
    refs = [JDS._numpy_parse(raw.decode(), ["f", "u", "f"])]
    from paddle_tpu import native

    lib = native.load_data_feed()
    if lib is not None:
        refs.append(JDS._native_parse(lib, raw, ["f", "u", "f"]))
    for ref in refs:
        for (gv, go), (rv, ro) in zip(got, ref):
            assert gv.dtype == rv.dtype
            np.testing.assert_array_equal(gv, rv)
            np.testing.assert_array_equal(go, ro)
    for bad in ("2 1.0\n", "1 1.0 0\n", "1 1.0\n"):
        with pytest.raises(ValueError):
            PDS._numpy_parse(bad, ["f", "u", "f"])


@pytest.mark.parametrize("shuffle", ["local", "global"])
def test_shuffles_under_a_seed_equal_reference(tmp_path, shuffle):
    f = str(tmp_path / "d.txt")
    _write_multislot(f, 20, seed=4)
    got = []
    for fluid in (pfluid, jfluid):
        ds = _dataset(fluid, "InMemoryDataset", [f], 20, seed=123)
        getattr(ds, shuffle + "_shuffle")()
        got.append(_batches(ds))
    _same_batches(*got)
    unshuffled = _batches(_dataset(pfluid, "InMemoryDataset", [f], 20))
    assert not np.array_equal(got[0][0]["dense"], unshuffled[0]["dense"])


def test_in_memory_queries_preload_and_release(tmp_path):
    files = []
    for i in range(3):
        files.append(str(tmp_path / ("p%d.txt" % i)))
        _write_multislot(files[-1], 4 + i, seed=10 + i)
    ds = _dataset(pfluid, "InMemoryDataset", files, 4, load=False)
    ds.preload_into_memory(thread_num=2)
    ds.wait_preload_done()
    ref = _dataset(jfluid, "InMemoryDataset", files, 4, thread=2)
    assert ds.get_memory_data_size() == ref.get_memory_data_size() == 15
    assert ds.get_shuffle_data_size() == 15
    _same_batches(_batches(ds), _batches(ref))
    assert ds.desc() == ref.desc()
    ds.release_memory()
    assert ds.get_memory_data_size() == 0 and _batches(ds) == []


def test_pipe_command_and_queue_streaming(tmp_path):
    f = str(tmp_path / "h.txt")
    _write_multislot(f, 6, seed=9)
    got = [_dataset(fluid, "InMemoryDataset", [f], 100,
                    pipe_command="head -n 2") for fluid in (pfluid, jfluid)]
    assert got[0].get_memory_data_size() == 2
    _same_batches(_batches(got[0]), _batches(got[1]))
    q = _dataset(pfluid, "QueueDataset", [f], 2)
    reader = q.batch_reader()()
    first = next(reader)
    reader.close()      # a consumer that stops early releases the producer
    assert first["dense"].shape == (2, 3)
    with pytest.raises(NotImplementedError, match="InMemoryDataset"):
        q.local_shuffle()
    with pytest.raises(NotImplementedError, match="InMemoryDataset"):
        q.global_shuffle()
    bad = str(tmp_path / "bad.txt")
    with open(bad, "w") as fh:
        fh.write("3 1 2\n")
    with pytest.raises(RuntimeError, match="QueueDataset stream failed"):
        _batches(_dataset(pfluid, "QueueDataset", [bad], 2))


def test_data_feeder_equals_reference():
    samples = [(np.arange(3, dtype=np.float32) + i, i, float(i % 2))
               for i in range(5)]
    got = [fluid.DataFeeder(_use_vars(fluid)).feed(samples)
           for fluid in (pfluid, jfluid)]
    _same_batches([got[0]], [got[1]])
    assert got[0]["ids"].shape == (5, 1)


# -- train_from_dataset -------------------------------------------------------

def _linear(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        dense = fluid.layers.data("dense", [3])
        ids = fluid.layers.data("ids", [1], dtype="int64")
        label = fluid.layers.data("label", [1])
        pred = fluid.layers.fc(dense, 1, name="w")
        err = fluid.layers.elementwise_sub(pred, label)
        loss = fluid.layers.mean(fluid.layers.elementwise_mul(err, err))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, [dense, ids, label], loss


def _persistables(main, scope):
    return {v.name: np.asarray(scope.find_var(v.name)).copy()
            for v in main.list_vars()
            if v.persistable and scope.find_var(v.name) is not None}


def test_train_from_dataset_equals_run_loop_and_reference(tmp_path):
    f = str(tmp_path / "d.txt")
    _write_multislot(f, 12, seed=21)
    results = {}
    for mode in ("ref", "tfd", "loop"):
        fluid = jfluid if mode == "ref" else pfluid
        main, startup, use_vars, loss = _linear(fluid)
        ds = _dataset(fluid, "InMemoryDataset", [f], 4, use_vars)
        exe = fluid.Executor() if mode == "ref" else fluid.Executor("cpu")
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        if mode == "ref":
            init = _persistables(main, scope)
        else:
            for n, a in init.items():
                scope.set_var(n, torch.from_numpy(a.copy()))
        if mode == "loop":
            for feed in ds.batch_reader()():
                exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        else:
            assert exe.train_from_dataset(main, ds, scope=scope,
                                          fetch_list=[loss]) == 3
        results[mode] = _persistables(main, scope)
    for n, want in results["ref"].items():
        np.testing.assert_array_equal(results["tfd"][n], results["loop"][n])
        np.testing.assert_allclose(results["tfd"][n], want, rtol=STATE_RTOL,
                                   atol=1e-7)


def _write_deepfm(path, cfg, n_batches, batch, seed):
    """Config-shaped MultiSlot lines: the fields as one id slot of
    num_fields values, the dense features, the label."""
    with open(path, "w") as fh:
        for b in range(n_batches):
            f = JD.synthetic_batch(cfg, batch, seed=seed + b)
            for i in range(batch):
                fh.write("%d %s %d %s 1 %d\n" % (
                    cfg.num_fields, " ".join(map(str, f["sparse_ids"][i])),
                    cfg.num_dense,
                    " ".join("%.6f" % v for v in f["dense_x"][i]),
                    f["label"][i, 0]))


def _deepfm_cfg(M):
    return M.DeepFMConfig(sparse_feature_dim=640, num_fields=4,
                          num_dense=3, embedding_size=4, fc_sizes=(16,))


def test_deepfm_host_tier_train_from_dataset(tmp_path):
    """DeepFM-tiny with fm_emb on a host table (budget 64, evictions),
    one pass of 4 batches: train_from_dataset on the port equals a plain
    exe.run loop over the same batches to the bit (flushed host store,
    device parameters, both moments), and the reference's pass within
    1e-5."""
    f = str(tmp_path / "ctr.txt")
    _write_deepfm(f, _deepfm_cfg(JD), 4, 16, seed=5)
    results = {}
    for mode in ("ref", "tfd", "loop"):
        ref = mode == "ref"
        fluid, E, M = (jfluid, JE, JD) if ref else (pfluid, PE, PD)
        E.reset_tables()
        table = E.HostEmbeddingTable("fm_emb", 640, 4, resident_budget=64,
                                     seed=3)
        with fluid.unique_name.guard():
            main, startup, loss, _ = M.build_train_program(
                _deepfm_cfg(M), residence="host")
        block = main.global_block()
        use = [block.var(n) for n in ("sparse_ids", "dense_x", "label")]
        ds = _dataset(fluid, "InMemoryDataset", [f], 16, use)
        exe = fluid.Executor() if ref else fluid.Executor("cpu")
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        if ref:
            init = _persistables(main, scope)
        else:
            for n, a in init.items():
                scope.set_var(n, torch.from_numpy(a.copy()))
        if mode == "loop":
            for feed in ds.batch_reader()():
                exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        else:
            assert exe.train_from_dataset(main, ds, scope=scope,
                                          fetch_list=[loss]) == 4
        state = _persistables(main, scope)
        state.update({"host:values": table.snapshot()},
                     **{"host:" + k: table.slot_snapshot(k)
                        for k in ("adam:Moment1", "adam:Moment2")})
        results[mode] = state
    assert PM.counter("embedding_evictions_total",
                      labels={"table": "fm_emb"}).value > 0
    for n in results["tfd"]:
        np.testing.assert_array_equal(results["tfd"][n], results["loop"][n])
    for n in ("host:values", "host:adam:Moment1", "host:adam:Moment2",
              "fm_w1", "deep_fc0.w_0", "deep_out.w_0", "fm_w1_moment1_0"):
        np.testing.assert_allclose(results["tfd"][n], results["ref"][n],
                                   rtol=STATE_RTOL, atol=1e-7)


def test_infer_from_dataset_and_debug_print(tmp_path, capsys):
    f = str(tmp_path / "i.txt")
    _write_multislot(f, 8, seed=2)
    main, startup, use_vars, loss = _linear(pfluid)
    test = main._prune([loss])
    ds = _dataset(pfluid, "QueueDataset", [f], 2, use_vars)
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    exe.run(startup, scope=scope)
    before = np.asarray(scope.find_var("w.w_0")).copy()
    assert exe.infer_from_dataset(test, ds, scope=scope, fetch_list=[loss],
                                  debug=True, print_period=2) == 4
    np.testing.assert_array_equal(np.asarray(scope.find_var("w.w_0")),
                                  before)
    assert capsys.readouterr().out.count("batch ") == 2
    with pytest.raises(ValueError, match="dataset is required"):
        exe.train_from_dataset(main)


# -- DataLoader and the stager ------------------------------------------------

def _gen_batches(n=10):
    data = np.arange(4 * n, dtype=np.float32).reshape(n, 4)

    def gen():
        for i in range(n):
            yield [data[i:i + 1]]
    return data, gen


@pytest.mark.parametrize("mode", ["sync", "threaded", "multiprocess"])
def test_dataloader_from_generator_covers_the_stream(mode):
    data, gen = _gen_batches()
    x = _use_vars(pfluid)[0]
    loader = pfluid.DataLoader.from_generator(
        feed_list=[x], use_double_buffer=mode != "sync",
        use_multiprocess=mode == "multiprocess", num_workers=3,
        place="cpu")
    loader.set_batch_generator(gen)
    batches = list(loader)
    rows = sorted(float(np.asarray(b["dense"])[0, 0]) for b in batches)
    assert rows == [float(v) for v in data[:, 0]]
    kinds = {type(b["dense"]) for b in batches}
    assert kinds == ({np.ndarray} if mode == "sync" else {torch.Tensor})


def test_dataloader_sample_generators_and_worker_sharding():
    x = _use_vars(pfluid)[0]

    def samples():
        for i in range(7):
            yield (np.full(3, float(i), np.float32),)

    loader = pfluid.DataLoader.from_generator(feed_list=[x], place="cpu")
    loader.set_sample_generator(samples, batch_size=3, drop_last=False)
    assert [tuple(b["dense"].shape) for b in loader] == [(3, 3), (3, 3),
                                                         (1, 3)]
    loader.set_sample_list_generator(lambda: iter([[s for s in samples()]]))
    assert [tuple(b["dense"].shape) for b in loader] == [(7, 3)]

    def sharded():
        info = PR.get_worker_info()
        info.mark_sharded()
        for i in range(info.id, 6, info.num_workers):
            yield [np.full((1, 3), float(i), np.float32)]

    mp = pfluid.DataLoader.from_generator(
        feed_list=[x], use_multiprocess=True, num_workers=2,
        stage_on_device=False)
    mp.set_batch_generator(sharded)
    assert sorted(float(b["dense"][0, 0]) for b in mp) == \
        [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
    assert PR.get_worker_info() is None


def test_dataloader_from_dataset(tmp_path):
    f = str(tmp_path / "i.txt")
    _write_multislot(f, 8, seed=12)
    ds = _dataset(pfluid, "InMemoryDataset", [f], 4)
    batches = list(pfluid.DataLoader.from_dataset(ds, places=["cpu"]))
    assert len(batches) == 2 and tuple(batches[0]["dense"].shape) == (4, 3)
    assert isinstance(batches[0]["dense"], torch.Tensor)


def test_stager_errors_retries_and_close():
    """Producer errors re-raise in the consumer; an injected transient
    staging fault is retried (counted under site reader.stage); close()
    is idempotent and joins the thread; a worker's death names it."""
    def bad():
        yield {"x": np.zeros(2)}
        raise RuntimeError("boom in source")

    st = PR.DeviceStager(bad(), capacity=1)
    next(st)
    with pytest.raises(RuntimeError, match="boom in source"):
        next(st)
    st.close()
    st.close()
    attempts = PM.counter("resilience_retry_attempts_total",
                          labels={"site": "reader.stage"})
    before = attempts.value
    PF.arm("reader.stage", after_n=1, times=1)
    st = PR.DeviceStager(iter([{"x": np.ones(2)}] * 3),
                         transform=lambda f: PR.stage_feed(f, "cpu"))
    got = list(st)
    assert len(got) == 3 and attempts.value == before + 1
    assert PF.hits("reader.stage") == 4
    # keep_on_host leaves a name's numpy array as it is
    staged = PR.stage_feed({"a": np.ones(2), "b": np.ones(2)}, "cpu",
                           keep_on_host={"b"})
    assert isinstance(staged["a"], torch.Tensor) and \
        isinstance(staged["b"], np.ndarray)
    # an abandoned stager stalled on a full queue is released
    st = PR.DeviceStager(iter([{"x": np.ones(1)}] * 10), capacity=1)
    next(st)
    st.close()

    def dies():
        yield [np.zeros((1, 3), np.float32)]
        raise RuntimeError("boom in worker")

    loader = pfluid.DataLoader.from_generator(
        feed_list=[_use_vars(pfluid)[0]], use_multiprocess=True,
        num_workers=1, stage_on_device=False)
    loader.set_batch_generator(dies)
    with pytest.raises(RuntimeError, match="worker 0 died"):
        list(loader)


# -- refusals -------------------------------------------------------------------

@pytest.mark.parametrize("case,match", [
    ("native_parser", "ROADMAP queue 1 item 9"),
    ("native_channel", "ROADMAP queue 1 item 9"),
    ("hdfs", "ROADMAP queue 1 item 9"),
    ("exchange", "ROADMAP queue 1 item 8"),
    ("global_shuffle_fleet", "ROADMAP queue 1 item 8"),
    ("boxps", "ROADMAP queue 1 item 8"),
    ("stage_sharding", "ROADMAP queue 1 item 7"),
    ("loader_sharding", "ROADMAP queue 1 item 7"),
    # the window prefetch is ported: on explicit feeds (no py_reader)
    # prefetch=True raises the reference's ValueError
    pytest.param("prefetch_run", "prefetch=True needs a py_reader-fed",
                 id="prefetch_run-ROADMAP queue 5"),
])
def test_refusals_name_their_roadmap_items(tmp_path, monkeypatch, case,
                                           match):
    f = str(tmp_path / "r.txt")
    _write_multislot(f, 4, seed=1)
    if case == "prefetch_run":
        msgs = []
        for fluid, exe in ((jfluid, jfluid.Executor()),
                           (pfluid, pfluid.Executor("cpu"))):
            main, startup, _, loss = _linear(fluid)
            scope = fluid.Scope()
            exe.run(startup, scope=scope)
            with pytest.raises(ValueError, match=match) as e:
                exe.run(main, feed={"dense": np.ones((2, 2, 3), np.float32),
                                    "label": np.ones((2, 2, 1), np.float32)},
                        fetch_list=[loss], scope=scope, iters=2,
                        prefetch=True)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        return
    with pytest.raises(NotImplementedError, match=match):
        if case == "native_parser":
            PDS._native_parse(None, b"", ["f"])
        elif case == "native_channel":
            monkeypatch.setenv("PADDLE_TPU_NATIVE_CHANNEL", "1")
            _dataset(pfluid, "QueueDataset", [f], 2).batch_reader()
        elif case == "hdfs":
            _dataset(pfluid, "InMemoryDataset", [f], 2).set_hdfs_config(
                "hdfs://x:9000", "u,p")
        elif case == "exchange":
            _dataset(pfluid, "InMemoryDataset", [f], 2).set_exchange(
                None, ["127.0.0.1:1"])
        elif case == "global_shuffle_fleet":
            _dataset(pfluid, "InMemoryDataset", [f], 2).global_shuffle(
                fleet=object())
        elif case == "boxps":
            pfluid.DatasetFactory().create_dataset("BoxPSDataset")
        elif case == "stage_sharding":
            PR.stage_feed({"x": np.ones(1)}, "cpu", sharding={"x": None})
        else:
            pfluid.DataLoader.from_generator(
                feed_list=[_use_vars(pfluid)[0]], sharding=object())


def test_factory_and_setters_match_reference():
    for fluid in (pfluid, jfluid):
        with pytest.raises(ValueError, match="unknown dataset class"):
            fluid.DatasetFactory().create_dataset("Nope")
        with pytest.raises(TypeError, match="takes Variables"):
            fluid.DatasetFactory().create_dataset().set_use_var(["x"])
        with pytest.raises(RuntimeError, match="set_use_var"):
            fluid.DatasetFactory().create_dataset(
                "InMemoryDataset")._parse_file(os.devnull)
    assert type(pfluid.DatasetFactory().create_dataset()).__name__ == \
        "QueueDataset"
