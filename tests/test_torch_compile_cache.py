"""The port's persistent compile cache (paddle_tpu_torch/fluid/
compile_cache.py, the library tiers of kernels/_build.py) on the CPU.

- The counterpart of each test of tests/test_compile_cache.py: inert
  when disabled; a restart hits disk and runs bit-identical; a corrupted
  entry is quarantined and never fatal; a version bump misses cleanly;
  two processes race on one directory (every time); a prelowered model
  cold-starts with 0 live compiles; a cold process serves the saved
  parameters' values; LRU eviction by mtime (and the libraries no entry
  names); ``prewarm`` validates and quarantines; ``restore_on_restart``
  prewarms.
- ``program_digest`` equals the reference's for the same desc.
- Each package loads the other's ``prelower=True`` directory, building
  live, and leaves the other's files untouched.
- A plan read from disk equals the live plan and runs a BERT-tiny
  encoder to the same outputs, exactly.
- The library tiers, with a stand-in shared library (the CPU has no
  nvcc): lookup order, sha256 sidecars, a truncated library quarantined
  and never loaded, an entry whose library differs is a miss, no
  ``nvcc`` started.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import inference
from paddle_tpu_torch.fluid import compile_cache, layers, monitor, unique_name
from paddle_tpu_torch.kernels import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENC_FEEDS = ["src_ids", "pos_ids", "sent_ids", "input_mask"]
SEQ = 16


def _build_regression():
    """A tiny training program; unique_name.guard makes repeat builds
    byte-identical (like a fresh process would be)."""
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data("x", shape=[4], dtype="float32")
        y = layers.data("y", shape=[1], dtype="float32")
        pred = layers.fc(x, 1, name="cc_fc")
        d = layers.elementwise_add(pred, layers.scale(y, -1.0))
        loss = layers.reduce_sum(layers.elementwise_mul(d, d))
        fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def _feed(batch=8, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.rand(batch, 4).astype(np.float32),
            "y": rng.rand(batch, 1).astype(np.float32)}


def _run_restart(feed, steps=2):
    """One simulated process lifetime: fresh Executor (empty memory
    tier), fresh program build, `steps` training steps."""
    main, startup, loss = _build_regression()
    exe = fluid.Executor("cpu")
    out = []
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        for _ in range(steps):
            (lv,) = exe.run(main, feed=feed, fetch_list=[loss])
            out.append(float(np.asarray(lv)))
    return out


def _counters():
    return (monitor.counter("executor_compile_cache_disk_hit_total").value,
            monitor.counter("executor_compile_cache_disk_miss_total").value,
            monitor.counter("compile_cache_quarantined_total").value)


def _entries(d, suffix=compile_cache.ENTRY_SUFFIX):
    return sorted(f for f in os.listdir(d) if f.endswith(suffix))


def _softmax_model(fl, lay, model_dir, seed, name, batch_sizes, exe):
    main, startup = fl.Program(), fl.Program()
    main.random_seed = seed
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = lay.data("x", shape=[4], dtype="float32")
        pred = lay.fc(x, 3, name=name, act="softmax")
    scope = fl.Scope()
    with fl.scope_guard(scope):
        exe.run(startup)
        fl.io.save_inference_model(
            model_dir, ["x"], [pred], exe, main_program=main,
            prelower=True, prelower_batch_sizes=batch_sizes)
    return scope


def test_disabled_is_inert(tmp_path, monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_DIR, raising=False)
    h0, m0, _ = _counters()
    losses = _run_restart(_feed())
    assert np.isfinite(losses).all()
    h1, m1, _ = _counters()
    assert (h1, m1) == (h0, m0), "disk tier consulted while disabled"
    assert os.listdir(str(tmp_path)) == []


def test_restart_hits_disk_and_is_bit_identical(tmp_path, monkeypatch):
    monkeypatch.setenv(compile_cache.ENV_DIR, str(tmp_path))
    h0, m0, _ = _counters()
    cold = _run_restart(_feed())
    h1, m1, _ = _counters()
    assert m1 - m0 == 2, "cold run: startup + main should both miss disk"
    assert h1 == h0
    assert len(_entries(str(tmp_path))) == 2
    # "restart": fresh Executor + rebuilt program, same cache dir
    warm = _run_restart(_feed())
    h2, m2, _ = _counters()
    assert warm == cold, "a plan read from disk diverged from live"
    assert h2 - h1 == 2 and m2 == m1, \
        "warm restart should build zero steps live"
    disk_hits = monitor.counter("executor_compile_cache_hit_total",
                                labels={"tier": "disk"}).value
    assert disk_hits >= 2


def test_corrupted_entry_quarantined_never_fatal(tmp_path, monkeypatch):
    monkeypatch.setenv(compile_cache.ENV_DIR, str(tmp_path))
    cold = _run_restart(_feed())
    paths = _entries(str(tmp_path))
    # truncate one entry, garbage-overwrite the other
    with open(os.path.join(str(tmp_path), paths[0]), "r+b") as f:
        f.truncate(17)
    with open(os.path.join(str(tmp_path), paths[1]), "wb") as f:
        f.write(b"\x80\x04 not a cache entry")
    _, m0, q0 = _counters()
    warm = _run_restart(_feed())
    _, m1, q1 = _counters()
    assert warm == cold, "fallback live build diverged"
    assert q1 - q0 == 2, "both bad entries should be quarantined"
    assert m1 - m0 == 2, "bad entries must count as disk misses"
    assert len(_entries(str(tmp_path),
                        compile_cache.QUARANTINE_SUFFIX)) == 2
    assert len(_entries(str(tmp_path))) == 2


def test_entry_with_code_is_refused(tmp_path, monkeypatch):
    """An entry is plain data: a pickle that names any global (code to
    import) is quarantined unread, and so is one that does not describe
    the program."""
    import pickle

    monkeypatch.setenv(compile_cache.ENV_DIR, str(tmp_path))
    cold = _run_restart(_feed())
    first, second = _entries(str(tmp_path))
    with open(os.path.join(str(tmp_path), first), "wb") as f:
        f.write(pickle.dumps({"format": compile_cache.FORMAT_VERSION,
                              "plan": {"op": os.getcwd},
                              "libraries": ()}))
    path = os.path.join(str(tmp_path), second)
    entry = compile_cache._read_entry(path)
    entry["plan"] = dict(entry["plan"], op_types=("scale",))
    with open(path, "wb") as f:
        f.write(pickle.dumps(entry))
    _, _, q0 = _counters()
    assert _run_restart(_feed()) == cold
    assert _counters()[2] - q0 == 2


def test_version_bump_misses_cleanly(tmp_path, monkeypatch):
    monkeypatch.setenv(compile_cache.ENV_DIR, str(tmp_path))
    _run_restart(_feed())
    before = _entries(str(tmp_path))
    # a torch upgrade changes the env fingerprint -> different key
    monkeypatch.setattr(compile_cache, "FORMAT_VERSION",
                        compile_cache.FORMAT_VERSION + 1)
    h0, m0, q0 = _counters()
    _run_restart(_feed())
    h1, m1, q1 = _counters()
    assert h1 == h0, "stale-version entry must not load"
    assert m1 - m0 == 2
    assert q1 == q0, "a clean version miss is not a quarantine"
    after = _entries(str(tmp_path))
    assert set(before) < set(after) and len(after) == 4


_RACE = """
import os, sys
os.environ["PADDLE_COMPILE_CACHE_DIR"] = sys.argv[1]
sys.path.insert(0, sys.argv[2])
import numpy as np
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import layers, monitor
main, startup = fluid.Program(), fluid.Program()
with fluid.program_guard(main, startup):
    x = layers.data("x", shape=[4], dtype="float32")
    y = layers.data("y", shape=[1], dtype="float32")
    pred = layers.fc(x, 1, name="cc_fc")
    d = layers.elementwise_add(pred, layers.scale(y, -1.0))
    loss = layers.reduce_sum(layers.elementwise_mul(d, d))
    fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
exe = fluid.Executor("cpu")
rng = np.random.RandomState(0)
feed = {"x": rng.rand(8, 4).astype(np.float32),
        "y": rng.rand(8, 1).astype(np.float32)}
with fluid.scope_guard(fluid.Scope()):
    exe.run(startup)
    for _ in range(3):
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss])
print("LOSS=%.9f Q=%d" % (float(np.asarray(lv)), monitor.counter(
    "compile_cache_quarantined_total").value))
"""


def test_two_processes_race_same_dir(tmp_path):
    """Two fresh processes populating one cache dir concurrently: both
    succeed (temp file + rename, no torn reads, nothing quarantined)
    and the dir converges on one entry per step."""
    env = {k: v for k, v in os.environ.items()
           if k != compile_cache.ENV_DIR}
    for _ in range(2):      # a second round races over a filled dir
        procs = [subprocess.Popen(
            [sys.executable, "-c", _RACE, str(tmp_path), REPO],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            text=True) for _ in range(2)]
        outs = [p.communicate(timeout=300) for p in procs]
        for p, (out, err) in zip(procs, outs):
            assert p.returncode == 0, err
        lines = {o.strip() for o, _ in outs}
        assert len(lines) == 1 and lines.pop().endswith("Q=0"), outs
        assert len(_entries(str(tmp_path))) == 2
        assert not [f for f in os.listdir(str(tmp_path))
                    if f.endswith(".tmp")]


def test_prelowered_model_cold_start(tmp_path, monkeypatch):
    """save_inference_model(prelower=True) -> a Predictor in a process
    with NO cache dir configured cold-starts from the model-adjacent
    entries, building zero steps live."""
    monkeypatch.delenv(compile_cache.ENV_DIR, raising=False)
    model_dir = str(tmp_path / "model")
    _softmax_model(fluid, layers, model_dir, 0, "pl_fc", (1, 4),
                   fluid.Executor("cpu"))
    pl_dir = os.path.join(model_dir, compile_cache.PRELOWERED_DIRNAME)
    assert len(_entries(pl_dir)) == 2
    h0, m0, _ = _counters()
    p = inference.Predictor(inference.Config(model_dir=model_dir,
                                             place="cpu"))
    assert p._exe._cache_read_dirs == [pl_dir]
    assert p.clone()._exe._cache_read_dirs == [pl_dir]
    out4 = p.run({"x": np.ones((4, 4), np.float32)})
    h1, m1, _ = _counters()
    assert h1 - h0 == 1 and m1 == m0, "prelowered batch=4 should hit"
    assert np.allclose(np.sum(out4[0], axis=1), 1.0, atol=1e-5)
    # a batch size outside the prelowered set builds live, and with no
    # write dir configured it must NOT write into the model dir
    p.run({"x": np.ones((2, 4), np.float32)})
    h2, m2, _ = _counters()
    assert h2 == h1 and m2 - m1 == 1
    assert len(_entries(pl_dir)) == 2


def test_prelower_needs_declared_feed_shapes(tmp_path):
    main = fluid.Program()      # its feed "x" is declared nowhere
    with pytest.raises(ValueError, match="no declared shape"):
        fluid.io.save_inference_model(
            str(tmp_path), ["x"], [], fluid.Executor("cpu"),
            main_program=main, prelower=True)


_COLD_SERVE = """
import os, sys
os.environ.pop("PADDLE_COMPILE_CACHE_DIR", None)
sys.path.insert(0, sys.argv[2])
import numpy as np
from paddle_tpu_torch import inference
from paddle_tpu_torch.fluid import monitor
from paddle_tpu_torch.kernels import _build
d = np.load(os.path.join(sys.argv[1], "feeds.npz"))
feeds = [d["f%d" % i] for i in range(8)]
p = inference.Predictor(inference.Config(os.path.join(sys.argv[1], "model"),
                                         place="cpu"))
srv = inference.Server()
srv.register("m", p, inference.ServeConfig(max_batch_size=2,
                                           max_queue_delay_ms=1.0),
             warmup_feed={"x": np.zeros((1, 4), np.float32)})
outs = [srv.submit("m", {"x": f}).result(timeout=60)[0] for f in feeds]
srv.close()
np.savez(os.path.join(sys.argv[1], "outs.npz"),
         **{"o%d" % i: o for i, o in enumerate(outs)})
print("MISS=%d WARM=%d NVCC=%d" % (
    monitor.counter("executor_compile_cache_disk_miss_total").value,
    monitor.counter("serving_warmup_disk_hits_total",
                    labels={"model": "m"}).value, _build.nvcc_runs))
"""


def test_cold_serve_values_match(tmp_path):
    """A COLD process serving through prelowered plans returns the saved
    parameters' forward pass, and its warm-up counts one disk hit per
    ladder size."""
    model_dir = str(tmp_path / "model")
    scope = _softmax_model(fluid, layers, model_dir, 3, "cs_fc", (1, 2),
                           fluid.Executor("cpu"))
    w = scope.find_var("cs_fc.w_0").numpy()
    b = scope.find_var("cs_fc.b_0").numpy()
    rng = np.random.RandomState(7)
    feeds = [rng.rand(rng.randint(1, 3), 4).astype(np.float32)
             for _ in range(8)]
    np.savez(str(tmp_path / "feeds.npz"),
             **{"f%d" % i: f for i, f in enumerate(feeds)})
    env = {k: v for k, v in os.environ.items()
           if k != compile_cache.ENV_DIR}
    r = subprocess.run(
        [sys.executable, "-c", _COLD_SERVE, str(tmp_path), REPO],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "MISS=0 WARM=2 NVCC=0" in r.stdout, r.stdout
    got = np.load(str(tmp_path / "outs.npz"))
    for i, f in enumerate(feeds):
        z = f @ w + b
        e = np.exp(z - z.max(axis=1, keepdims=True))
        ref = e / e.sum(axis=1, keepdims=True)
        np.testing.assert_allclose(
            got["o%d" % i], ref, rtol=1e-5, atol=1e-6,
            err_msg="cold-served request %d diverged from the saved "
                    "params' forward pass" % i)


def test_lru_eviction_by_mtime(tmp_path, monkeypatch, fake_library):
    monkeypatch.setenv(compile_cache.ENV_DIR, str(tmp_path))
    _run_restart(_feed())
    entries = _entries(str(tmp_path))
    assert len(entries) == 2
    sizes = {f: os.path.getsize(os.path.join(str(tmp_path), f))
             for f in entries}
    newest = max(entries, key=lambda f: os.path.getmtime(
        os.path.join(str(tmp_path), f)))
    oldest = [f for f in entries if f != newest][0]
    old_path = os.path.join(str(tmp_path), oldest)
    # the old entry names a library; the survivor does not
    _plant(fake_library, str(tmp_path / "_build"), sidecar=False)
    _build.library("fused_attention")
    entry = compile_cache._read_entry(old_path)
    assert compile_cache.save_entry(str(tmp_path), oldest[:-6],
                                    entry["plan"], ["fused_attention"])
    kdir = os.path.join(str(tmp_path), compile_cache.KERNELS_DIRNAME)
    assert len(os.listdir(kdir)) == 2        # the library + its sidecar
    os.utime(old_path, (1, 1))
    monkeypatch.setenv(compile_cache.ENV_MAX_BYTES,
                       str(sizes[newest] + 16))
    e0 = monitor.counter("compile_cache_evicted_total").value
    evicted = compile_cache._evict(str(tmp_path))
    assert evicted == 1
    assert _entries(str(tmp_path)) == [newest]
    assert monitor.counter("compile_cache_evicted_total").value - e0 == 1
    assert os.listdir(kdir) == [], "a library no entry names must go"


def test_prewarm_validates_and_quarantines(tmp_path, monkeypatch):
    monkeypatch.setenv(compile_cache.ENV_DIR, str(tmp_path))
    _run_restart(_feed())
    bad = os.path.join(str(tmp_path), "0" * 64 + compile_cache.ENTRY_SUFFIX)
    with open(bad, "wb") as f:
        f.write(b"torn write")
    # the reference's entries in the same dir are not the port's
    foreign = os.path.join(str(tmp_path), "1" * 64 + ".xc")
    with open(foreign, "wb") as f:
        f.write(b"an XLA executable")
    _, _, q0 = _counters()
    ok = compile_cache.prewarm(str(tmp_path))
    _, _, q1 = _counters()
    assert ok == 2
    assert q1 - q0 == 1
    assert not os.path.exists(bad)
    assert os.path.exists(bad + compile_cache.QUARANTINE_SUFFIX)
    assert open(foreign, "rb").read() == b"an XLA executable"


def test_restore_on_restart_prewarms(tmp_path, monkeypatch):
    """A restarted worker (PADDLE_RESTART_ATTEMPT>0) validates the cache
    before its first step: the corrupt entry is quarantined by
    restore_on_restart itself, not discovered mid-step."""
    monkeypatch.setenv(compile_cache.ENV_DIR, str(tmp_path))
    bad = os.path.join(str(tmp_path), "f" * 64 + compile_cache.ENTRY_SUFFIX)
    with open(bad, "wb") as f:
        f.write(b"garbage")
    monkeypatch.setenv("PADDLE_RESTART_ATTEMPT", "1")
    mgr = fluid.io.CheckpointManager(str(tmp_path / "ckpt"))
    _, _, q0 = _counters()
    assert mgr.restore_on_restart() is None  # no checkpoint yet
    _, _, q1 = _counters()
    assert q1 - q0 == 1 and not os.path.exists(bad)


# -- against the reference package --------------------------------------------
def _encoder_programs(fl, B):
    cfg = B.BertConfig.tiny()
    cfg.use_fused_attention = "packed"
    with fl.unique_name.guard():
        return B.build_encoder_program(cfg, seq_len=SEQ)


def test_program_digest_equals_reference():
    import paddle_tpu.fluid as jfluid
    from paddle_tpu.fluid import compile_cache as jcc
    from paddle_tpu.models import bert as JB
    from paddle_tpu_torch.models import bert as PB

    jmain, jstartup, _ = _encoder_programs(jfluid, JB)
    pmain, pstartup, _ = _encoder_programs(fluid, PB)
    for j, p in ((jmain, pmain), (jstartup, pstartup)):
        assert compile_cache.program_digest(p) == jcc.program_digest(j)
    # the digest follows the program's edits
    before = compile_cache.program_digest(pmain)
    with unique_name.guard(), fluid.program_guard(pmain):
        layers.scale(pmain.global_block().var("src_ids"), 2.0)
    assert compile_cache.program_digest(pmain) != before


def _snapshot(d):
    return {f: (os.path.getmtime(os.path.join(d, f)),
                open(os.path.join(d, f), "rb").read())
            for f in sorted(os.listdir(d))
            if os.path.isfile(os.path.join(d, f))}


def test_each_package_loads_the_others_prelowered_dir(tmp_path,
                                                       monkeypatch):
    """A reference export with prelower=True serves in the port (its
    steps built live: the ``.xc`` entries are not the port's), and a
    port export in the reference (the reference's keys miss, so it
    compiles live); neither reads, quarantines or rewrites the other's
    files, and both serve the same values."""
    import paddle_tpu.fluid as jfluid
    from paddle_tpu import inference as JI
    from paddle_tpu.fluid import layers as jlayers

    monkeypatch.delenv(compile_cache.ENV_DIR, raising=False)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    _softmax_model(jfluid, jlayers, ref_dir, 5, "x_fc", (1, 2),
                   jfluid.Executor())
    _softmax_model(fluid, layers, port_dir, 5, "x_fc", (1, 2),
                   fluid.Executor("cpu"))
    ref_pl = os.path.join(ref_dir, compile_cache.PRELOWERED_DIRNAME)
    port_pl = os.path.join(port_dir, compile_cache.PRELOWERED_DIRNAME)
    assert len(_entries(ref_pl, ".xc")) == 2
    assert len(_entries(port_pl)) == 2 and not _entries(port_pl, ".xc")
    before = {d: _snapshot(d) for d in (ref_pl, port_pl)}
    x = np.random.RandomState(1).rand(2, 4).astype(np.float32)
    h0, m0, q0 = _counters()
    port_out = inference.Predictor(inference.Config(
        ref_dir, place="cpu")).run({"x": x})[0]
    h1, m1, q1 = _counters()
    assert (h1 - h0, m1 - m0, q1 - q0) == (0, 1, 0)
    h0, m0, q0 = _counters()
    ref_out = JI.Predictor(JI.Config(model_dir=port_dir)).run({"x": x})[0]
    assert _counters() == (h0, m0, q0)
    for d in (ref_pl, port_pl):
        assert _snapshot(d) == before[d], d
        assert not _entries(d, compile_cache.QUARANTINE_SUFFIX)
    # the same saved values give the same answers: the reference's export
    # served live by the reference (a copy without __prelowered__), the
    # port's by the port
    live = str(tmp_path / "ref_live")
    shutil.copytree(ref_dir, live, ignore=shutil.ignore_patterns(
        compile_cache.PRELOWERED_DIRNAME))
    np.testing.assert_allclose(port_out, JI.Predictor(JI.Config(
        model_dir=live)).run({"x": x})[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ref_out, inference.Predictor(
        inference.Config(port_dir, place="cpu")).run({"x": x})[0],
        rtol=1e-5, atol=1e-6)


def test_plan_from_disk_runs_the_encoder_exactly(tmp_path, monkeypatch):
    """BERT-tiny's packed encoder: the plan a prelowered entry holds
    equals the plan built live, field by field, and a Predictor serving
    from it answers exactly as one building its steps live."""
    from paddle_tpu_torch.fluid.executor import _Plan
    from paddle_tpu_torch.models import bert as PB

    monkeypatch.delenv(compile_cache.ENV_DIR, raising=False)
    main, startup, enc = _encoder_programs(fluid, PB)
    exe, scope = fluid.Executor("cpu"), fluid.Scope()
    model_dir = str(tmp_path / "enc")
    with fluid.scope_guard(scope):
        exe.run(startup, scope=scope)
        fluid.io.save_inference_model(
            model_dir, ENC_FEEDS, [enc], exe, main_program=main,
            prelower=True, prelower_batch_sizes=(2, 3))
    live_dir = str(tmp_path / "live")
    shutil.copytree(model_dir, live_dir, ignore=shutil.ignore_patterns(
        compile_cache.PRELOWERED_DIRNAME))
    cached = inference.Predictor(inference.Config(model_dir, place="cpu"))
    live = inference.Predictor(inference.Config(live_dir, place="cpu"))
    batch = PB.synthetic_batch(PB.BertConfig.tiny(), 3, SEQ, seed=9)
    h0, m0, _ = _counters()
    for rows in (2, 3, 2):
        feed = {n: batch[n][:rows] for n in ENC_FEEDS}
        np.testing.assert_array_equal(cached.run(feed)[0],
                                      live.run(feed)[0])
    h1, m1, _ = _counters()
    assert (h1 - h0, m1 - m0) == (2, 0)
    pl = os.path.join(model_dir, compile_cache.PRELOWERED_DIRNAME)
    for name in _entries(pl):
        data = compile_cache._read_entry(os.path.join(pl, name))["plan"]
        program = cached.program
        fetches = [v.name for v in cached._fetch_vars]
        assert _Plan.from_entry(program, fetches, data).to_entry() == \
            _Plan(program, fetches).to_entry() == data


# -- the library tiers ----------------------------------------------------------
@pytest.fixture
def fake_library(tmp_path, monkeypatch):
    """The library tiers with fresh state and a stand-in for
    ``fused_attention``'s library: a real shared object of this Python
    (the CPU has no nvcc), loaded into the tiers under the library's
    file name. ``_build._build`` raises if anything would start nvcc."""
    import _json

    src = _json.__file__
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_PATHS", {})
    monkeypatch.setattr(_build, "_READ_DIRS", [])
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))

    def no_nvcc(stems, dst_dir):
        raise AssertionError("nvcc would run for %s" % (stems,))
    monkeypatch.setattr(_build, "_build", no_nvcc)
    return src


def _plant(src, d, name=None, sidecar=True):
    os.makedirs(d, exist_ok=True)
    dst = os.path.join(d, name or _build.lib_name("fused_attention"))
    shutil.copyfile(src, dst)
    if sidecar:
        _build._write_sidecar(dst, _build.sha256_file(src))
    return dst


def test_library_tiers_in_order(tmp_path, monkeypatch, fake_library):
    monkeypatch.setenv(compile_cache.ENV_DIR, str(tmp_path / "cache"))
    pre = str(tmp_path / "model" / "__prelowered__" / "kernels")
    cache = str(tmp_path / "cache" / "kernels")
    _plant(fake_library, cache)
    unsigned = _plant(fake_library, pre, sidecar=False)
    _build.add_read_dir(pre)
    n0 = _build.nvcc_runs
    # a library without its sidecar is not loaded (a writer mid-rename)
    _build.library("fused_attention")
    assert _build.loaded_from("fused_attention") == os.path.join(
        cache, os.path.basename(unsigned))
    monkeypatch.setattr(_build, "_LIBS", {})
    _build._write_sidecar(unsigned, _build.sha256_file(fake_library))
    _build.library("fused_attention")
    assert _build.loaded_from("fused_attention") == unsigned
    assert _build.nvcc_runs == n0
    with _build.record_uses() as used:
        _build.library("fused_attention")
    assert used == {"fused_attention"}


def test_truncated_library_is_quarantined_never_loaded(
        tmp_path, monkeypatch, fake_library):
    monkeypatch.setenv(compile_cache.ENV_DIR, str(tmp_path / "cache"))
    pre = str(tmp_path / "pre")
    bad = _plant(fake_library, pre)
    with open(bad, "r+b") as f:
        f.truncate(1000)
    _build.add_read_dir(pre)
    good = _plant(fake_library, str(tmp_path / "_build"), sidecar=False)
    _, _, q0 = _counters()
    _build.library("fused_attention")
    assert _build.loaded_from("fused_attention") == good
    assert _counters()[2] - q0 == 1
    assert os.path.exists(bad + compile_cache.QUARANTINE_SUFFIX)
    assert not os.path.exists(bad)
    # nothing anywhere: the build would run (and here refuses)
    monkeypatch.setattr(_build, "_LIBS", {})
    os.remove(good)
    with pytest.raises(AssertionError, match="nvcc would run"):
        _build.library("fused_attention")


def test_entry_libraries_decide_the_hit(tmp_path, monkeypatch,
                                        fake_library):
    """An entry names its libraries by file name and sha256: loaded from
    a tier they make the lookup a hit (and a hit from a read-only tier
    is copied into the write dir, libraries too); a copy that differs is
    quarantined and the lookup misses."""
    monkeypatch.setenv(compile_cache.ENV_DIR, str(tmp_path / "cache"))
    pre = str(tmp_path / "pre")
    lib = _plant(fake_library, os.path.join(pre, "kernels"))
    _build.add_read_dir(os.path.join(pre, "kernels"))
    _build.library("fused_attention")
    plan = {"op_types": ("scale",)}
    with compile_cache.override_dir(pre):
        assert compile_cache.save_entry(pre, "k" * 64, plan,
                                        ["fused_attention"])
    entry = compile_cache._read_entry(compile_cache.entry_path(pre, "k" * 64))
    assert entry["libraries"] == (("fused_attention", os.path.basename(lib),
                                   _build.sha256_file(lib)),)
    monkeypatch.setattr(_build, "_LIBS", {})
    h0, m0, q0 = _counters()
    assert compile_cache.lookup("k" * 64, [pre]) == plan
    assert _counters()[:2] == (h0 + 1, m0)
    cache = str(tmp_path / "cache")
    assert os.path.exists(compile_cache.entry_path(cache, "k" * 64))
    assert os.listdir(os.path.join(cache, "kernels")) == sorted(
        os.listdir(os.path.join(pre, "kernels")))
    # the same name with other bytes: quarantined, a miss
    shutil.rmtree(cache)
    monkeypatch.setattr(_build, "_LIBS", {})
    with open(lib, "ab") as f:
        f.write(b"\0")
    assert compile_cache.lookup("k" * 64, [pre]) is None
    assert _counters() == (h0 + 1, m0 + 1, q0 + 1)
    assert os.path.exists(lib + compile_cache.QUARANTINE_SUFFIX)
