"""Crash-consistent checkpoints and fault tolerance in the port
(``paddle_tpu_torch/fluid/io.py``: ``save`` / ``load``,
``CheckpointManager``; ``Executor.run(checkpoint=...)``, the anomaly
policies; ``paddle_tpu_torch/distributed/preemption.py``), held to the
JAX package's on the CPU.

- ``io.save`` / ``io.load`` cross both ways between the packages, the
  files byte for byte and the values exactly;
- the port's counterpart of each single-process test of
  ``tests/test_fault_tolerance.py:67-350``;
- a version written by either package restored by the other: the
  parameters and moments exactly; the generator entry by the rule each
  side has (``fluid/io.py``'s docstring; ROADMAP queue 3);
- a drain in a subprocess: SIGTERM after a step, exit 0, the marker, the
  newest version at the drained step;
- a run resumed from a version equal to the uninterrupted run to the
  bit: BERT-tiny with dropout 0.1, fed by a py_reader.

Tolerances (fp32): rtol 1e-5 against the reference (atol 1e-6); files
and restored values exact.
"""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import faults as jfaults
from paddle_tpu.fluid import flags as jflags
from paddle_tpu.fluid.core import tensor_io as jtio
from paddle_tpu.fluid.io import CheckpointManager as JCheckpointManager
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.distributed import preemption
from paddle_tpu_torch.fluid import faults, flags, monitor
from paddle_tpu_torch.fluid.core import tensor_io
from paddle_tpu_torch.fluid.io import CheckpointManager, RNG_STATE_VAR
from paddle_tpu_torch.models import bert

RTOL, ATOL = 1e-5, 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_faults_and_flags():
    saved = [dict(f._FLAGS) for f in (jflags, flags)]
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()
    for f, s in zip((jflags, flags), saved):
        f._FLAGS.clear()
        f._FLAGS.update(s)


def _mlp(pkg, seed=11):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", shape=[4], dtype="float32")
        y = pkg.layers.data("y", shape=[1], dtype="float32")
        h = pkg.layers.fc(x, size=6, act="relu")
        pred = pkg.layers.fc(h, size=1)
        d = pkg.layers.elementwise_sub(pred, y)
        loss = pkg.layers.mean(pkg.layers.elementwise_mul(d, d))
        pkg.optimizer.Adam(0.05).minimize(loss)
    return main, startup, loss


def _feed(step):
    rs = np.random.RandomState(77 + step)
    return {"x": rs.rand(3, 4).astype(np.float32),
            "y": rs.rand(3, 1).astype(np.float32)}


def _names(program):
    return sorted(v.name for v in program.list_vars() if v.persistable)


def _params(program, scope):
    return {n: np.array(scope.find_var(n)) for n in _names(program)
            if scope.find_var(n) is not None}


def _trained(steps=3):
    """The port's MLP after ``steps`` Adam steps: (main, startup, loss,
    exe, scope)."""
    main, startup, loss = _mlp(fluid)
    exe, scope = fluid.Executor("cpu"), fluid.Scope()
    exe.run(startup, scope=scope)
    for i in range(steps):
        exe.run(main, feed=_feed(i), fetch_list=[loss], scope=scope)
    return main, startup, loss, exe, scope


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


# -- io.save / io.load across the packages ------------------------------------

def test_io_save_bytes_equal_the_references(tmp_path):
    """The port's state copied into the reference's scope: both save,
    and the three files are equal byte for byte."""
    main, _, _, _, scope = _trained()
    jmain = _mlp(jfluid)[0]
    jscope = jfluid.Scope()
    for n in _names(main):
        jscope.set_var(n, np.array(scope.find_var(n)))
    with fluid.scope_guard(scope):
        fluid.io.save(main, str(tmp_path / "port" / "m"))
    with jfluid.scope_guard(jscope):
        jfluid.io.save(jmain, str(tmp_path / "ref" / "m"))
    for suffix in (".pdparams", ".pdopt", ".pdmodel"):
        with open(str(tmp_path / "port" / "m") + suffix, "rb") as f:
            got = f.read()
        with open(str(tmp_path / "ref" / "m") + suffix, "rb") as f:
            assert got == f.read(), suffix


def test_io_load_crosses_both_ways(tmp_path):
    main, _, _, exe, scope = _trained()
    want = _params(main, scope)
    with fluid.scope_guard(scope):
        fluid.io.save(main, str(tmp_path / "m"))
    jmain = _mlp(jfluid)[0]
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.io.load(jmain, str(tmp_path / "m"))
    _equal({n: np.asarray(jscope.find_var(n)) for n in want}, want)
    # and back: the reference's files into a fresh port scope
    with jfluid.scope_guard(jscope):
        jfluid.io.save(jmain, str(tmp_path / "r"))
    fresh = fluid.Scope()
    with fluid.scope_guard(fresh):
        assert fluid.io.load(main, str(tmp_path / "r"), executor=exe)
    got = _params(main, fresh)
    _equal(got, want)
    assert all(fresh.find_var(n).device.type == "cpu" for n in got)


def test_io_load_missing_raises_and_strict_false_tolerates(tmp_path):
    msgs = []
    for pkg, kw in ((jfluid, {}), (fluid, {"executor": None})):
        prog = _mlp(pkg)[0]
        missing = str(tmp_path / "nope" / "model")
        with pytest.raises(FileNotFoundError, match="strict=False") as e:
            pkg.io.load(prog, missing, **kw)
        msgs.append(str(e.value))
        assert pkg.io.load(prog, missing, strict=False, **kw) is False
    assert msgs[0] == msgs[1]


# -- atomic tensor_io writes -------------------------------------------------

def test_save_combine_atomic_survives_injected_crash(tmp_path):
    path = str(tmp_path / "w.pdparams")
    old = {"a": np.arange(6, dtype=np.float32).reshape(2, 3)}
    tensor_io.save_combine(path, old)
    faults.arm("io.write")
    with pytest.raises(faults.FaultInjected):
        tensor_io.save_combine(path, {"a": np.zeros((2, 3), np.float32)})
    np.testing.assert_array_equal(tensor_io.load_combine(path)["a"],
                                  old["a"])
    assert [n for n in os.listdir(str(tmp_path)) if ".tmp-" in n] == []


def test_save_combine_atomic_replaces_on_success(tmp_path):
    path = str(tmp_path / "w.pdparams")
    tensor_io.save_combine(path, {"a": np.zeros(3, np.float32)})
    new = {"a": np.ones(3, np.float32), "b": torch.ones(2,
                                                        dtype=torch.bfloat16)}
    tensor_io.save_combine(path, new)
    got = tensor_io.load_combine(path)
    np.testing.assert_array_equal(got["a"], new["a"])
    assert torch.equal(got["b"], new["b"])
    # the reference reads the port's file, and the other way
    np.testing.assert_array_equal(jtio.load_combine(path)["a"], new["a"])


# -- CheckpointManager -----------------------------------------------------------

def test_checkpoint_roundtrip_restores_exact_state(tmp_path):
    main, startup, loss, exe, scope = _trained()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(main, scope, step=3)
    saved, rng = _params(main, scope), scope.generator.get_state()
    (rec,) = mgr.history
    assert rec["step"] == 3 and rec["bytes"] > 0
    assert rec["snapshot_s"] >= 0 and rec["write_s"] >= rec["sha256_s"] >= 0
    fresh = fluid.Scope()
    exe2 = fluid.Executor("cpu")
    exe2.run(startup, scope=fresh)
    assert CheckpointManager(str(tmp_path)).restore(exe2, main,
                                                    scope=fresh) == 3
    _equal(_params(main, fresh), saved)
    assert torch.equal(fresh.generator.get_state(), rng)
    # the two scopes train on alike, to the bit
    a = exe.run(main, feed=_feed(9), fetch_list=[loss], scope=scope)[0]
    b = exe2.run(main, feed=_feed(9), fetch_list=[loss], scope=fresh)[0]
    np.testing.assert_array_equal(a, b)


def test_checkpoint_rotation_keeps_max_to_keep(tmp_path):
    main, _, _, _, scope = _trained(0)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(main, scope, step=s)
    assert mgr.steps() == [3, 4]


def test_torn_checkpoint_detected_and_falls_back(tmp_path):
    main, _, loss, exe, scope = _trained(0)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    mgr.save(main, scope, step=5)
    at5 = _params(main, scope)
    exe.run(main, feed=_feed(0), fetch_list=[loss], scope=scope)
    mgr.save(main, scope, step=10)
    p = os.path.join(mgr._path(10), "params.pdparams")
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) // 2)
    fell = monitor.counter("checkpoint_latest_fallback_total")
    f0 = fell.value
    assert mgr.validate(10) is False and mgr.validate(5) is True
    assert mgr.latest() == 5 and fell.value == f0 + 1
    assert mgr.restore(exe, main, scope=scope) == 5
    _equal(_params(main, scope), at5)
    with pytest.raises(IOError, match="checksum"):
        mgr.restore(exe, main, scope=scope, step=10)


def test_crash_during_version_write_leaves_previous_intact(tmp_path):
    main, _, _, _, scope = _trained(0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(main, scope, step=1)
    # after the data files, before the manifest and the rename; 3 times
    # outlasts the retry's 3 attempts
    faults.arm("io.write", times=3)
    with pytest.raises(faults.FaultInjected):
        mgr.save(main, scope, step=2)
    faults.reset()
    assert mgr.latest() == 1 and mgr.steps() == [1]


def test_background_save_lands_after_wait(tmp_path):
    main, _, _, _, scope = _trained(0)
    mgr = CheckpointManager(str(tmp_path), background=True)
    mgr.save(main, scope, step=7)
    mgr.wait()
    assert mgr.latest() == 7 and mgr.validate(7)


def test_background_save_failure_surfaces_on_wait(tmp_path):
    main, _, _, _, scope = _trained(0)
    mgr = CheckpointManager(str(tmp_path), background=True)
    faults.arm("io.write", times=3)
    mgr.save(main, scope, step=1)
    with pytest.raises(faults.FaultInjected):
        mgr.wait()


def test_background_snapshot_is_taken_before_the_next_step(tmp_path):
    """The snapshot is the caller's: the step after a background save
    does not reach the version."""
    main, _, loss, exe, scope = _trained(2)
    mgr = CheckpointManager(str(tmp_path), background=True)
    mgr.save(main, scope, step=2)
    want = _params(main, scope)
    exe.run(main, feed=_feed(5), fetch_list=[loss], scope=scope)
    mgr.wait()
    fresh = fluid.Scope()
    mgr.restore(exe, main, scope=fresh)
    _equal(_params(main, fresh), want)


def test_restore_on_restart_env_contract(tmp_path, monkeypatch):
    main, _, _, exe, scope = _trained(0)
    mgr = CheckpointManager(str(tmp_path))
    monkeypatch.setenv("PADDLE_RESTART_ATTEMPT", "1")
    assert mgr.restore_on_restart(exe, main, scope=scope) is None
    mgr.save(main, scope, step=4)
    assert mgr.restore_on_restart(exe, main, scope=scope) == 4
    monkeypatch.setenv("PADDLE_RESTART_ATTEMPT", "0")
    assert mgr.restore_on_restart(exe, main, scope=scope) is None


def test_checkpoint_dir_from_env(tmp_path, monkeypatch):
    msgs = []
    for cls in (JCheckpointManager, CheckpointManager):
        monkeypatch.setenv("PADDLE_CHECKPOINT_DIR", str(tmp_path / "cp"))
        assert cls().dirname == str(tmp_path / "cp")
        monkeypatch.delenv("PADDLE_CHECKPOINT_DIR")
        with pytest.raises(ValueError, match="PADDLE_CHECKPOINT_DIR") as e:
            cls()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_restore_with_reshard_names_its_roadmap_item(tmp_path):
    main, _, _, exe, scope = _trained(0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(main, scope, step=1)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 7"):
        mgr.restore(exe, main, scope=scope, strategy=object())


def test_executor_checkpoint_every_n_steps(tmp_path):
    main, _, loss, exe, scope = _trained(0)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=10)
    saves = monitor.counter("checkpoint_saves_total")
    s0 = saves.value
    for i in range(7):
        exe.run(main, feed=_feed(i), fetch_list=[loss], scope=scope,
                checkpoint=(mgr, 3))
    mgr.wait()
    assert mgr.steps() == [3, 6] and saves.value == s0 + 2
    feed = {k: np.stack([_feed(7)[k], _feed(8)[k]]) for k in ("x", "y")}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope, iters=2,
            checkpoint=(mgr, 3))
    mgr.wait()
    assert mgr.steps() == [3, 6, 9]


@pytest.mark.parametrize("arg", [("not a manager",), (object(), 0),
                                 "m", (object(), 1)])
def test_executor_checkpoint_arg_validated_as_reference(arg):
    msgs = []
    for pkg, exe in ((jfluid, jfluid.Executor()),
                     (fluid, fluid.Executor("cpu"))):
        with pytest.raises(ValueError, match="checkpoint") as e:
            exe.run(pkg.Program(), checkpoint=arg)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _reader_mlp(pkg, batches):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = 3
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        reader = pkg.layers.py_reader(capacity=2, shapes=[[3, 4], [3, 1]],
                                      dtypes=["float32", "float32"])
        x, y = pkg.layers.read_file(reader)
        d = pkg.layers.elementwise_sub(pkg.layers.fc(x, 1), y)
        loss = pkg.layers.mean(pkg.layers.elementwise_mul(d, d))
        pkg.optimizer.SGD(0.1).minimize(loss)
    reader.decorate_tensor_provider(lambda: iter(batches))
    return main, startup, reader, loss


def test_py_reader_position_saved_and_resumed(tmp_path):
    """The manifest holds the reader's position, as the reference's; a
    restored run's reader starts at the batch after the version."""
    batches = [(f["x"], f["y"]) for f in map(_feed, range(8))]
    positions = []
    for pkg, cls, exe in ((jfluid, JCheckpointManager, jfluid.Executor()),
                          (fluid, CheckpointManager,
                           fluid.Executor("cpu"))):
        main, startup, reader, loss = _reader_mlp(pkg, batches)
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
        mgr = cls(str(tmp_path / pkg.__name__))
        reader.start()
        for _ in range(5):
            exe.run(main, fetch_list=[loss], scope=scope,
                    checkpoint=(mgr, 2))
        mgr.wait()
        positions.append(mgr.manifest(4)["reader_positions"])
    assert positions[0] == positions[1] == {"py_reader_0.slot0": 4}
    # a restored run reads batch 5 next, and trains as the first did
    main, startup, reader, loss = _reader_mlp(fluid, batches)
    scope, exe = fluid.Scope(), fluid.Executor("cpu")
    exe.run(startup, scope=scope)
    mgr = CheckpointManager(str(tmp_path / fluid.__name__))
    assert mgr.restore(exe, main, scope=scope) == 4
    reader.start()
    assert reader.position == 4
    exe.run(main, fetch_list=[loss], scope=scope)
    assert reader.position == 5


# -- anomaly policies ---------------------------------------------------------

def test_anomaly_skip_step_discards_and_budget_raises():
    main, _, loss, exe, scope = _trained(0)
    flags.set_flags({"FLAGS_anomaly_policy": "skip_step",
                     "FLAGS_anomaly_skip_budget": 2})
    before = _params(main, scope)
    faults.arm("step.nonfinite", after_n=0, times=1)
    exe.run(main, feed=_feed(0), fetch_list=[loss], scope=scope)
    _equal(_params(main, scope), before)
    exe.run(main, feed=_feed(1), fetch_list=[loss], scope=scope)
    after = _params(main, scope)
    assert any(not np.array_equal(after[n], before[n]) for n in before)
    faults.arm("step.nonfinite", after_n=0, times=5)
    exe.run(main, feed=_feed(2), fetch_list=[loss], scope=scope)
    exe.run(main, feed=_feed(3), fetch_list=[loss], scope=scope)
    with pytest.raises(FloatingPointError, match="skip_budget"):
        exe.run(main, feed=_feed(4), fetch_list=[loss], scope=scope)


def test_anomaly_rollback_restores_checkpoint_as_reference(tmp_path):
    """Three steps with a version at step 3, a fourth, then a planted
    non-finite fifth under ``rollback``: the state is the step-3
    version's exactly, generator included, and equals the reference's
    after the same run within rtol."""
    out = []
    for pkg, cls, exe in ((jfluid, JCheckpointManager, jfluid.Executor()),
                          (fluid, CheckpointManager,
                           fluid.Executor("cpu"))):
        main, startup, loss = _mlp(pkg)
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
        if pkg is fluid:
            fluid.copy_scope(init, scope, _names(main), device="cpu")
        else:
            init = jfluid.Scope()
            for n in _names(main):
                init.set_var(n, np.array(scope.find_var(n)))
        mgr = cls(str(tmp_path / pkg.__name__))
        for i in range(3):
            exe.run(main, feed=_feed(i), fetch_list=[loss], scope=scope,
                    checkpoint=(mgr, 3))
        mgr.wait()
        at_ckpt = _params(main, scope)
        rng = scope.generator.get_state() if pkg is fluid else None
        exe.run(main, feed=_feed(3), fetch_list=[loss], scope=scope,
                checkpoint=(mgr, 3))
        pkg.set_flags({"FLAGS_anomaly_policy": "rollback"})
        (faults if pkg is fluid else jfaults).arm("step.nonfinite")
        rolled = monitor.counter("executor_anomaly_rollbacks_total").value
        exe.run(main, feed=_feed(4), fetch_list=[loss], scope=scope,
                checkpoint=(mgr, 3))
        _equal(_params(main, scope), at_ckpt)
        if pkg is fluid:
            assert torch.equal(scope.generator.get_state(), rng)
            assert monitor.counter(
                "executor_anomaly_rollbacks_total").value == rolled + 1
        pkg.set_flags({"FLAGS_anomaly_policy": "raise"})
        out.append(_params(main, scope))
    for n in out[0]:
        np.testing.assert_allclose(out[1][n], out[0][n], rtol=RTOL,
                                   atol=ATOL, err_msg=n)


def test_rollback_on_a_bad_batch_ends_at_the_budget(tmp_path):
    """A batch that makes its step non-finite comes back after each
    rollback (the reader rewinds to the version): the steps committed
    again do not reset the count of discards, so the budget ends the
    run instead of a loop."""
    batches = [(f["x"], f["y"]) for f in map(_feed, range(8))]
    batches[4] = (np.full_like(batches[4][0], np.nan), batches[4][1])
    main, startup, reader, loss = _reader_mlp(fluid, batches)
    scope, exe = fluid.Scope(), fluid.Executor("cpu")
    exe.run(startup, scope=scope)
    mgr = CheckpointManager(str(tmp_path))
    flags.set_flags({"FLAGS_anomaly_policy": "rollback",
                     "FLAGS_anomaly_skip_budget": 2})
    reader.start()
    positions = []
    with pytest.raises(FloatingPointError, match="skip_budget"):
        for _ in range(20):
            exe.run(main, fetch_list=[loss], scope=scope,
                    checkpoint=(mgr, 2))
            positions.append(reader.position)
    # 1-4 commit, 5 rolls back to 4 twice (the third time raises)
    assert positions == [1, 2, 3, 4, 4, 4]
    assert mgr.steps() == [2, 4]


def test_anomaly_rollback_without_checkpoint_is_the_references_error():
    msgs = []
    for pkg, fl, fa, exe in ((jfluid, jflags, jfaults, jfluid.Executor()),
                             (fluid, flags, faults, fluid.Executor("cpu"))):
        main, startup, loss = _mlp(pkg)
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
        fl.set_flags({"FLAGS_anomaly_policy": "rollback"})
        fa.arm("step.nonfinite", after_n=0, times=1)
        with pytest.raises(RuntimeError, match="rollback") as e:
            exe.run(main, feed=_feed(0), fetch_list=[loss], scope=scope)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_real_nonfinite_feed_still_raises_by_default():
    main, _, loss, exe, scope = _trained(0)
    flags.set_flags({"FLAGS_check_nan_inf": True})
    bad = _feed(0)
    bad["x"] = np.full_like(bad["x"], np.nan)
    with pytest.raises(FloatingPointError, match="check_nan_inf"):
        exe.run(main, feed=bad, fetch_list=[loss], scope=scope)


def test_bad_anomaly_policy_rejected():
    flags.set_flags({"FLAGS_anomaly_policy": "explode"})
    with pytest.raises(ValueError, match="anomaly_policy"):
        flags.anomaly_policy()


def test_injected_nonfinite_under_raise_names_the_point():
    msgs = []
    for pkg, fa, exe in ((jfluid, jfaults, jfluid.Executor()),
                         (fluid, faults, fluid.Executor("cpu"))):
        main, startup, loss = _mlp(pkg)
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
        fa.arm("step.nonfinite")
        with pytest.raises(FloatingPointError) as e:
            exe.run(main, feed=_feed(0), fetch_list=[loss], scope=scope)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "step.nonfinite" in msgs[1]


# -- versions across the packages -----------------------------------------------

def test_reference_version_restored_by_the_port(tmp_path, caplog):
    """The reference's version: parameters and Adam moments exactly; its
    threefry key seeds the port's generator by the documented rule
    (the key's first 8 bytes, little-endian, top bit cleared), logged."""
    jmain, jstartup, jloss = _mlp(jfluid)
    jscope, jexe = jfluid.Scope(), jfluid.Executor()
    jexe.run(jstartup, scope=jscope)
    for i in range(3):
        jexe.run(jmain, feed=_feed(i), fetch_list=[jloss], scope=jscope)
    with jfluid.scope_guard(jscope):
        JCheckpointManager(str(tmp_path)).save(jmain, step=3)
    key = np.asarray(jscope.find_var(RNG_STATE_VAR))
    main = _mlp(fluid)[0]
    scope, exe = fluid.Scope(), fluid.Executor("cpu")
    with caplog.at_level(logging.INFO, logger="paddle_tpu_torch.fluid.io"):
        assert CheckpointManager(str(tmp_path)).restore(exe, main,
                                                        scope=scope) == 3
    _equal(_params(main, scope),
           {n: np.asarray(jscope.find_var(n)) for n in _names(main)})
    assert key.dtype == np.uint32 and key.shape == (2,)
    seed = int.from_bytes(key.tobytes()[:8], "little") & (2 ** 63 - 1)
    assert scope.generator.initial_seed() == seed
    assert any("seeded the generator" in r.message for r in caplog.records)


def test_port_version_restored_by_the_reference(tmp_path):
    """The port's version: the reference takes its parameters and
    moments exactly, and its scope's ``@rng_state@`` becomes the port's
    generator state (uint8 bytes), which its next run refuses as a PRNG
    key (TypeError): ROADMAP queue 3's rule."""
    main, _, _, _, scope = _trained()
    CheckpointManager(str(tmp_path)).save(main, scope, step=3)
    want = _params(main, scope)
    jmain, _, jloss = _mlp(jfluid)
    jscope, jexe = jfluid.Scope(), jfluid.Executor()
    with jfluid.scope_guard(jscope):
        assert JCheckpointManager(str(tmp_path)).restore(jexe, jmain) == 3
    _equal({n: np.asarray(jscope.find_var(n)) for n in want}, want)
    rng = np.asarray(jscope.find_var(RNG_STATE_VAR))
    assert rng.dtype == np.uint8
    np.testing.assert_array_equal(rng, scope.generator.get_state().numpy())
    with pytest.raises(TypeError, match="PRNG key"):
        jexe.run(jmain, feed=_feed(3), fetch_list=[jloss], scope=jscope)


# -- preemption drain ---------------------------------------------------------------

_DRAIN_CHILD = r"""
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import faults
from paddle_tpu_torch.fluid.io import CheckpointManager

main, startup = fluid.Program(), fluid.Program()
main.random_seed = 5
with fluid.program_guard(main, startup), fluid.unique_name.guard():
    x = fluid.layers.data("x", shape=[4], dtype="float32")
    loss = fluid.layers.mean(fluid.layers.dropout(fluid.layers.fc(x, 3),
                                                  0.5))
    fluid.optimizer.SGD(0.1).minimize(loss)
exe, scope = fluid.Executor("cpu"), fluid.Scope()
exe.run(startup, scope=scope)
mgr = CheckpointManager(sys.argv[2], max_to_keep=2)
faults.arm("worker.preempt", after_n=int(sys.argv[3]) - 1)
for step in range(1, 20):
    exe.run(main, feed={"x": np.full((2, 4), step, np.float32)},
            fetch_list=[loss], scope=scope, checkpoint=(mgr, 4))
    print("step", step, flush=True)
    faults.check("worker.preempt")
print("never drained", flush=True)
sys.exit(3)
"""


def test_drain_in_a_subprocess(tmp_path):
    """SIGTERM after step 6 (``worker.preempt``): the run after it
    drains before its step, the manager force-saves at step 6, the
    marker lands, the process exits 0."""
    script = tmp_path / "child.py"
    script.write_text(_DRAIN_CHILD)
    env = dict(os.environ, PADDLE_PREEMPT_DRAIN="1",
               PADDLE_HEARTBEAT_DIR=str(tmp_path / "hb"),
               PADDLE_TRAINER_ID="2")
    os.makedirs(str(tmp_path / "hb"))
    proc = subprocess.run(
        [sys.executable, str(script), REPO, str(tmp_path / "ckpt"), "6"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == [w for s in range(1, 7)
                                   for w in ("step", str(s))]
    assert "drained cleanly at step 6" in proc.stderr
    marker = tmp_path / "hb" / "hb.2.preempted"
    assert json.loads(marker.read_text())["reason"] == "signal:SIGTERM"
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.steps() == [4, 6] and mgr.latest() == 6


def test_drain_api_and_marker(tmp_path, monkeypatch):
    """``request_drain`` flips the flag and runs the ``on_drain``
    callbacks; ``check_drain`` force-saves and exits 0."""
    main, _, _, _, scope = _trained(1)
    preemption.reset()
    try:
        hits = []
        preemption.on_drain(lambda: hits.append(1))
        assert not preemption.draining()
        preemption.check_drain()   # nothing to do
        preemption.request_drain("test")
        assert preemption.draining() and hits == [1]
        assert preemption.drain_reason() == "test"
        mgr = CheckpointManager(str(tmp_path / "c"))
        mgr._step = 1
        monkeypatch.setenv("PADDLE_HEARTBEAT_DIR", str(tmp_path))
        with pytest.raises(SystemExit) as e:
            preemption.check_drain(mgr, main, scope)
        assert e.value.code == 0 and mgr.steps() == [1]
        assert os.path.exists(preemption.preempt_marker_path(
            str(tmp_path), 0))
    finally:
        preemption.reset()


# -- resume equals the uninterrupted run -------------------------------------------

def _bert_run(tmp_path, steps, restore=False):
    """BERT-tiny, dropout 0.1, S 16, batch 2, fed by a py_reader over 8
    batches, a version every 3 steps: (losses, final state, generator
    state). ``restore``: first restore the newest version."""
    cfg = bert.BertConfig.tiny()
    with fluid.unique_name.guard():
        main, startup, loss = bert.build_pretrain_program(
            cfg, seq_len=16, py_reader_batch=2)
    batches = [bert.reader_batch(bert.synthetic_batch(cfg, 2, 16, seed=i))
               for i in range(8)]
    main.py_reader.decorate_tensor_provider(lambda: iter(batches))
    exe, scope = fluid.Executor("cpu"), fluid.Scope()
    exe.run(startup, scope=scope)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    start = mgr.restore(exe, main, scope=scope) if restore else 0
    main.py_reader.start()
    losses = [float(exe.run(main, fetch_list=[loss], scope=scope,
                            checkpoint=(mgr, 3))[0].reshape(-1)[0])
              for _ in range(start, steps)]
    return losses, {n: scope.find_var(n).clone()
                    for n in scope.local_var_names()}, \
        scope.generator.get_state()


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """Interrupted after step 4 (the newest version step 3), restored
    and trained to step 7: steps 4-7 and the final state, the Adam
    moments and the generator equal the uninterrupted run's, to the
    bit."""
    want, state, rng = _bert_run(tmp_path / "a", 7)
    _bert_run(tmp_path / "b", 4)
    got, got_state, got_rng = _bert_run(tmp_path / "b", 7, restore=True)
    assert got == want[3:]
    assert sorted(got_state) == sorted(state)
    for n, t in state.items():
        assert torch.equal(got_state[n], t), n
    assert torch.equal(got_rng, rng)
