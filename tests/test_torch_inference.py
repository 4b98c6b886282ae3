"""The port's inference slice held to the JAX package on the CPU: the
``ProgramDesc`` bytes (paddle_tpu_torch/fluid/core/proto_io.py, a wire
codec of its own), the PTC1 tensor file (core/tensor_io.py),
``fluid.io``'s inference models, ``inference.Predictor`` and the
dynamic-batching ``inference.serving.Server``.

- Bytes: BERT-tiny's programs (packed attention: main, startup and the
  encoder) serialize to the reference's bytes exactly, and each package
  parses the other's to the same desc; PTC1 files are byte-identical
  both ways, bfloat16 included.
- Models: a packed BERT-tiny encoder saved by either package (one file
  per parameter, or one PTC1 file) runs in the other's Predictor with the
  same outputs, rtol 1e-5 and atol 1e-5 (fp32, sums in another order).
- Server: the reference's tests/test_serving.py cases for ``Server``
  against the port's Predictor on a small fc model. The reference's "one
  compile per bucket" is here one warm-up run per bucket: the port's
  eager executor compiles nothing, but the signature counter it keeps
  must not grow past the ladder. The timing cases keep the reference's
  margins (a 2 s batch delay that a deadline must beat by 1 s), which
  passed 10 runs in 10 on a CPU.
"""

import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import inference as JI
from paddle_tpu.fluid.core import proto_io as JP
from paddle_tpu.fluid.core import tensor_io as JT
from paddle_tpu.models import bert as JB
import paddle_tpu_torch.fluid as pfluid
from paddle_tpu_torch import inference as PI
from paddle_tpu_torch.fluid import compat as PC
from paddle_tpu_torch.fluid import framework as PF
from paddle_tpu_torch.fluid import layers as PL
from paddle_tpu_torch.fluid import monitor
from paddle_tpu_torch.fluid.core import proto_io as PP
from paddle_tpu_torch.fluid.core import tensor_io as PT
from paddle_tpu_torch.inference import Closed, Overloaded, ServeConfig, Server
from paddle_tpu_torch.models import bert as PB

TOL = dict(rtol=1e-5, atol=1e-5)
ENC_FEEDS = ["src_ids", "pos_ids", "sent_ids", "input_mask"]
SEQ = 16


def _packed_cfg(B):
    cfg = B.BertConfig.tiny()
    cfg.use_fused_attention = "packed"
    return cfg


def _programs(B, unique_name):
    """BERT-tiny's packed pretraining main and startup programs and its
    packed encoder program, built inside ``unique_name.guard()``."""
    with unique_name.guard():
        main, startup, _ = B.build_pretrain_program(_packed_cfg(B),
                                                    seq_len=SEQ)
    with unique_name.guard():
        enc, _, _ = B.build_encoder_program(_packed_cfg(B), seq_len=SEQ)
    return {"main": main, "startup": startup, "encoder": enc}


@pytest.fixture(scope="module")
def programs():
    return (_programs(JB, jfluid.unique_name),
            _programs(PB, pfluid.unique_name))


@pytest.mark.parametrize("which", ["main", "startup", "encoder"])
def test_program_bytes_match_reference(programs, which):
    ref, port = programs[0][which], programs[1][which]
    want = ref.serialize_to_string()
    got = port.serialize_to_string()
    assert got == want
    assert PP.program_from_bytes(want) == JP.program_from_bytes(want)
    again = PF.Program.parse_from_string(want)
    assert again.to_desc() == port.to_desc()
    # feed and fetch names travel with an inference model's bytes
    desc = port.to_desc()
    desc.update(feed_names=ENC_FEEDS, fetch_names=["out"])
    assert PP.program_to_bytes(desc) == JP.program_to_bytes(desc)
    assert PP.program_from_bytes(JP.program_to_bytes(desc))[
        "fetch_names"] == ["out"]


def test_attr_encodings_match_reference():
    """Every attr kind the reference's encoder knows: empty and bool
    lists, mixed numbers, None, a repr'd dict, defaults inside the oneof,
    negative ints; map keys that extend one another; an empty map value."""
    attrs = {"a": [], "b": [True, False], "c": [1, 2.5], "d": ["x", ""],
             "e": None, "f": (1, 2), "g": 0, "h": 0.0, "i": "", "j": False,
             "k": -3, "l": {"x": 1}, "bias": 1.5, "bias_after_scale": True,
             "n": 1e300}
    desc = {"version": 1, "random_seed": -5, "param_grad_map": {
        "w": "w@GRAD", "w_": "", "a": "a@GRAD"},
        "blocks": [{"idx": 0, "parent_idx": -1, "vars": [
            {"name": "v", "shape": [-1, 0, 3], "dtype": "float32",
             "persistable": True}],
            "ops": [{"type": "scale", "inputs": {"X": ["v"], "Y": []},
                     "outputs": {"Out": ["v"]}, "attrs": attrs}]}]}
    want = JP.program_to_bytes(desc)
    assert PP.program_to_bytes(desc) == want
    assert PP.program_from_bytes(want) == JP.program_from_bytes(want)


def test_load_gate_raises_typed_errors(programs):
    desc = programs[1]["encoder"].to_desc()
    desc["version"] = 2
    with pytest.raises(PC.ProgramVersionError) as e:
        PP.program_from_bytes(PP.program_to_bytes(desc))
    assert e.value.status == PC.CompatibleInfo.UNSUPPORTED_VERSION
    desc["version"] = 1
    desc["blocks"][0]["ops"][0]["type"] = "no_such_op"
    data = PP.program_to_bytes(desc)
    with pytest.raises(PC.ProgramCompatError, match="no_such_op") as e:
        PF.Program.parse_from_string(data)
    assert e.value.status == PC.CompatibleInfo.UNDEFINED_OP
    assert not isinstance(e.value, PC.ProgramVersionError)
    assert PP.program_from_bytes(data, check=False)["blocks"][0]["ops"][0][
        "type"] == "no_such_op"
    assert PC.check_program_compatible(programs[1]["main"])


def test_ptc1_files_byte_identical_both_ways(tmp_path):
    rng = np.random.RandomState(0)
    bf16 = rng.randn(3, 5).astype(np.float32)
    arrays = {"w": rng.randn(4, 3).astype(np.float32),
              "ids": rng.randint(0, 9, (2, 7)).astype(np.int64),
              "mask": rng.rand(5) > 0.5,
              "half": rng.randn(2, 2).astype(np.float16),
              "scalar": np.array(3.5, np.float64),
              "empty": np.zeros((0, 4), np.int32)}
    ref = dict(arrays, bf=bf16.astype(ml_dtypes.bfloat16))
    port = dict(arrays, bf=torch.from_numpy(bf16).to(torch.bfloat16))
    JT.save_combine(str(tmp_path / "ref.ptc"), ref)
    PT.save_combine(str(tmp_path / "port.ptc"), port)
    assert (tmp_path / "ref.ptc").read_bytes() == \
        (tmp_path / "port.ptc").read_bytes()
    got = PT.load_combine(str(tmp_path / "ref.ptc"))
    back = JT.load_combine(str(tmp_path / "port.ptc"))
    assert list(got) == list(ref) == list(back)
    for n, a in arrays.items():
        np.testing.assert_array_equal(got[n], a)
        assert got[n].dtype == a.dtype and back[n].dtype == a.dtype
    assert got["bf"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["bf"].float().numpy(),
                                  back["bf"].astype(np.float32))


def _encoder_feed(batch, seed):
    feed = PB.synthetic_batch(PB.BertConfig.tiny(), batch, SEQ, seed=seed)
    return {n: feed[n] for n in ENC_FEEDS}


def _save_encoder(fluid, B, dirname, exe, params_filename=None):
    with fluid.unique_name.guard():
        main, startup, enc = B.build_encoder_program(_packed_cfg(B),
                                                     seq_len=SEQ)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup, scope=scope)
        return fluid.io.save_inference_model(
            str(dirname), ENC_FEEDS, [enc], exe, main_program=main,
            params_filename=params_filename)


@pytest.mark.parametrize("params_filename", [None, "params"],
                         ids=["per_var", "ptc1"])
def test_inference_model_crosses_both_ways(tmp_path, params_filename):
    feed = _encoder_feed(3, seed=1)
    _save_encoder(jfluid, JB, tmp_path / "ref", jfluid.Executor(),
                  params_filename)
    _save_encoder(pfluid, PB, tmp_path / "port", pfluid.Executor("cpu"),
                  params_filename)
    assert (tmp_path / "ref" / "__model__").read_bytes() == \
        (tmp_path / "port" / "__model__").read_bytes()
    for src in ("ref", "port"):
        d = str(tmp_path / src)
        want = JI.create_predictor(JI.Config(
            d, params_file=params_filename)).run(feed)[0]
        got = PI.create_predictor(PI.Config(
            d, params_file=params_filename, place="cpu")).run(feed)[0]
        assert got.shape == (3, SEQ, 64)
        np.testing.assert_allclose(got, np.asarray(want), err_msg=src, **TOL)


def test_predictor_api(tmp_path):
    _save_encoder(pfluid, PB, tmp_path, pfluid.Executor("cpu"))
    cfg = PI.Config(str(tmp_path), place="cpu")
    cfg.switch_ir_optim(True)
    cfg.enable_memory_optim()
    pred = PI.create_predictor(cfg)
    assert pred.get_input_names() == ENC_FEEDS
    (out_name,) = pred.get_output_names()
    feed = _encoder_feed(2, seed=2)
    with pytest.raises(RuntimeError, match="run\\(\\) has not been called"):
        pred.get_output_handle(out_name).copy_to_cpu()
    for n, a in feed.items():
        pred.get_input_handle(n).copy_from_cpu(a)
    handle_out = pred.run()[0]
    np.testing.assert_array_equal(
        pred.get_output_handle(out_name).copy_to_cpu(), handle_out)
    with pytest.raises(ValueError, match="missing inference feeds"):
        pred.run()              # staged inputs were consumed
    np.testing.assert_allclose(pred.run(feed)[0], handle_out, **TOL)
    clone = pred.clone()
    assert clone._scope is pred._scope and clone.program is pred.program
    np.testing.assert_allclose(clone.run(feed)[0], handle_out, **TOL)
    rec = monitor.counter("predictor_shape_recompile_total")
    before = rec.value
    pred.run(_encoder_feed(4, seed=3))
    assert rec.value == before + 1
    pool = PI.PredictorPool(cfg, size=2)
    assert len(pool) == 2 and pool.retrieve(1)._scope is \
        pool.retrieve(0)._scope
    with pytest.raises(IndexError, match="valid indices"):
        pool.retrieve(2)
    with pytest.raises(ValueError, match="size"):
        PI.PredictorPool(cfg, size=0)
    bf = PI.Config(str(tmp_path), place="cpu")
    bf.enable_bf16()
    low = PI.create_predictor(bf)
    assert low._scope.find_var("word_emb").dtype == torch.bfloat16
    np.testing.assert_allclose(low.run(feed)[0], handle_out, atol=0.1)


def test_prelower_and_default_device(tmp_path):
    with pytest.raises(ValueError, match="no declared shape"):
        pfluid.io.save_inference_model(str(tmp_path / "none"), ["x"], [],
                                       pfluid.Executor("cpu"),
                                       main_program=PF.Program(),
                                       prelower=True)
    exe = pfluid.Executor("cpu")
    with pfluid.unique_name.guard():
        main, startup, enc = PB.build_encoder_program(_packed_cfg(PB),
                                                      seq_len=SEQ)
    scope = pfluid.Scope()
    with pfluid.scope_guard(scope):
        exe.run(startup, scope=scope)
        pfluid.io.save_inference_model(
            str(tmp_path / "pre"), ENC_FEEDS, [enc], exe, main_program=main,
            prelower=True, prelower_batch_sizes=(1, 2))
    assert sorted(f.suffix for f in (tmp_path / "pre" / "__prelowered__")
                  .iterdir()) == [".tplan", ".tplan"]
    if not torch.cuda.is_available():
        _save_encoder(pfluid, PB, tmp_path, pfluid.Executor("cpu"))
        with pytest.raises(RuntimeError, match="CUDA"):
            PI.create_predictor(PI.Config(str(tmp_path)))


def test_mixed_products_promote_only_under_enable_bf16(tmp_path):
    """A Predictor under enable_bf16 (and its clone) multiplies its fp32
    feed by the bf16 weights in fp32, as the reference's jnp.matmul
    promotes them; an executor that does not promote (the training
    executor's default) refuses the same program on the same weights, so
    a cast the AMP rewrite missed cannot run silently in another type."""
    _save_fc(tmp_path)
    full = _predictor(tmp_path)
    bf = PI.Config(str(tmp_path), place="cpu")
    bf.enable_bf16()
    low = PI.create_predictor(bf)
    assert low._scope.find_var("fc_0.w_0").dtype == torch.bfloat16
    feed = {"x": np.random.RandomState(4).randn(5, 6).astype(np.float32)}
    out = low.run(feed)[0]
    np.testing.assert_allclose(out, full.run(feed)[0], atol=2e-2)
    np.testing.assert_array_equal(low.clone().run(feed)[0], out)
    with pytest.raises(RuntimeError, match="dtype"):
        pfluid.Executor("cpu").run(low.program, feed=feed,
                                   fetch_list=low._fetch_vars,
                                   scope=low._scope)


# -- Server over the port's Predictor ------------------------------------------
def _save_fc(tmpdir, seed=21):
    main, startup = PF.Program(), PF.Program()
    main.random_seed = seed
    with pfluid.program_guard(main, startup):
        x = PL.data("x", shape=[6], dtype="float32")
        h = PL.fc(x, size=16, act="gelu")
        prob = PL.softmax(PL.fc(h, size=3))
    exe = pfluid.Executor("cpu")
    scope = pfluid.Scope()
    with pfluid.scope_guard(scope):
        exe.run(startup, scope=scope)
        pfluid.io.save_inference_model(str(tmpdir), ["x"], [prob], exe,
                                       main_program=main)


def _predictor(tmpdir):
    return PI.create_predictor(PI.Config(str(tmpdir), place="cpu"))


def _metric(kind, name, model):
    return getattr(monitor, kind)(name, labels={"model": model})


def test_server_batches_match_direct(tmp_path):
    """Coalesced and padded batches resolve each future to what a direct
    Predictor.run of its rows returns."""
    _save_fc(tmp_path)
    pred, direct = _predictor(tmp_path), _predictor(tmp_path)
    rng = np.random.RandomState(3)
    batches0 = _metric("counter", "serving_batches_total", "fc_t").value
    with Server() as srv:
        srv.register("fc_t", pred,
                     config=ServeConfig(max_batch_size=8,
                                        max_queue_delay_ms=2.0),
                     warmup_feed={"x": rng.rand(1, 6).astype(np.float32)})
        feeds = [rng.rand(rng.randint(1, 5), 6).astype(np.float32)
                 for _ in range(24)]
        futs = [srv.submit("fc_t", {"x": f}) for f in feeds]
        for f, fut in zip(feeds, futs):
            out = fut.result(timeout=60)
            assert out[0].shape == (f.shape[0], 3)
            np.testing.assert_allclose(out[0], direct.run({"x": f})[0],
                                       **TOL)
    assert _metric("counter", "serving_batches_total", "fc_t").value > \
        batches0


def test_mixed_size_stream_one_warmup_per_bucket(tmp_path):
    """After the warm-up ran each ladder size once, no request size adds
    a signature: the recompile counter stays where warm-up left it."""
    _save_fc(tmp_path, seed=22)
    pred = _predictor(tmp_path)
    rng = np.random.RandomState(4)
    with Server() as srv:
        ladder = srv.register(
            "fc_mix", pred,
            config=ServeConfig(max_batch_size=8, max_queue_delay_ms=1.0,
                               max_queue_depth=512),
            warmup_feed={"x": rng.rand(1, 6).astype(np.float32)})
        assert ladder == [1, 2, 4, 8]
        assert len(pred._seen_sigs) == len(ladder)
        before = monitor.counter("predictor_shape_recompile_total").value
        futs = [srv.submit("fc_mix", {"x": rng.rand(rng.randint(1, 9), 6)
                                      .astype(np.float32)})
                for _ in range(40)]
        for fut in futs:
            fut.result(timeout=60)
        assert len(pred._seen_sigs) == len(ladder)
        assert monitor.counter(
            "predictor_shape_recompile_total").value == before
    assert _metric("histogram", "serving_warmup_seconds",
                   "fc_mix").count == 1


def test_overload_sheds_with_typed_error(tmp_path):
    """Past max_queue_depth rows submit sheds with Overloaded; two
    consecutive sheds trip the breaker; queued work still completes."""
    _save_fc(tmp_path, seed=23)
    pred = _predictor(tmp_path)
    row = {"x": np.random.RandomState(5).rand(1, 6).astype(np.float32)}
    shed = _metric("counter", "serving_shed_total", "fc_shed")
    shed0 = shed.value
    srv = Server()
    try:
        srv.register("fc_shed", pred,
                     config=ServeConfig(max_batch_size=8,
                                        max_queue_delay_ms=500.0,
                                        max_queue_depth=4,
                                        breaker_threshold=2,
                                        breaker_reset_s=30.0),
                     warmup_feed=row)
        futs = [srv.submit("fc_shed", row) for _ in range(4)]
        with pytest.raises(Overloaded, match="depth bound"):
            srv.submit("fc_shed", row)
        with pytest.raises(Overloaded):
            srv.submit("fc_shed", row)
        with pytest.raises(Overloaded, match="breaker is open"):
            srv.submit("fc_shed", row)
        assert shed.value - shed0 >= 3
        for fut in futs:
            fut.result(timeout=60)
    finally:
        srv.close()


def test_closed_loop_64_clients(tmp_path):
    """64 client threads: every future resolves to its direct result,
    requests coalesce, the queue drains, and p50/p99 come off the
    latency histogram."""
    _save_fc(tmp_path, seed=24)
    pred = _predictor(tmp_path)
    rng = np.random.RandomState(6)
    xs = [rng.rand(1, 6).astype(np.float32) for _ in range(8)]
    direct = _predictor(tmp_path)
    expect = [direct.run({"x": x})[0] for x in xs]
    n_clients, per_client = 64, 3
    lbl = "load_t"
    reqs0 = _metric("counter", "serving_requests_total", lbl).value
    batches0 = _metric("counter", "serving_batches_total", lbl).value
    e2e = _metric("histogram", "serving_request_seconds", lbl)
    count0 = e2e.count
    errors = []
    with Server() as srv:
        srv.register(lbl, pred,
                     config=ServeConfig(max_batch_size=16,
                                        max_queue_delay_ms=4.0,
                                        max_queue_depth=256),
                     warmup_feed={"x": xs[0]})

        def client(cid):
            try:
                for r in range(per_client):
                    i = (cid + r) % len(xs)
                    out = srv.submit(lbl, {"x": xs[i]}).result(timeout=60)
                    np.testing.assert_allclose(out[0], expect[i], **TOL)
            except BaseException as e:  # collected, asserted empty below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    assert not errors, errors[:3]
    reqs = _metric("counter", "serving_requests_total", lbl).value - reqs0
    batches = _metric("counter", "serving_batches_total", lbl).value - \
        batches0
    assert reqs == n_clients * per_client
    assert 1 <= batches < reqs
    assert _metric("gauge", "serving_queue_depth", lbl).value == 0
    assert e2e.count - count0 == reqs
    assert 0 < e2e.quantile(0.5) <= e2e.quantile(0.99)


def test_server_lifecycle_and_validation(tmp_path):
    _save_fc(tmp_path, seed=25)
    pred = _predictor(tmp_path)
    srv = Server()
    srv.register("fc_life", pred, config=ServeConfig(max_batch_size=4))
    with pytest.raises(ValueError, match="already registered"):
        srv.register("fc_life", pred)
    with pytest.raises(ValueError, match="max_batch_size"):
        srv.submit("fc_life", {"x": np.zeros((5, 6), np.float32)})
    with pytest.raises(ValueError, match="leading"):
        srv.submit("fc_life", {"x": np.zeros((2, 6), np.float32),
                               "y": np.zeros((3, 1), np.float32)})
    with pytest.raises(ValueError, match="exemplar row"):
        srv.register("fc_life2", pred,
                     warmup_feed={"x": np.zeros((2, 6), np.float32)})
    with pytest.raises(ValueError, match="deadline_ms"):
        ServeConfig(deadline_ms=0)
    srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit("fc_life", {"x": np.zeros((1, 6), np.float32)})
    srv.close()


def test_close_is_typed_flushes_and_idempotent(tmp_path):
    """Queued futures flush through the normal dispatch on close;
    submit and register after it raise Closed (a RuntimeError, not
    Overloaded); a second close is a no-op."""
    _save_fc(tmp_path, seed=26)
    pred, direct = _predictor(tmp_path), _predictor(tmp_path)
    rng = np.random.RandomState(8)
    srv = Server()
    srv.register("fc_close", pred,
                 config=ServeConfig(max_batch_size=8,
                                    max_queue_delay_ms=5000.0),
                 warmup_feed={"x": rng.rand(1, 6).astype(np.float32)})
    xs = [rng.rand(1, 6).astype(np.float32) for _ in range(3)]
    futs = [srv.submit("fc_close", {"x": x}) for x in xs]
    srv.close()
    for x, fut in zip(xs, futs):
        np.testing.assert_allclose(fut.result(timeout=10)[0],
                                   direct.run({"x": x})[0], **TOL)
    with pytest.raises(Closed):
        srv.submit("fc_close", {"x": xs[0]})
    with pytest.raises(Closed):
        srv.register("fc_close2", pred)
    assert issubclass(Closed, RuntimeError)
    assert not issubclass(Closed, Overloaded)
    srv.close()
    srv.close()


def test_deadline_aware_batch_close(tmp_path):
    """A 100 ms deadline closes a batch long before its 2 s delay; a full
    bucket closes at once; an expired deadline is shed typed; none of it
    adds a signature."""
    _save_fc(tmp_path, seed=27)
    pred = _predictor(tmp_path)
    rng = np.random.RandomState(9)

    def row():
        return {"x": rng.rand(1, 6).astype(np.float32)}

    with Server() as srv:
        srv.register("fc_dl", pred,
                     config=ServeConfig(max_batch_size=8,
                                        max_queue_delay_ms=2000.0),
                     warmup_feed=row())
        before = monitor.counter("predictor_shape_recompile_total").value
        t0 = time.perf_counter()
        lazy = [srv.submit("fc_dl", row()) for _ in range(2)]
        tight = srv.submit("fc_dl", row(), deadline_ms=100.0)
        for fut in lazy + [tight]:
            fut.result(timeout=10)
        assert time.perf_counter() - t0 < 1.0
        t1 = time.perf_counter()
        full = [srv.submit("fc_dl", row()) for _ in range(8)]
        for fut in full:
            fut.result(timeout=10)
        assert time.perf_counter() - t1 < 1.0
        with pytest.raises(Overloaded, match="deadline"):
            srv.submit("fc_dl", row(), deadline_ms=0.0)
        assert monitor.counter(
            "predictor_shape_recompile_total").value == before
