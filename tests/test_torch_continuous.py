"""Dense continuous batching and greedy self-speculative decoding in the
port (paddle_tpu_torch/models/transformer.py: ``open_stream``,
``ContinuousDecodeSession``, ``decode_step_draft``, ``verify_step``,
``build_speculative_session``, ``SpeculativeDecodeSession``), held to
the JAX package's at ``Transformer.tiny()`` sizes on the CPU.

The reference model, its dense session (``slot_prefill=True``) and its
two speculative sessions (k 3, draft depth 1 and full depth) are built
once for the module, and the reference's weights carry across with
``load_jax_params``. The reference's sessions run its plain decode
attention (capacity 16 is below its Pallas tier's threshold); its
draft and verify steps are also run with its Pallas decode kernel in
interpret mode. Greedy tokens, finished flags, completions and monitor
deltas must be equal; caches within rtol 1e-5 (the same math, summed
in another order). No verify row here has an empty causal window: a
verify step's rows see at least cache_len + 1 >= 2 columns.
"""

import threading
import types

import numpy as np
import pytest
import torch

from paddle_tpu import inference as JI
from paddle_tpu.fluid import dygraph, framework, unique_name
from paddle_tpu.fluid import monitor as jax_monitor
from paddle_tpu.kernels import attention as JA
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch.fluid import monitor
from paddle_tpu_torch.fluid.resilience import Closed
from paddle_tpu_torch.inference import GenerativePredictor, GenerativeServer
from paddle_tpu_torch.models import transformer as PT

pytestmark = pytest.mark.decode

B, S, P, C, K = 3, 6, 4, 16, 3      # width, src, prompt, capacity, k
L, H, D = 2, 4, 8                   # Transformer.tiny: layers, heads, d
NEW = 8
RTOL, ATOL = 1e-5, 1e-6
ATTENTION_OP = "fused_multihead_attention_cache"


def _step_inputs(seed):
    """Numpy inputs of one verify step and one draft step: random caches
    whose rows above each length are stale values the steps must mask,
    lengths that differ by row, and one draft row already finished."""
    rng = np.random.RandomState(seed)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    tlen = np.array([4, 3, 9], np.int32)
    verify = [rng.randint(2, 512, (B, K)).astype(np.int32),
              np.arange(K, dtype=np.int32).reshape(1, -1), tlen] + \
        [f32(B, H, S, D) for _ in range(2 * L)] + \
        [f32(B, H, C, D) for _ in range(2 * L)]
    draft = [rng.randint(2, 512, (B, 1)).astype(np.int32),
             np.array([[False], [True], [False]]),
             np.array([1], np.int32), tlen] + \
        [f32(B, H, S, D) for _ in range(2)] + \
        [f32(B, H, C, D) for _ in range(2)]
    return verify, draft


def _reference_steps(ref, verify, draft, route):
    """The reference's eager verify_step and 1-layer decode_step_draft on
    ``route``: "plain" (its jnp version) or "interpret" (its Pallas
    decode kernel in interpret mode). The attention op's compiled kernels
    are dropped from the tracer's per-op cache first, so it lowers again
    under the route's environment; returns (verify outputs, draft
    outputs, calls of the Pallas decode kernel)."""
    calls = []
    pallas = JA._pallas_attention_decode

    def spy(*args, **kw):
        calls.append(1)
        return pallas(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JA, "_pallas_attention_decode", spy)
        if route == "interpret":
            mp.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
            mp.setenv("PADDLE_TPU_ATTN_FORCE", "decode")
        cache = framework._dygraph_tracer()._fn_cache
        for key in [k for k in cache if k[0] == ATTENTION_OP]:
            del cache[key]
        v = [o.numpy() for o in ref.verify_step(
            *[dygraph.to_variable(a) for a in verify])]
        d = [o.numpy() for o in ref.decode_step_draft(
            *[dygraph.to_variable(a) for a in draft])]
    return v, d, len(calls)


@pytest.fixture(scope="module")
def built():
    """The reference model and its sessions, the port's copies, and the
    reference's draft and verify outputs on both routes."""
    with dygraph.guard(), unique_name.guard():
        ref = JT.Transformer.tiny()
        arrays = {n: np.array(p.numpy()) for n, p in ref.named_parameters()}
        port = PT.load_jax_params(PT.Transformer.tiny(device="cpu", seed=1),
                                  arrays)
        src, prompt, plens = _requests(5, 0)
        # end_id: a token the first request emits mid-way, so finished
        # flags are set and held
        probe, _ = PT.build_decode_session(port, B, S, P, C).generate(
            src[:B], prompt[:B], plens[:B], NEW)
        end_id = int(probe[0, 3])
        ref_sess = JT.build_decode_session(ref, B, S, P, C, end_id=end_id,
                                           slot_prefill=True)
        ref_spec = {Ld: JT.build_speculative_session(ref, ref_sess, k=K,
                                                     draft_layers=Ld)
                    for Ld in (1, L)}
        verify, draft = _step_inputs(3)
        steps = {route: _reference_steps(ref, verify, draft, route)
                 for route in ("plain", "interpret")}
    port_sess = PT.build_decode_session(port, B, S, P, C, end_id=end_id,
                                        slot_prefill=True)
    return types.SimpleNamespace(
        ref=ref, port=port, ref_sess=ref_sess, ref_spec=ref_spec,
        port_sess=port_sess, verify=verify, draft=draft, steps=steps,
        requests=(src, prompt), batch=(src[:B], prompt[:B], plens[:B]))


def _requests(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(2, 512, (n, S)).astype(np.int64),
            rng.randint(2, 512, (n, P)).astype(np.int64),
            np.array([4, 3, 2, 4, 1][:n], np.int64))


# the stream schedule: (request, prompt_len, budget) joins and steps
STREAM_REQUESTS = [(0, 4, 7), (1, 2, 3), (2, 3, 1), (3, 4, 5), (4, 1, 4)]
STREAM_SCRIPT = ["join 0", "join 1", "step", "step",
                 "join 2",      # budget 1: retires at join
                 "join 3",      # joins while 0 and 1 decode
                 "step", "step", "step",   # 1 retires; a slot idles
                 "step", "join 4", "drain"]


def _drive(stream, src, prompt, script=STREAM_SCRIPT):
    """Run ``script`` on ``stream``; the event log and {request: (tokens,
    finished)}."""
    log, slot_of, done = [], {}, {}

    def finish(slot, toks, fin):
        req = slot_of.pop(slot)
        done[req] = (list(toks), bool(fin))
        log.append(("done", slot, req, list(toks), bool(fin)))

    for cmd in script:
        if cmd.startswith("join"):
            req = int(cmd.split()[1])
            _, plen, budget = STREAM_REQUESTS[req]
            slot, out = stream.join(src[req], prompt[req], prompt_len=plen,
                                    max_new_tokens=budget)
            log.append(("join", req, slot, None if out is None
                        else (list(out[0]), bool(out[1]))))
            slot_of[slot] = req
            if out is not None:
                finish(slot, *out)
        else:
            while stream.active_count:
                for slot, toks, fin in stream.step():
                    finish(slot, toks, fin)
                if cmd == "step":
                    break
        log.append(("active", stream.active_count))
    return log, done


STREAM_METRICS = ("decode_slot_join_total", "decode_slot_retire_total",
                  "decode_slot_scatter_dispatch_total", "decode_steps_total")


def _deltas(mon, fn):
    """fn()'s result and the change it made to the stream's counters and
    occupancy histogram (count, sum) in the monitor ``mon``."""
    occ = mon.histogram("decode_slot_occupancy")
    # the sum from zero: a delta of a sum that other tests in this process
    # grew would round differently in the two packages' monitors
    occ._reset_value()
    before = [mon.counter(n).value for n in STREAM_METRICS] + \
        [occ.count, occ.sum]
    out = fn()
    after = [mon.counter(n).value for n in STREAM_METRICS] + \
        [occ.count, occ.sum]
    return out, [a - b for a, b in zip(after, before)]


def test_dense_stream_matches_reference_and_solo_runs(built):
    """Ragged prompts and budgets, a join while others decode, a retire at
    join, an idle slot and end_id: the port's stream gives the reference
    stream's completions, joins, retires, scatters, steps and occupancy,
    and every request's tokens equal its solo run in the port's
    stream."""
    src, prompt = built.requests
    (want, want_done), want_m = _deltas(
        jax_monitor, lambda: _drive(built.ref_sess.open_stream(), src,
                                    prompt))
    stream = built.port_sess.open_stream()
    assert isinstance(stream, PT.ContinuousDecodeSession)
    assert stream.width == B and stream.vacant_slots() == [0, 1, 2]
    (got, got_done), got_m = _deltas(monitor,
                                     lambda: _drive(stream, src, prompt))
    assert got == want
    assert got_m == want_m
    # one scatter per join that decodes (request 2 retired at its join)
    assert got_m[2] == len(STREAM_REQUESTS) - 1
    assert any(fin for _, fin in got_done.values()), "end_id never emitted"
    assert [e[3] is not None for e in got if e[:2] == ("join", 2)] == [True]
    for req in range(len(STREAM_REQUESTS)):
        _, solo = _drive(stream, src, prompt,
                         ["join %d" % req, "drain"])
        assert solo[req] == got_done[req], "request %d" % req


@pytest.mark.parametrize("route", ["plain", "interpret"])
def test_verify_step_matches_reference(built, route):
    """verify_step at k 3 over caches whose rows above each length are
    stale: greedy [B, k] and new_len equal, the written caches within
    RTOL, against the reference on ``route``."""
    want, _, calls = built.steps[route]
    assert (calls > 0) == (route == "interpret")
    with torch.no_grad():
        got = built.port.verify_step(
            *[torch.from_numpy(np.array(a)) for a in built.verify])
    assert got[0].dtype == torch.int32 and got[0].shape == (B, K)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert len(got) == len(want) == 2 + 2 * L
    for i in range(2, 2 + 2 * L):
        np.testing.assert_allclose(got[i].numpy(), want[i], rtol=RTOL,
                                   atol=ATOL, err_msg="cache %d" % i)


@pytest.mark.parametrize("route", ["plain", "interpret"])
def test_decode_step_draft_matches_reference(built, route):
    """decode_step_draft through one of the two layers, with a finished
    row: next token, new_len, finished mask equal, caches within RTOL."""
    _, want, _ = built.steps[route]
    with torch.no_grad():
        got = built.port.decode_step_draft(
            *[torch.from_numpy(np.array(a)) for a in built.draft])
    assert len(got) == len(want) == 5
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(), want[i])
    assert got[0][1, 0] == 1 and got[2][1, 0]
    for i in (3, 4):
        np.testing.assert_allclose(got[i].numpy(), want[i], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("draft_layers", [1, L], ids=["shallow", "full"])
def test_speculative_generate_matches_reference_and_dense(built,
                                                          draft_layers):
    """k 3: the port's tokens and finished flags equal the reference's
    speculative and the port's dense generate; the accepted-token
    histogram moves by the same count and sum as the reference's. The
    one-layer draft is rejected in some rounds, so verify leaves stale
    rows above the rolled-back lengths; the full-depth draft accepts k
    every round."""
    src, prompt, plens = built.batch
    want, want_fin = built.ref_spec[draft_layers].generate(src, prompt,
                                                           plens, NEW)
    dense, dense_fin = built.port_sess.generate(src, prompt, plens, NEW)
    spec = PT.build_speculative_session(built.port, built.port_sess, k=K,
                                        draft_layers=draft_layers)
    hist = monitor.histogram("decode_spec_accepted_tokens")
    ref_hist = jax_monitor.histogram("decode_spec_accepted_tokens")
    c0, s0 = hist.count, hist.sum
    got, got_fin = spec.generate(src, prompt, plens, NEW)
    count, total = hist.count - c0, hist.sum - s0
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got_fin, np.asarray(want_fin))
    np.testing.assert_array_equal(got, dense)
    np.testing.assert_array_equal(got_fin, dense_fin)
    assert got.dtype == np.int64 and got_fin.any()
    c1, s1 = ref_hist.count, ref_hist.sum
    built.ref_spec[draft_layers].generate(src, prompt, plens, NEW)
    assert (count, total) == (ref_hist.count - c1, ref_hist.sum - s1)
    if draft_layers == L:
        assert total == K * count
    else:
        assert total < K * count


def test_errors_match_reference(built):
    """Each of the reference's errors, raised by the port with the same
    type and words."""
    src, prompt, plens = built.batch
    ref_stream = built.ref_sess.open_stream()
    stream = built.port_sess.open_stream()
    for st in (ref_stream, stream):
        with pytest.raises(RuntimeError, match="no active slot"):
            st.step()
        with pytest.raises(ValueError, match="max_new_tokens"):
            st.join(src[0], prompt[0], max_new_tokens=0)
        for plen in (0, P + 1):
            with pytest.raises(ValueError, match="prompt_len must be in"):
                st.join(src[0], prompt[0], prompt_len=plen)
        for b in range(B):
            st.join(src[b], prompt[b], max_new_tokens=3)
        with pytest.raises(RuntimeError, match="no vacant slot"):
            st.join(src[0], prompt[0], max_new_tokens=3)
        while st.active_count:
            st.step()
    for mod, model, sess in ((JT, built.ref, built.ref_sess),
                             (PT, built.port, built.port_sess)):
        with pytest.raises(ValueError, match="k must be >= 2"):
            mod.build_speculative_session(model, sess, k=1)
        for Ld in (0, L + 1):
            with pytest.raises(ValueError, match="draft_layers must be in"):
                mod.build_speculative_session(model, sess, k=K,
                                              draft_layers=Ld)
    for spec in (built.ref_spec[1], PT.build_speculative_session(
            built.port, built.port_sess, k=K, draft_layers=1)):
        with pytest.raises(ValueError, match="must not wrap the KV ring"):
            spec.generate(src, prompt, plens, C - P - K + 1)
        with pytest.raises(ValueError, match="max_new_tokens"):
            spec.generate(src, prompt, plens, 0)
    plain = PT.build_decode_session(built.port, B, S, P, C)
    for open_stream in (
            plain.open_stream,
            lambda: JT.DecodeSession.open_stream(
                types.SimpleNamespace(prefill1_program=None))):
        with pytest.raises(ValueError, match=r"slot_prefill=True"):
            open_stream()


def test_predictor_opens_the_dense_stream():
    """GenerativePredictor(slot_prefill=True).open_stream() is a dense
    ContinuousDecodeSession; without it (and not paged) it refuses; the
    input and output names are the reference's."""
    model = PT.Transformer.tiny(device="cpu", seed=4)
    pred = GenerativePredictor(model, batch_size=2, src_len=S, prompt_len=P,
                               cache_capacity=C, slot_prefill=True,
                               device="cpu")
    assert isinstance(pred.open_stream(), PT.ContinuousDecodeSession)
    plain = GenerativePredictor(model, 2, S, P, C, device="cpu")
    with pytest.raises(ValueError, match="slot_prefill=True"):
        plain.open_stream()
    assert pred.get_input_names() == JI.GenerativePredictor.get_input_names(
        None)
    assert pred.get_output_names() == \
        JI.GenerativePredictor.get_output_names(None)


def test_server_drives_the_dense_stream():
    """GenerativeServer over the dense stream: 8 requests from 4 client
    threads resolve to the tokens each request gets alone in the stream;
    after close, submit raises the typed Closed."""
    src, prompt, _ = _requests(5, 2)
    order = [0, 1, 2, 3, 4, 0, 3, 1]
    plens = [4, 2, 3, 1, 4, 4, 1, 2]
    budgets = [5, 9, 1, 7, 6, 5, 4, 3]
    pred = GenerativePredictor(PT.Transformer.tiny(device="cpu", seed=6),
                               batch_size=3, src_len=S, prompt_len=P,
                               cache_capacity=C, slot_prefill=True,
                               device="cpu")
    stream = pred.open_stream()
    solo = []
    for i, plen, budget in zip(order, plens, budgets):
        slot, out = stream.join(src[i], prompt[i], prompt_len=plen,
                                max_new_tokens=budget)
        while out is None:
            out = next(((t, f) for s, t, f in stream.step() if s == slot),
                       None)
        solo.append(out)
    futs = [None] * len(order)
    with GenerativeServer(stream, model="port-dense") as srv:
        def client(k):
            for j in range(k, len(order), 4):
                futs[j] = srv.submit(src[order[j]], prompt[order[j]],
                                     prompt_len=plens[j],
                                     max_new_tokens=budgets[j])

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        together = [f.result(timeout=300) for f in futs]
    with pytest.raises(Closed):
        srv.submit(src[0], prompt[0])
    assert stream.active_count == 0
    for j, ((tok, fin), (tok1, fin1)) in enumerate(zip(together, solo)):
        assert tok.dtype == np.int64 and len(tok) == budgets[j] or fin
        np.testing.assert_array_equal(tok, tok1, err_msg="request %d" % j)
        assert fin == fin1
