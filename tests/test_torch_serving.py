"""The port's serving tier (paddle_tpu_torch/inference): GenerativeServer
over the paged GenerativePredictor stream, and the dense
GenerativePredictor.run, at ``Transformer.tiny()`` sizes on the CPU."""

import threading

import numpy as np
import pytest

from paddle_tpu_torch.fluid import monitor
from paddle_tpu_torch.fluid.resilience import Closed, Overloaded
from paddle_tpu_torch.inference import GenerativePredictor, GenerativeServer
from paddle_tpu_torch.models.transformer import (PagedDecodeSession,
                                                 Transformer)

pytestmark = pytest.mark.serving

S, P = 6, 8


def _predictor(**kw):
    geometry = dict(batch_size=4, src_len=S, prompt_len=P,
                    cache_capacity=16, end_id=1, paged=True, page_tokens=4,
                    device="cpu")
    geometry.update(kw)
    return GenerativePredictor(Transformer.tiny(device="cpu", seed=3),
                               **geometry)


def _requests(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(2, 512, (n, S)).astype(np.int64),
            rng.randint(2, 512, (n, P)).astype(np.int64),
            rng.randint(2, P + 1, n))


def test_server_resolves_concurrent_requests_like_solo_runs():
    """8 requests from 4 client threads (two repeat an earlier request,
    so the prefix cache hits) all resolve, each with the tokens the same
    request gets alone in the stream."""
    src, prompt, plens = _requests(6, 0)
    order = [0, 1, 2, 3, 4, 5, 0, 3]
    budgets = [5, 9, 3, 7, 6, 4, 5, 7]
    pred = _predictor(prefix_cache_size=4)
    stream = pred.open_stream()
    assert isinstance(stream, PagedDecodeSession)
    hits0 = monitor.counter("decode_prefix_hit_total").value
    futs = [None] * len(order)
    with GenerativeServer(stream, model="port-tiny") as srv:
        def client(k):
            for j in range(k, len(order), 4):
                i = order[j]
                futs[j] = srv.submit(src[i], prompt[i],
                                     prompt_len=int(plens[i]),
                                     max_new_tokens=budgets[j])

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        together = [f.result(timeout=60) for f in futs]
        solo = []
        for j, i in enumerate(order):
            solo.append(srv.submit(src[i], prompt[i],
                                   prompt_len=int(plens[i]),
                                   max_new_tokens=budgets[j]
                                   ).result(timeout=60))
    assert monitor.counter("decode_prefix_hit_total").value - hits0 >= 2
    for j, ((tok, fin), (tok1, fin1)) in enumerate(zip(together, solo)):
        assert tok.dtype == np.int64
        assert len(tok) == budgets[j] or fin
        np.testing.assert_array_equal(tok, tok1, err_msg="request %d" % j)
        assert fin == fin1
    # every slot retired: only the prefix cache still holds pages
    cached = {p for e in stream.prefix_cache._entries.values()
              for p in e.pages}
    assert stream.pool.live_pages == len(cached) > 0


def test_server_sheds_a_request_the_pool_cannot_seat():
    """Pool of 2 usable pages, prompts of 2 pages: while the first
    request decodes (its ring wraps onto its own pages), a second one
    sheds with Overloaded; once the first retires, a third fits."""
    src, prompt, _ = _requests(3, 1)
    pred = _predictor(cache_capacity=8, pool_pages=3)
    shed0 = monitor.counter("serving_shed_total",
                            labels={"model": "port-shed"}).value
    with GenerativeServer(pred.open_stream(), model="port-shed") as srv:
        first = srv.submit(src[0], prompt[0], prompt_len=8,
                           max_new_tokens=20)
        second = srv.submit(src[1], prompt[1], prompt_len=5,
                            max_new_tokens=4)
        with pytest.raises(Overloaded, match="page pool"):
            second.result(timeout=60)
        tokens, _ = first.result(timeout=60)
        third = srv.submit(src[2], prompt[2], prompt_len=5,
                           max_new_tokens=4).result(timeout=60)
    assert len(tokens) >= 1 and len(third[0]) >= 1
    assert monitor.counter("serving_shed_total",
                           labels={"model": "port-shed"}).value - shed0 == 1


def test_server_close_is_typed_and_idempotent():
    srv = GenerativeServer(_predictor().open_stream(), model="port-close")
    srv.close()
    srv.close()
    src, prompt, _ = _requests(1, 2)
    with pytest.raises(Closed):
        srv.submit(src[0], prompt[0])


def test_dense_predictor_run():
    """GenerativePredictor.run is the dense DecodeSession.generate: a
    longer generation extends a shorter one, and positions or token ids
    past the model's tables are refused on the host."""
    src, prompt, plens = _requests(2, 3)
    pred = GenerativePredictor(Transformer.tiny(device="cpu", seed=4),
                               batch_size=2, src_len=S, prompt_len=P,
                               cache_capacity=16, device="cpu")
    with pytest.raises(ValueError, match="paged=True"):
        pred.open_stream()
    toks, fin = pred.run({"src": src, "prompt": prompt,
                          "prompt_lens": plens}, max_new_tokens=6)
    toks2, _ = pred.run({"src": src, "prompt": prompt,
                         "prompt_lens": plens}, max_new_tokens=9)
    assert toks.shape == (2, 6) and toks.dtype == np.int64
    assert fin.shape == (2,) and fin.dtype == bool
    np.testing.assert_array_equal(toks2[:, :6], toks)
    with pytest.raises(ValueError, match="position table"):
        pred.run({"src": src, "prompt": prompt}, max_new_tokens=60)
    bad = src.copy()
    bad[1, 2] = 512
    with pytest.raises(ValueError, match="vocabulary"):
        pred.run({"src": bad, "prompt": prompt}, max_new_tokens=2)


def test_monitor_and_breaker_match_reference():
    """The port's copies of the histogram quantile and the admission
    breaker behave as the reference's on the same inputs."""
    from paddle_tpu.fluid import monitor as jax_monitor
    from paddle_tpu.fluid import resilience as jax_resilience
    from paddle_tpu_torch.fluid import resilience

    obs = np.random.RandomState(5).lognormal(-4.0, 1.5, 300)
    ours = monitor.Histogram("h")
    ref = jax_monitor.Histogram("h")
    for v in obs:
        ours.observe(v)
        ref.observe(v)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert ours.quantile(q) == ref.quantile(q)
    assert (ours.count, ours.sum) == (ref.count, ref.sum)

    def trace(cls):
        now = [0.0]
        br = cls(failure_threshold=2, reset_timeout=1.0, name="parity",
                 clock=lambda: now[0])
        seen = []
        for op, dt in [("fail", 0), ("allow", 0), ("fail", 0),
                       ("allow", 0.5), ("allow", 0.6), ("allow", 0),
                       ("fail", 0), ("allow", 1.0), ("ok", 0),
                       ("allow", 0)]:
            now[0] += dt
            if op == "fail":
                br.record_failure()
            elif op == "ok":
                br.record_success()
            else:
                seen.append(br.allow())
            seen.append(br.state)
        return seen

    assert trace(resilience.CircuitBreaker) == \
        trace(jax_resilience.CircuitBreaker)
