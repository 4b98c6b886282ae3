"""The port's Transformer and decode sessions
(paddle_tpu_torch/models/transformer.py) held to the JAX package's, at
``Transformer.tiny()`` sizes: the reference model's weights carry across
with ``load_jax_params``, the same numpy requests go through both, and
prefill must match in fp32 (rtol 1e-4, atol 1e-5: same math, other
summation order) while greedy tokens, finished flags and shedding
decisions must be identical."""

import numpy as np
import pytest
import torch

from paddle_tpu.fluid import dygraph
from paddle_tpu.fluid.resilience import Overloaded as JaxOverloaded
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch.fluid import monitor
from paddle_tpu_torch.fluid.dygraph import nn as PN
from paddle_tpu_torch.fluid.resilience import Overloaded
from paddle_tpu_torch.models import transformer as PT

pytestmark = pytest.mark.decode

S, P = 6, 4                 # source and prompt lengths of every request


@pytest.fixture(scope="module")
def models():
    """(reference model, port model carrying the reference's weights)."""
    with dygraph.guard():
        ref = JT.Transformer.tiny()
        arrays = {n: np.array(p.numpy()) for n, p in ref.named_parameters()}
    port = PT.load_jax_params(PT.Transformer.tiny(device="cpu", seed=1),
                              arrays)
    return ref, port


def _requests(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(2, 512, (n, S)).astype(np.int64),
            rng.randint(2, 512, (n, P)).astype(np.int64))


def test_load_jax_params_covers_every_parameter(models):
    ref, port = models
    want = {n: tuple(p.shape) for n, p in ref.named_parameters()}
    got = {n: tuple(p.shape) for n, p in port.named_parameters()}
    assert got == want
    arrays = {n: np.zeros(s, np.float32) for n, s in want.items()}
    del arrays["proj.bias"]
    with pytest.raises(KeyError, match="proj.bias"):
        PT.load_jax_params(PT.Transformer.tiny(device="cpu"), arrays)


def test_prefill_matches_reference(models):
    """Logits, the prompt K/V written into the ring caches and the cross
    K/V of one prefill, against the reference's eager prefill."""
    ref, port = models
    B, C = 2, 8
    L, H, d = 2, 4, 8
    src, prompt = _requests(B, 0)
    feeds = [src, prompt, np.tile(np.arange(S), (B, 1)),
             np.tile(np.arange(P), (B, 1)), JT.make_causal_bias(P),
             np.zeros(B, np.int32)] + \
        [np.zeros((B, H, C, d), np.float32) for _ in range(2 * L)]
    with dygraph.guard():
        ref.eval()
        want = [o.numpy() for o in ref.prefill(
            *[dygraph.to_variable(a) for a in feeds])]
    port.eval()
    with torch.no_grad():
        got = port.prefill(*[torch.from_numpy(np.asarray(a))
                             for a in feeds])
    assert len(got) == len(want) == 1 + 4 * L
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5,
                                   err_msg="prefill output %d" % i)


def test_forward_matches_reference(models):
    """Teacher-forced logits (encoder, causal decoder, projection) with a
    source padding bias, against the reference's eager forward."""
    ref, port = models
    B, T = 2, 5
    src, _ = _requests(B, 4)
    tgt = np.random.RandomState(4).randint(2, 512, (B, T)).astype(np.int64)
    src_bias = np.zeros((B, 1, 1, S), np.float32)
    src_bias[1, ..., 4:] = -1e4
    feeds = [src, tgt, np.tile(np.arange(S), (B, 1)),
             np.tile(np.arange(T), (B, 1)), JT.make_causal_bias(T),
             src_bias]
    with dygraph.guard():
        ref.eval()
        want = ref(*[dygraph.to_variable(a) for a in feeds]).numpy()
    port.eval()
    with torch.no_grad():
        got = port(*[torch.from_numpy(a) for a in feeds])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_dense_generate_token_identical(models):
    """Ragged prompts and 10 new tokens through a ring of capacity 8, so
    every sequence wraps; end_id is a token the first sequence emits
    mid-way, so a finished flag is set and held."""
    ref, port = models
    B, C, new = 3, 8, 10
    src, prompt = _requests(B, 1)
    plens = np.array([4, 3, 2], np.int64)
    probe, _ = PT.build_decode_session(port, B, S, P, C).generate(
        src, prompt, plens, new)
    end_id = int(probe[0, 3])
    got, got_fin = PT.build_decode_session(
        port, B, S, P, C, end_id=end_id).generate(src, prompt, plens, new)
    with dygraph.guard():
        want, want_fin = JT.build_decode_session(
            ref, B, S, P, C, end_id=end_id).generate(src, prompt, plens,
                                                     new)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got_fin, np.asarray(want_fin))
    assert got.dtype == np.int64 and got_fin[0]
    assert (got[0, 4:] == end_id).all()


def _drive(sess, overloaded, src, prompt):
    """One scripted join/step sequence; returns its event log."""
    log = []

    def join(i, plen, budget):
        try:
            slot, done = sess.join(src[i], prompt[i], prompt_len=plen,
                                   max_new_tokens=budget)
        except overloaded:
            log.append(("shed", i))
            return
        log.append(("join", i, slot,
                    None if done is None else list(done[0])))

    def step():
        for slot, toks, fin in sess.step():
            log.append(("done", slot, list(toks), bool(fin)))

    join(0, 3, 9)          # miss: prefill, one page, cached
    join(0, 3, 9)          # hit: aliases the cached page
    join(1, 4, 3)          # miss: second page
    step()                 # slots 0 and 1 split the shared page (COW)
    join(2, 4, 3)          # pool dry -> Overloaded, nothing touched
    while sess.active_count:
        step()             # ring wraps; slot 2 then retires
    join(2, 4, 3)          # pages back: fits now
    join(1, 4, 3)          # hit on the second cached prefix
    while sess.active_count:
        step()
    log.append(("live_pages", sess.pool.live_pages))
    return log


def test_paged_session_token_identical(models, monkeypatch):
    """Paged join/step against the reference's paged session with its
    Pallas paged kernel (interpret mode): prefix hits, copy-on-write
    divergence, typed Overloaded shedding and ring wraparound all give
    the same events and tokens. Pool: 5 pages of 4 tokens (scratch +
    4), capacity 8, so the scripted third join cannot be seated."""
    ref, port = models
    monkeypatch.setenv("PADDLE_TPU_ATTN_FORCE", "paged")
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    src, prompt = _requests(3, 2)
    geometry = dict(batch_size=3, src_len=S, prompt_len=P,
                    cache_capacity=8, end_id=1, page_tokens=4, pool_pages=5,
                    prefix_cache_size=2)
    hits0 = monitor.counter("decode_prefix_hit_total").value
    got = _drive(PT.build_paged_decode_session(port, **geometry),
                 Overloaded, src, prompt)
    hits = monitor.counter("decode_prefix_hit_total").value - hits0
    with dygraph.guard():
        want = _drive(JT.build_paged_decode_session(ref, **geometry),
                      JaxOverloaded, src, prompt)
    assert got == want
    assert ("shed", 2) in got and hits == 2
    # slots 0 and 1 hold one request (a miss and its prefix hit); slot 0
    # retired early for want of a page, slot 1 ran to its budget of 9
    before_rejoin = got[:got.index(("join", 2, 0, None))]
    toks = {e[1]: e[2] for e in before_rejoin if e[0] == "done"}
    assert len(toks[0]) < 9 == len(toks[1])
    assert toks[1][:len(toks[0])] == toks[0]


def test_cuda_device_refused_without_a_card():
    """device="cuda" never quietly runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        PT.Transformer.tiny()


@pytest.mark.parametrize("build", [
    lambda: PN.Linear(4, 4),
    lambda: PN.Embedding([8, 4]),
    lambda: PN.LayerNorm([4], begin_norm_axis=2),
    lambda: PT.MultiHeadAttention(8, 2),
    lambda: PT.FFN(8, 16),
    lambda: PT.EncoderLayer(8, 2, 16),
    lambda: PT.DecoderLayer(8, 2, 16),
], ids=["Linear", "Embedding", "LayerNorm", "MultiHeadAttention", "FFN",
        "EncoderLayer", "DecoderLayer"])
def test_layers_default_to_the_card(build):
    """Every public layer defaults to device="cuda" as the model does, so
    one built without a device raises where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        build()
