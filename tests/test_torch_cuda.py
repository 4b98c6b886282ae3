"""paddle_tpu_torch on the card: each CUDA kernel against its plain
PyTorch version, and the decode sessions and a BERT-tiny training step
on the card against the same on the CPU; DeepFM's sparse step graphed
against eager, its untouched rows and an out-of-range id; dygraph on the
card by default, and a traced Transformer-tiny's AMP step graphed against
eager and its first loss against the eager dygraph loss; the host
embedding tier's in-place admission, its prefetched rows waited on, and a
stager-fed loop against an unstaged one; a py_reader's prefetched
windows waited on behind a slow copy, a rollback into a graphed step,
and recompute graphed against eager and against no recompute; beam
search with planted ties against the CPU, the learning-rate step counter
across graph replays, a gru_unit step graphed against eager, a LoD
program (sequence_conv, dynamic_lstm, sequence_pool) replaying batches of
other lengths equal to eager and near the CPU, and graphed against eager
to the bit: the GRU + CRF tagger's step, a warpctc step, and the sampled
losses (nce, sampled softmax, hsigmoid) with a cudnn LSTM's dropout,
whose draws come from the generator in the graph. Every
test needs a CUDA device
and skips without one. This file imports neither jax nor paddle_tpu, so it also runs on a
machine without them, skipping the suite's conftest (which imports jax):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: fp32 atol 2e-5 (fp32 accumulation in another order), bf16
and fp16 atol 2e-2 (inputs rounded to 16 bits, fp32 accumulation; 3e-2
of the largest magnitude for the fused attention's gradients, or
chip_smoke.py's LONG_RTOL relative to it); the paged kernel
equals the dense kernel on the gathered cache to 1e-6; greedy tokens of
the fp32 sessions (TF32 off) are identical on both devices."""

import os

import numpy as np
import pytest
import torch

import chip_smoke as smoke
from paddle_tpu_torch.kernels import attention as A
from paddle_tpu_torch.models import transformer as T

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("Q,C,lens,causal", [
    (1, 1024, [1, 64, 96, 1024], False),
    (1, 1000, [999, 1000, 1500, 3], False),     # ragged, wrapped
    (4, 256, [2, 4, 100, 256], True),           # incl. an empty window
])
def test_decode_kernel_matches_plain(cuda_device, dtype, atol, Q, C, lens,
                                     causal):
    g = torch.Generator(device=cuda_device).manual_seed(C)
    B, H, d = len(lens), 16, 64
    q, k, v = (torch.randn(*s, device=cuda_device, generator=g).to(dtype)
               for s in ((B, H, Q, d), (B, H, C, d), (B, H, C, d)))
    cache_len = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    n0 = A.decode_attention_kernel.launches
    got = A.attention_with_cache(q, k, v, cache_len, causal_window=causal)
    want = A._ref_attention_cache(q, k, v, cache_len, d ** -0.5,
                                  causal_window=causal)
    torch.cuda.synchronize()
    assert A.decode_attention_kernel.launches == n0 + 1
    assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.parametrize("dtype,atol,d", [(torch.float32, 2e-5, 8),
                                          (torch.float32, 2e-5, 128),
                                          (torch.bfloat16, 2e-2, 16),
                                          (torch.bfloat16, 2e-2, 128)])
def test_decode_kernel_head_widths(cuda_device, dtype, atol, d):
    """The narrowest and widest rows the kernel takes (2 and 32 lanes
    per row), over tails of 1 and 63 columns and a wrapped ring."""
    g = torch.Generator(device=cuda_device).manual_seed(d)
    B, H, C = 4, 2, 320
    q, k, v = (torch.randn(*s, device=cuda_device, generator=g).to(dtype)
               for s in ((B, H, 1, d), (B, H, C, d), (B, H, C, d)))
    cache_len = torch.tensor([1, 65, 319, 700], dtype=torch.int32,
                             device=cuda_device)
    got = A.attention_with_cache(q, k, v, cache_len)
    want = A._ref_attention_cache(q, k, v, cache_len, d ** -0.5)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= atol


def test_paged_kernel_matches_plain_and_dense(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    B, H, d, ptok, npages, P = 8, 16, 64, 128, 8, 25
    k_pool, v_pool = (torch.randn(P, H, ptok, d, device=cuda_device,
                                  generator=g) for _ in range(2))
    q = torch.randn(B, H, 1, d, device=cuda_device, generator=g)
    table = torch.zeros(B, npages, dtype=torch.int32, device=cuda_device)
    table[0] = torch.arange(1, 9)
    table[1, :3] = torch.tensor([12, 9, 20])
    cache_len = torch.tensor([1024, 300, 1, 1, 1, 1, 1, 1],
                             dtype=torch.int32, device=cuda_device)
    n0 = A.paged_attention_kernel.launches
    got = A.paged_attention_cache(q, k_pool, v_pool, table, cache_len)
    kd, vd = (A.gather_paged_cache(p, table).contiguous()
              for p in (k_pool, v_pool))
    want = A._ref_attention_cache(q, kd, vd, cache_len, d ** -0.5)
    dense = A.attention_with_cache(q, kd, vd, cache_len)
    torch.cuda.synchronize()
    assert A.paged_attention_kernel.launches == n0 + 1
    assert (got - want).abs().max().item() <= 2e-5
    assert (got - dense).abs().max().item() <= 1e-6


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_decode_kernels_at_forced_pieces(cuda_device, splits, dtype, atol):
    """Both kernels with the key axis cut into a forced count of pieces
    (capacity 1024: pieces of 1024, 512, 384 and 128 columns), against
    the plain version: slots of length 1, one inside a page, one across
    three, a wrapped ring and a full one; at Q 4 speculative verify rows,
    two of them with empty windows. The paged kernel on a permuted pool
    equals the dense kernel on the gathered cache bit for bit, and each
    wrapper counts one launch a call."""
    g = torch.Generator(device=cuda_device).manual_seed(splits)
    B, H, d, ptok, npages = 6, 4, 64, 128, 8
    C = ptok * npages
    assert A.decode_pieces(B, H, 1, C, d, dtype, 132, splits=splits)[1] \
        == splits
    lens = torch.tensor([1, 100, 300, 1024, 1500, 1], dtype=torch.int32,
                        device=cuda_device)
    P = B * npages + 1
    pools = [torch.randn(P, H, ptok, d, device=cuda_device,
                         generator=g).to(dtype) for _ in range(2)]
    table = (torch.randperm(P - 1, device=cuda_device, generator=g)[
        :B * npages] + 1).to(torch.int32).view(B, npages)
    kd, vd = (A.gather_paged_cache(p, table).contiguous() for p in pools)
    for Q, causal, cache_len in (
            (1, False, lens),
            (4, True, torch.tensor([2, 3, 100, 1024, 700, 5],
                                   dtype=torch.int32, device=cuda_device))):
        q = torch.randn(B, H, Q, d, device=cuda_device, generator=g).to(dtype)
        n0 = (A.decode_attention_kernel.launches,
              A.paged_attention_kernel.launches)
        got = A.decode_attention_kernel(q, kd, vd, cache_len, d ** -0.5,
                                        causal, _splits=splits)
        want = A._ref_attention_cache(q, kd, vd, cache_len, d ** -0.5,
                                      causal)
        torch.cuda.synchronize()
        assert (got.float() - want.float()).abs().max().item() <= atol
        if causal:
            assert A.decode_attention_kernel.launches == n0[0] + 1
            continue
        paged = A.paged_attention_kernel(q, *pools, table, cache_len,
                                         d ** -0.5, _splits=splits)
        torch.cuda.synchronize()
        assert (A.decode_attention_kernel.launches,
                A.paged_attention_kernel.launches) == (n0[0] + 1, n0[1] + 1)
        assert torch.equal(paged, got)


@pytest.mark.parametrize("longest", [1, 100, 300, 1024, 1500])
def test_decode_kernels_at_the_hosts_longest(cuda_device, longest):
    """The rule's own pieces at a batch that splits (6 slots of 4 heads),
    cut over the longest length the host passes: one piece at 1 and 100,
    three where the rows run past it (300: the last piece runs on to the
    capacity), eight at 1024 and past it; against the plain version, and
    the paged kernel on a permuted pool bit for bit equal to the dense
    kernel on the gathered cache at the same length."""
    g = torch.Generator(device=cuda_device).manual_seed(longest)
    B, H, d, ptok, npages = 6, 4, 64, 128, 8
    P = B * npages + 1
    pools = [torch.randn(P, H, ptok, d, device=cuda_device, generator=g)
             for _ in range(2)]
    table = (torch.randperm(P - 1, device=cuda_device, generator=g)[
        :B * npages] + 1).to(torch.int32).view(B, npages)
    kd, vd = (A.gather_paged_cache(p, table).contiguous() for p in pools)
    q = torch.randn(B, H, 1, d, device=cuda_device, generator=g)
    lens = torch.tensor([1, 100, 300, 1024, 1500, 1], dtype=torch.int32,
                        device=cuda_device)
    got = A.decode_attention_kernel(q, kd, vd, lens, d ** -0.5,
                                    longest=longest)
    paged = A.paged_attention_kernel(q, *pools, table, lens, d ** -0.5,
                                     longest=longest)
    want = A._ref_attention_cache(q, kd, vd, lens, d ** -0.5)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 2e-5
    assert torch.equal(paged, got)


def test_decode_library_refuses_what_the_host_did_not_plan(cuda_device):
    """The library takes the q-rows a block the host decided
    (``decode_block_rows``) and refuses a count it has no kernel for;
    rows past 2048 bytes refuse a forced count of pieces."""
    q = torch.zeros(1, 1, 3, 64, device=cuda_device)
    k = torch.zeros(1, 1, 256, 64, device=cuda_device)
    lens = torch.ones(1, dtype=torch.int32, device=cuda_device)
    out = torch.empty_like(q)
    fn = A._entry("pt_decode_attention_f32", 6, 9)
    with torch.cuda.device(cuda_device):
        for rows, refused in ((A.decode_block_rows(3, 256), False),
                              (3, True)):
            rc = fn(q.data_ptr(), k.data_ptr(), k.data_ptr(),
                    lens.data_ptr(), out.data_ptr(), None, 1, 1, 3, 64,
                    256, 0, 256, 1, rows, 1.0, A._stream(cuda_device))
            assert (rc != 0) == refused, rows
    torch.cuda.synchronize()
    q = torch.zeros(1, 1, 1, 640, device=cuda_device)
    k = torch.zeros(1, 1, 256, 640, device=cuda_device)
    with pytest.raises(ValueError, match="one piece"):
        A.decode_attention_kernel(q, k, k, lens, 1.0, _splits=2)


def test_kernel_wrapper_refuses_what_it_cannot_take(cuda_device):
    """What the decode wrapper refuses (a wrong length type, strided
    caches, float64), and what it used to refuse and now takes, matching
    the plain version: a 2052-byte row (fp32 d 513: two column chunks),
    float16 rows, 192-byte rows (fp32 d 48: twelve 16-byte pieces on
    sixteen lanes), a 24-byte row (fp32 d 6, copied element by element),
    a 1024-byte row (fp32 d 256: two pieces a lane) and a cache that
    starts off a 16-byte boundary (element by element)."""
    q = torch.zeros(1, 1, 1, 64, device=cuda_device)
    lens = torch.ones(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError, match="cache_len"):
        A.decode_attention_kernel(q, q, q, lens.long(), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        kc = torch.zeros(1, 1, 64, 2, device=cuda_device).transpose(2, 3)
        A.decode_attention_kernel(q, kc, kc, lens, 1.0)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        A.decode_attention_kernel(q.double(), q.double(), q.double(), lens,
                                  1.0)
    g = torch.Generator(device=cuda_device).manual_seed(48)
    q513, k513 = (torch.randn(1, 1, n, 513, device=cuda_device, generator=g)
                  for n in (1, 3))
    lens3 = torch.full((1,), 3, dtype=torch.int32, device=cuda_device)
    got = A.decode_attention_kernel(q513, k513, k513, lens3, 513 ** -0.5)
    want = A._ref_attention_cache(q513, k513, k513, lens3, 513 ** -0.5)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 2e-5
    kc = torch.randn(80 * 64 + 1, device=cuda_device,
                     generator=g)[1:].view(1, 1, 80, 64)
    lens = torch.tensor([70], dtype=torch.int32, device=cuda_device)
    got = A.decode_attention_kernel(q + 1, kc, kc, lens, 0.125)
    want = A._ref_attention_cache(q + 1, kc, kc, lens, 0.125)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 2e-5
    lens = torch.tensor([1, 70], dtype=torch.int32, device=cuda_device)
    for dtype, d, atol in ((torch.float16, 64, 2e-2),
                           (torch.float32, 48, 2e-5),
                           (torch.float32, 6, 2e-5),
                           (torch.float32, 256, 2e-5)):
        q, k, v = (torch.randn(*s, device=cuda_device, generator=g)
                   .to(dtype) for s in ((2, 3, 1, d), (2, 3, 80, d),
                                        (2, 3, 80, d)))
        got = A.decode_attention_kernel(q, k, v, lens, d ** -0.5)
        want = A._ref_attention_cache(q, k, v, lens, d ** -0.5)
        torch.cuda.synchronize()
        assert (got.float() - want.float()).abs().max().item() <= atol


# rows the decode kernels take since their lanes round up to a power of
# two: 16 bytes on one lane (bf16 d 8), 48 bytes on four (bf16 d 24:
# three pieces), 192 bytes on sixteen (fp32 d 48, bf16 d 96: twelve
# pieces), and float16; rows that are not a multiple of 16 bytes (fp32 d
# 6, bf16 d 12, fp16 d 300: element-by-element copies), rows past 512
# bytes (fp32 d 192 and 512, bf16 d 512: 32 lanes of 2 or 4 pieces) and
# rows past 2048 bytes, split across blocks in 2048-byte column chunks
# (fp32 d 640 and bf16 d 1536: 2560 and 3072 bytes; fp32 d 641 and fp16
# d 1300, copied element by element)
@pytest.mark.parametrize("dtype,atol,d", [(torch.bfloat16, 2e-2, 8),
                                          (torch.bfloat16, 2e-2, 24),
                                          (torch.float32, 2e-5, 48),
                                          (torch.bfloat16, 2e-2, 96),
                                          (torch.float16, 2e-2, 64),
                                          (torch.float32, 2e-5, 6),
                                          (torch.bfloat16, 2e-2, 12),
                                          (torch.float16, 2e-2, 300),
                                          (torch.float32, 2e-5, 192),
                                          (torch.float32, 2e-5, 512),
                                          (torch.bfloat16, 2e-2, 512),
                                          (torch.float32, 2e-5, 640),
                                          (torch.bfloat16, 2e-2, 1536),
                                          (torch.float32, 2e-5, 641),
                                          (torch.float16, 2e-2, 1300)])
def test_decode_kernels_take_any_16_byte_row(cuda_device, dtype, atol, d):
    """The dense and paged kernels at row widths that are not a power of
    two of 16-byte pieces, against the plain version, over tails of 1
    and 63 columns and a wrapped ring; the paged kernel equals the dense
    one on the gathered cache."""
    g = torch.Generator(device=cuda_device).manual_seed(d)
    B, H, C = 4, 2, 320
    q, k, v = (torch.randn(*s, device=cuda_device, generator=g).to(dtype)
               for s in ((B, H, 1, d), (B, H, C, d), (B, H, C, d)))
    cache_len = torch.tensor([1, 65, 319, 700], dtype=torch.int32,
                             device=cuda_device)
    n0 = (A.decode_attention_kernel.launches,
          A.paged_attention_kernel.launches)
    got = A.attention_with_cache(q, k, v, cache_len)
    want = A._ref_attention_cache(q, k, v, cache_len, d ** -0.5)
    ptok = 64
    table = torch.arange(B * C // ptok, dtype=torch.int32,
                         device=cuda_device).view(B, C // ptok)
    pool = [t.view(B, H, C // ptok, ptok, d).permute(0, 2, 1, 3, 4)
            .reshape(B * C // ptok, H, ptok, d).contiguous() for t in (k, v)]
    paged = A.paged_attention_cache(q, *pool, table, cache_len)
    torch.cuda.synchronize()
    assert (A.decode_attention_kernel.launches,
            A.paged_attention_kernel.launches) == (n0[0] + 1, n0[1] + 1)
    assert (got.float() - want.float()).abs().max().item() <= atol
    assert (paged.float() - got.float()).abs().max().item() <= 1e-6


def test_padded_session_rows_on_card_match_cpu(cuda_device):
    """A model of head width 6 (fp32, 24-byte rows): the dense and paged
    sessions pad their caches' rows to 8 elements (32 bytes) and give
    the same greedy tokens on the card as on the CPU; the caches' padded
    columns stay zero."""
    rng = np.random.RandomState(6)
    B, S, P, C = 2, 6, 4, 16
    src = rng.randint(2, 512, (B, S))
    prompt = rng.randint(2, 512, (B, P))
    plens = np.array([4, 2])
    out = {}
    for name, dev in (("cpu", "cpu"), ("card", cuda_device)):
        model = T.Transformer(512, 512, d_model=24, n_heads=4, d_inner=48,
                              n_layers=2, max_len=64, device="cpu",
                              seed=6).to(dev)
        sess = T.build_decode_session(model, B, S, P, C)
        assert sess._caches[0].shape[-1] == 8
        dense, _ = sess.generate(src, prompt, plens, 8)
        assert not any(c[..., 6:].any() for c in sess._caches)
        paged = T.build_paged_decode_session(model, B, S, P, C,
                                             page_tokens=4)
        done = {}
        for b in range(B):
            slot, ready = paged.join(src[b], prompt[b],
                                     prompt_len=int(plens[b]),
                                     max_new_tokens=8)
            if ready is not None:
                done[slot] = ready[0]
        while paged.active_count:
            for slot, toks, _ in paged.step():
                done[slot] = toks
        out[name] = (dense, [list(done[b]) for b in range(B)])
    np.testing.assert_array_equal(out["card"][0], out["cpu"][0])
    assert out["card"][1] == out["cpu"][1]


def test_sessions_on_card_match_cpu(cuda_device):
    """The tiny model's dense and paged sessions give the same greedy
    tokens on the card (kernels) as on the CPU (plain versions)."""
    rng = np.random.RandomState(0)
    B, S, P, C = 3, 6, 4, 16
    src = rng.randint(2, 512, (B, S))
    prompt = rng.randint(2, 512, (B, P))
    plens = np.array([4, 3, 2])
    cpu = T.Transformer.tiny(device="cpu", seed=7)
    card = T.Transformer.tiny(device="cpu", seed=7).to(cuda_device)
    out = {}
    for name, model in (("cpu", cpu), ("card", card)):
        dense, _ = T.build_decode_session(model, B, S, P, C).generate(
            src, prompt, plens, 12)
        paged = T.build_paged_decode_session(model, B, S, P, C,
                                             page_tokens=4)
        done = {}
        for b in range(B):
            slot, ready = paged.join(src[b], prompt[b],
                                     prompt_len=int(plens[b]),
                                     max_new_tokens=12)
            if ready is not None:
                done[slot] = ready[0]
        while paged.active_count:
            for slot, toks, _ in paged.step():
                done[slot] = toks
        out[name] = (dense, [list(done[b]) for b in range(B)])
    np.testing.assert_array_equal(out["card"][0], out["cpu"][0])
    assert out["card"][1] == out["cpu"][1]


@pytest.mark.parametrize("longest,splits", [(132, None), (None, 1),
                                            (None, 2), (None, 8)])
def test_verify_window_on_the_decode_kernel(cuda_device, longest, splits):
    """The speculative verify step's shape on the dense kernel: Q 4 rows
    under the causal window, fp32, lengths on both sides of 128 columns
    (the rule cuts 132 columns into pieces of 128 here, so a row's
    window may end in either piece) and one rolled-back row of length
    68, whose rejected rows above it hold values 100 times the live
    ones, as every row above a length does here; at the rule's pieces
    for the host's longest length and at forced counts over the
    capacity, against the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    B, H, Q, C, d = 9, 16, 4, 1024, 64
    lens = list(range(125, 133)) + [68]
    q, k, v = (torch.randn(*s, device=cuda_device, generator=g)
               for s in ((B, H, Q, d), (B, H, C, d), (B, H, C, d)))
    cache_len = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    stale = (torch.arange(C, device=cuda_device).view(1, C) >=
             cache_len.view(B, 1)).view(B, 1, C, 1)
    k, v = (torch.where(stale, 100 * t, t) for t in (k, v))
    if longest is not None:
        assert A.decode_pieces(B, H, Q, C, d, torch.float32,
                               A._sm_count(q.device), longest) == (128, 2)
    got = A.decode_attention_kernel(q, k, v, cache_len, d ** -0.5, True,
                                    longest=longest, _splits=splits)
    want = A._ref_attention_cache(q, k, v, cache_len, d ** -0.5, True)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 2e-5


def test_stream_and_speculative_on_card_match_dense(cuda_device):
    """Transformer.tiny on the card: a short dense stream (a retire at
    join, idle slots, a join while a slot decodes) gives each request
    the dense session's tokens, and speculative generate at k 3 with
    draft depth 1 and 2 equals the dense generate; the draft and verify
    steps launch the decode kernel."""
    rng = np.random.RandomState(0)
    B, S, P, C = 3, 6, 4, 16
    src = rng.randint(2, 512, (B, S))
    prompt = rng.randint(2, 512, (B, P))
    plens = np.array([4, 3, 2])
    model = T.Transformer.tiny(device="cpu", seed=7).to(cuda_device)
    sess = T.build_decode_session(model, B, S, P, C, slot_prefill=True)
    dense, dense_fin = sess.generate(src, prompt, plens, 8)
    for Ld in (1, 2):
        spec = T.build_speculative_session(model, sess, k=3,
                                           draft_layers=Ld)
        n0 = A.decode_attention_kernel.launches
        toks, fin = spec.generate(src, prompt, plens, 8)
        assert A.decode_attention_kernel.launches > n0
        np.testing.assert_array_equal(toks, dense)
        np.testing.assert_array_equal(fin, dense_fin)
    stream = sess.open_stream()
    done = {}
    for b, budget in ((0, 8), (1, 1)):
        slot, out = stream.join(src[b], prompt[b], prompt_len=int(plens[b]),
                                max_new_tokens=budget)
        if out is not None:
            done[b] = list(out[0])
    slots = {0: 0}
    stream.step()
    slot, _ = stream.join(src[2], prompt[2], prompt_len=int(plens[2]),
                          max_new_tokens=8)
    slots[slot] = 2
    while stream.active_count:
        for slot, toks, _ in stream.step():
            done[slots.pop(slot)] = list(toks)
    assert done == {0: list(dense[0]), 1: list(dense[1, :1]),
                    2: list(dense[2])}


def _attn_inputs(dev, dtype, B, H, S, d, bias_shape, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(B, H, S, d, device=dev, generator=g)
                   .to(dtype) for _ in range(4))
    bias = None
    if bias_shape is not None:
        bias = torch.randn(*bias_shape, device=dev, generator=g) * 2.0
        # mask a few key columns the way a padding mask does
        bias[..., -3:] = -1e4
    return q, k, v, do, bias


def _grads(fn, q, k, v, bias, do):
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    if bias is not None:
        leaves.append(bias.detach().clone().requires_grad_(True))
    out = fn(*leaves[:3], leaves[3] if bias is not None else None)
    grads = torch.autograd.grad(out, leaves, do)
    return [out.detach()] + [g.float() for g in grads]


# fp32: kernel and plain differ in summation order only; bf16: the inputs
# are bf16 in both, the plain version rounds p and the products to bf16
# in other places, so the limit scales with the values (dq/dk carry
# |scale * ds * k| sums over S columns)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("B,H,S,d,bias_shape,p", [
    (2, 3, 128, 64, (2, 1, 1, 128), 0.0),        # the path's padding mask
    (2, 3, 128, 64, (2, 1, 1, 128), 0.1),        # with dropout
    (2, 3, 100, 64, (2, 3, 100, 100), 0.1),      # per-head rows, ragged S
    (2, 3, 77, 32, (2, 1, 77, 77), 0.0),         # head-broadcast rows
    (2, 3, 64, 16, (2, 3, 1, 64), 0.2),          # per-head, row-broadcast
    (1, 2, 200, 128, (1, 1, 1, 200), 0.0),       # widest head
    (2, 2, 65, 64, None, 0.0),                   # no bias, one-column tail
])
def test_fused_attention_kernels_match_plain(cuda_device, dtype, atol, B, H,
                                             S, d, bias_shape, p):
    q, k, v, do, bias = _attn_inputs(cuda_device, dtype, B, H, S, d,
                                     bias_shape, S + d)
    seed = torch.tensor([S * 7919 + 3], dtype=torch.int64,
                        device=cuda_device)
    n0 = (A.fused_attention_fwd_kernel.launches,
          A.fused_attention_bwd_dq_kernel.launches,
          A.fused_attention_bwd_dkdv_kernel.launches)
    got = _grads(lambda q_, k_, v_, b_: A.fused_attention(
        q_, k_, v_, b_, dropout_prob=p, seed=seed), q, k, v, bias, do)
    want = _grads(lambda q_, k_, v_, b_: A._ref_fused_attention(
        q_, k_, v_, b_, d ** -0.5, p, seed), q, k, v, bias, do)
    torch.cuda.synchronize()
    assert (A.fused_attention_fwd_kernel.launches,
            A.fused_attention_bwd_dq_kernel.launches,
            A.fused_attention_bwd_dkdv_kernel.launches) == tuple(
                n + 1 for n in n0)
    for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        err = (a.float() - b.float()).abs().max().item()
        scale = max(1.0, b.float().abs().max().item())
        assert err <= atol * scale, (name, err, scale)


def test_fused_attention_dropout_on_card(cuda_device):
    """Keep rate, upscaling, and one seed giving one mask in the forward
    and in the backward (the gradient of v is exactly p-dropped^T dO)."""
    B, H, S, d, p = 2, 2, 256, 64, 0.25
    q = torch.zeros(B, H, S, d, device=cuda_device)
    k = torch.zeros_like(q)
    v = torch.ones_like(q).requires_grad_(True)
    seed = torch.tensor([99], dtype=torch.int64, device=cuda_device)
    out = A.fused_attention(q, k, v, dropout_prob=p, seed=seed)
    keep = A.dropout_keep_mask(B, H, S, p, seed).float()
    # uniform weights 1/S: each output is (kept columns) / (S (1 - p))
    want = keep.sum(-1, keepdim=True) / (S * (1 - p))
    torch.testing.assert_close(out[..., :1], want, rtol=1e-5, atol=1e-6)
    assert abs(keep.mean().item() - (1 - p)) < 0.01
    again = A.fused_attention(q, k, v, dropout_prob=p, seed=seed)
    assert torch.equal(out, again)
    (dv,) = torch.autograd.grad(out.sum(), v)
    want_dv = (keep / (S * (1 - p))).sum(-2).unsqueeze(-1).expand_as(dv)
    torch.testing.assert_close(dv, want_dv, rtol=1e-5, atol=1e-6)


def test_fused_attention_refuses_long_sequences(cuda_device):
    """Calls the kernels once refused past S 1024 now run through them
    and match the plain version: S 2048 at d 300 (refused before the
    widths past 256, zero-padded to 320 and split into five column
    chunks), at d 48 (refused before the head widths were padded), and
    S 1040 (refused before the long and flash tiers were ported)."""
    g = torch.Generator(device=cuda_device).manual_seed(300)
    q, k, v = (torch.randn(1, 1, 2048, 300, device=cuda_device, generator=g)
               for _ in range(3))
    got = A.fused_attention(q, k, v)
    want = A._ref_fused_attention(q, k, v, None, 300 ** -0.5, 0.0, None)
    torch.cuda.synchronize()
    assert A.built_width(300) == 320 and A.column_chunks(300) == 5
    assert (got - want).abs().max().item() <= 2e-5
    g = torch.Generator(device=cuda_device).manual_seed(2048)
    q, k, v = (torch.randn(1, 2, 2048, 48, device=cuda_device, generator=g)
               for _ in range(3))
    n0 = A.fused_attention_fwd_kernel.launches
    got = A.fused_attention(q, k, v)
    want = A._ref_fused_attention(q, k, v, None, 48 ** -0.5, 0.0, None)
    torch.cuda.synchronize()
    assert A.fused_attention_fwd_kernel.launches == n0 + 1
    assert got.shape == q.shape
    assert (got - want).abs().max().item() <= 2e-5
    g = torch.Generator(device=cuda_device).manual_seed(1040)
    q, k, v = (torch.randn(1, 2, 1040, 64, device=cuda_device, generator=g)
               for _ in range(3))
    got = A.fused_attention(q, k, v)
    want = A._ref_fused_attention(q, k, v, None, 0.125, 0.0, None)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 2e-5


_LONG_COUNTERS = (A.fused_attention_fwd_kernel,
                  A.fused_attention_bwd_dq_kernel,
                  A.fused_attention_bwd_dkdv_kernel)


# Past S 1024 the same kernels stand in for the TPU package's long and
# flash tiers. Each output is held to chip_smoke.py's limit for it: its
# max |kernel - plain| as a share of the plain output's own largest
# magnitude (LONG_RTOL, set between the sound kernels' readings and
# planted faults' on the H100).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,S,bias_shape,p", [
    (1, 2, 1088, (1, 1, 1, 1088), 0.1),     # 17 k-tiles
    (1, 2, 1100, (1, 2, 1, 1100), 0.0),     # ragged: no tile divides
    (2, 4, 2048, (2, 1, 1, 2048), 0.1),     # the path's mask
    (2, 2, 2048, (2, 1, 2048, 2048), 0.0),  # dbias by head atomics
    (1, 4, 4096, (1, 4, 4096, 4096), 0.0),  # per-row bias
    (1, 2, 8192, (1, 1, 1, 8192), 0.0),
])
def test_long_attention_kernels_match_plain(cuda_device, dtype, B, H, S,
                                            bias_shape, p):
    d = 64
    q, k, v, do, bias = _attn_inputs(cuda_device, dtype, B, H, S, d,
                                     bias_shape, S)
    seed = torch.tensor([S * 31 + 1], dtype=torch.int64, device=cuda_device)
    n0 = [w.launches for w in _LONG_COUNTERS]
    got = _grads(lambda q_, k_, v_, b_: A.fused_attention(
        q_, k_, v_, b_, dropout_prob=p, seed=seed), q, k, v, bias, do)
    torch.cuda.synchronize()
    assert [w.launches for w in _LONG_COUNTERS] == [n + 1 for n in n0]
    want = _grads(lambda q_, k_, v_, b_: A._ref_fused_attention(
        q_, k_, v_, b_, d ** -0.5, p, seed), q, k, v, bias, do)
    torch.cuda.synchronize()
    over = {}
    for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        rel = ((a.float() - b.float()).abs().max() /
               b.float().abs().max()).item()
        if not rel <= smoke.LONG_RTOL[dtype][name]:
            over[name] = rel
    assert not over, over


def test_long_attention_offsets_past_2_31(cuda_device):
    """A per-row bias [3, 12, 8192, 8192] holds 2.4e9 elements, so its
    offsets and those of its gradient pass 2^31: the (batch, head) pairs
    at both ends of the kernels' output match the plain version on that
    pair alone (pairs are independent)."""
    B, H, S, d = 3, 12, 8192, 64
    q, k, v, do, bias = _attn_inputs(cuda_device, torch.float32, B, H, S, d,
                                     (B, H, S, S), 5)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)] + [
        bias.requires_grad_(True)]     # no second 9.7 GB copy
    out = A.fused_attention(*leaves)
    got = [out.detach()] + list(torch.autograd.grad(out, leaves, do))
    del leaves, out
    for b, h in ((0, 0), (B - 1, H - 1)):
        pair = [t[b:b + 1, h:h + 1] for t in (q, k, v, do, bias)]
        want = _grads(lambda q_, k_, v_, b_: A._ref_fused_attention(
            q_, k_, v_, b_, d ** -0.5, 0.0, None), *pair[:3], pair[4],
            pair[3])
        torch.cuda.synchronize()
        for name, a, w in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
            err = (a[b:b + 1, h:h + 1].float() - w).abs().max().item()
            assert err <= 2e-5 * max(1.0, w.abs().max().item()), (b, h, name,
                                                                  err)


def test_long_dropout_mask_same_in_forward_and_backward(cuda_device):
    """At S 2048 the forward and both backward kernels draw one mask:
    with uniform weights the output is the kept share of each row and
    the gradient of v the dropped weights' column sums. Tolerance rtol
    1e-4: fp32 sums over 2048 terms (1.8e-5 read on the H100), while one
    element masked otherwise moves a sum by 1/(0.9 S) = 5.4e-4."""
    B, H, S, d, p = 1, 2, 2048, 64, 0.1
    q = torch.zeros(B, H, S, d, device=cuda_device)
    v = torch.ones_like(q).requires_grad_(True)
    seed = torch.tensor([2048], dtype=torch.int64, device=cuda_device)
    out = A.fused_attention(q, q, v, dropout_prob=p, seed=seed)
    (dv,) = torch.autograd.grad(out.sum(), v)
    keep = A.dropout_keep_mask(B, H, S, p, seed).float()
    torch.testing.assert_close(out[..., :1], keep.sum(-1, keepdim=True) /
                               (S * (1 - p)), rtol=1e-4, atol=0)
    want_dv = (keep / (S * (1 - p))).sum(-2).unsqueeze(-1).expand_as(dv)
    torch.testing.assert_close(dv, want_dv, rtol=1e-4, atol=0)


def test_flash_attention_lse_on_card(cuda_device):
    """flash_attention's row logsumexp equals torch.logsumexp of the
    biased fp32 scores, and its output the plain forward's (S 4096)."""
    q, k, v, _, bias = _attn_inputs(cuda_device, torch.float32, 1, 4, 4096,
                                    64, (1, 1, 1, 4096), 4)
    o, lse = A.flash_attention(q, k, v, bias)
    want_o, want_lse = A._ref_flash_attention(q, k, v, bias, 0.125, 0.0,
                                              None)
    torch.cuda.synchronize()
    assert lse.shape == (1, 4, 4096) and lse.dtype == torch.float32
    assert (lse - want_lse).abs().max().item() <= 1e-5 * max(
        1.0, want_lse.abs().max().item())
    assert (o - want_o).abs().max().item() <= 2e-5


def test_bert_tiny_step_on_card_matches_cpu(cuda_device):
    """One BERT-tiny training step (fused attention, dropout 0) on the card
    through the kernels, against the same step on the CPU through the
    plain versions, from one state: the loss to rtol 1e-5 and the
    persistables to atol 1e-6 (1% of the first Adam step, lr 1e-4).

    A key bias adds the same q.b to every score of a row, which the
    softmax cancels: its gradient is zero in exact arithmetic, so what
    either device computes is rounding noise, which Adam's first step
    turns into moves of about +-lr. The key biases and their moments are
    held instead to gradients below 1e-3 of the query biases'."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.tiny()
    cfg.use_fused_attention = True
    cfg.hidden_dropout = cfg.attn_dropout = 0.0
    with fluid.unique_name.guard():
        main, startup, loss = bert.build_pretrain_program(cfg, seq_len=64)
    feed = bert.synthetic_batch(cfg, 2, 64, seed=0)
    cpu = fluid.Scope()
    fluid.Executor("cpu").run(startup, scope=cpu)
    card = fluid.Scope()
    for n in cpu.local_var_names():
        card.set_var(n, cpu.find_var(n).to(cuda_device))
    n0 = (A.fused_attention_fwd_kernel.launches,
          A.fused_attention_bwd_dq_kernel.launches,
          A.fused_attention_bwd_dkdv_kernel.launches)
    got = fluid.Executor(cuda_device).run(main, feed=feed, fetch_list=[loss],
                                          scope=card)
    torch.cuda.synchronize()
    assert (A.fused_attention_fwd_kernel.launches,
            A.fused_attention_bwd_dq_kernel.launches,
            A.fused_attention_bwd_dkdv_kernel.launches) == tuple(
                n + cfg.n_layers for n in n0)
    want = fluid.Executor("cpu").run(main, feed=feed, fetch_list=[loss],
                                     scope=cpu)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for n in cpu.local_var_names():
        if "_attn_k.b_0" in n:
            continue
        np.testing.assert_allclose(card.find_var(n).cpu().numpy(),
                                   cpu.find_var(n).numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)
    for i in range(cfg.n_layers):
        def moment(kind):
            return card.find_var("layer_%d_attn_%s.b_0_moment1_0"
                                 % (i, kind)).abs().max().item()
        assert moment("k") <= 1e-3 * moment("q"), (i, moment("k"))


def test_amp_bert_tiny_step_on_card_matches_cpu(cuda_device):
    """One BERT-tiny AMP step (bf16, fused attention, dropout 0) on the
    card through the kernels and bf16 cuBLAS products, against the same
    step on the CPU from one state: the loss within 4e-3 relative (one
    bf16 step, 2^-8: the two devices round their bf16 products at other
    points), and every Adam first moment, 0.1 of a bf16 gradient, within
    2^-5 of its tensor's largest magnitude. The query and key
    projections are held apart, within 2^-3 (layer 1's query weight and
    bias read 3.5e-2 on the H100, the key weights 3.4e-2): their
    gradients pass through the softmax's Jacobian, a difference of
    nearly equal terms at random init, which cancels the key biases'
    entirely, so the rounding differences stand out."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.tiny()
    cfg.use_fused_attention = True
    cfg.hidden_dropout = cfg.attn_dropout = 0.0
    with fluid.unique_name.guard():
        main, startup, loss = bert.build_pretrain_program(cfg, seq_len=64,
                                                          use_amp=True)
    feed = bert.synthetic_batch(cfg, 2, 64, seed=0)
    cpu = fluid.Scope()
    fluid.Executor("cpu").run(startup, scope=cpu)
    card = fluid.Scope()
    for n in cpu.local_var_names():
        card.set_var(n, cpu.find_var(n).to(cuda_device))
    n0 = [w.launches for w in _LONG_COUNTERS]
    got = fluid.Executor(cuda_device).run(main, feed=feed, fetch_list=[loss],
                                          scope=card)
    torch.cuda.synchronize()
    assert [w.launches for w in _LONG_COUNTERS] == [
        n + cfg.n_layers for n in n0]
    want = fluid.Executor("cpu").run(main, feed=feed, fetch_list=[loss],
                                     scope=cpu)
    np.testing.assert_allclose(got[0], want[0], rtol=4e-3)
    over = {}
    for n in cpu.local_var_names():
        # the key biases' gradients are zero but for rounding noise (see
        # test_bert_tiny_step_on_card_matches_cpu)
        if n.endswith("_moment1_0") and "_attn_k.b_0" not in n:
            w = cpu.find_var(n)
            rel = (card.find_var(n).cpu() - w).abs().max().item() / \
                w.abs().max().item()
            apart = "_attn_q." in n or "_attn_k.w_0" in n
            if not rel <= (2 ** -3 if apart else 2 ** -5):
                over[n] = rel
    assert not over, over


# -- the packed layout: the same kernels through the heads' strides --------
_FUSED_COUNTERS = (A.fused_attention_fwd_kernel,
                   A.fused_attention_bwd_dq_kernel,
                   A.fused_attention_bwd_dkdv_kernel)


def _packed_inputs(dev, dtype, B, S, H, d, bias_shape, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(B, S, H * d, device=dev, generator=g)
                   .to(dtype) for _ in range(4))
    bias = torch.randn(*bias_shape, device=dev, generator=g) * 2.0
    bias[..., -3:] = -1e4
    return q, k, v, do, bias


def _rel_over(got, want, dtype):
    """{output: relative error} of the outputs past chip_smoke.py's limit
    for them (LONG_RTOL: max |kernel - plain| over the plain output's own
    largest magnitude)."""
    over = {}
    for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        rel = ((a.float() - b.float()).abs().max() /
               b.float().abs().max()).item()
        if not rel <= smoke.LONG_RTOL[dtype][name]:
            over[name] = rel
    return over


# An odd H fails the TPU's resident gate, H 12 at d 64 passes it; a head
# stride of d where H*d is needed would pass every case at H 1.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,d,bias_shape,p", [
    (2, 64, 3, 16, (2, 1, 1, 64), 0.0),        # BERT-tiny's head width
    (3, 128, 12, 64, (3, 1, 1, 128), 0.1),     # BERT-base, padding mask
    (3, 128, 12, 64, (3, 12, 1, 128), 0.0),    # per-head bias
    (2, 130, 5, 64, (2, 5, 1, 130), 0.1),      # odd H, ragged S
    (2, 256, 3, 32, (1, 1, 1, 256), 0.0),      # batch-broadcast bias
    (1, 200, 2, 128, (1, 2, 200, 200), 0.0),   # per-row bias, widest head
])
def test_packed_kernels_match_plain(cuda_device, dtype, B, S, H, d,
                                    bias_shape, p):
    q, k, v, do, bias = _packed_inputs(cuda_device, dtype, B, S, H, d,
                                       bias_shape, S * H + d)
    seed = torch.tensor([S * 131 + H], dtype=torch.int64, device=cuda_device)
    n0 = [w.launches for w in _FUSED_COUNTERS]
    got = _grads(lambda q_, k_, v_, b_: A.fused_attention_packed(
        q_, k_, v_, b_, n_heads=H, dropout_prob=p, seed=seed),
        q, k, v, bias, do)
    torch.cuda.synchronize()
    assert [w.launches for w in _FUSED_COUNTERS] == [n + 1 for n in n0]
    assert got[0].shape == (B, S, H * d) and got[4].shape == bias.shape
    want = _grads(lambda q_, k_, v_, b_: A._ref_fused_attention_packed(
        q_, k_, v_, b_, H, d ** -0.5, p, seed), q, k, v, bias, do)
    torch.cuda.synchronize()
    over = _rel_over(got, want, dtype)
    assert not over, over


def test_packed_entry_copies_nothing(cuda_device, monkeypatch):
    """The packed entry hands the kernels the heads' strided views and
    passes their buffers on as they are: its output is the forward
    kernel's o, and the gradients of the packed q, k and v are the dq and
    dk/dv kernels' dq, dk and dv, each in the packed layout."""
    B, S, H, d = 2, 64, 3, 16
    q, k, v, do, bias = _packed_inputs(cuda_device, torch.float32, B, S, H,
                                       d, (B, 1, 1, S), 5)
    packed = (S * H * d, d, H * d, 1)
    made = {}

    def spy(name):
        launch = getattr(A, name)

        def wrapper(*args, **kwargs):
            out = launch(*args, **kwargs)
            made[name] = [args[0].stride()] + [
                (t.data_ptr(), t.stride()) for t in out
                if t is not None and t.shape == args[0].shape]
            return out

        # the launcher counts on the name it sees
        wrapper.launches = wrapper.tensor_core_launches = 0
        monkeypatch.setattr(A, name, wrapper)

    for w in _FUSED_COUNTERS:
        spy(w.__name__)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = A.fused_attention_packed(*leaves, bias, n_heads=H)
    dq, dk, dv = torch.autograd.grad(out, leaves, do)
    fwd = made["fused_attention_fwd_kernel"]
    bwd = made["fused_attention_bwd_dq_kernel"][1:] + \
        made["fused_attention_bwd_dkdv_kernel"][1:]
    assert all(made[w.__name__][0] == packed for w in _FUSED_COUNTERS)
    assert fwd[1] == (out.data_ptr(), packed), (fwd, out.stride())
    assert bwd == [(t.data_ptr(), packed) for t in (dq, dk, dv)], bwd
    assert all(t.is_contiguous() for t in (out, dq, dk, dv))


def test_packed_large_shape_both_ends(cuda_device):
    """Packed [3, 8192, 12 * 64] bf16 with a padding mask: the (batch,
    head) pairs at both ends of every output match the plain version run
    on that pair alone, and the head-summed dbias of the last batch row
    matches the plain per-pair gradients summed over its heads."""
    B, S, H, d = 3, 8192, 12, 64
    dtype = torch.bfloat16
    q, k, v, do, bias = _packed_inputs(cuda_device, dtype, B, S, H, d,
                                       (B, 1, 1, S), 8192)
    got = _grads(lambda q_, k_, v_, b_: A.fused_attention_packed(
        q_, k_, v_, b_, n_heads=H), q, k, v, bias, do)
    heads = [A._split_heads(t, H) for t in got[:4]]
    qh, kh, vh, doh = (A._split_heads(t, H) for t in (q, k, v, do))
    dbias_last = torch.zeros(1, 1, 1, S, device=cuda_device)
    for b, h in [(0, 0)] + [(B - 1, h) for h in range(H)]:
        pair = [t[b:b + 1, h:h + 1] for t in (qh, kh, vh, doh)]
        want = _grads(lambda q_, k_, v_, b_: A._ref_fused_attention(
            q_, k_, v_, b_, d ** -0.5, 0.0, None), *pair[:3],
            bias[b:b + 1], pair[3])
        torch.cuda.synchronize()
        if b == B - 1:
            dbias_last += want[4]
        if (b, h) in ((0, 0), (B - 1, H - 1)):
            gotp = [t[b:b + 1, h:h + 1] for t in heads]
            over = _rel_over(gotp, want[:4], dtype)
            assert not over, (b, h, over)
    rel = ((got[4][B - 1:] - dbias_last).abs().max() /
           dbias_last.abs().max()).item()
    assert rel <= smoke.LONG_RTOL[dtype]["dbias"], rel


def test_packed_equals_per_head_with_dropout(cuda_device):
    """One seed, one Philox mask: the packed entry and fused_attention on
    contiguous transposed copies of the operands agree to the last bit in
    out, dq, dk and dv (the same kernels, the same sums; only the
    addressing differs), and
    dbias, summed over heads by fp32 atomics in the order the blocks
    finish, within 1e-6 of its largest magnitude."""
    B, S, H, d, p = 4, 128, 12, 64, 0.1
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do, bias = _packed_inputs(cuda_device, dtype, B, S, H, d,
                                           (B, 1, 1, S), 77)
        seed = torch.tensor([12345], dtype=torch.int64, device=cuda_device)
        packed = _grads(lambda q_, k_, v_, b_: A.fused_attention_packed(
            q_, k_, v_, b_, n_heads=H, dropout_prob=p, seed=seed),
            q, k, v, bias, do)

        def per_head(q_, k_, v_, b_):
            o = A.fused_attention(*(A._split_heads(t, H).contiguous()
                                    for t in (q_, k_, v_)), b_,
                                  dropout_prob=p, seed=seed)
            return A._merge_heads(o)

        heads = _grads(per_head, q, k, v, bias, do)
        torch.cuda.synchronize()
        for name, a, b in zip(("out", "dq", "dk", "dv"), packed, heads):
            assert torch.equal(a, b), (dtype, name)
        rel = ((packed[4] - heads[4]).abs().max() /
               heads[4].abs().max()).item()
        assert rel <= 1e-6, (dtype, rel)


# The bf16 backward on the tensor cores (mma.sync, cp.async tiles) against
# the plain version, under chip_smoke.py's LONG_RTOL: every head width,
# ragged S, H 1 and an odd H in the packed layout, every bias shape (and
# none), dropout on and off.
@pytest.mark.parametrize("B,H,S,d,bias_shape,p,packed", [
    (2, 3, 128, 16, (2, 1, 1, 128), 0.1, False),     # padding-mask shape
    (2, 3, 77, 32, (2, 3, 77, 77), 0.0, False),      # per-row, ragged S
    (2, 3, 1000, 64, (2, 1, 1000, 1000), 0.1, False),  # dbias by atomics
    (1, 2, 200, 128, (1, 2, 1, 200), 0.1, False),    # per-head, widest
    (1, 2, 1000, 16, None, 0.1, False),              # no bias, ragged
    (2, 1, 77, 64, (2, 1, 1, 77), 0.0, True),        # H 1, ragged
    (2, 5, 130, 64, (2, 5, 1, 130), 0.1, True),      # odd H, ragged
    (2, 3, 256, 128, (1, 1, 1, 256), 0.0, True),     # batch-broadcast
    (3, 4, 128, 16, (3, 4, 128, 128), 0.1, True),    # BERT-tiny heads
])
def test_bf16_backward_matches_plain(cuda_device, B, H, S, d, bias_shape, p,
                                     packed):
    dtype = torch.bfloat16
    if packed:
        q, k, v, do, bias = _packed_inputs(cuda_device, dtype, B, S, H, d,
                                           bias_shape, S * H + d)
        run = A.fused_attention_packed
        plain = A._ref_fused_attention_packed
        extra = {"n_heads": H}
    else:
        q, k, v, do, bias = _attn_inputs(cuda_device, dtype, B, H, S, d,
                                         bias_shape, S * H + d)
        run, plain, extra = A.fused_attention, A._ref_fused_attention, {}
    seed = torch.tensor([S * 17 + d], dtype=torch.int64, device=cuda_device)
    n0 = [w.launches for w in _FUSED_COUNTERS]
    got = _grads(lambda q_, k_, v_, b_: run(
        q_, k_, v_, b_, dropout_prob=p, seed=seed, **extra), q, k, v, bias,
        do)
    torch.cuda.synchronize()
    assert [w.launches for w in _FUSED_COUNTERS] == [n + 1 for n in n0]
    want = _grads(lambda q_, k_, v_, b_: plain(
        q_, k_, v_, b_, *([H] if packed else []), d ** -0.5, p, seed),
        q, k, v, bias, do)
    torch.cuda.synchronize()
    over = _rel_over(got, want, dtype)
    assert not over, over


def test_bf16_backward_copies_only_the_misaligned_operand(cuda_device,
                                                          monkeypatch):
    """q a view one element past a 16-byte boundary: the wrappers hand
    the bf16 kernels a 16-byte-aligned contiguous copy of it, and k and
    v as they are; the gradients match the plain version's."""
    B, H, S, d = 2, 3, 96, 64
    dtype = torch.bfloat16
    q0, k, v, do, bias = _attn_inputs(cuda_device, dtype, B, H, S, d,
                                      (B, 1, 1, S), 31)
    flat = torch.empty(q0.numel() + 1, dtype=dtype, device=cuda_device)
    q = flat[1:].view(B, H, S, d)
    q.copy_(q0)
    seen = {}
    launch = A.fused_attention_bwd_dq_kernel

    def spy(*args, **kwargs):
        seen["ptrs"] = [t.data_ptr() for t in args[:3]]
        return launch(*args, **kwargs)

    spy.launches = spy.tensor_core_launches = 0
    monkeypatch.setattr(A, "fused_attention_bwd_dq_kernel", spy)
    n0 = A.fused_attention_bwd_dkdv_kernel.launches
    leaves = [q.detach().requires_grad_(True)] + [
        t.detach().clone().requires_grad_(True) for t in (k, v)]
    out = A.fused_attention(*leaves, bias)
    got = [out.detach()] + [g.float() for g in torch.autograd.grad(
        out, leaves, do)]
    torch.cuda.synchronize()
    # the launcher counts on the name it sees: the spy
    assert spy.launches == 1 and \
        A.fused_attention_bwd_dkdv_kernel.launches == n0 + 1
    qp, kp, vp = seen["ptrs"]
    assert qp != q.data_ptr() and qp % 16 == 0
    assert (kp, vp) == (leaves[1].data_ptr(), leaves[2].data_ptr())
    want = _grads(lambda q_, k_, v_, b_: A._ref_fused_attention(
        q_, k_, v_, b_, d ** -0.5, 0.0, None), q0, k, v, bias, do)
    torch.cuda.synchronize()
    over = _rel_over(got, want, dtype)
    assert not over, over


# Head widths the kernels are not built for reach them zero-padded to the
# next built width, forward and backward, per head and packed, in every
# type, held to chip_smoke.py's LONG_RTOL.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("B,H,S,d,bias_shape,p,packed", [
    (2, 3, 130, 48, (2, 1, 1, 130), 0.1, False),
    (2, 3, 200, 80, (2, 3, 200, 200), 0.0, False),
    (2, 2, 77, 100, (2, 2, 1, 77), 0.1, False),
    (2, 16, 128, 48, (2, 1, 1, 128), 0.1, True),     # hidden 768, 16 heads
    (2, 3, 96, 80, (2, 3, 1, 96), 0.0, True),
    # d 256 built: the backward's outputs in two column halves on the
    # tensor cores, 32-row tiles in fp32, the SIMT forward in every type
    (2, 3, 200, 160, (2, 1, 200, 200), 0.1, False),
    (1, 2, 300, 256, (1, 2, 1, 300), 0.0, False),
    (2, 2, 130, 256, (2, 1, 1, 130), 0.1, True),
    (2, 3, 77, 200, (2, 3, 77, 77), 0.0, True),
    # past 256: the outputs' columns in 64-column chunks, one block each
    (2, 3, 150, 320, (2, 1, 1, 150), 0.1, False),
    (1, 2, 130, 512, (1, 2, 130, 130), 0.0, False),
    (2, 2, 100, 300, (2, 2, 1, 100), 0.1, True),
])
def test_fused_attention_pads_other_head_widths(cuda_device, dtype, B, H, S,
                                                d, bias_shape, p, packed):
    if packed:
        q, k, v, do, bias = _packed_inputs(cuda_device, dtype, B, S, H, d,
                                           bias_shape, S * H + d)
        run = A.fused_attention_packed
        plain = A._ref_fused_attention_packed
        extra = {"n_heads": H}
    else:
        q, k, v, do, bias = _attn_inputs(cuda_device, dtype, B, H, S, d,
                                         bias_shape, S * H + d)
        run, plain, extra = A.fused_attention, A._ref_fused_attention, {}
    seed = torch.tensor([S * 13 + d], dtype=torch.int64, device=cuda_device)
    n0 = [w.launches for w in _FUSED_COUNTERS]
    got = _grads(lambda q_, k_, v_, b_: run(
        q_, k_, v_, b_, dropout_prob=p, seed=seed, **extra), q, k, v, bias,
        do)
    torch.cuda.synchronize()
    assert [w.launches for w in _FUSED_COUNTERS] == [n + 1 for n in n0]
    assert got[0].shape == q.shape and got[0].dtype == dtype
    want = _grads(lambda q_, k_, v_, b_: plain(
        q_, k_, v_, b_, *([H] if packed else []), d ** -0.5, p, seed),
        q, k, v, bias, do)
    torch.cuda.synchronize()
    over = _rel_over(got, want, dtype)
    assert not over, over


# The forward in the 16-bit types against the plain version: the
# tensor-core forward (attn_fwd_mma) at every built head width up to 128,
# every bias shape (and none), ragged S, dropout on and off, contiguous
# and strided packed operands, bf16 and fp16, and the SIMT forward at
# d 256; out and the row logsumexp under chip_smoke.py's LONG_RTOL.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,H,S,d,bias_shape,p,packed", [
    (2, 3, 500, 16, None, 0.1, False),
    (2, 3, 500, 32, (2, 1, 1, 500), 0.0, False),       # padding-mask shape
    (2, 3, 1040, 64, (2, 3, 1, 1040), 0.1, False),     # per-head
    (1, 2, 1040, 128, (1, 1, 1040, 1040), 0.0, False),  # head-bcast rows
    (2, 2, 500, 64, (2, 2, 500, 500), 0.1, False),     # per-row
    (1, 3, 1040, 16, (1, 3, 1040, 1040), 0.0, False),
    (2, 3, 500, 128, (1, 1, 1, 500), 0.1, False),      # batch-broadcast
    (2, 2, 1040, 32, (2, 1, 1, 1040), 0.1, False),
    (3, 12, 128, 64, (3, 1, 1, 128), 0.1, True),       # config 3's heads
    (2, 5, 130, 16, (2, 5, 1, 130), 0.0, True),        # odd H, ragged S
    (2, 3, 77, 128, (2, 3, 77, 77), 0.1, True),
    (1, 2, 300, 256, (1, 2, 1, 300), 0.1, False),      # SIMT at d 256
])
def test_16bit_forward_matches_plain(cuda_device, dtype, B, H, S, d,
                                     bias_shape, p, packed):
    if packed:
        q, k, v, _, bias = _packed_inputs(cuda_device, dtype, B, S, H, d,
                                          bias_shape, S + d)
        q, k, v = (A._split_heads(t, H) for t in (q, k, v))
    else:
        q, k, v, _, bias = _attn_inputs(cuda_device, dtype, B, H, S, d,
                                        bias_shape, S + d)
    seed = torch.tensor([S * 29 + d], dtype=torch.int64, device=cuda_device)
    n0 = (A.fused_attention_fwd_kernel.launches,
          A.fused_attention_fwd_kernel.tensor_core_launches)
    o, lse = A.flash_attention(q, k, v, bias, dropout_prob=p, seed=seed)
    want_o, want_lse = A._ref_flash_attention(q, k, v, bias, d ** -0.5, p,
                                              seed)
    torch.cuda.synchronize()
    assert (A.fused_attention_fwd_kernel.launches,
            A.fused_attention_fwd_kernel.tensor_core_launches) == (
                n0[0] + 1, n0[1] + (d <= 128))
    assert o.dtype == dtype and lse.dtype == torch.float32
    if packed:
        assert o.stride() == q.stride()
    rtol = smoke.LONG_RTOL[dtype]
    for name, a, b in (("out", o, want_o), ("lse", lse, want_lse)):
        rel = ((a.float() - b.float()).abs().max() /
               b.float().abs().max()).item()
        assert rel <= rtol[name], (name, rel)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_16bit_forward_draws_the_plain_mask(cuda_device, dtype):
    """q = k = 0 gives every key the weight 1/S, and a one-hot v (key
    128 t + c on column c) makes o[.., r, c] = keep[r, 128 t + c] / (S (1
    - p)), exact in 16 bits: the forward's dropout mask equals
    dropout_keep_mask bit for bit over two q-tiles, four k-tiles, three
    heads and two batch rows."""
    B, H, S, d, p = 2, 3, 256, 128, 0.3
    q = torch.zeros(B, H, S, d, dtype=dtype, device=cuda_device)
    seed = torch.tensor([31337], dtype=torch.int64, device=cuda_device)
    keep = A.dropout_keep_mask(B, H, S, p, seed)
    cols = torch.arange(d, device=cuda_device)
    for t in range(S // d):
        v = torch.zeros_like(q)
        v[:, :, t * d + cols, cols] = 1
        o = A.fused_attention(q, q, v, dropout_prob=p, seed=seed)
        torch.cuda.synchronize()
        assert torch.equal(o != 0, keep[..., t * d:(t + 1) * d]), t
        torch.testing.assert_close(
            o.float(), keep[..., t * d:(t + 1) * d].float() / (S * (1 - p)),
            rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_16bit_dropout_mask_bit_equal_forward_backward(cuda_device, dtype):
    """S = d = 128, q = k = 0 (every weight 1/S): with v the identity the
    forward's o[r, c] is keep[r, c] / (S (1 - p)), and with dO the
    identity the backward's dv[c, r] is the same dropped weight, so both
    kernels' masks equal dropout_keep_mask bit for bit, over three heads
    and two batch rows."""
    B, H, S, p = 2, 3, 128, 0.3
    eye = torch.eye(S, dtype=dtype, device=cuda_device).expand(
        B, H, S, S).contiguous()
    q = torch.zeros(B, H, S, S, dtype=dtype, device=cuda_device)
    seed = torch.tensor([4711], dtype=torch.int64, device=cuda_device)
    keep = A.dropout_keep_mask(B, H, S, p, seed)
    v = eye.clone().requires_grad_(True)
    o = A.fused_attention(q, q, v, dropout_prob=p, seed=seed)
    (dv,) = torch.autograd.grad(o, v, eye)
    torch.cuda.synchronize()
    assert torch.equal(o != 0, keep)
    assert torch.equal(dv.transpose(2, 3) != 0, keep)


# The fp32 kernels on the tensor cores (3xTF32: attn_fwd_tf32x3,
# attn_bwd_dq_tf32x3, attn_bwd_dkdv_tf32x3) against the plain version:
# the bert path's shape, ragged S, every bias shape and none, d 16, 32,
# 64 and 128 (there the 3xTF32 forward and the SIMT backward), dropout on
# and off, held to chip_smoke.py's FUSED_ATOL (2e-5 of max(1, the plain
# output's largest magnitude)).
@pytest.mark.parametrize("B,H,S,d,bias_shape,p", [
    (32, 12, 512, 64, (32, 1, 1, 512), 0.1),    # the bert path
    (2, 3, 500, 64, (2, 3, 500, 500), 0.1),     # per-row, ragged S
    (2, 3, 333, 16, (2, 1, 1, 333), 0.1),
    (2, 3, 200, 32, (2, 3, 1, 200), 0.0),       # per-head
    (1, 2, 300, 128, (1, 1, 300, 300), 0.1),    # head-broadcast rows
    (2, 2, 130, 64, (1, 1, 1, 130), 0.1),       # batch-broadcast
    (2, 2, 65, 128, None, 0.0),                 # no bias, one-key tail
])
def test_tf32x3_kernels_match_plain(cuda_device, B, H, S, d, bias_shape, p):
    q, k, v, do, bias = _attn_inputs(cuda_device, torch.float32, B, H, S, d,
                                     bias_shape, S * 3 + d)
    seed = torch.tensor([S * 31 + d], dtype=torch.int64, device=cuda_device)
    n0 = [(w.launches, w.tensor_core_launches) for w in _FUSED_COUNTERS]
    got = _grads(lambda q_, k_, v_, b_: A.fused_attention(
        q_, k_, v_, b_, dropout_prob=p, seed=seed), q, k, v, bias, do)
    torch.cuda.synchronize()
    on_tc = (True, d <= 64, d <= 64)
    assert [(w.launches, w.tensor_core_launches)
            for w in _FUSED_COUNTERS] == [(a + 1, b + tc) for (a, b), tc
                                          in zip(n0, on_tc)]
    want = _grads(lambda q_, k_, v_, b_: A._ref_fused_attention(
        q_, k_, v_, b_, d ** -0.5, p, seed), q, k, v, bias, do)
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        err = (a - b).abs().max().item()
        limit = smoke.FUSED_ATOL[torch.float32] * max(
            1.0, b.abs().max().item())
        assert err <= limit, (name, err, limit)


def test_fp32_dropout_mask_bit_equal_forward_backward(cuda_device):
    """The 3xTF32 kernels' mask (d 64, S 128: two q-tiles and two
    k-tiles), q = k = 0 so every weight is 1/S: with v one-hot on key
    block t (v[64 t + c, c] = 1) the forward's o[r, c] is keep[r, 64 t +
    c] / (S (1 - p)), and with dO one-hot on query block t the
    backward's dv[key, c] is the dropped weight of query 64 t + c, so
    both kernels' masks equal dropout_keep_mask bit for bit, over three
    heads and two batch rows."""
    B, H, S, d, p = 2, 3, 128, 64, 0.3
    q = torch.zeros(B, H, S, d, device=cuda_device)
    seed = torch.tensor([1717], dtype=torch.int64, device=cuda_device)
    keep = A.dropout_keep_mask(B, H, S, p, seed)
    cols = torch.arange(d, device=cuda_device)
    assert all(A.on_tensor_cores(w, torch.float32, d) for w in range(3))
    for t in range(S // d):
        block = torch.zeros_like(q)
        block[:, :, t * d + cols, cols] = 1
        v = block.clone().requires_grad_(True)
        o = A.fused_attention(q, q, v, dropout_prob=p, seed=seed)
        (dv,) = torch.autograd.grad(o, v, block)
        torch.cuda.synchronize()
        want = keep[..., t * d:(t + 1) * d]
        assert torch.equal(o != 0, want), t
        torch.testing.assert_close(o, want.float() / (S * (1 - p)),
                                   rtol=1e-6, atol=0)
        assert torch.equal(dv.transpose(2, 3) != 0,
                           keep[:, :, t * d:(t + 1) * d]), t


def test_packed_amp_bert_tiny_step_on_card_matches_cpu(cuda_device):
    """One BERT-tiny AMP step with use_fused_attention="packed" (bf16,
    dropout 0) on the card through the packed kernels, against the same
    step on the CPU from one state, to the limits and for the reasons of
    test_amp_bert_tiny_step_on_card_matches_cpu."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.tiny()
    cfg.use_fused_attention = "packed"
    cfg.hidden_dropout = cfg.attn_dropout = 0.0
    with fluid.unique_name.guard():
        main, startup, loss = bert.build_pretrain_program(cfg, seq_len=64,
                                                          use_amp=True)
    feed = bert.synthetic_batch(cfg, 2, 64, seed=0)
    cpu = fluid.Scope()
    fluid.Executor("cpu").run(startup, scope=cpu)
    card = fluid.Scope()
    for n in cpu.local_var_names():
        card.set_var(n, cpu.find_var(n).to(cuda_device))
    n0 = [w.launches for w in _FUSED_COUNTERS]
    got = fluid.Executor(cuda_device).run(main, feed=feed, fetch_list=[loss],
                                          scope=card)
    torch.cuda.synchronize()
    assert [w.launches for w in _FUSED_COUNTERS] == [
        n + cfg.n_layers for n in n0]
    want = fluid.Executor("cpu").run(main, feed=feed, fetch_list=[loss],
                                     scope=cpu)
    np.testing.assert_allclose(got[0], want[0], rtol=4e-3)
    over = {}
    for n in cpu.local_var_names():
        if n.endswith("_moment1_0") and "_attn_k.b_0" not in n:
            w = cpu.find_var(n)
            rel = (card.find_var(n).cpu() - w).abs().max().item() / \
                w.abs().max().item()
            apart = "_attn_q." in n or "_attn_k.w_0" in n
            if not rel <= (2 ** -3 if apart else 2 ** -5):
                over[n] = rel
    assert not over, over


def test_predictor_and_server_on_card(cuda_device, tmp_path):
    """A BERT-tiny packed encoder saved from the card, loaded by a
    Predictor on the card and on the CPU: the card's outputs match the
    CPU's (fp32, atol 1e-4: cuBLAS and the kernels sum in another order),
    a Server's coalesced batches match direct runs on the card (the
    kernels treat every row alone; atol 1e-5 for the products), and the
    forward kernel ran on the packed operands."""
    from paddle_tpu_torch import fluid, inference
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.tiny()
    cfg.use_fused_attention = "packed"
    feeds = ["src_ids", "pos_ids", "sent_ids", "input_mask"]
    with fluid.unique_name.guard():
        main, startup, enc = bert.build_encoder_program(cfg, seq_len=64)
    exe, scope = fluid.Executor(cuda_device), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup, scope=scope)
        fluid.io.save_inference_model(str(tmp_path), feeds, [enc], exe,
                                      main_program=main,
                                      params_filename="params")
    batch = bert.synthetic_batch(cfg, 12, 64, seed=3)
    batch["input_mask"][::2, 40:] = 0.0
    rows = {n: batch[n] for n in feeds}
    card = inference.create_predictor(inference.Config(
        str(tmp_path), params_file="params"))
    cpu = inference.create_predictor(inference.Config(
        str(tmp_path), params_file="params", place="cpu"))
    np.testing.assert_allclose(card.run(rows)[0], cpu.run(rows)[0],
                               atol=1e-4)
    n0 = A.fused_attention_fwd_kernel.launches
    reqs = [{n: rows[n][i:i + 3] for n in feeds} for i in range(0, 12, 3)]
    with inference.Server() as srv:
        srv.register("enc", card.clone(),
                     config=inference.ServeConfig(max_batch_size=8),
                     warmup_feed={n: rows[n][:1] for n in feeds})
        futs = [srv.submit("enc", r) for r in reqs]
        outs = [f.result(timeout=120)[0] for f in futs]
    assert A.fused_attention_fwd_kernel.launches > n0
    for r, out in zip(reqs, outs):
        np.testing.assert_allclose(out, card.run(r)[0], atol=1e-5)


# -- the executor's CUDA graphs ---------------------------------------------------
# BERT-tiny in the packed layout, bf16 AMP, batch 4, S 64: graphed
# (Executor(cuda_graphs=True), the default: run 1 eager, run 2 captures,
# later runs replay) against eager (cuda_graphs=False), each from a clone
# of one state and generator. The same kernels run in the same order on
# the same inputs (the embedding backward in a fixed order), so graphed
# and eager must agree to the bit, as every reading of chip_smoke's
# executor phase did at config 3 (PERF.md §6).


def _graph_program(dropout=0.0, dynamic_scaling=False):
    """(cfg, main, loss, feed, scope after startup) of BERT-tiny packed
    AMP pretraining; ``dynamic_scaling`` decorates Adam with dynamic loss
    scaling that moves every step (raised every 2 good steps)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import optimizer
    from paddle_tpu_torch.fluid.contrib import mixed_precision
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.tiny()
    cfg.use_fused_attention = "packed"
    cfg.hidden_dropout = cfg.attn_dropout = dropout
    with fluid.unique_name.guard():
        if not dynamic_scaling:
            main, startup, loss = bert.build_pretrain_program(
                cfg, seq_len=64, use_amp=True)
        else:
            main, startup = fluid.Program(), fluid.Program()
            main.random_seed = 7
            with fluid.program_guard(main, startup):
                enc = bert.bert_encoder(*bert._feeds(64), cfg)
                n = bert.max_predictions(64)
                loss = bert.mlm_loss_masked(
                    enc, *(fluid.layers.data(name, shape=[n], dtype=dt)
                           for name, dt in (("mask_pos", "int64"),
                                            ("mask_label", "int64"),
                                            ("mask_weight", "float32"))),
                    cfg)
                mixed_precision.decorate(
                    optimizer.Adam(learning_rate=1e-4),
                    use_dynamic_loss_scaling=True, init_loss_scaling=1.0,
                    incr_every_n_steps=2).minimize(loss)
    feed = bert.synthetic_batch(cfg, 4, 64, seed=0)
    scope = fluid.Scope()
    fluid.Executor("cuda", cuda_graphs=False).run(startup, scope=scope)
    return cfg, main, loss, feed, scope


def _replays():
    from paddle_tpu_torch.fluid import monitor
    return monitor.counter("executor_graph_replay_total").value


def _losses(exe, main, loss, feed, scope, steps, **kw):
    return [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=scope, **kw)[0]).reshape(-1)[0])
            for _ in range(steps)]


def test_graphed_steps_match_eager(cuda_device):
    """10 graphed steps at p 0 against 10 eager ones: the losses and
    every persistable after them equal; 9 replays (runs 2-10). The
    wrappers count the first (eager) run's launches alone, once a layer
    each; a traced replay runs the same kernels, by name."""
    from paddle_tpu_torch import fluid

    cfg, main, loss, feed, scope = _graph_program()
    graphed, eager = (smoke.clone_scope(fluid, scope) for _ in range(2))
    r0 = _replays()
    n0 = [w.launches for w in _FUSED_COUNTERS]
    exe = fluid.Executor(cuda_device)
    got = _losses(exe, main, loss, feed, graphed, 9)
    _, kern = smoke.host_launches(
        lambda: got.extend(_losses(exe, main, loss, feed, graphed, 1)))
    assert _replays() - r0 == 9
    assert [w.launches - n for w, n in zip(_FUSED_COUNTERS, n0)] == \
        [cfg.n_layers] * 3
    assert list(smoke.traced_launches(kern).values()) == [cfg.n_layers] * 6
    want = _losses(fluid.Executor(cuda_device, cuda_graphs=False), main,
                   loss, feed, eager, 10)
    assert _replays() - r0 == 9
    assert got == want
    for n in eager.local_var_names():
        assert torch.equal(graphed.find_var(n), eager.find_var(n)), n


def test_graph_loss_scaling_state_matches_eager(cuda_device):
    """Dynamic loss scaling writes its scale and good/bad counters out
    of place (assign ops); the graph copies them back into the storage it
    reads next: after each of 6 steps they equal the eager run's (the
    counters move every step, the scale every 2)."""
    from paddle_tpu_torch import fluid

    cfg, main, loss, feed, scope = _graph_program(dynamic_scaling=True)
    names = sorted(n for n in scope.local_var_names()
                   if n.startswith("loss_scaling"))
    assert len(names) == 3, names
    runs = {}
    for label, graphs in (("graphed", True), ("eager", False)):
        sc = smoke.clone_scope(fluid, scope)
        exe = fluid.Executor(cuda_device, cuda_graphs=graphs)
        runs[label] = []
        for _ in range(6):
            exe.run(main, feed=feed, fetch_list=[loss], scope=sc)
            runs[label].append([float(sc.find_var(n).reshape(-1)[0])
                                for n in names])
    assert runs["graphed"] == runs["eager"]
    assert len({tuple(r) for r in runs["eager"]}) == 6


def test_graph_masks_change_between_replays(cuda_device):
    """At p 0.1 every replay draws new masks from the scope's generator:
    from one state, a replay with the generator rewound repeats its
    loss exactly, and one without differs."""
    from paddle_tpu_torch import fluid

    cfg, main, loss, feed, scope = _graph_program(dropout=0.1)
    exe = fluid.Executor(cuda_device)
    _losses(exe, main, loss, feed, scope, 2)          # warm, capture
    state = {n: scope.find_var(n).clone() for n in scope.local_var_names()}
    rng = scope.generator.get_state()

    def replay(rewind):
        for n, t in state.items():
            scope.find_var(n).copy_(t)
        if rewind:
            scope.generator.set_state(rng)
        return _losses(exe, main, loss, feed, scope, 1)[0]

    first = replay(True)
    assert replay(True) == first
    assert replay(False) != first


def test_graph_sees_a_replaced_weight(cuda_device):
    """A weight replaced with set_var between two graphed runs changes
    the next fetch as it does eagerly."""
    from paddle_tpu_torch import fluid

    cfg, main, loss, feed, scope = _graph_program()
    name = "mlm_out_bias"
    out = {}
    for label, graphs in (("graphed", True), ("eager", False)):
        sc = smoke.clone_scope(fluid, scope)
        exe = fluid.Executor(cuda_device, cuda_graphs=graphs)
        out[label] = _losses(exe, main, loss, feed, sc, 3)
        old = sc.find_var(name)
        sc.set_var(name, old + torch.linspace(-5, 5, old.numel(),
                                              device=old.device))
        out[label] += _losses(exe, main, loss, feed, sc, 2)
    assert out["graphed"] == out["eager"]
    assert abs(out["eager"][3] - out["eager"][2]) > 4e-2 * abs(
        out["eager"][2])


def test_graph_async_handles_survive_the_next_replay(cuda_device):
    """Two async replays, read after both, give the eager losses of
    those steps: each handle holds its own copy of the graph's output."""
    from paddle_tpu_torch import fluid

    cfg, main, loss, feed, scope = _graph_program()
    graphed, eager = (smoke.clone_scope(fluid, scope) for _ in range(2))
    exe = fluid.Executor(cuda_device)
    _losses(exe, main, loss, feed, graphed, 2)
    handles = [exe.run(main, feed=feed, fetch_list=[loss], scope=graphed,
                       fetch_mode="async")[0] for _ in range(2)]
    got = [float(h.numpy().reshape(-1)[0]) for h in handles]
    want = _losses(fluid.Executor(cuda_device, cuda_graphs=False), main,
                   loss, feed, eager, 4)[2:]
    assert got == want
    assert got[0] != got[1]


def test_graph_iters_matches_single_runs(cuda_device):
    """iters=4 (its first step eager, the second captured, then
    replays) gives the trajectory and state of 4 single graphed runs."""
    from paddle_tpu_torch import fluid

    cfg, main, loss, feed, scope = _graph_program()
    a, b = (smoke.clone_scope(fluid, scope) for _ in range(2))
    r0 = _replays()
    # stacked explicitly: batch 4 = iters 4 would read a per-step feed
    # as a stack (the reference's rule for a dynamic batch dim)
    stacked = {k: np.stack([v] * 4) for k, v in feed.items()}
    traj = fluid.Executor(cuda_device).run(
        main, feed=stacked, fetch_list=[loss], scope=a, iters=4)[0]
    assert traj.shape[0] == 4 and _replays() - r0 == 3
    singles = _losses(fluid.Executor(cuda_device), main, loss, feed, b, 4)
    assert traj.reshape(4, -1)[:, 0].tolist() == singles
    for n in b.local_var_names():
        assert torch.equal(a.find_var(n), b.find_var(n)), n


def test_graph_skip_step_restores_the_state(cuda_device):
    """Under skip_step a non-finite replay (an input mask of NaN) leaves
    every persistable bit-equal, and the next clean replay trains on."""
    from paddle_tpu_torch import fluid

    cfg, main, loss, feed, scope = _graph_program()
    fluid.set_flags({"FLAGS_anomaly_policy": "skip_step"})
    try:
        exe = fluid.Executor(cuda_device)
        _losses(exe, main, loss, feed, scope, 2)
        before = {n: scope.find_var(n).clone()
                  for n in scope.local_var_names()}
        bad = dict(feed, input_mask=np.full_like(feed["input_mask"], np.nan))
        r0 = _replays()
        exe.run(main, feed=bad, fetch_list=[loss], scope=scope)
        assert _replays() - r0 == 1
        for n, t in before.items():
            assert torch.equal(scope.find_var(n), t), n
        assert np.isfinite(_losses(exe, main, loss, feed, scope, 1)).all()
        assert not torch.equal(scope.find_var("word_emb"),
                               before["word_emb"])
    finally:
        fluid.set_flags({"FLAGS_anomaly_policy": "raise"})


def test_graph_of_one_scope_never_serves_another(cuda_device):
    """One program, one executor, two scopes: the second scope's first
    run is its own (eager) run, equal to the first scope's first step,
    and leaves the first scope's state as it was."""
    from paddle_tpu_torch import fluid

    cfg, main, loss, feed, scope = _graph_program()
    a, b = (smoke.clone_scope(fluid, scope) for _ in range(2))
    exe = fluid.Executor(cuda_device)
    first = _losses(exe, main, loss, feed, a, 3)
    kept = {n: a.find_var(n).clone() for n in a.local_var_names()}
    r0 = _replays()
    assert _losses(exe, main, loss, feed, b, 1) == first[:1]
    assert _replays() == r0
    for n, t in kept.items():
        assert torch.equal(a.find_var(n), t), n


def test_predictor_graphs_match_eager(cuda_device, tmp_path):
    """A packed BERT-tiny encoder Predictor captures one graph per input
    signature (two batch sizes, three runs each): every output equals
    an eager predictor's (fp32, the same kernels), from its replays."""
    from paddle_tpu_torch import fluid, inference
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.tiny()
    cfg.use_fused_attention = "packed"
    feeds = ["src_ids", "pos_ids", "sent_ids", "input_mask"]
    with fluid.unique_name.guard():
        main, startup, enc = bert.build_encoder_program(cfg, seq_len=64)
    exe, scope = fluid.Executor(cuda_device), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup, scope=scope)
        fluid.io.save_inference_model(str(tmp_path), feeds, [enc], exe,
                                      main_program=main)
    graphed = inference.create_predictor(inference.Config(str(tmp_path)))
    eager = graphed.clone()
    eager._exe.cuda_graphs = False
    batch = bert.synthetic_batch(cfg, 6, 64, seed=4)
    r0 = _replays()
    for rows in (2, 6, 2, 6, 2, 6):
        feed = {n: batch[n][:rows] for n in feeds}
        np.testing.assert_allclose(graphed.run(feed)[0], eager.run(feed)[0],
                                   rtol=1e-6, atol=1e-6)
    assert _replays() - r0 == 4


# -- the convolutional slice: ResNet through the executor on the card ---------
def _resnet18(fluid, fmt, use_amp, size=64):
    from paddle_tpu_torch.models import resnet
    return smoke.resnet_program(fluid, resnet, fmt, depth=18, size=size,
                                use_amp=use_amp, lr=0.01)


@pytest.mark.parametrize("fmt,use_amp", [("NCHW", True), ("NHWC", True),
                                         ("NCHW", False)])
def test_resnet18_graphed_matches_eager(cuda_device, fmt, use_amp):
    """4 graphed steps (run 1 eager, run 2 captured, then replays)
    against 4 eager ones from one state: the losses and every persistable
    (parameters, velocities, batch-norm running statistics) equal to the
    bit, with 3 replays; the convolutions' backward is deterministic."""
    from paddle_tpu_torch import fluid

    main, startup, loss, _ = _resnet18(fluid, fmt, use_amp)
    feed = smoke.resnet_feed(cuda_device, 8, 64, seed=1)
    scope = fluid.Scope()
    fluid.Executor(cuda_device, cuda_graphs=False).run(startup, scope=scope)
    graphed, eager = (smoke.clone_scope(fluid, scope) for _ in range(2))
    r0 = _replays()
    got = _losses(fluid.Executor(cuda_device), main, loss, feed, graphed, 4)
    assert _replays() - r0 == 3
    want = _losses(fluid.Executor(cuda_device, cuda_graphs=False), main,
                   loss, feed, eager, 4)
    assert got == want and all(np.isfinite(got))
    assert smoke.unequal(graphed, eager) == []


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_convolutions_keep_the_layout(cuda_device, monkeypatch, fmt):
    """Every convolution of a ResNet-18 AMP step, forward and backward,
    takes and gives tensors in the program's layout: channels-last
    strides under NHWC (the permuted views, no copy between), contiguous
    NCHW under NCHW."""
    import torch.nn.functional as F

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.ops import nn as nn_ops

    fmt_of = torch.channels_last if fmt == "NHWC" else \
        torch.contiguous_format
    seen = []
    conv, conv_bwd = F.conv2d, nn_ops._Conv2d.backward

    def spy(x, w, *args):
        out = conv(x, w, *args)
        if out.device.type == "cuda":
            seen.append(("fwd", x.is_contiguous(memory_format=fmt_of),
                         out.is_contiguous(memory_format=fmt_of)))
        return out

    def spy_bwd(ctx, grad):
        out = conv_bwd(ctx, grad)
        seen.append(("bwd", grad.is_contiguous(memory_format=fmt_of),
                     out[0] is None or
                     out[0].is_contiguous(memory_format=fmt_of)))
        return out

    monkeypatch.setattr(F, "conv2d", spy)
    monkeypatch.setattr(nn_ops._Conv2d, "backward", staticmethod(spy_bwd))
    main, startup, loss, _ = _resnet18(fluid, fmt, True)
    scope = fluid.Scope()
    exe = fluid.Executor(cuda_device, cuda_graphs=False)
    exe.run(startup, scope=scope)
    del seen[:]
    exe.run(main, feed=smoke.resnet_feed(cuda_device, 8, 64, seed=2),
            fetch_list=[loss], scope=scope)
    assert len(seen) == 2 * 20
    assert all(x and out for _, x, out in seen), seen


def test_resnet18_on_card_matches_cpu(cuda_device):
    """chip_smoke.py's card-vs-CPU check: ResNet-18 fp32 at 64x64,
    batch 8, 3 graphed steps on the card against the port's CPU path
    from one state, each loss and persistable after every step within
    max(CARD_CPU_RTOL, 3 x what fp32 rounding alone moves it, read from
    the CPU's float64 run)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import resnet

    smoke.resnet_card_vs_cpu(fluid, resnet, cuda_device)


# -- DeepFM: the sparse embedding engine's device tier on the card -----------
DEEPFM_CARD_BATCH = 1024


def _deepfm_start(fluid, device, is_sparse=True):
    from paddle_tpu_torch.models import deepfm

    prog = smoke.deepfm_program(fluid, deepfm, is_sparse=is_sparse)
    scope = fluid.Scope()
    fluid.Executor(device, cuda_graphs=False).run(prog[1], scope=scope)
    feed = smoke.deepfm_feed(deepfm, DEEPFM_CARD_BATCH, seed=5, dev=device)
    return prog, scope, feed


def test_deepfm_sparse_graphed_matches_eager(cuda_device):
    """DeepFMConfig(), is_sparse=True, batch 1024: 4 graphed steps (run
    1 eager, run 2 captured, then replays) against 4 eager ones from one
    state: the losses and every persistable (tables, Adam moments, MLP)
    equal to the bit, with 3 replays. The static-size unique, the
    per-row sums and the scatters take no host sync and one fixed
    order."""
    from paddle_tpu_torch import fluid

    (main, _, loss, _), scope, feed = _deepfm_start(fluid, cuda_device)
    graphed, eager = (smoke.clone_scope(fluid, scope) for _ in range(2))
    r0 = _replays()
    got = _losses(fluid.Executor(cuda_device), main, loss, feed, graphed, 4)
    assert _replays() - r0 == 3
    want = _losses(fluid.Executor(cuda_device, cuda_graphs=False), main,
                   loss, feed, eager, 4)
    assert got == want and all(np.isfinite(got))
    assert smoke.unequal(graphed, eager) == []


def test_deepfm_rows_named_from_both_ends_graphed_matches_eager(
        cuda_device):
    """DeepFMConfig(), is_sparse=True, batch 1024, every other lookup's
    id written as id - vocab (the same row, counted from the end), so
    most touched rows take two Adam updates a step, as in the reference:
    3 graphed steps against 3 eager ones and 3 eager again from one
    state, the losses and every persistable equal to the bit
    (``chip_smoke.graphed_vs_eager``). The two updates of a row land in
    two scatters, one after the other, never in one atomic race."""
    from paddle_tpu_torch import fluid

    (main, _, loss, _), scope, feed = _deepfm_start(fluid, cuda_device)
    ids = feed["sparse_ids"].clone()
    ids.view(-1)[::2] -= 100000
    smoke.graphed_vs_eager(fluid, cuda_device, main,
                           dict(feed, sparse_ids=ids), loss, scope,
                           "deepfm_both_ends")


def test_deepfm_untouched_rows_frozen_on_card(cuda_device):
    """chip_smoke.py's SelectedRows step check at batch 1024: [n, dim]
    gradients with their rows, no [vocab, ...] tensor made, and after 3
    graphed steps the untouched rows of both tables and of their Adam
    moments equal to the bit, every touched row moved."""
    from paddle_tpu_torch import fluid

    (main, _, loss, _), scope, feed = _deepfm_start(fluid, cuda_device)
    smoke.deepfm_sparse_step(fluid, cuda_device, main, feed, loss, scope,
                             100000)


@pytest.mark.parametrize("is_sparse", [True, False],
                         ids=["sparse", "dense"])
def test_out_of_range_id_reads_nan_without_device_assert(cuda_device,
                                                         is_sparse):
    """Vocabulary 10, Adam, ids 12 and -11 beside in-range ones (-1
    counts from the end): the lookup reads NaN rows there, graphed and
    eager, and no device assert fires; those positions' updates are
    dropped and every parameter stays finite and equal to the port's CPU
    run within 1e-6; a later step in the same process still runs."""
    from paddle_tpu_torch import fluid

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 4
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("ids", shape=[3], dtype="int64")
        emb = fluid.layers.embedding(ids, size=[10, 2], is_sparse=is_sparse,
                                     param_attr=fluid.ParamAttr(name="w"))
        loss = fluid.layers.mean(fluid.layers.reduce_sum(emb, dim=-1))
        fluid.optimizer.Adam(learning_rate=0.1).minimize(loss)
    cpu = fluid.Scope()
    fluid.Executor("cpu").run(startup, scope=cpu)
    card = fluid.Scope()
    for n in cpu.local_var_names():
        card.set_var(n, cpu.find_var(n).to(cuda_device))
    w0 = cpu.find_var("w").clone()
    bad = {"ids": np.array([[1, 12, 2], [-11, 1, -1]], np.int64)}
    exe, cexe = fluid.Executor(cuda_device), fluid.Executor("cpu")
    for _ in range(3):             # eager, captured, replayed
        out = exe.run(main, feed=bad, fetch_list=[emb], scope=card)[0]
        want = cexe.run(main, feed=bad, fetch_list=[emb], scope=cpu)[0]
        torch.cuda.synchronize()
        nan = np.isnan(out)
        assert nan[0, 1].all() and nan[1, 0].all() and nan.sum() == 4
        np.testing.assert_array_equal(nan, np.isnan(want))
    for n in cpu.local_var_names():
        got = card.find_var(n).cpu()
        assert torch.isfinite(got).all(), n
        np.testing.assert_allclose(got.numpy(), cpu.find_var(n).numpy(),
                                   atol=1e-6, err_msg=n)
    moved = (card.find_var("w").cpu() != w0).any(dim=1)
    assert moved[[1, 2, 9]].all() and not moved[[0, 3, 4, 5, 6, 7, 8]].any()
    good = {"ids": np.array([[3, 4, 5], [6, 7, 8]], np.int64)}
    assert np.isfinite(exe.run(main, feed=good, fetch_list=[loss],
                               scope=card)[0]).all()
    torch.cuda.synchronize()


def test_dygraph_defaults_to_the_card(cuda_device):
    """``dygraph.guard()`` with no place, its variables and layers, and
    a Transformer built under it, all on the card."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import dygraph

    with dygraph.guard():
        assert fluid.framework._dygraph_tracer().device.type == "cuda"
        x = dygraph.to_variable(np.ones((2, 3), np.float32))
        lin = dygraph.nn.Linear(3, 2)
        assert x._ivar.is_cuda and lin.weight.is_cuda
        assert lin(x)._ivar.is_cuda
        model = T.Transformer.tiny()
        assert all(p.is_cuda for p in model.parameters())
    assert dygraph.nn.Linear(3, 2).weight.is_cuda


def _traced_tiny(fluid, dygraph, dev, dropout, amp):
    """Transformer.tiny traced on the card in training mode, with
    chip_smoke's loss and (AMP) Adam appended; its startup run."""
    args, labels = smoke.transformer_args(T, 4, 16)
    args = (args[0] % 512, args[1] % 512) + args[2:]
    labels = labels % 512
    with fluid.unique_name.guard(), dygraph.guard(dev):
        model = T.Transformer.tiny(dropout_rate=dropout, seed=3)
        _, traced = dygraph.jit.trace(
            model, [dygraph.to_variable(a) for a in args])
    with fluid.unique_name.guard():
        startup, loss = smoke.transformer_static(fluid, traced, 16, amp=amp,
                                                 vocab=512)
    traced._materialize_scope()
    fluid.Executor(dev, cuda_graphs=False).run(startup, scope=traced._scope)
    return model, traced, loss, args, labels


def test_traced_transformer_graphed_equals_eager(cuda_device):
    """A traced Transformer-tiny's AMP step (dropout 0.1): graphed equals
    eager to the bit over chip_smoke's CHECK_STEPS steps, losses and
    every persistable (``chip_smoke.graphed_vs_eager``)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import dygraph

    _, traced, loss, args, labels = _traced_tiny(fluid, dygraph, cuda_device,
                                                 0.1, True)
    feed = smoke.transformer_feed(traced, args, labels, cuda_device)
    smoke.graphed_vs_eager(fluid, cuda_device, traced.program, feed, loss,
                           traced._scope, "transformer_tiny")


def test_eager_dygraph_loss_equals_traced_first_loss(cuda_device):
    """At p 0, the eager dygraph loss of the model (``loss_fn``) and the
    traced program's first loss (``mean`` of the same cross-entropy)
    agree on the card, and the model's parameters are the program's."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import dygraph

    model, traced, loss, args, labels = _traced_tiny(fluid, dygraph,
                                                     cuda_device, 0.0, False)
    with dygraph.guard(cuda_device), dygraph.no_grad():
        want = float(T.loss_fn(model(*[dygraph.to_variable(a) for a in args]),
                               dygraph.to_variable(labels)).numpy())
    exe = fluid.Executor(cuda_device)
    got = smoke.fetch_losses(exe, traced.program, smoke.transformer_feed(
        traced, args, labels, cuda_device), [loss], traced._scope, 1)[0]
    exe.close()
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)
    for _, p in model.named_parameters():
        assert traced._scope.find_var(p.name).data_ptr() == p.data_ptr()


# -- the host embedding tier and dataset feeding on the card ------------------

def _host_start(device, budget=4096, batch=256):
    """bench.py's embedding bench shape (chip_smoke.HOST_BENCH) with
    fm_emb on a fresh HostEmbeddingTable: (table, main, loss, scope after
    startup, seeded feeds)."""
    from paddle_tpu_torch import embedding, fluid
    from paddle_tpu_torch.models import deepfm

    b = smoke.HOST_BENCH
    cfg = smoke.host_cfg(deepfm, b["vocab"], b["fields"], b["dense"],
                         b["dim"], b["fc"])
    table, main, startup, loss = smoke.host_program(fluid, deepfm, embedding,
                                                    cfg, budget)
    scope = fluid.Scope()
    fluid.Executor(device).run(startup, scope=scope)
    feeds = [deepfm.synthetic_batch(cfg, batch, seed=i) for i in range(21)]
    return table, main, loss, scope, feeds


def test_host_admission_writes_in_place(cuda_device):
    """20 graphed steps with evictions: the cache and its moments keep
    their storage (admission is index_copy_ into the scope's tensors), so
    no replay copies state into the graph's captured storage."""
    from paddle_tpu_torch import embedding, fluid
    from paddle_tpu_torch.fluid import monitor

    table, main, loss, scope, feeds = _host_start(cuda_device)
    exe = fluid.Executor(cuda_device)
    names = ["fm_emb@CACHE", "fm_emb@CACHE_moment1_0",
             "fm_emb@CACHE_moment2_0"]
    copies = monitor.counter("executor_graph_state_copy_total")
    evictions = monitor.counter("embedding_evictions_total",
                                labels={"table": "fm_emb"})
    exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
    ptrs = [scope.find_var(n).data_ptr() for n in names]
    c0, e0 = copies.value, evictions.value
    for f in feeds[1:]:
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
        embedding.prefetch(main, f)
    table.close()
    assert [scope.find_var(n).data_ptr() for n in names] == ptrs
    assert copies.value == c0 and evictions.value > e0
    embedding.reset_tables()


def _host_losses(device, plant=None, monkeypatch=None):
    from paddle_tpu_torch import embedding, fluid

    table, main, loss, scope, feeds = _host_start(device)
    if plant is not None:
        monkeypatch.setattr(type(table), "_copy_rows", staticmethod(plant))
    exe = fluid.Executor(device)
    out = []
    for i, f in enumerate(feeds):
        out.append(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0])
        if i + 1 < len(feeds):
            embedding.prefetch(main, feeds[i + 1])
    out.append(table.snapshot())
    embedding.reset_tables()
    return out


def test_host_prefetched_rows_are_waited_on(cuda_device, monkeypatch):
    """A slow copy planted on the prefetch's side stream (a sleep before
    the rows' copies): prepare makes the current stream wait on the
    stage's event, so the losses and the flushed host store equal an
    unplanted run's to the bit."""
    from paddle_tpu_torch.embedding import host

    copy = host.HostEmbeddingTable._copy_rows

    def slow(sources, device):
        torch.cuda._sleep(50 * smoke.HOLD_CYCLES)   # on the side stream
        return copy(sources, device)

    want = _host_losses(cuda_device)
    got = _host_losses(cuda_device, plant=slow, monkeypatch=monkeypatch)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_host_stager_fed_loop_equals_unstaged(cuda_device, monkeypatch):
    """train_from_dataset (a DeviceStager copying each batch on its own
    stream, a slow copy planted before each) against a plain exe.run loop
    over the same batches: the flushed host store, its moments and every
    device persistable equal to the bit."""
    from paddle_tpu_torch import embedding, fluid
    from paddle_tpu_torch.fluid import reader
    from paddle_tpu_torch.models import deepfm

    stage = reader.stage_feed

    def slow(feed, place="cuda", **kw):
        with torch.cuda.stream(reader._stage_stream(torch.device(place))):
            torch.cuda._sleep(20 * smoke.HOLD_CYCLES)
        return stage(feed, place, **kw)

    monkeypatch.setattr(reader, "stage_feed", slow)
    # 26 fields at batch 256: about 6300 distinct ids a batch
    d = dict(vocab=65536, budget=16384, batch=256, batches=6)
    monkeypatch.setattr(smoke, "HOST_DATASET", d)
    rec = smoke.host_dataset(fluid, deepfm, embedding,
                             fluid.monitor, cuda_device)
    assert not rec["unequal"] and rec["states"] > 20
    assert rec["train_from_dataset"]["batches"] == d["batches"]


# -- py_reader windows, checkpoints and recompute on the card -----------------

def _reader_tiny(fluid, device, n_batches=16, recompute=False):
    """BERT-tiny packed AMP (dropout 0.1, S 64, batch 4) fed by its
    py_reader over ``n_batches`` seeded batches, the startup run in a
    scope: (main, loss, scope, persistable names)."""
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.tiny()
    cfg.use_fused_attention = "packed"
    with fluid.unique_name.guard():
        main, startup, loss = bert.build_pretrain_program(
            cfg, seq_len=64, use_amp=True, py_reader_batch=4,
            recompute=recompute)
    batches = [bert.reader_batch(bert.synthetic_batch(cfg, 4, 64, seed=i))
               for i in range(n_batches)]
    main.py_reader.decorate_tensor_provider(lambda: iter(batches))
    scope = fluid.Scope()
    fluid.Executor(device, cuda_graphs=False).run(startup, scope=scope)
    return main, loss, scope, smoke.persistable_names(main)


def _windows(fluid, device, main, loss, scope, prefetch):
    exe = fluid.Executor(device)
    main.py_reader.start()
    out = [exe.run(main, fetch_list=[loss], scope=scope, iters=4,
                   prefetch=prefetch)[0] for _ in range(4)]
    exe.close()
    main.py_reader.reset()
    return np.concatenate([o.reshape(-1) for o in out])


def test_window_prefetch_waits_for_a_slow_copy(cuda_device, monkeypatch):
    """A slow copy planted on the stager stream before each prefetched
    window's copies: the replays wait on the window's event, so the
    prefetched trajectory equals the inline one to the bit."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import reader

    main, loss, scope, _ = _reader_tiny(fluid, cuda_device)
    want = _windows(fluid, cuda_device, main, loss, smoke.clone_scope(
        fluid, scope), prefetch=False)
    copy = reader.copy_feed

    def slow(feed, device, keep_on_host=()):
        with torch.cuda.stream(reader._stage_stream(device)):
            torch.cuda._sleep(50 * smoke.HOLD_CYCLES)
        return copy(feed, device, keep_on_host)

    monkeypatch.setattr(reader, "copy_feed", slow)
    got = _windows(fluid, cuda_device, main, loss, smoke.clone_scope(
        fluid, scope), prefetch=True)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all()


def test_graph_rollback_restores_the_version(cuda_device, tmp_path):
    """The smoke's checkpointed run at BERT-tiny, graphed: a planted
    non-finite step 6 rolls back to the step-4 version (scope, generator,
    reader) to the bit, the next replay copies the restored values into
    the captured storage (no state tensor rebound, no new capture) and
    equals a fresh eager step from the version; the committed trajectory
    and final state equal an uninterrupted run's."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import faults, monitor
    from paddle_tpu_torch.fluid.io import CheckpointManager

    main, loss, init, names = _reader_tiny(fluid, cuda_device)
    sc, exe = smoke.clone_scope(fluid, init), fluid.Executor(cuda_device)
    main.py_reader.start()
    plain = smoke.reader_steps(exe, main, loss, sc, smoke.CKPT_STEPS)
    digest = smoke.state_digest(sc, names)
    exe.close()
    main.py_reader.reset()
    rec = smoke.checkpointed_run(fluid, faults, monitor, cuda_device, main,
                                 loss, init, names, CheckpointManager,
                                 str(tmp_path / "v"))
    assert rec["rollback_exact"] and rec["eager_equal"], rec
    assert rec["rebound"] == 0 and rec["new_captures"] == 0, rec
    assert rec["state_copies"] == len(names) and rec["rollbacks"] == 1
    assert rec.pop("losses") == plain and rec.pop("digest") == digest
    assert rec["versions"] == [8, 12]


def _recompute_tiny(fluid, device, recompute, graphs, steps=4):
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.tiny()
    cfg.use_fused_attention = True
    with fluid.unique_name.guard():
        main, startup, loss = bert.build_pretrain_program(
            cfg, seq_len=64, recompute=recompute)
    scope = fluid.Scope()
    fluid.Executor(device, cuda_graphs=False).run(startup, scope=scope)
    feed = bert.synthetic_batch(cfg, 4, 64, seed=0)
    exe = fluid.Executor(device, cuda_graphs=graphs)
    smoke.reset_launches(A)
    losses = _losses(exe, main, loss, feed, scope, 1)
    launched = smoke.launches(A, smoke.FUSED_KERNELS)
    losses += _losses(exe, main, loss, feed, scope, steps - 1)
    state = {n: scope.find_var(n).clone()
             for n in smoke.persistable_names(main)}
    exe.close()
    return losses, state, launched, cfg.n_layers


def test_recompute_graphed_equals_eager_and_plain(cuda_device):
    """BERT-tiny fp32 with dropout 0.1 under recompute: graphed equals
    eager, and equals the graphed run without recompute, to the bit; the
    eager step launches the attention forward once more per layer."""
    from paddle_tpu_torch import fluid

    g_loss, g_state, g_launch, L = _recompute_tiny(fluid, cuda_device,
                                                   True, True)
    e_loss, e_state, _, _ = _recompute_tiny(fluid, cuda_device, True, False)
    p_loss, p_state, p_launch, _ = _recompute_tiny(fluid, cuda_device,
                                                   False, True)
    assert g_loss == e_loss == p_loss and np.isfinite(g_loss).all()
    for n, t in p_state.items():
        assert torch.equal(g_state[n], t) and torch.equal(e_state[n], t), n
    assert [g_launch[k] for k in smoke.FUSED_KERNELS] == [2 * L, L, L]
    assert [p_launch[k] for k in smoke.FUSED_KERNELS] == [L, L, L]


# -- the persistent compile cache on the card -----------------------------------
def _prelowered_encoder(fluid, bert, device, dirname, sizes=(2, 4)):
    cfg = bert.BertConfig.tiny()
    cfg.use_fused_attention = "packed"
    feeds = ["src_ids", "pos_ids", "sent_ids", "input_mask"]
    with fluid.unique_name.guard():
        main, startup, enc = bert.build_encoder_program(cfg, seq_len=64)
    exe, scope = fluid.Executor(device), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup, scope=scope)
        fluid.io.save_inference_model(dirname, feeds, [enc], exe,
                                      main_program=main, prelower=True,
                                      prelower_batch_sizes=sizes)
    return cfg, feeds


def test_step_from_disk_entry_replays_equal_to_live(cuda_device, tmp_path,
                                                    monkeypatch):
    """A packed BERT-tiny encoder exported with prelower=True: a
    Predictor whose steps come from the disk entries (their plan, the
    attention library they name) answers to the bit as one building its
    steps live, from its graph's replays too."""
    import shutil

    from paddle_tpu_torch import fluid, inference
    from paddle_tpu_torch.fluid import compile_cache, monitor
    from paddle_tpu_torch.models import bert

    monkeypatch.delenv(compile_cache.ENV_DIR, raising=False)
    d = str(tmp_path / "enc")
    cfg, feeds = _prelowered_encoder(fluid, bert, cuda_device, d)
    pl = os.path.join(d, compile_cache.PRELOWERED_DIRNAME)
    assert os.listdir(os.path.join(pl, compile_cache.KERNELS_DIRNAME))
    live_dir = str(tmp_path / "live")
    shutil.copytree(d, live_dir, ignore=shutil.ignore_patterns(
        compile_cache.PRELOWERED_DIRNAME))
    hits = monitor.counter("executor_compile_cache_disk_hit_total")
    h0 = hits.value
    cached = inference.create_predictor(inference.Config(d))
    live = inference.create_predictor(inference.Config(live_dir))
    batch = bert.synthetic_batch(cfg, 4, 64, seed=3)
    r0 = _replays()
    for rows in (2, 4, 2, 4, 2, 4):
        feed = {n: batch[n][:rows] for n in feeds}
        np.testing.assert_array_equal(cached.run(feed)[0],
                                      live.run(feed)[0])
    assert hits.value - h0 == 2 and _replays() - r0 == 8


def _fresh_tiers(monkeypatch, tmp_path):
    """The library tiers of kernels/_build.py with no library loaded and
    an empty _build/ (the process's loaded libraries stay loaded)."""
    from paddle_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_PATHS", {})
    monkeypatch.setattr(_build, "_READ_DIRS", [])
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "no_build"))
    return _build


def test_library_from_read_tier_starts_no_nvcc(cuda_device, tmp_path,
                                               monkeypatch):
    """A library found in a read tier (a model's __prelowered__/kernels/,
    its sha256 checked) is loaded with no nvcc run, and its kernels
    launch and agree with the plain version."""
    from paddle_tpu_torch.fluid import compile_cache

    built = A._build.library("fused_attention") and \
        A._build.loaded_from("fused_attention")
    _build = _fresh_tiers(monkeypatch, tmp_path)
    monkeypatch.setenv(compile_cache.ENV_DIR, str(tmp_path / "cache"))
    tier = str(tmp_path / "model" / "__prelowered__" / "kernels")
    os.makedirs(tier)
    dst = os.path.join(tier, os.path.basename(built))
    shutil_copy(built, dst)
    _build._write_sidecar(dst, _build.sha256_file(built))
    _build.add_read_dir(tier)
    n0_nvcc = _build.nvcc_runs
    lib = _build.library("fused_attention")
    assert _build.loaded_from("fused_attention") == dst
    assert _build.nvcc_runs == n0_nvcc
    # and it launches: one attention forward on its kernels, against
    # the plain version
    assert lib is _build.library("fused_attention")
    q, k, v = (torch.randn(1, 2, 64, 32, device=cuda_device)
               for _ in range(3))
    n0 = A.fused_attention_fwd_kernel.launches
    out = A.flash_attention(q, k, v)[0]
    want = torch.softmax(q @ k.transpose(-1, -2) * 32 ** -0.5, -1) @ v
    torch.cuda.synchronize()
    assert A.fused_attention_fwd_kernel.launches == n0 + 1
    assert (out - want).abs().max().item() <= 2e-5
    assert _build.nvcc_runs == n0_nvcc


def shutil_copy(src, dst):
    import shutil
    shutil.copyfile(src, dst)


def test_truncated_library_is_quarantined_and_rebuilt(cuda_device,
                                                      tmp_path,
                                                      monkeypatch):
    """A truncated library in the compile cache's kernels/ (its sidecar
    intact) is quarantined, never loaded, and rebuilt by one nvcc into
    the cache dir."""
    from paddle_tpu_torch.fluid import compile_cache, monitor

    built = A._build.library("decode_attention") and \
        A._build.loaded_from("decode_attention")
    _build = _fresh_tiers(monkeypatch, tmp_path)
    cache = str(tmp_path / "cache")
    monkeypatch.setenv(compile_cache.ENV_DIR, cache)
    tier = os.path.join(cache, compile_cache.KERNELS_DIRNAME)
    os.makedirs(tier)
    dst = os.path.join(tier, os.path.basename(built))
    with open(built, "rb") as f, open(dst, "wb") as g:
        g.write(f.read()[:4096])
    _build._write_sidecar(dst, _build.sha256_file(built))
    q0 = monitor.counter("compile_cache_quarantined_total").value
    n0 = _build.nvcc_runs
    _build.library("decode_attention")
    assert monitor.counter("compile_cache_quarantined_total").value == q0 + 1
    assert os.path.exists(dst + compile_cache.QUARANTINE_SUFFIX)
    assert _build.nvcc_runs == n0 + 1
    assert _build.loaded_from("decode_attention") == dst
    assert _build._expected_sha(dst) == _build.sha256_file(dst)


# -- the padded recurrent slice: beam search, the step counter, gru_unit -------


def _beam_search_program(B, beam, V, end_id):
    from paddle_tpu_torch import fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        pre_ids = L.data("pre_ids", [B * beam, 1], dtype="int64",
                         append_batch_size=False)
        pre_scores = L.data("pre_scores", [B * beam, 1],
                            append_batch_size=False)
        scores = L.data("scores", [B * beam, V], append_batch_size=False)
        outs = L.beam_search(pre_ids, pre_scores, None, scores, beam, end_id,
                             is_accumulated=False)
    return main, list(outs)


def test_beam_search_ties_on_card_match_cpu(cuda_device):
    """Planted ties (each row's best probability twice, equal previous
    scores, step 0's -1e9 beams, finished beams): the card selects the
    CPU's ids and parents exactly, in the order score descending, then
    candidate index ascending."""
    from paddle_tpu_torch import fluid

    B, beam, V, end_id = 16, 4, 3000, 1
    rng = np.random.RandomState(0)
    p = rng.rand(B * beam, V).astype(np.float32)
    p = np.round(p / p.sum(-1, keepdims=True) * 2e3) / 2e3 + 1e-4
    p[:, -1] = p.max(-1)
    p[:, 7] = p.max(-1)
    pre_scores = np.zeros((B * beam, 1), np.float32)
    pre_scores[np.arange(B * beam) % beam != 0] = -1e9
    pre_scores[beam * (B // 2):] = -0.5
    pre_ids = rng.randint(2, V, (B * beam, 1)).astype(np.int64)
    pre_ids[[5, 6, 40, 41, 42]] = end_id
    feed = {"pre_ids": pre_ids, "pre_scores": pre_scores,
            "scores": p.astype(np.float32)}
    main, outs = _beam_search_program(B, beam, V, end_id)
    card = fluid.Executor(cuda_device, cuda_graphs=False).run(
        main, feed=feed, fetch_list=outs, scope=fluid.Scope())
    cpu = fluid.Executor("cpu").run(main, feed=feed, fetch_list=outs,
                                    scope=fluid.Scope())
    np.testing.assert_array_equal(card[0], cpu[0])
    np.testing.assert_array_equal(card[2], cpu[2])
    np.testing.assert_allclose(card[1], cpu[1], rtol=1e-6)
    sel = cpu[1].reshape(B, beam)
    assert any(len(set(r)) < beam for r in sel.tolist())   # ties selected


def test_lr_step_counter_advances_across_replays(cuda_device):
    """``@LR_STEP@`` is incremented in place inside the captured step:
    six graphed runs read the counter 0..5 and the staircase learning
    rate at each, and the replays ran."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import monitor

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        loss = L.mean(L.fc(L.data("x", [4]), size=2))
        lr = L.exponential_decay(0.5, 2, 0.7, staircase=True)
        fluid.optimizer.SGD(lr).minimize(loss)
    scope, exe = fluid.Scope(), fluid.Executor(cuda_device)
    exe.run(startup, scope=scope)
    replays = monitor.counter("executor_graph_replay_total")
    r0 = replays.value
    feed = {"x": np.ones((3, 4), np.float32)}
    for step in range(6):
        got = exe.run(main, feed=feed, fetch_list=[lr], scope=scope)[0]
        assert int(scope.find_var("@LR_STEP@").item()) == step
        assert float(got.reshape(-1)[0]) == pytest.approx(
            0.5 * 0.7 ** (step // 2), rel=1e-6)
    assert replays.value - r0 >= 4
    exe.close()


def test_gru_unit_graphed_equals_eager(cuda_device):
    """A gru_unit layer trained by SGD: 3 graphed steps equal 3 eager
    ones to the bit (losses and every persistable)."""
    from paddle_tpu_torch import fluid

    H = 64
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        g = L.fc(L.data("x", [32]), size=3 * H)
        h = L.fc(L.data("h", [16]), size=H)
        hid, _, _ = L.gru_unit(g, h, 3 * H, origin_mode=True)
        loss = L.mean(L.elementwise_mul(hid, hid))
        fluid.optimizer.SGD(0.1).minimize(loss)
    scope = fluid.Scope()
    fluid.Executor(cuda_device, cuda_graphs=False).run(startup, scope=scope)
    rng = np.random.RandomState(2)
    feed = {"x": torch.from_numpy(rng.randn(8, 32).astype(np.float32))
            .to(cuda_device),
            "h": torch.from_numpy(rng.randn(8, 16).astype(np.float32))
            .to(cuda_device)}
    smoke.graphed_vs_eager(fluid, cuda_device, main, feed, loss, scope,
                           "test_gru_unit")


def _lod_program(fluid, H=32):
    """Embedding, sequence_conv, a reversed dynamic_lstm with
    peepholes, MAX and SQRT pooling and a softmax fc: the sentiment
    nets' LoD ops in one program, trained by SGD."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 4
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        words = L.data("words", [1], dtype="int64", lod_level=1)
        label = L.data("label", [1], dtype="int64")
        emb = L.embedding(words, size=[50, 16])
        conv = L.sequence_conv(emb, num_filters=4 * H, filter_size=3,
                               act="tanh")
        hid, _ = L.dynamic_lstm(conv, size=4 * H, is_reverse=True)
        pooled = [L.sequence_pool(hid, "max"), L.sequence_pool(conv, "sqrt")]
        pred = L.fc(pooled, size=2, act="softmax")
        loss = L.mean(L.cross_entropy(pred, label))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def _lod_feed(fluid, seed, lens, rows=256):
    rng = np.random.RandomState(seed)
    data = np.zeros((rows, 1), np.int64)
    data[:sum(lens), 0] = rng.randint(0, 50, sum(lens))
    return {"words": fluid.create_lod_tensor(data, [lens]),
            "label": rng.randint(0, 2, (len(lens), 1)).astype(np.int64)}


def test_lod_replays_new_lengths_equal_to_eager(cuda_device):
    """Batches of other lengths in one bucket (the rows and the longest
    length's time bound, 40) replay one captured graph, each step equal
    to the eager executor's to the bit, a zero-length review included;
    then the card's state against the CPU's after the same steps."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import monitor

    main, startup, loss = _lod_program(fluid)
    cpu = fluid.Scope()
    fluid.Executor("cpu").run(startup, scope=cpu)
    feeds = [_lod_feed(fluid, i, lens) for i, lens in enumerate((
        [33, 5, 0, 20], [1, 38, 12, 7], [40, 40, 0, 1], [9, 9, 9, 35]))]
    captures = monitor.counter("executor_graph_capture_total")
    losses, scopes = {}, {}
    for label, graphs in (("eager", False), ("graphed", True)):
        card = fluid.Scope()
        for n in cpu.local_var_names():
            card.set_var(n, cpu.find_var(n).to(cuda_device, copy=True))
        exe = fluid.Executor(cuda_device, cuda_graphs=graphs)
        c0 = captures.value
        losses[label] = [float(exe.run(main, feed=f, fetch_list=[loss],
                                       scope=card)[0]) for f in feeds]
        if graphs:
            assert captures.value - c0 == 1
        exe.close()
        scopes[label] = card
    assert losses["graphed"] == losses["eager"]
    assert smoke.unequal(scopes["graphed"], scopes["eager"]) == []
    cexe = fluid.Executor("cpu")
    want = [float(cexe.run(main, feed=f, fetch_list=[loss], scope=cpu)[0])
            for f in feeds]
    np.testing.assert_allclose(losses["eager"], want, rtol=1e-4)


def _padded_lod(fluid, rows, data, lens):
    out = np.zeros((rows,) + data.shape[1:], data.dtype)
    out[:data.shape[0]] = data
    return fluid.create_lod_tensor(out, [lens])


def test_tagger_step_graphed_equals_eager(cuda_device):
    """models/tagger.py (embedding, fc, dynamic_gru, emission fc,
    linear_chain_crf) on Adam: 3 graphed steps equal 3 eager ones to the
    bit, losses and every persistable (the CRF's gold score from one-hot
    products, no atomics)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import tagger

    with fluid.unique_name.guard():
        main, startup, loss = tagger.build_train_program(
            vocab=300, num_tags=11, emb_dim=16, hidden=64)
    scope = fluid.Scope()
    fluid.Executor(cuda_device, cuda_graphs=False).run(startup, scope=scope)
    feed, lens = tagger.synthetic_tagging(np.random.RandomState(4), 8,
                                          vocab=300, num_tags=11,
                                          max_len=40)
    feed = {n: _padded_lod(fluid, 256, t.data(), lens)
            for n, t in feed.items()}
    smoke.graphed_vs_eager(fluid, cuda_device, main, feed, loss, scope,
                           "test_tagger")


def test_warpctc_step_graphed_equals_eager(cuda_device):
    """An fc over LoD frames trained by warpctc (log-space alpha
    recursion, autograd's backward) on SGD: graphed equals eager to the
    bit."""
    from paddle_tpu_torch import fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", [16], lod_level=1)
        y = L.data("y", [1], dtype="int64", lod_level=1)
        loss = L.mean(L.warpctc(L.fc(x, size=12), y, blank=0,
                                norm_by_times=True))
        fluid.optimizer.SGD(0.1).minimize(loss)
    scope = fluid.Scope()
    fluid.Executor(cuda_device, cuda_graphs=False).run(startup, scope=scope)
    rng = np.random.RandomState(5)
    xl, yl = [30, 1, 17, 40, 9], [6, 1, 3, 12, 4]
    feed = {"x": _padded_lod(fluid, 128, rng.randn(sum(xl), 16).astype(
        np.float32), xl),
        "y": _padded_lod(fluid, 32, rng.randint(1, 12, (sum(yl), 1)),
                         yl)}
    smoke.graphed_vs_eager(fluid, cuda_device, main, feed, loss, scope,
                           "test_warpctc")


def test_sampled_losses_graphed_equal_eager(cuda_device):
    """nce and the sampled softmax (uniform negatives from the scope's
    generator, drawn inside the graph), hsigmoid, and a 2-layer cudnn
    LSTM with dropout 0.3 between its layers: graphed equals eager to the
    bit, each replay drawing on from the generator as an eager step
    would."""
    from paddle_tpu_torch import fluid

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        seq = L.data("seq", [12, 16, 8], append_batch_size=False)
        ih = L.data("ih", [2, 16, 32], append_batch_size=False)
        ic = L.data("ic", [2, 16, 32], append_batch_size=False)
        out, _, _ = L.lstm(seq, ih, ic, 12, 32, 2, dropout_prob=0.3)
        x = L.reshape(L.slice(out, [0], [11], [12]), [16, 32])
        lab = L.data("lab", [1], dtype="int64")
        loss = L.mean(L.nce(x, lab, num_total_classes=50,
                            num_neg_samples=20))
        loss = loss + L.mean(L.sampled_softmax_with_cross_entropy(
            L.fc(x, size=50), lab, 10))
        loss = loss + L.mean(L.hsigmoid(x, lab, num_classes=50))
        fluid.optimizer.SGD(0.05).minimize(loss)
    scope = fluid.Scope()
    fluid.Executor(cuda_device, cuda_graphs=False).run(startup, scope=scope)
    rng = np.random.RandomState(6)
    feed = {"seq": rng.randn(12, 16, 8).astype(np.float32),
            "ih": np.zeros((2, 16, 32), np.float32),
            "ic": np.zeros((2, 16, 32), np.float32),
            "lab": rng.randint(0, 50, (16, 1)).astype(np.int64)}
    smoke.graphed_vs_eager(fluid, cuda_device, main, feed, loss, scope,
                           "test_sampled_losses")
