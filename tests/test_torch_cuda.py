"""paddle_tpu_torch on the card: each CUDA kernel against its plain
PyTorch version, and the decode sessions and a BERT-tiny training step
on the card against the same on the CPU. Every test needs a CUDA device
and skips without one. This file imports neither jax nor paddle_tpu, so it also runs on a
machine without them, skipping the suite's conftest (which imports jax):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: fp32 atol 2e-5 (fp32 accumulation in another order), bf16
atol 2e-2 (inputs rounded to bf16, fp32 accumulation; 3e-2 of the
largest magnitude for the fused attention's gradients); the paged kernel
equals the dense kernel on the gathered cache to 1e-6; greedy tokens of
the fp32 sessions (TF32 off) are identical on both devices."""

import numpy as np
import pytest
import torch

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


def test_kernel_wrapper_refuses_what_it_cannot_take(cuda_device):
    q = torch.zeros(1, 1, 1, 64, device=cuda_device)
    lens = torch.ones(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError, match="cache_len"):
        A.decode_attention_kernel(q, q, q, lens.long(), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        kc = torch.zeros(1, 1, 64, 2, device=cuda_device).transpose(2, 3)
        A.decode_attention_kernel(q, kc, kc, lens, 1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        A.decode_attention_kernel(q.half(), q.half(), q.half(), lens, 1.0)
    with pytest.raises(ValueError, match="itemsize"):
        q48 = torch.zeros(1, 1, 1, 48, device=cuda_device)
        A.decode_attention_kernel(q48, q48, q48, lens, 1.0)
    with pytest.raises(ValueError, match="16-byte boundary"):
        kc = torch.zeros(65, device=cuda_device)[1:].view(1, 1, 1, 64)
        A.decode_attention_kernel(q, kc, q, lens, 1.0)


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
    q = torch.zeros(1, 1, 1040, 64, device=cuda_device)
    with pytest.raises(NotImplementedError, match="long"):
        A.fused_attention(q, q, q)


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
