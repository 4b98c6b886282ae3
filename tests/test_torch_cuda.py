"""paddle_tpu_torch on the card: each CUDA kernel against its plain
PyTorch version, and the decode sessions on the card against the same
sessions on the CPU. Every test needs a CUDA device and skips without
one. This file imports neither jax nor paddle_tpu, so it also runs on a
machine without them, skipping the suite's conftest (which imports jax):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: fp32 atol 2e-5 (fp32 accumulation in another order), bf16
atol 2e-2 (inputs rounded to bf16, fp32 accumulation); the paged kernel
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
