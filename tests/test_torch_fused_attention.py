"""The port's fused training attention (paddle_tpu_torch/kernels/attention.py)
held to the JAX package's: the same numpy inputs go through both, the JAX
side through its Pallas kernels (``_pallas_attention`` /
``_pallas_attention_bwd``) in interpret mode. On the CPU the port takes
its plain PyTorch version, which tests/test_torch_cuda.py holds the CUDA
kernels to on the card.

Tolerance: fp32, rtol 1e-5 and atol 1e-5 on the output and on the
gradients of q, k, v and bias (the same math summed in another order).
Dropout masks come from different generators in the two packages, so
parity runs at p = 0 and the port's mask is checked on its own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import attention as JA
from paddle_tpu_torch.kernels import attention as PA

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def pallas_calls(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode and count
    the calls of the two wrappers under test."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = JA._pallas_attention, JA._pallas_attention_bwd

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(JA, "_pallas_attention", count_fwd)
    monkeypatch.setattr(JA, "_pallas_attention_bwd", count_bwd)
    return calls


@pytest.mark.parametrize("S", [64, 40])
@pytest.mark.parametrize("bias_heads,bias_rows", [
    (1, 1),     # [B, 1, 1, S]: BERT's padding mask
    (2, 1),     # [B, H, 1, S]
    (1, 0),     # [B, 1, S, S]
    (2, 0),     # [B, H, S, S]
])
def test_fused_attention_matches_reference_kernels(pallas_calls, S,
                                                   bias_heads, bias_rows):
    rng = np.random.RandomState(S * 10 + bias_heads * 3 + bias_rows)
    B, H, d = 2, 2, 16
    q, k, v, do = (rng.randn(B, H, S, d).astype(np.float32)
                   for _ in range(4))
    bias = rng.randn(B, bias_heads, bias_rows or S, S).astype(np.float32)
    bias[0, ..., -5:] = -1e4          # padded keys of the first row

    def jax_loss(q_, k_, v_, b_):
        return jnp.sum(JA.fused_attention(q_, k_, v_, b_) * do)

    want_out = np.asarray(JA.fused_attention(q, k, v, bias))
    want_grads = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(q, k, v, bias)
    assert pallas_calls == {"fwd": 2, "bwd": 1}, pallas_calls

    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v, bias)]
    out = PA.fused_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    for name, g, w in zip("q k v bias".split(), grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


def test_philox_known_answers():
    """Philox4x32-10 against Random123's known-answer vectors."""
    z = torch.zeros((), dtype=torch.int64)
    ones = torch.full((), 0xFFFFFFFF, dtype=torch.int64)
    assert [int(w) for w in PA.philox4x32((z,) * 4, (z, z))] == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert [int(w) for w in PA.philox4x32((ones,) * 4, (ones, ones))] == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]


def _seed(n):
    return torch.tensor([n], dtype=torch.int64)


def test_plain_dropout_keep_rate_and_scale():
    """With uniform weights (q = k = 0) and v = 1 each output is the kept
    share of its row times 1/(1-p); over 2*2*256*256 draws the keep rate
    is within 0.5% of 1-p."""
    B, H, S, d, p = 2, 2, 256, 16, 0.1
    q = torch.zeros(B, H, S, d)
    out = PA.fused_attention(q, q, torch.ones(B, H, S, d), dropout_prob=p,
                             seed=_seed(5))
    keep = PA.dropout_keep_mask(B, H, S, p, _seed(5)).float()
    assert abs(keep.mean().item() - (1 - p)) < 0.005
    want = keep.sum(-1, keepdim=True) / (S * (1 - p))
    torch.testing.assert_close(out[..., :1], want, rtol=1e-5, atol=1e-6)


def test_plain_dropout_same_seed_same_output():
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 48, 16).astype(np.float32))
               for _ in range(3))
    a = PA.fused_attention(q, k, v, dropout_prob=0.2, seed=_seed(11))
    b = PA.fused_attention(q, k, v, dropout_prob=0.2, seed=_seed(11))
    c = PA.fused_attention(q, k, v, dropout_prob=0.2, seed=_seed(12))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_plain_dropout_gradient_uses_the_forward_mask():
    """dv = (dropped weights)^T dO exactly: the backward sees the mask the
    forward drew."""
    B, H, S, d, p = 1, 2, 64, 16, 0.3
    q = torch.zeros(B, H, S, d)
    v = torch.ones(B, H, S, d, requires_grad=True)
    out = PA.fused_attention(q, q, v, dropout_prob=p, seed=_seed(3))
    (dv,) = torch.autograd.grad(out.sum(), v)
    keep = PA.dropout_keep_mask(B, H, S, p, _seed(3)).float()
    want = (keep / (S * (1 - p))).sum(-2).unsqueeze(-1).expand_as(dv)
    torch.testing.assert_close(dv, want, rtol=1e-5, atol=1e-6)


def test_meta_tensors_give_shapes_only():
    q = torch.empty(2, 3, 40, 16, device="meta")
    out = PA.fused_attention(q, q, q, dropout_prob=0.1,
                             seed=torch.empty(1, dtype=torch.int64,
                                              device="meta"))
    assert out.shape == q.shape and out.device.type == "meta"


def test_fused_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 1, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        PA.fused_attention_fwd_kernel(q, q, q, None, (0, 0, 0), None, 1.0,
                                      0.0)
    lse = torch.zeros(1, 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        PA.fused_attention_bwd_dq_kernel(q, q, q, None, (0, 0, 0), None, q,
                                         lse, q, 1.0, 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        PA.fused_attention_bwd_dkdv_kernel(q, q, q, None, (0, 0, 0), None,
                                           lse, lse, q, 1.0, 0.0)
