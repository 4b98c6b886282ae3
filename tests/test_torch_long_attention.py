"""The port's training attention past S 1024 held to the JAX package's
long and flash tiers (``_pallas_attention_long(_bwd)``,
``_pallas_attention_flash(_bwd)``) in interpret mode, the way
tests/test_kernels.py drives them: the tier bounds are patched down
(``_MAX_FUSED_SEQ``, ``_MAX_LONG_SEQ``, ``_FLASH_BLOCK_CANDIDATES``) so
S 256 takes each tier with several tiles. On the CPU the port takes its
plain versions, which tests/test_torch_cuda.py holds the CUDA kernels
to on the card; the port has one kernel family for every S.

Tolerance: fp32, p = 0, rtol and atol 1e-5 on outputs, gradients and
the row logsumexp (the same math summed in another order)."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu.kernels import attention as JA
from paddle_tpu_torch.kernels import attention as PA

TOL = dict(rtol=1e-5, atol=1e-5)
B, H, S, D = 2, 2, 256, 16
SCALE = D ** -0.5
_WRAPPERS = ("_pallas_attention", "_pallas_attention_bwd",
             "_pallas_attention_long", "_pallas_attention_long_bwd",
             "_pallas_attention_flash", "_pallas_attention_flash_bwd")


@pytest.fixture
def tpu_calls(monkeypatch):
    """Interpret mode, the fused tier's bound at 64, and a count of the
    calls of each tier's wrappers."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(JA, "_MAX_FUSED_SEQ", 64)
    calls = collections.Counter()
    for name in _WRAPPERS:
        def counted(*a, _name=name, _fn=getattr(JA, name), **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(JA, name, counted)
    return calls


@pytest.fixture
def flash_tier(tpu_calls, monkeypatch):
    """The flash tier at S 256 in 64-row tiles (4 x 4 tiles)."""
    monkeypatch.setattr(JA, "_MAX_LONG_SEQ", 0)
    monkeypatch.setattr(JA, "_FLASH_BLOCK_CANDIDATES", (64,))
    return tpu_calls


def _inputs(bias_shape, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, H, S, D).astype(np.float32) * 0.5
                   for _ in range(4))
    bias = rng.randn(*bias_shape).astype(np.float32)
    bias[..., -7:] = -1e4               # padded keys
    return q, k, v, do, bias


def _both(q, k, v, do, bias):
    """(reference out and grads, port out and grads) through each
    package's ``fused_attention``."""
    def jax_loss(q_, k_, v_, b_):
        return jnp.sum(JA.fused_attention(q_, k_, v_, b_) * do)

    want = [np.asarray(JA.fused_attention(q, k, v, bias))] + [
        np.asarray(g) for g in jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
            q, k, v, bias)]
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v, bias)]
    out = PA.fused_attention(*leaves)
    got = [out.detach().numpy()] + [
        g.numpy() for g in torch.autograd.grad(out, leaves,
                                               torch.from_numpy(do))]
    return want, got


def _assert_close(want, got):
    for name, w, g in zip(("out", "dq", "dk", "dv", "dbias"), want, got):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("bias_shape", [
    (B, 1, 1, S),       # BERT's padding mask
    (B, H, 1, S),
    (B, H, S, S),       # per-row, per-head
])
def test_long_tier_matches_reference_kernels(tpu_calls, bias_shape):
    want, got = _both(*_inputs(bias_shape, sum(bias_shape)))
    assert tpu_calls == {"_pallas_attention_long": 2,
                         "_pallas_attention_long_bwd": 1}, tpu_calls
    _assert_close(want, got)


@pytest.mark.parametrize("bias_shape", [(B, 1, 1, S), (B, H, 1, S)])
def test_flash_tier_matches_reference_kernels(flash_tier, bias_shape):
    want, got = _both(*_inputs(bias_shape, sum(bias_shape) + 1))
    assert flash_tier == {"_pallas_attention_flash": 2,
                          "_pallas_attention_flash_bwd": 1}, flash_tier
    _assert_close(want, got)


@pytest.mark.parametrize("bias_shape", [(B, 1, 1, S), (B, H, 1, S),
                                        (1, 1, 1, S)])
def test_flash_contract_matches_reference(flash_tier, bias_shape):
    """flash_attention -> (o, lse) and flash_attention_backward -> (dq,
    dk, dv, dbias) against _pallas_attention_flash(_bwd) called directly
    (the reference's lse is [B, H, S, 1]; its dbias is per batch row, so
    a batch-broadcast bias sums it)."""
    q, k, v, do, bias = _inputs(bias_shape, 3 + len(set(bias_shape)))
    seed = jnp.zeros((1,), jnp.int32)
    jbias = jnp.broadcast_to(bias, (B,) + bias_shape[1:])
    o, lse = JA._pallas_attention_flash(q, k, v, jbias, SCALE, 0.0, seed)
    grads = JA._pallas_attention_flash_bwd(q, k, v, jbias, seed, do, o, lse,
                                           SCALE, 0.0)
    want = [np.asarray(o)] + [np.asarray(g) for g in grads]
    if bias_shape[0] == 1:
        want[-1] = want[-1].sum(0, keepdims=True)

    t = [torch.from_numpy(a) for a in (q, k, v, do, bias)]
    po, plse = PA.flash_attention(t[0], t[1], t[2], t[4], SCALE)
    np.testing.assert_allclose(plse.numpy(), np.asarray(lse)[..., 0], **TOL)
    pgrads = PA.flash_attention_backward(t[0], t[1], t[2], t[4], None, t[3],
                                         po, plse, SCALE)
    _assert_close(want, [po.numpy()] + [g.numpy() for g in pgrads])


def test_dropout_mask_of_one_pair_alone():
    """dropout_keep_mask of one (b, h) pair built alone with first_pair
    b * H + h, as chip_smoke.py builds it at S 8192, equals that pair's
    slice of the whole mask; so does the plain forward of the pair."""
    seed = torch.tensor([12345], dtype=torch.int64)
    Bm, Hm, Sm = 2, 3, 40
    whole = PA.dropout_keep_mask(Bm, Hm, Sm, 0.3, seed)
    q, k, v = (torch.randn(Bm, Hm, Sm, D) for _ in range(3))
    out = PA._ref_fused_attention(q, k, v, None, SCALE, 0.3, seed)
    for b in range(Bm):
        for h in range(Hm):
            one = PA.dropout_keep_mask(1, 1, Sm, 0.3, seed, b * Hm + h)
            assert torch.equal(one[0, 0], whole[b, h])
            pair = [t[b:b + 1, h:h + 1] for t in (q, k, v)]
            torch.testing.assert_close(
                PA._ref_fused_attention(*pair, None, SCALE, 0.3, seed,
                                        b * Hm + h)[0, 0], out[b, h])


def test_flash_backward_without_bias_grad():
    q = torch.randn(1, 2, 40, 16)
    bias = torch.zeros(1, 1, 1, 40)
    o, lse = PA.flash_attention(q, q, q, bias)
    *_, dbias = PA.flash_attention_backward(q, q, q, bias, None, q, o, lse,
                                            bias_grad=False)
    assert dbias is None


@pytest.mark.parametrize("S_", [512, 1024, 1088, 2048, 3072, 4096, 6144,
                                8192])
@pytest.mark.parametrize("d", [64, 128])
def test_reference_tier_names_the_tpu_dispatch(monkeypatch, S_, d):
    """The tier chip_smoke.py reports a launch under is the one the JAX
    package's own dispatch takes for that shape with BERT's [B, 1, 1, S]
    bias."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    q = jax.ShapeDtypeStruct((2, 12, S_, d), jnp.float32)
    bias = jax.ShapeDtypeStruct((2, 1, 1, S_), jnp.float32)
    want = ("fused" if JA._use_kernel(q, 0.0) else
            "long" if JA._use_long_kernel(q, 0.0, bias) else
            "flash" if JA._use_flash_kernel(q, 0.0, bias) else None)
    assert chip_smoke.reference_tier(S_, d) == want
