"""The fp32 training attention's arithmetic on the tensor cores (3xTF32:
``attn_fwd_tf32x3``, ``attn_bwd_dq_tf32x3``, ``attn_bwd_dkdv_tf32x3``),
emulated on the CPU by ``tools/tf32_rehearsal.py`` and held to the JAX
package and to the port's plain version.

- TF32 rounding (cvt.rna.tf32.f32: to nearest, ties away from zero) on
  known values, and the hi/lo split that 3xTF32 multiplies (lo the
  remainder as the tensor cores read it, truncated to TF32).
- The emulated forward and gradients (dq, dk, dv, dbias) at B 2, H 3,
  ragged S 40, d 16 and 64, with a padding bias and a per-row bias,
  against the JAX package's ``fused_attention`` (its Pallas kernels in
  interpret mode, as tests/test_torch_fused_attention.py runs them) at
  p 0, and against the port's plain version at p 0 and 0.1 (one Philox
  mask): within chip_smoke.py's FUSED_ATOL for fp32 (2e-5) of max(1, the
  reference's largest magnitude).
- TF32 alone (hi.hi, the ``tf32x1`` fault of
  tools/attention_fault_check.py) lies past that limit on every output,
  and 3xTF32 more than ten times inside it: the fp32 limit tells the
  two apart.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as smoke
from paddle_tpu.kernels import attention as JA
from paddle_tpu_torch.kernels import attention as PA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = smoke.FUSED_ATOL[torch.float32]


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


R = _tool("tf32_rehearsal")


def test_tf32_rounding_and_split():
    one = 1.0
    x = torch.tensor([one, one + 2 ** -11, one + 2 ** -12,
                      -(one + 2 ** -11), one + 3 * 2 ** -11, 0.0, 3.0e-3],
                     dtype=torch.float32)
    got = R.tf32(x)
    # ties go away from zero; below half a TF32 step rounds down
    want = [one, one + 2 ** -10, one, -(one + 2 ** -10), one + 2 ** -9,
            0.0]
    assert got[:6].tolist() == want
    assert not (got.view(torch.int32) & 0x1FFF).any()
    g = torch.Generator().manual_seed(0)
    y = torch.randn(1000, generator=g) * 1e3
    hi, lo = R.split(y)
    assert not ((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF).any()
    assert ((hi + lo - y).abs() <= y.abs() * 2 ** -21).all()
    assert ((hi - y).abs() <= y.abs() * 2 ** -11).all()


def _case(d, bias_kind):
    B, H, S = 2, 3, 40
    shape = "padding" if bias_kind == "padding" else (B, 1, S, S)
    q, k, v, do, bias, seed = R.inputs(B, H, S, d, shape, 0.0, seed=d)
    return q, k, v, do, bias, seed


def _emulate(q, k, v, do, bias, seed, p, products):
    scale = q.shape[-1] ** -0.5
    o, lse = R.emulate_forward(q, k, v, bias, scale, p, seed, products)
    return (o,) + R.emulate_backward(q, k, v, bias, seed, do, o, lse, scale,
                                     p, products)


def _within(got, want, names, atol):
    for name, a, b in zip(names, got, want):
        b = torch.from_numpy(np.array(b))
        err = (a - b).abs().max().item()
        limit = atol * max(1.0, b.abs().max().item())
        assert err <= limit, (name, err, limit)


@pytest.mark.parametrize("bias_kind", ["padding", "per_row"])
@pytest.mark.parametrize("d", [16, 64])
def test_3xtf32_emulation_matches_reference(monkeypatch, d, bias_kind):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    q, k, v, do, bias, seed = _case(d, bias_kind)
    got = _emulate(q, k, v, do, bias, seed, 0.0, 3)
    qn, kn, vn, don, bn = (t.numpy() for t in (q, k, v, do, bias))

    def jax_loss(q_, k_, v_, b_):
        return jnp.sum(JA.fused_attention(q_, k_, v_, b_) * don)

    want = (np.asarray(JA.fused_attention(qn, kn, vn, bn)),) + tuple(
        jax.grad(jax_loss, argnums=(0, 1, 2, 3))(qn, kn, vn, bn))
    _within(got, want, R.OUTPUTS, ATOL)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("bias_kind", ["padding", "per_row"])
@pytest.mark.parametrize("d", [16, 64])
def test_3xtf32_emulation_matches_plain(d, bias_kind, p):
    q, k, v, do, bias, seed = _case(d, bias_kind)
    got = _emulate(q, k, v, do, bias, seed, p, 3)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
    ref = PA._ref_fused_attention(*leaves, d ** -0.5, p, seed)
    want = (ref.detach(),) + torch.autograd.grad(ref, leaves, do)
    _within(got, want, R.OUTPUTS, ATOL)


@pytest.mark.parametrize("bias_kind", ["padding", "per_row"])
@pytest.mark.parametrize("d", [16, 64])
def test_1xtf32_gap_exceeds_the_fp32_limit(d, bias_kind):
    """TF32 alone misses FUSED_ATOL on every output; 3xTF32 stays ten
    times inside it, on the same inputs (tools/tf32_rehearsal.py prints
    both at the bert path's shape)."""
    data = _case(d, bias_kind)
    three = R.errors(*data, 0.1, 3)
    one = R.errors(*data, 0.1, 1)
    assert all(three[x] <= ATOL / 10 for x in R.OUTPUTS), three
    assert all(one[x] > ATOL for x in R.OUTPUTS), one
