"""The arithmetic of the fp32 tensor-core kernels (``attn_fwd_tf32x3``,
``attn_bwd_dq_tf32x3``, ``attn_bwd_dkdv_tf32x3`` in
csrc/fused_attention.cu), emulated in plain PyTorch on the CPU and held
to the plain version, to see without a card how far 3xTF32 (and TF32
alone) takes them from fp32.

    python3 tools/tf32_rehearsal.py

The emulation follows the kernels: each fp32 operand x is split into
hi = x rounded to TF32 (round to nearest, ties away from zero, by bit
operations: cvt.rna.tf32.f32) and lo = x - hi truncated to TF32 (the
kernels pass lo's fp32 bits, which the tensor cores read truncated); a
product runs in steps of 8 along its contraction (one mma.sync m16n8k8
each), each step adding lo.hi, then hi.lo, then hi.hi into an fp32
accumulator (``products`` 3), or hi.hi alone (1, TF32). The products
whose A operand is an accumulator (P.V, dS.K, P^T.dO, dS^T.Q) take their
8-key steps in the kernels' relabelled order (slot t key 2t, slot t + 4
key 2t + 1), and each 64-row tile of them from a zero accumulator, added
to the fp32 sum. The forward runs over 64-key tiles with the kernel's
online softmax in log2 units (the weights summed undropped, O = O * corr
+ the tile's P.V); the backward recomputes P from lse, dS = P *
(dP * keep / (1 - p) - delta) and dbias from the fp32 dS. Prints one JSON
line per case and product count: each output's max |emulation - plain|
over max(1, the plain output's largest magnitude), against chip_smoke.py's
FUSED_ATOL for fp32.
"""

import json
import math
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as smoke  # noqa: E402
from paddle_tpu_torch.kernels import attention as A  # noqa: E402

TILE, STEP = 64, 8
# the order of an 8-key step's keys in the A and B slots of the products
# whose A operand is an accumulator tile: slot t is key 2t, t + 4 is 2t + 1
RELABEL = (0, 2, 4, 6, 1, 3, 5, 7)
OUTPUTS = ("out", "dq", "dk", "dv", "dbias")
# (name, B, H, S, d, bias_shape, p): the bert path's shape at a cut batch
# and two heads, a ragged S with a per-row bias, d 16
CASES = (("bert_path_cut", 1, 2, 512, 64, "padding", 0.1),
         ("ragged_per_row", 2, 3, 77, 64, (2, 3, 77, 77), 0.1),
         ("d16_padding", 2, 3, 100, 16, "padding", 0.0))


def tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero: add half of the 13 dropped bits to the bit
    pattern's magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncated(x):
    """x with the 13 bits below TF32's mantissa cleared: how the tensor
    cores read an fp32 operand's bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x):
    """(hi, lo): x = hi + lo to about fp32's accuracy, both TF32: hi
    rounded, lo the remainder truncated."""
    hi = tf32(x)
    return hi, tf32_truncated(x - hi)


def mm(a, b, products=3, relabel=False):
    """a [.., M, K] @ b [.., K, N] as the kernels' mma.sync chains: steps
    of 8 along K, each adding lo.hi, hi.lo and hi.hi (``products`` 3) or
    hi.hi (1) into an fp32 accumulator; with ``relabel`` (the products
    over keys or queries) each step takes K in the kernels' relabelled
    order and each 64-row tile of K runs from a zero accumulator, added
    to the sum."""
    (ah, al), (bh, bl) = split(a), split(b)
    K = a.shape[-1]
    total = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    c = torch.zeros_like(total)
    for k0 in range(0, K, STEP):
        idx = torch.arange(k0, min(k0 + STEP, K))
        if relabel and len(idx) == STEP:
            idx = idx[list(RELABEL)]
        pa = [x.index_select(-1, idx) for x in (ah, al)]
        pb = [x.index_select(-2, idx) for x in (bh, bl)]
        if products == 3:
            c = c + pa[1] @ pb[0]
            c = c + pa[0] @ pb[1]
        c = c + pa[0] @ pb[0]
        if relabel and (k0 + STEP) % TILE == 0:
            total, c = total + c, torch.zeros_like(c)
    return total + c


def _keep(B, H, S, p, seed):
    if p > 0.0:
        return A.dropout_keep_mask(B, H, S, p, seed)
    return torch.ones(B, H, S, S, dtype=torch.bool)


def emulate_forward(q, k, v, bias, scale, p, seed, products=3):
    """(o, lse) as attn_fwd_tf32x3 computes them, fp32."""
    B, H, S, d = q.shape
    keep = _keep(B, H, S, p, seed)
    log2e = 1.0 / math.log(2.0)
    bias = torch.zeros(1, 1, 1, S) if bias is None else bias.float()
    m = torch.full((B, H, S, 1), -float("inf"))
    l = torch.zeros(B, H, S, 1)
    acc = torch.zeros(B, H, S, d)
    for k0 in range(0, S, TILE):
        cols = slice(k0, min(k0 + TILE, S))
        s = mm(q, k[:, :, cols].transpose(-1, -2), products)
        s = s * (scale * log2e) + bias[..., cols] * log2e
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        w = torch.exp2(s - m_new)
        l = l * corr + w.sum(-1, keepdim=True)
        w = torch.where(keep[..., cols], w, 0.0)
        acc = acc * corr + mm(w, v[:, :, cols], products, relabel=True)
        m = m_new
    keep_scale = 1.0 / (1.0 - p) if p > 0.0 else 1.0
    return acc * (keep_scale / l), (m * math.log(2.0) +
                                    torch.log(l)).squeeze(-1)


def _reduce_to(t, shape):
    """t [B, H, S, S] summed over the dimensions ``shape`` broadcasts."""
    dims = [i for i, n in enumerate(shape) if n == 1 and t.shape[i] > 1]
    return t.sum(dims, keepdim=True) if dims else t


def emulate_backward(q, k, v, bias, seed, do, o, lse, scale, p,
                     products=3):
    """(dq, dk, dv, dbias) as attn_bwd_dq_tf32x3 and
    attn_bwd_dkdv_tf32x3 compute them (dbias None without a bias)."""
    B, H, S, _ = q.shape
    keep = _keep(B, H, S, p, seed)
    keep_scale = 1.0 / (1.0 - p) if p > 0.0 else 1.0
    delta = (do * o).sum(-1, keepdim=True)
    b = 0.0 if bias is None else bias.float()
    s = mm(q, k.transpose(-1, -2), products)
    dp = mm(do, v.transpose(-1, -2), products)
    pr = torch.exp(s * scale + b - lse.unsqueeze(-1))
    ds = pr * (torch.where(keep, dp * keep_scale, 0.0) - delta)
    pd = torch.where(keep, pr * keep_scale, 0.0)
    dq = mm(ds, k, products, relabel=True) * scale
    dk = mm(ds.transpose(-1, -2), q, products, relabel=True) * scale
    dv = mm(pd.transpose(-1, -2), do, products, relabel=True)
    dbias = None if bias is None else _reduce_to(ds, bias.shape)
    return dq, dk, dv, dbias


def inputs(B, H, S, d, bias_shape, p, seed=0):
    """fp32 q, k, v, dO, the bias (a padding mask, lengths S/2..S, or a
    random bias of ``bias_shape`` with its last two keys masked) and the
    dropout seed, from a generator seeded by the shape."""
    gen = torch.Generator().manual_seed(seed + S * d + B)
    q, k, v, do = (torch.randn(B, H, S, d, generator=gen) for _ in range(4))
    if bias_shape == "padding":
        lens = torch.randint(S // 2, S + 1, (B, 1), generator=gen)
        bias = torch.where(torch.arange(S)[None] < lens, 0.0,
                           -1e4).view(B, 1, 1, S)
    else:
        bias = torch.randn(*bias_shape, generator=gen)
        bias[..., -2:] = -1e4
    return q, k, v, do, bias, torch.tensor([S + d], dtype=torch.int64)


def errors(q, k, v, do, bias, seed, p, products):
    """{output: max |emulation - plain| / max(1, max |plain|)}."""
    scale = q.shape[-1] ** -0.5
    o, lse = emulate_forward(q, k, v, bias, scale, p, seed, products)
    got = (o,) + emulate_backward(q, k, v, bias, seed, do, o, lse, scale, p,
                                  products)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (q, k, v, bias)]
    ref = A._ref_fused_attention(*leaves, scale, p, seed)
    want = (ref.detach(),) + torch.autograd.grad(ref, leaves, do)
    return {key: ((a - b).abs().max() / max(1.0, b.abs().max().item())
                  ).item() for key, a, b in zip(OUTPUTS, got, want)}


def main():
    atol = smoke.FUSED_ATOL[torch.float32]
    for name, B, H, S, d, bias_shape, p in CASES:
        data = inputs(B, H, S, d, bias_shape, p)
        for products in (3, 1):
            err = errors(*data, p, products)
            print(json.dumps(dict(case=name, B=B, H=H, S=S, d=d, dropout=p,
                                  products=products, rel_err=err,
                                  fused_atol=atol,
                                  over=sorted(x for x in err
                                              if not err[x] <= atol))),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
