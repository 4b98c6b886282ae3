"""The arithmetic of the tensor-core forward (``attn_fwd_mma`` in
csrc/fused_attention.cu), emulated in plain PyTorch on the CPU and held
to the plain version, to see without a card how far its rounding takes
it from the plain output.

    python3 tools/fwd_rehearsal.py

The emulation follows that kernel: bf16 (or fp16) q, k and v; fp32 scores
(scale * q.k^T + bias) * log2(e) over 64-key tiles; an online softmax in
log2 units that keeps the running row max and sum in fp32 and sums the
unrounded, undropped weights; the dropped weights in ``pieces`` pieces of
the input type (each what the ones before leave, rounded; the kernel's
count, ``kernel_pieces``, is read from its source) for each tile's P.V,
which joins the fp32 accumulator as acc * corr + P.V (the tile's sum
correctly rounded here: the tensor cores' is not); o = acc * (keep_scale
/ l) rounded to the input type, lse = m ln 2 + log(l). Prints one JSON
line per case and number of pieces (1, 2, 3 and fp32 P, "0"): out's max
|emulation - plain| over the plain output's largest magnitude, lse's
likewise, chip_smoke.py's limits for them (LONG_RTOL), and the share of
the outputs whose rounding to the input type differs from the plain
version's (a step of a BERT program carries each such flip on to its
loss).
"""

import json
import math
import os
import re
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as smoke  # noqa: E402
from paddle_tpu_torch.kernels import attention as A  # noqa: E402

TILE = 64
SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "paddle_tpu_torch", "kernels", "csrc", "fused_attention.cu")
# (name, B, H, S, d, p, dtype): the long tier's shape at a cut batch, the
# packed config-3 and BERT-tiny shapes at a cut batch, dropout on and off
CASES = (("long_S2048", 1, 4, 2048, 64, 0.0, torch.bfloat16),
         ("long_S2048_dropout", 1, 4, 2048, 64, 0.1, torch.bfloat16),
         ("config3_S128", 8, 12, 128, 64, 0.0, torch.bfloat16),
         ("config3_S128_dropout", 8, 12, 128, 64, 0.1, torch.bfloat16),
         ("tiny_S128", 8, 4, 128, 16, 0.0, torch.bfloat16),
         ("ragged_S500_f16", 2, 3, 500, 64, 0.1, torch.float16))


def kernel_pieces():
    """The pieces of P the tensor-core forward feeds P.V in (its
    ``kPPieces``, read from the source)."""
    with open(SOURCE) as f:
        return int(re.search(r"constexpr int kPPieces = (\d);",
                             f.read()).group(1))


def emulate_forward(q, k, v, bias, scale, p, seed, pieces):
    """(o in q's type, lse fp32) as attn_fwd_mma computes them."""
    B, H, S, _ = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    keep = (A.dropout_keep_mask(B, H, S, p, seed) if p > 0.0
            else torch.ones(B, H, S, S, dtype=torch.bool))
    log2e = 1.0 / math.log(2.0)
    m = torch.full((B, H, S, 1), -float("inf"))    # log2 units
    l = torch.zeros(B, H, S, 1)
    acc = torch.zeros(B, H, S, q.shape[-1])
    for k0 in range(0, S, TILE):
        cols = slice(k0, min(k0 + TILE, S))
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, cols])
        s = s * (scale * log2e) + bias[..., cols].float() * log2e
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        w = torch.exp2(s - m_new)
        l = l * corr + w.sum(-1, keepdim=True)
        w = torch.where(keep[..., cols], w, 0.0)
        if pieces:
            rest, w = w, torch.zeros_like(w)
            for _ in range(pieces):
                piece = rest.to(q.dtype).float()
                w, rest = w + piece, rest - piece
        acc = acc * corr + torch.einsum("bhqk,bhkd->bhqd", w,
                                        vf[:, :, cols])
        m = m_new
    o = (acc * ((1.0 / (1.0 - p)) / l)).to(q.dtype)
    return o, (m * math.log(2.0) + torch.log(l)).squeeze(-1)


def case(name, B, H, S, d, p, dtype, pieces=None):
    """The record of one case; ``pieces`` None: the kernel's."""
    pieces = kernel_pieces() if pieces is None else pieces
    gen = torch.Generator().manual_seed(S * d + B)
    q, k, v = (torch.randn(B, H, S, d, generator=gen).to(dtype)
               for _ in range(3))
    lens = torch.randint(S // 2, S + 1, (B, 1), generator=gen)
    bias = torch.where(torch.arange(S)[None] < lens, 0.0,
                       -1e4).view(B, 1, 1, S)
    seed = torch.tensor([S + d], dtype=torch.int64)
    scale = d ** -0.5
    o, lse = emulate_forward(q, k, v, bias, scale, p, seed, pieces)
    want_o, want_lse = A._ref_flash_attention(q, k, v, bias, scale, p, seed)
    rel = {key: ((a.float() - b.float()).abs().max() /
                 b.float().abs().max()).item()
           for key, a, b in (("out", o, want_o), ("lse", lse, want_lse))}
    rtol = {key: smoke.LONG_RTOL[dtype][key] for key in rel}
    return dict(case=name, B=B, H=H, S=S, d=d, dropout=p, dtype=str(dtype),
                pieces=pieces, rel_err=rel, rtol=rtol,
                flip_share=(o != want_o).float().mean().item())


def main():
    for c in CASES:
        for pieces in (1, 2, 3, 0):
            print(json.dumps(case(*c, pieces=pieces)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
