"""The arithmetic of the decode-attention kernels that split the key axis
(``decode_attention_kernel`` and ``decode_attention_combine`` in
csrc/decode_attention.cu), emulated in plain PyTorch on the CPU and held
to the plain version, to see without a card what the pieces, their empty
and all-masked partials and the combine do to the result.

    python3 tools/decode_rehearsal.py

The emulation follows the kernels: the span (``decode_span``: the
capacity, or the host's longest length) is cut into pieces of
``decode_piece(span, splits, granule)`` columns, the last running on to
the capacity; in each piece a q-row walks
tiles of ``tile`` columns with an online softmax in fp32 (running max m
from -1e30, l and acc rescaled by exp(m_old - m_new) each tile), over its
own columns only (col < limit, or the whole capacity with every score
-1e30 when its window is empty); a row with no column in a piece leaves
the empty partial m = -inf, l = 0. The combine merges a row's partials in
piece order: M = max m_i, o = sum_i exp(m_i - M) acc_i / sum_i
exp(m_i - M) l_i, skipping empty pieces (a row whose columns all lie in
piece 0 takes piece 0's acc / l, which the kernels write directly and
which the merge of one piece equals). ``fault`` plants what
tools/decode_fault_check.py plants in the kernels: ``drop_split`` (the
combine skips the last piece), ``no_rescale`` (the combine adds the
partials without exp(m_i - M)) and ``split_boundary`` (each piece after
the first skips its first column). Prints one JSON line per case and
emulation: max |emulation - plain| over max(1, the plain output's largest
magnitude), against chip_smoke.py's FP32_ATOL.
"""

import json
import math
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from paddle_tpu_torch.kernels import attention as A  # noqa: E402

FAULTS = ("drop_split", "no_rescale", "split_boundary")
MASKED = -1e30


def emulate_split_decode(q, k, v, cache_len, scale, causal_window, splits,
                         tile, granule=A.DECODE_PIECE_COLS, fault=None,
                         longest=None):
    """o [B, H, Q, d] in fp32 for q [B, H, Q, d], k/v [B, H, C, d] and
    cache_len [B], as the kernels compute it with ``splits`` pieces of
    ``decode_piece(span, splits, granule)`` columns (span =
    ``decode_span(C, longest)``; the last piece runs on to C) walked in
    tiles of ``tile`` columns, combined in piece order; ``fault`` one of
    FAULTS."""
    if fault not in (None,) + FAULTS:
        raise ValueError("unknown fault %r" % (fault,))
    B, H, Q, d = q.shape
    C = k.shape[2]
    s_all = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    v = v.float()
    valid = torch.clamp(cache_len.reshape(B).long(), max=C).view(B, 1, 1, 1)
    limit = valid.expand(B, 1, Q, 1)
    if causal_window:
        limit = limit - (Q - 1) + torch.arange(Q).view(1, 1, Q, 1)
    n_row = torch.where(limit > 0, limit, torch.full_like(limit, C))
    span = A.decode_span(C, longest)
    piece = A.decode_piece(span, splits, granule)
    starts = list(range(0, span, piece))
    parts = []
    for i, c_begin in enumerate(starts):
        c_end = C if i == len(starts) - 1 else c_begin + piece
        if fault == "split_boundary" and c_begin > 0:
            c_begin += 1
        m = torch.full((B, H, Q, 1), MASKED)
        l = torch.zeros(B, H, Q, 1)
        acc = torch.zeros(B, H, Q, d)
        for t0 in range(c_begin, c_end, tile):
            cols = torch.arange(t0, min(t0 + tile, c_end)).view(1, 1, 1, -1)
            s = s_all[..., t0:t0 + cols.shape[-1]]
            s = torch.where(cols < limit, s * scale,
                            torch.full_like(s, MASKED))
            s = torch.where(cols < n_row, s, torch.full_like(s, -math.inf))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p @ v[:, :, t0:t0 + cols.shape[-1]]
            m = m_new
        parts.append((torch.where(l > 0, m, torch.full_like(m, -math.inf)),
                      l, acc))
    if len(parts) == 1:
        return parts[0][2] / parts[0][1]
    if fault == "drop_split":
        parts = parts[:-1]
    big_m = torch.stack([m for m, _, _ in parts]).amax(0)
    o = torch.zeros(B, H, Q, d)
    total = torch.zeros(B, H, Q, 1)
    for m, l, acc in parts:
        w = torch.ones_like(m) if fault == "no_rescale" else \
            torch.exp(m - big_m)
        w = torch.where(m == -math.inf, torch.zeros_like(w), w)
        o = o + w * acc
        total = total + w * l
    return o / total


# (name, B, H, Q, C, d, lens, causal, splits): the serving path's shape
# cut to 2 heads, a long slot over 16 pieces, speculative verify rows
# with empty windows, a wrapped ring and slots of length 1
CASES = (("serving_cut", 8, 2, 1, 1024, 64,
          [1024, 300, 96, 70, 65, 1, 1, 1], False, 8),
         ("long_slot", 2, 2, 1, 2048, 64, [2048, 700], False, 16),
         ("verify_empty_windows", 4, 2, 4, 512, 64, [2, 3, 200, 512], True,
          4),
         ("wrapped_ring", 3, 2, 1, 512, 64, [513, 1000, 5], False, 4))
TILE = 32


def main():
    from chip_smoke import FP32_ATOL
    for name, B, H, Q, C, d, lens, causal, splits in CASES:
        g = torch.Generator().manual_seed(C + Q)
        q, k, v = (torch.randn(*s, generator=g)
                   for s in ((B, H, Q, d), (B, H, C, d), (B, H, C, d)))
        cache_len = torch.tensor(lens, dtype=torch.int32)
        want = A._ref_attention_cache(q, k, v, cache_len, d ** -0.5, causal)
        mag = max(1.0, want.abs().max().item())
        for fault in (None,) + FAULTS:
            got = emulate_split_decode(q, k, v, cache_len, d ** -0.5, causal,
                                       splits, TILE, fault=fault)
            err = (got - want).abs().max().item() / mag
            print(json.dumps(dict(
                case=name, splits=-(-C // A.decode_piece(C, splits)),
                fault=fault or "sound", rel_err=err, atol=FP32_ATOL,
                within=err <= FP32_ATOL)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
