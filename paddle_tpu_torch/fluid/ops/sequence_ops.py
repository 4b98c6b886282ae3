"""Sequence ops (counterpart of ``paddle_tpu/fluid/ops/sequence_ops.py``).

Only ``sequence_mask`` is ported: it is a dense op, which the padded
recurrent layers use to hold each row's state past its length
(``layers.rnn(sequence_length=)``). The LoD ops of the reference's
module (bounded-LoD rows and their segment arithmetic) wait for the LoD
half of ROADMAP queue 1 item 4 (sequence/LoD).
"""

import torch

from ..registry import register, to_torch_dtype


@register("sequence_mask")
def _sequence_mask(ctx, op):
    """[n, maxlen] of ``out_dtype``: 1 where the position is below the
    row's length X. ``maxlen`` is the attr, or the MaxLenTensor's value
    when the attr is not positive (read on the host: a program that is
    captured into a CUDA graph gives the attr)."""
    x = ctx.get_input(op, "X").reshape(-1)
    maxlen = op.attr("maxlen", -1)
    if maxlen is None or int(maxlen) <= 0:
        mv = ctx.get_input(op, "MaxLenTensor")
        if mv is None:
            raise ValueError("sequence_mask needs a maxlen attr or a "
                             "MaxLenTensor input")
        maxlen = int(mv.reshape(-1)[0])
    out = torch.arange(int(maxlen), dtype=x.dtype,
                       device=x.device)[None, :] < x[:, None]
    ctx.set_output(op, "Out", out.to(to_torch_dtype(
        op.attr("out_dtype", "int64"))))
