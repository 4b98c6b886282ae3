"""In-graph metric ops: accuracy (counterpart in
``paddle_tpu/fluid/ops/metrics.py``)."""

import torch

from ..registry import register


@register("accuracy")
def _accuracy(ctx, op):
    """The share of rows whose label is among the top-k ``Indices``
    (fp32), the count of those rows and the row count (int32 scalars).
    The row count is a shape constant, filled on the device: a copy from
    the host inside a CUDA-graph capture would break the capture."""
    idx = ctx.get_input(op, "Indices")              # [N, k] from top_k
    label = ctx.get_input(op, "Label")
    if label.dim() == 2 and label.shape[-1] == 1:
        label = label[..., 0]
    hit = (idx == label[:, None].to(idx.dtype)).any(dim=1)
    correct = hit.to(torch.float32).sum()
    total = idx.shape[0]
    ctx.set_output(op, "Accuracy", correct / total)
    ctx.set_output(op, "Correct", correct.to(torch.int32))
    ctx.set_output(op, "Total", torch.full((), total, dtype=torch.int32,
                                           device=idx.device))
