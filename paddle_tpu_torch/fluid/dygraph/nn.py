"""``Linear``, ``Embedding`` and ``LayerNorm`` with the semantics of
``paddle_tpu/fluid/dygraph/nn.py`` and the ops they trace (``matmul``,
``elementwise_add``, ``lookup_table``, ``layer_norm``).

Parameters keep the reference's layouts so weights carry across as they
are: ``Linear.weight`` is [in, out] (the transpose of
``torch.nn.Linear``'s) and the layer computes ``x @ weight + bias``.
Weights are drawn like the reference's defaults (Xavier-uniform weights,
zero biases, unit LayerNorm scale) from an explicit ``torch.Generator``
on the parameter's device. Every layer takes ``device=`` and defaults to
``"cuda"``, which raises where torch sees no card.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ... import resolve_device

__all__ = ["Linear", "Embedding", "LayerNorm"]


def _xavier(shape, device, generator):
    """Xavier-uniform [fan_in, fan_out] (the reference's ``Xavier()``)."""
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    w = torch.empty(shape, device=device)
    return nn.Parameter(w.uniform_(-limit, limit, generator=generator))


class Linear(nn.Module):
    """``out = act(x @ weight + bias)``; weight [input_dim, output_dim]."""

    def __init__(self, input_dim, output_dim, act=None, device="cuda",
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        if act not in (None, "relu"):
            raise ValueError("Linear act must be None or 'relu', got %r"
                             % (act,))
        self._act = act
        self.weight = _xavier((input_dim, output_dim), device, generator)
        self.bias = nn.Parameter(torch.zeros(output_dim, device=device))

    def forward(self, x):
        out = torch.matmul(x, self.weight) + self.bias
        return F.relu(out) if self._act == "relu" else out


class Embedding(nn.Module):
    """``lookup_table``: rows of ``weight`` [vocab, dim] by id. As in the
    reference, ids of rank >= 2 with a trailing dim of 1 drop it, so
    [B, 1] ids embed to [B, dim] and [B, 1, 1] ids to [B, 1, dim]."""

    def __init__(self, size, device="cuda", generator=None):
        super().__init__()
        self.weight = _xavier(tuple(size), resolve_device(device), generator)

    def forward(self, ids):
        if ids.dim() >= 2 and ids.shape[-1] == 1:
            ids = ids[..., 0]
        return F.embedding(ids.long(), self.weight)


class LayerNorm(nn.Module):
    """Normalises over the axes from ``begin_norm_axis`` on, with the
    biased variance and ``epsilon`` inside the square root, then scales
    and shifts by the [prod(normalized_shape)] parameters."""

    def __init__(self, normalized_shape, begin_norm_axis=1, epsilon=1e-5,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        n = math.prod(normalized_shape)
        self._begin_norm_axis = begin_norm_axis
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(n, device=device))
        self.bias = nn.Parameter(torch.zeros(n, device=device))

    def forward(self, x):
        shape = x.shape[self._begin_norm_axis:]
        return F.layer_norm(x, shape, self.weight.view(shape),
                            self.bias.view(shape), self._epsilon)
