"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu, beside it.

It mirrors ``paddle_tpu``'s module paths where a reader would look for
the counterpart, imports ``torch`` and never ``jax`` or ``paddle_tpu``,
and runs its hand-written Hopper kernels (``kernels/csrc``) on CUDA
tensors. Entry points take ``device=`` and default to ``"cuda"``;
``device="cpu"`` runs the kernels' plain PyTorch versions.
"""

import torch

__all__ = ["resolve_device"]


def resolve_device(device):
    """``torch.device`` for ``device``; raises if it names CUDA and no
    card is present (the port never falls back to the CPU on its own).
    ``device`` is a ``torch.device``, its name, or a ``fluid.CPUPlace`` /
    ``fluid.CUDAPlace``."""
    device = torch.device(getattr(device, "_device", device))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device %r requested but torch sees no CUDA "
                           "device" % str(device))
    return device
