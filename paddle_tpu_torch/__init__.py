"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu, beside it.

It mirrors ``paddle_tpu``'s module paths where a reader would look for
the counterpart, imports ``torch`` and never ``jax`` or ``paddle_tpu``,
and runs its hand-written Hopper kernels (``kernels/csrc``) on CUDA
tensors. Entry points take ``device=`` and default to ``"cuda"``;
``device="cpu"`` runs the kernels' plain PyTorch versions.

The port is held to the reference in fp32, so its own fp32 products must
not drop to TF32 on the card; it turns TF32 off only while its work runs
(``fp32_products``) and leaves the process's flags as the user set them
otherwise.
"""

import contextlib
import threading

import torch

__all__ = ["resolve_device", "fp32_products"]


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


# how many blocks of the port's fp32 work are running, on any thread, and
# the TF32 flags from before the first of them
_FP32_LOCK = threading.Lock()
_FP32_DEPTH = 0
_FP32_SAVED = None


@contextlib.contextmanager
def fp32_products():
    """TF32 off for cuBLAS and cuDNN (``torch.backends.cuda.matmul
    .allow_tf32``, ``torch.backends.cudnn.allow_tf32``) while the block
    runs, then the flags as they were. The flags are process-wide: the
    first block to enter saves them and turns TF32 off, the last to
    leave restores them, under a module lock, so blocks on several
    threads (and nested blocks) neither serialise nor restore each
    other's saved value; torch code another thread runs in that window
    runs without TF32 too. Also a decorator."""
    global _FP32_DEPTH, _FP32_SAVED
    with _FP32_LOCK:
        if _FP32_DEPTH == 0:
            _FP32_SAVED = (torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _FP32_DEPTH += 1
    try:
        yield
    finally:
        with _FP32_LOCK:
            _FP32_DEPTH -= 1
            if _FP32_DEPTH == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _FP32_SAVED
