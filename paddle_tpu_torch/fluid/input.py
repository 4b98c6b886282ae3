"""The v1.6 input-layer module (counterpart of
``paddle_tpu/fluid/input.py``): ``fluid.input.embedding`` and
``fluid.input.one_hot``, which are the ``layers`` functions."""

from .layers import embedding, one_hot  # noqa: F401

__all__ = ["one_hot", "embedding"]
