"""contrib: the port's counterpart of ``paddle_tpu/fluid/contrib``;
so far only ``mixed_precision`` (AMP)."""

from . import mixed_precision  # noqa: F401
