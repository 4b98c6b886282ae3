"""Automatic mixed precision (bf16): the port's counterpart of
``paddle_tpu/fluid/contrib/mixed_precision``, with the same names and
the same emitted ops, so an AMP program's desc is the reference's."""

from .decorator import OptimizerWithMixedPrecision, decorate  # noqa: F401
from .fp16_lists import AutoMixedPrecisionLists  # noqa: F401
from .fp16_utils import cast_model_to_fp16, rewrite_program  # noqa: F401
