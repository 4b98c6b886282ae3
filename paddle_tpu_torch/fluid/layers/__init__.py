"""Static-graph layer functions: each appends ops to the default main
program (and parameter init ops to the startup program). The subset the
BERT pretraining program uses; the counterparts of
``paddle_tpu/fluid/layers``."""

from .io import data  # noqa: F401
from .loss import softmax_with_cross_entropy  # noqa: F401
from .nn import (dropout, einsum, elementwise_add, elementwise_div,  # noqa: F401
                 elementwise_mul, embedding, fc, fused_attention,
                 fused_attention_packed, gather, layer_norm, matmul,
                 reduce_sum, reshape, scale, softmax, transpose, unsqueeze)
from .tensor import create_parameter, fill_constant  # noqa: F401
