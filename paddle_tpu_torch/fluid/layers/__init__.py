"""Static-graph layer functions: each appends ops to the default main
program (and parameter init ops to the startup program). The subset the
BERT, LeNet and ResNet programs use; the counterparts of
``paddle_tpu/fluid/layers``."""

from .io import data  # noqa: F401
from .loss import softmax_with_cross_entropy  # noqa: F401
from .metric_op import accuracy  # noqa: F401
from .nn import (batch_norm, conv2d, dropout, einsum,  # noqa: F401
                 elementwise_add, elementwise_div, elementwise_mul,
                 embedding, fc, fused_attention, fused_attention_packed,
                 gather, layer_norm, matmul, mean, pool2d, reduce_sum, relu,
                 reshape, scale, sign, softmax, topk, transpose, unsqueeze)
from .tensor import create_parameter, fill_constant  # noqa: F401
