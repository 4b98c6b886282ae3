"""Static-graph layer functions: each appends ops to the default main
program (and parameter init ops to the startup program). The subset the
BERT, LeNet, ResNet and DeepFM programs use, and ``py_reader``; the
counterparts of ``paddle_tpu/fluid/layers``."""

from .extras import (get_tensor_from_selected_rows,  # noqa: F401
                     merge_selected_rows)
from .io import data  # noqa: F401
from .loss import (sigmoid_cross_entropy_with_logits,  # noqa: F401
                   softmax_with_cross_entropy)
from .metric_op import accuracy  # noqa: F401
from .nn import (batch_norm, conv2d, dropout, einsum,  # noqa: F401
                 elementwise_add, elementwise_div, elementwise_mul,
                 elementwise_sub, embedding, fc, fused_attention,
                 fused_attention_packed, gather, layer_norm, matmul, mean,
                 pool2d, reduce_sum, relu, reshape, scale, sign, softmax,
                 topk, transpose, unsqueeze)
from .ops import sigmoid  # noqa: F401
from .py_reader import (create_py_reader_by_data, double_buffer,  # noqa: F401
                        py_reader, read_file)
from .tensor import cast, concat, create_parameter, fill_constant  # noqa: F401
