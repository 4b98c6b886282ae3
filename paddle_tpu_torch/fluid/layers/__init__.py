"""Static-graph layer functions: each appends ops to the default main
program (and parameter init ops to the startup program). The subset the
BERT, LeNet, ResNet, DeepFM, seq2seq, word2vec and VGG programs use,
the recurrent cells and beam search (``rnn``), the learning-rate
schedules, the comparisons (``control_flow``), and ``py_reader``; the
counterparts of ``paddle_tpu/fluid/layers``. What is not ported yet
(the LoD sequence layers, control-flow sub-blocks, the LoD recurrences)
raises, naming its ROADMAP item."""

from . import (control_flow, learning_rate_scheduler,  # noqa: F401
               math_op_patch, nn, ops, rnn, sequence_lod, tensor)
from .control_flow import *  # noqa: F401,F403
from .extras import (get_tensor_from_selected_rows,  # noqa: F401
                     merge_selected_rows)
from .io import data  # noqa: F401
from .learning_rate_scheduler import *  # noqa: F401,F403
from .loss import (cross_entropy,  # noqa: F401
                   sigmoid_cross_entropy_with_logits,
                   softmax_with_cross_entropy)
from .metric_op import accuracy  # noqa: F401
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .py_reader import (create_py_reader_by_data, double_buffer,  # noqa: F401
                        py_reader, read_file)
from .rnn import *  # noqa: F401,F403
from .sequence_lod import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
