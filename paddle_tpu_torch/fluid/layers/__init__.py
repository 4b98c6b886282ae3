"""Static-graph layer functions: each appends ops to the default main
program (and parameter init ops to the startup program). The subset the
BERT, LeNet, ResNet, DeepFM, seq2seq, word2vec, VGG, sentiment, tagger
and recommender programs use, the recurrent cells and beam search
(``rnn``), the LoD sequence layers and recurrences, the structured
losses, the learning-rate schedules, control flow over sub-blocks
(``control_flow``: While, while_loop, cond, case, switch_case, Switch,
StaticRNN, the tensor arrays; ``extras``: IfElse, DynamicRNN), and
``py_reader``; the counterparts of ``paddle_tpu/fluid/layers``."""

from . import (control_flow, learning_rate_scheduler,  # noqa: F401
               math_op_patch, nn, ops, rnn, sequence_lod, tensor)
from .control_flow import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .io import data  # noqa: F401
from .learning_rate_scheduler import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .metric_op import accuracy  # noqa: F401
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .py_reader import (create_py_reader_by_data, double_buffer,  # noqa: F401
                        py_reader, read_file)
from .rnn import *  # noqa: F401,F403
from .sequence_lod import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
