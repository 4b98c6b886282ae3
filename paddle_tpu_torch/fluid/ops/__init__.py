"""Op lowering rules on torch tensors; importing this package registers
every rule in ``fluid.registry``. The ops of the static-graph training
slices (BERT pretraining, LeNet, ResNet, DeepFM, and the padded
recurrent and book models: seq2seq, word2vec, VGG): the port's
counterparts of the same-named modules of ``paddle_tpu/fluid/ops/``."""

from . import (activations, autodiff, creation, elementwise,  # noqa: F401
               embedding_ops, loss, math, metrics, nn, optimizer_ops,
               rnn_ops, sequence_ops, tensor_ops)
