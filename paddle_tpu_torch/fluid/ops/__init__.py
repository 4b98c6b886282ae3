"""Op lowering rules on torch tensors; importing this package registers
every rule in ``fluid.registry``. The ops of the static-graph training
slices (BERT pretraining, LeNet, ResNet, DeepFM, the padded recurrent
and book models: seq2seq, word2vec, VGG; the LoD models: sentiment, the
CRF tagger, the recommender) and of control flow: the port's
counterparts of the same-named modules of ``paddle_tpu/fluid/ops/``."""

from . import (activations, autodiff, control_flow, creation,  # noqa: F401
               elementwise, embedding_ops, loss, math, metrics, misc_ops,
               nn, optimizer_ops, rnn_ops, sequence_ops,
               structured_loss_ops, tensor_ops)
