"""Op lowering rules on torch tensors; importing this package registers
every rule in ``fluid.registry``. The ops of the static-graph training
slices (BERT pretraining, LeNet and ResNet): the port's counterparts of
the same-named modules of ``paddle_tpu/fluid/ops/``."""

from . import (activations, autodiff, creation, elementwise, loss, math,  # noqa: F401
               metrics, nn, optimizer_ops, tensor_ops)
