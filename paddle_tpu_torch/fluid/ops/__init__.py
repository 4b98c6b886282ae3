"""Op lowering rules on torch tensors; importing this package registers
every rule in ``fluid.registry``. The ops of the static-graph training
slice (BERT pretraining): the port's counterparts of the same-named
modules of ``paddle_tpu/fluid/ops/``."""

from . import (activations, autodiff, creation, elementwise, loss, math,  # noqa: F401
               nn, optimizer_ops, tensor_ops)
