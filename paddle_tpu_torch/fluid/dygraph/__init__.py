"""Dygraph (eager) mode: the port's counterpart of
``paddle_tpu/fluid/dygraph/`` (reference ``python/paddle/fluid/dygraph/``):
the tracer and eager variables (``base``), ``Layer`` as a
``torch.nn.Module``, the modules of ``nn`` the port lowers,
``Sequential``, ``jit.trace`` to a static Program, the learning-rate
decay objects and ``save_dygraph`` / ``load_dygraph``.

Not ported yet (ROADMAP queue 1, item 6): the other ``nn`` modules,
``dygraph_grad_clip``, ``profiler``; ``parallel`` (``DataParallel``)
goes with multi-device (queue 7).
"""

from . import (backward_strategy, base, checkpoint, container, jit,  # noqa: F401
               layers, learning_rate_scheduler, nn)
from .backward_strategy import BackwardStrategy  # noqa: F401
from .base import (ParamBase, Tracer, VarBase, enabled, guard,  # noqa: F401
                   no_grad, to_variable)
from .checkpoint import load_dygraph, save_dygraph  # noqa: F401
from .container import Sequential  # noqa: F401
from .jit import TracedLayer  # noqa: F401
from .layers import Layer  # noqa: F401
from .learning_rate_scheduler import (CosineDecay,  # noqa: F401
                                      ExponentialDecay, InverseTimeDecay,
                                      LearningRateDecay, NaturalExpDecay,
                                      NoamDecay, PiecewiseDecay,
                                      PolynomialDecay)
from .nn import *  # noqa: F401,F403
