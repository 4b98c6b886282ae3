"""paddle_tpu_torch.fluid: the static-graph Program IR on PyTorch.

Build a program with ``layers`` inside ``program_guard``, add an
``optimizer``'s update ops, and run it with ``Executor`` in a ``Scope``;
``io`` saves and loads variables and inference models. The serving
slices also use ``monitor`` and ``resilience``.
"""

from . import (contrib, framework, initializer, io, layers,  # noqa: F401
               ops, optimizer, unique_name)
from .backward import append_backward  # noqa: F401
from .executor import (Executor, Scope, copy_scope, global_scope,  # noqa: F401
                       scope_guard)
from .framework import (Parameter, Program, Variable,  # noqa: F401
                        default_main_program, default_startup_program,
                        program_guard)
from .param_attr import ParamAttr  # noqa: F401
