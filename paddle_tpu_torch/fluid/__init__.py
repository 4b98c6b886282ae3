"""paddle_tpu_torch.fluid: the static-graph Program IR on PyTorch.

Build a program with ``layers`` inside ``program_guard``, add an
``optimizer``'s update ops (and a ``regularizer``'s weight decay), and
run it with ``Executor`` in a ``Scope`` (on the card, as a CUDA graph
per program and feed signature), directly or as a one-device
``CompiledProgram``; ``io`` saves and loads variables and inference
models. ``set_flags`` / ``get_flags`` hold the anomaly
policy, ``profiler`` times runs, run hooks observe them; the serving
slices also use ``monitor`` and ``resilience``.
"""

from . import (contrib, framework, initializer, io, layers,  # noqa: F401
               ops, optimizer, profiler, regularizer, unique_name)
from .backward import append_backward  # noqa: F401
from .compiler import (BuildStrategy, CompiledProgram,  # noqa: F401
                       ExecutionStrategy)
from .executor import (Executor, FetchHandle, Scope, copy_scope,  # noqa: F401
                       global_scope, register_run_hook, scope_guard,
                       unregister_run_hook)
from .flags import get_flags, set_flags  # noqa: F401
from .framework import (Parameter, Program, Variable,  # noqa: F401
                        default_main_program, default_startup_program,
                        program_guard)
from .param_attr import ParamAttr  # noqa: F401
