"""paddle_tpu_torch.fluid: the static-graph Program IR on PyTorch.

Build a program with ``layers`` inside ``program_guard``, add an
``optimizer``'s update ops (and a ``regularizer``'s weight decay), and
run it with ``Executor`` in a ``Scope`` (on the card, as a CUDA graph
per program and feed signature), directly or as a one-device
``CompiledProgram``; ``io`` saves and loads variables and inference
models. ``set_flags`` / ``get_flags`` hold the anomaly
policy, ``profiler`` times runs, run hooks observe them; the serving
slices also use ``monitor`` and ``resilience``. ``dygraph`` is eager
mode: ``dygraph.guard()``, layers, the eager optimizers, and
``dygraph.jit.trace`` to a Program. Input: ``DatasetFactory`` datasets
over MultiSlot files (``Executor.train_from_dataset``), ``DataLoader``,
``PyReader``, ``layers.py_reader`` (``core.EOFException`` ends a pass)
and ``DataFeeder``. ``clip`` clips gradients, ``nets`` composes
layers into blocks, ``layers.rnn`` and ``layers.BeamSearchDecoder`` run
recurrent cells and beam search. Ragged input: ``LoDTensor`` /
``create_lod_tensor`` feeds of ``layers.data(lod_level=1)`` slots, the
``sequence_*`` layers and ``layers.dynamic_lstm`` (``lod.py``). Fault tolerance: ``io.CheckpointManager`` with
``Executor.run(checkpoint=...)``, the ``rollback`` anomaly policy and
the preemption drain (``paddle_tpu_torch.distributed.preemption``).
"""

from . import (clip, contrib, core, dygraph, framework,  # noqa: F401
               initializer, io, layers, nets, ops, optimizer, profiler,
               regularizer, unique_name)
from .backward import append_backward  # noqa: F401
from .data_feeder import DataFeeder  # noqa: F401
from .dataset import (DatasetFactory, FileInstantDataset,  # noqa: F401
                      InMemoryDataset, QueueDataset)
from .compiler import (BuildStrategy, CompiledProgram,  # noqa: F401
                       ExecutionStrategy)
from .executor import (Executor, FetchHandle, Scope, copy_scope,  # noqa: F401
                       global_scope, register_run_hook, scope_guard,
                       unregister_run_hook)
from .flags import get_flags, set_flags  # noqa: F401
from .lod import LoDTensor, LoDTensorArray, create_lod_tensor  # noqa: F401
from . import input, lod_tensor  # noqa: F401,E402
from .framework import (CPUPlace, CUDAPlace, Parameter,  # noqa: F401
                        Program, Variable, default_main_program,
                        default_startup_program, in_dygraph_mode,
                        program_guard)
from .param_attr import ParamAttr  # noqa: F401
from .reader import DataLoader, PyReader  # noqa: F401


def data(name, shape, dtype="float32", lod_level=0):
    """``fluid.data`` (the 1.6 style): ``shape`` taken verbatim."""
    return layers.io.data(name, shape, dtype=dtype, append_batch_size=False,
                          lod_level=lod_level)


# the 1.6 top-level layer aliases
embedding = layers.embedding
one_hot = layers.one_hot
