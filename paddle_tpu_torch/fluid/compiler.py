"""CompiledProgram, BuildStrategy and ExecutionStrategy on one device:
the port's counterpart of ``paddle_tpu/fluid/compiler.py``.

``CompiledProgram(prog)`` and ``.with_data_parallel(loss_name=...)`` on
one place run exactly as ``prog`` does (the executor unwraps them), and
key the executor's cache by their own ``_uid``, as the reference does.
Data, pipeline and tensor parallelism over several places or a mesh
wait for ``torch.distributed`` (ROADMAP queue 7) and raise
``NotImplementedError``. The strategies are the reference's config
surface, accepted and not consulted.
"""

import itertools

__all__ = ["CompiledProgram", "BuildStrategy", "ExecutionStrategy"]

_MULTI_DEVICE = ("more than one place or a device mesh needs the port's "
                 "multi-device runtime on torch.distributed (ROADMAP "
                 "queue 7); CompiledProgram runs on one device")


class BuildStrategy:
    """Reference ``details/build_strategy.h:58``; accepted, not
    consulted (the executor's CUDA graph replays the step's kernels as
    the eager run issued them)."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = True
        self.fuse_all_optimizer_ops = True
        self.enable_inplace = True
        self.memory_optimize = True
        self.sync_batch_norm = False
        self.num_trainers = 1
        self.trainer_id = 0


class ExecutionStrategy:
    """Reference ``details/execution_strategy.h``; kept for API
    parity."""

    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 100
        self.use_experimental_executor = True


def _one_place(places):
    """Whether ``places`` (None, a count, or a list) names at most one
    device."""
    if places is None:
        return True
    if isinstance(places, int):
        return places <= 1
    return len(list(places)) <= 1


class CompiledProgram:
    _uid_counter = itertools.count(1)

    def __init__(self, program_or_graph, build_strategy=None):
        self._uid = next(CompiledProgram._uid_counter)
        self._program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()
        self._is_data_parallel = False
        self._places = None
        self._loss_name = None

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None, mesh_axes=("dp",), mesh_shape=None,
                           seq_feeds=None, seq_fetches=None):
        """Data parallelism on one place, which runs the program as it is.
        Several places, a mesh of more than one device, or sequence
        sharding raise ``NotImplementedError`` (ROADMAP queue 7)."""
        sizes = list((mesh_shape or {}).values())
        if not _one_place(places) or tuple(mesh_axes) != ("dp",) or \
                any(int(s) > 1 for s in sizes) or seq_feeds or seq_fetches:
            raise NotImplementedError(_MULTI_DEVICE)
        self._is_data_parallel = True
        self._loss_name = loss_name
        if build_strategy is not None:
            self._build_strategy = build_strategy
        self._places = places
        return self

    def with_pipeline(self, *args, **kwargs):
        """Pipeline parallelism (ROADMAP queue 7)."""
        raise NotImplementedError(_MULTI_DEVICE)

    def with_explicit_collectives(self, *args, **kwargs):
        """SPMD with explicit collective ops (ROADMAP queue 7)."""
        raise NotImplementedError(_MULTI_DEVICE)

    @property
    def mesh(self):
        """No mesh: one device."""
        return None
