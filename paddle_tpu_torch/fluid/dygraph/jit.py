"""Dygraph -> static Program (the port's counterpart of
``paddle_tpu/fluid/dygraph/jit.py``; reference ``dygraph/jit.py`` and
``imperative/jit/program_desc_tracer``).

``trace(layer, inputs)`` runs the layer once under the guard's tracer
while ``_ProgramRecorder`` appends each traced op to a port ``Program``:
a persistable variable (a parameter) becomes a ``Parameter`` under its
name, any other input a data var with its ``stop_gradient``, each output
a var named as its VarBase (``eager_var_N``). ``TracedLayer`` runs that
program through the port's ``Executor`` (on the card, graphed as every
program is) in a scope that binds the layer's own parameter tensors, no
copy: an eager step and a static step update the same storage.
"""

import numpy as np
import torch

from .. import framework
from ..framework import Program
from ..registry import to_numpy_dtype
from .base import VarBase, to_variable

__all__ = ["trace", "TracedLayer"]


def _np_dtype(vb):
    return to_numpy_dtype(vb._ivar.dtype)


class _ProgramRecorder:
    def __init__(self):
        self.program = Program()
        self.block = self.program.global_block()
        # id(VarBase) -> (the VarBase, held so its id stays its own; name)
        self._known = {}

    def name_of(self, vb):
        return self._known[id(vb)][1]

    def _var_for(self, vb):
        known = self._known.get(id(vb))
        if known is not None:
            return known[1]
        name = vb.name
        if vb.persistable:
            self.block.create_parameter(shape=list(vb.shape),
                                        dtype=_np_dtype(vb), name=name)
        else:
            self.block.create_var(name=name, shape=list(vb.shape),
                                  dtype=_np_dtype(vb), is_data=True,
                                  stop_gradient=vb.stop_gradient)
        self._known[id(vb)] = (vb, name)
        return name

    def record(self, op_type, input_slots, out_slot_names, out_vars, attrs):
        ins = {slot: [self._var_for(v) for v in vs]
               for slot, vs in input_slots.items()}
        outs = {}
        for slot, ov in zip(out_slot_names, out_vars):
            if ov is None:
                continue
            self.block.create_var(name=ov.name, shape=list(ov.shape),
                                  dtype=_np_dtype(ov))
            self._known[id(ov)] = (ov, ov.name)
            outs[slot] = [ov.name]
        self.block.append_op(op_type, inputs=ins, outputs=outs, attrs=attrs)


def trace(layer, inputs):
    """Run ``layer(*inputs)`` once, recording a static Program. Returns
    (outputs, TracedLayer)."""
    tracer = framework._dygraph_tracer()
    if tracer is None:
        raise RuntimeError("trace() must run under dygraph.guard()")
    rec = _ProgramRecorder()
    inputs = [to_variable(v) for v in inputs]
    for v in inputs:
        rec._var_for(v)
    tracer._program_recorder = rec
    try:
        outputs = layer(*inputs)
    finally:
        tracer._program_recorder = None
    out_list = outputs if isinstance(outputs, (list, tuple)) else [outputs]
    return outputs, TracedLayer(rec.program, layer,
                                [rec.name_of(v) for v in inputs],
                                [rec.name_of(v) for v in out_list],
                                tracer.device)


class TracedLayer:
    """A traced program with the layer it came from. ``_scope`` (made at
    the first run) binds each parameter of the layer, by name, to the
    parameter's own tensor."""

    def __init__(self, program, layer, feed_names, fetch_names, place):
        self.program = program
        self._layer = layer
        self._feed_names = feed_names
        self._fetch_names = fetch_names
        self._place = place
        self._scope = None
        self._exe = None

    @staticmethod
    def trace(layer, inputs):
        """Reference ``TracedLayer.trace``: the module-level ``trace``."""
        return trace(layer, inputs)

    def set_strategy(self, build_strategy=None, exec_strategy=None):
        """Accepted for parity (reference ``jit.py:91``): the executor
        runs the whole step as one CUDA graph, which owns what these
        strategies tuned."""
        self._build_strategy = build_strategy
        self._exec_strategy = exec_strategy

    def _materialize_scope(self):
        from ..executor import Scope

        if self._scope is not None:
            return
        self._scope = Scope()
        for _, p in self._layer.named_parameters():
            self._scope.set_var(p.name, p.data)

    def _executor(self):
        from ..executor import Executor

        if self._exe is None:
            self._exe = Executor(self._place)
        return self._exe

    def __call__(self, inputs):
        """Run the program on ``inputs`` (VarBases, tensors or numpy, in
        the traced order); returns the fetches as numpy."""
        self._materialize_scope()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        feed = {n: (v._ivar.detach() if isinstance(v, VarBase) else
                    v if isinstance(v, torch.Tensor) else np.asarray(v))
                for n, v in zip(self._feed_names, inputs)}
        return self._executor().run(self.program, feed=feed,
                                    fetch_list=self._fetch_names,
                                    scope=self._scope)

    def save_inference_model(self, dirname, feed=None, fetch=None):
        """Save the program and the layer's parameters with
        ``fluid.io.save_inference_model`` (fed by the traced inputs'
        names, fetching the traced outputs), for ``inference.Predictor``."""
        from .. import io
        from ..executor import scope_guard

        self._materialize_scope()
        with scope_guard(self._scope):
            fetch_vars = [self.program.global_block().var(n)
                          for n in self._fetch_names]
            io.save_inference_model(dirname, self._feed_names, fetch_vars,
                                    self._executor(), self.program)
