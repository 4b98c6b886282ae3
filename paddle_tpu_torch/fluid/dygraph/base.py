"""The dygraph core: eager variables, the tracer, ``guard``.

The port's counterpart of ``paddle_tpu/fluid/dygraph/base.py``
(reference ``paddle/fluid/imperative/``: ``Tracer::TraceOp``,
``VarBase``, ``BasicEngine``):

- ``Tracer.trace_op`` runs the op's registered lowering
  (``fluid/registry.py``) eagerly on the variables' tensors, on the
  guard's device: the eager op and the executor's op are the same rule.
- torch autograd is the tape. An op whose inputs all stop the gradient
  gives outputs that stop it and records nothing (no input requires
  grad); ``backward()`` adds into a leaf's existing gradient (torch's
  ``.grad`` accumulation); under ``no_grad`` nothing is recorded
  (``torch.no_grad``). Intermediate variables keep no gradient: autograd
  frees it once the leaves have theirs.
- Random ops draw from the tracer's own ``torch.Generator`` on its
  device, seeded by ``Tracer.seed`` (0 by default); there is no global
  generator.
- ``guard(place=None)`` runs on the card unless the caller passes the
  CPU (``"cpu"`` or ``fluid.CPUPlace()``); without a card it raises.

A parameter is a ``ParamBase``: a ``torch.nn.Parameter`` that is also a
``VarBase``, so a ``Layer``'s parameters are the module's tensors, the
optimizer updates them in place, and ``jit.TracedLayer`` binds the same
storage into its scope.
"""

import contextlib
import itertools

import numpy as np
import torch

from ... import fp32_products, resolve_device
from .. import framework
from ..registry import LowerCtx, lower_op, to_numpy_dtype

__all__ = ["guard", "to_variable", "enabled", "VarBase", "ParamBase",
           "Tracer", "no_grad", "grad_enabled"]


def _tracer():
    t = framework._dygraph_tracer()
    if t is None:
        raise RuntimeError("dygraph ops need fluid.dygraph.guard()")
    return t


def device_of(place=None):
    """The torch device of ``place``; None is the guard's device, or the
    card outside a guard (which raises where there is none)."""
    if place is None:
        t = framework._dygraph_tracer()
        place = t.device if t is not None else "cuda"
    return resolve_device(place)


class _EagerOp:
    """Duck-types ``framework.Operator`` for a lowering rule."""

    __slots__ = ("type", "inputs", "outputs", "attrs", "callstack")

    def __init__(self, type, inputs, outputs, attrs):
        self.type = type
        self.inputs = inputs
        self.outputs = outputs
        self.attrs = attrs
        self.callstack = ()

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def input_arg_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    def output_arg_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


class _EagerCtx(LowerCtx):
    """A ``LowerCtx`` over concrete tensors with no block: no var is
    declared, so an output's declared dtype reads float32 (as the
    reference's eager context gives) and no gradient is SelectedRows."""

    def __init__(self, env, generator, device):
        self.block = self.program = None
        self.env = env
        self.generator = generator
        self.device = device
        self.written = set()
        self.promote_products = False
        self.sparse_outs = frozenset()
        self.sparse_leaves = {}

    def set(self, name, value):
        self.env[name] = value

    def var(self, name):
        return None

    def var_dtype(self, name):
        return np.dtype("float32")


def run_op(op_type, inputs, out_slots, attrs, generator, device):
    """Lower one op eagerly: ``inputs`` {slot: [tensor]} -> the tensor of
    each of ``out_slots`` (None where the rule binds none)."""
    env, names = {}, {}
    for slot, ts in inputs.items():
        names[slot] = []
        for i, t in enumerate(ts):
            n = "%s#%d" % (slot, i)
            env[n] = t
            names[slot].append(n)
    op = _EagerOp(op_type, names, {s: [s + "@out"] for s in out_slots},
                  attrs)
    lower_op(_EagerCtx(env, generator, device), op)
    return [env.get(s + "@out") for s in out_slots]


def _differentiable(t):
    return t.is_floating_point() or t.is_complex()


class VarBase:
    """An eager variable (reference ``imperative::VarBase``): a torch
    tensor with a name and the reference's gradient flags. Unnamed
    variables are named ``eager_var_N`` from a process counter."""

    _counter = itertools.count(1)

    def __init__(self, value, name=None, stop_gradient=None,
                 persistable=False):
        self._ivar = value
        self.name = name or "eager_var_%d" % next(VarBase._counter)
        self.persistable = persistable
        self._stop = True
        if stop_gradient is not None:
            self.stop_gradient = stop_gradient

    # -- value access ------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._ivar.shape)

    @property
    def dtype(self):
        return to_numpy_dtype(self._ivar.dtype)

    def numpy(self):
        t = self._ivar.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    def gradient(self):
        t = self._ivar
        g = t.grad if t.is_leaf or t.retains_grad else None
        return None if g is None else (
            g.float() if g.dtype == torch.bfloat16 else g).cpu().numpy()

    def clear_gradient(self):
        self._ivar.grad = None

    def detach(self):
        return VarBase(self._ivar.detach(), stop_gradient=True)

    def set_value(self, value):
        """Copy ``value`` into this variable's storage, in place (a
        parameter keeps its tensor, which a traced scope and a captured
        graph may hold)."""
        t = self._ivar
        if isinstance(value, VarBase):
            value = value._ivar
        src = value if isinstance(value, torch.Tensor) else torch.as_tensor(
            np.asarray(value))
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError("set_value: %s has shape %s, got %s"
                             % (self.name, tuple(t.shape), tuple(src.shape)))
        with torch.no_grad():
            t.copy_(src.to(device=t.device, dtype=t.dtype))

    # -- gradient flags ----------------------------------------------------
    @property
    def stop_gradient(self):
        t = self._ivar
        return not t.requires_grad if _differentiable(t) else self._stop

    @stop_gradient.setter
    def stop_gradient(self, value):
        t = self._ivar
        if not _differentiable(t):
            self._stop = bool(value)
        elif t.is_leaf:
            t.requires_grad_(not value)
        elif value:
            self._ivar = t.detach()

    def backward(self, backward_strategy=None):
        """Gradients of this variable into every leaf that needs one,
        added to what the leaf holds. ``backward_strategy`` is accepted
        for parity: the reference's ``sort_sum_gradient`` asks for a
        deterministic sum, which autograd's fixed graph order gives."""
        tracer = _tracer()
        t = self._ivar
        t.backward(None if t.dim() == 0 else torch.ones_like(t))
        tracer._recorded = False

    # -- op sugar ----------------------------------------------------------
    def _binary(self, other, op_type, reverse=False):
        tracer = _tracer()
        if not isinstance(other, VarBase):
            t = self._ivar
            other = VarBase(torch.as_tensor(np.asarray(other)).to(
                device=t.device, dtype=t.dtype), stop_gradient=True)
        a, b = (other, self) if reverse else (self, other)
        (out,) = tracer.trace_op(op_type, {"X": [a], "Y": [b]}, ["Out"],
                                 {"axis": -1})
        return out

    def __add__(self, o):
        return self._binary(o, "elementwise_add")

    def __radd__(self, o):
        return self._binary(o, "elementwise_add", True)

    def __sub__(self, o):
        return self._binary(o, "elementwise_sub")

    def __rsub__(self, o):
        return self._binary(o, "elementwise_sub", True)

    def __mul__(self, o):
        return self._binary(o, "elementwise_mul")

    def __rmul__(self, o):
        return self._binary(o, "elementwise_mul", True)

    def __truediv__(self, o):
        return self._binary(o, "elementwise_div")

    def __neg__(self):
        (out,) = _tracer().trace_op("scale", {"X": [self]}, ["Out"],
                                    {"scale": -1.0})
        return out

    def astype(self, dtype):
        (out,) = _tracer().trace_op(
            "cast", {"X": [self]}, ["Out"],
            {"out_dtype": framework.dtype_str(framework.convert_dtype(
                dtype))})
        return out

    def __repr__(self):
        return "VarBase(name=%s, shape=%s,\n%r)" % (self.name, self.shape,
                                                    self.numpy())


class ParamBase(torch.nn.Parameter, VarBase):
    """A layer's parameter: a ``torch.nn.Parameter`` (the module's own
    tensor, so torch code reads it as it is) that is also a ``VarBase``
    (named, persistable; ``stop_gradient`` is ``not requires_grad``).
    Tensor methods (``shape``, ``dtype``, ``detach``, the arithmetic)
    keep torch's meaning; ``numpy``, ``gradient``, ``set_value`` and
    ``clear_gradient`` are the reference's."""

    persistable = True
    _pname = None

    def __init__(self, *args, **kwargs):
        pass    # torch.nn.Parameter.__new__ made the tensor

    @staticmethod
    def make(value, name, trainable=True):
        p = ParamBase(value, requires_grad=bool(trainable)
                      and _differentiable(value))
        p.name = name
        p.trainable = bool(trainable)
        p.regularizer = None
        p.optimize_attr = {"learning_rate": 1.0}
        return p

    @property
    def name(self):
        return self._pname

    @name.setter
    def name(self, value):
        self._pname = value

    @property
    def _ivar(self):
        return self

    def numpy(self):
        return VarBase.numpy(self)


class Tracer:
    """The eager dispatcher (reference ``imperative::Tracer``): runs each
    op's lowering on ``device`` and, while ``jit.trace`` records, appends
    it to the recorder's program. ``traced_ops`` counts the ops traced."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(0)
        # an op was recorded for backward since the last backward()
        self._recorded = False
        self._program_recorder = None
        self.traced_ops = 0

    def seed(self, s):
        self.generator.manual_seed(int(s))

    def trace_op(self, op_type, input_slots, out_slot_names, attrs=None):
        """``input_slots`` {slot: [VarBase]}; returns one output VarBase
        (or None) per slot of ``out_slot_names``."""
        attrs = dict(attrs or {})
        self.traced_ops += 1
        outs = run_op(op_type,
                      {s: [v._ivar for v in vs]
                       for s, vs in input_slots.items()},
                      out_slot_names, attrs, self.generator, self.device)
        out_vars = [None if o is None else VarBase(o) for o in outs]
        if any(o is not None and o.requires_grad for o in outs):
            self._recorded = True
        if self._program_recorder is not None:
            self._program_recorder.record(op_type, input_slots,
                                          out_slot_names, out_vars, attrs)
        return out_vars


def enabled():
    return framework.in_dygraph_mode()


@contextlib.contextmanager
def guard(place=None):
    """Eager mode on ``place``: the card unless the caller passes the
    CPU (``"cpu"`` or ``fluid.CPUPlace()``); fp32 products without TF32
    inside (``fp32_products``)."""
    tracer = Tracer(device_of("cuda" if place is None else place))
    with framework._dygraph_guard(tracer), fp32_products():
        yield


def to_variable(value, name=None, zero_copy=None):
    """A VarBase of ``value`` (numpy or a torch tensor) on the guard's
    device (the card outside a guard), with ``stop_gradient``."""
    if isinstance(value, VarBase):
        return value
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
    return VarBase(value.to(device_of()), name=name, stop_gradient=True)


# records nothing for backward (reference dygraph/base.py:355-391):
# torch's own mode, a context manager and a decorator
no_grad = grad_enabled = torch.no_grad
