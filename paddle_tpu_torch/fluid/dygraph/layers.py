"""``Layer``: the base of the dygraph modules, as a ``torch.nn.Module``
(the port's counterpart of ``paddle_tpu/fluid/dygraph/layers.py``).

Parameters are ``ParamBase`` tensors registered with the module, so
``named_parameters()`` gives the reference's paths
(``enc_0.attn.q_fc.weight``) and torch code reads them as they are. A
parameter's name is the reference's, ``unique_name.generate(
"<layer>.w")`` (or ``.b``), generated in the same order: under one
``unique_name.guard()`` both packages name every parameter alike, so a
traced desc and ``fluid.copy_scope`` line up.

Weights are drawn on the layer's device from a ``torch.Generator``: the
one passed, else the guard's tracer's. The default initializers draw as
the port's layers always have (Xavier-uniform through ``uniform_``,
zeros, ones), so a seeded model is the same model it was; an explicit
initializer (``ParamAttr(initializer=...)``, or a layer's own default
such as ``Conv2D``'s Normal) runs its init op's lowering eagerly.
"""

import math

import torch

from .. import framework, initializer, unique_name
from ..param_attr import ParamAttr
from .base import ParamBase, device_of, run_op

__all__ = ["Layer"]


def _default_generator(device, generator):
    if generator is not None:
        return generator
    t = framework._dygraph_tracer()
    if t is not None and t.device == device:
        return t.generator
    return None


def _init_value(init, shape, dtype, device, generator):
    """The tensor an initializer gives: Xavier-uniform, Constant 0 and 1
    drawn directly; any other through its init op's lowering."""
    tdt = getattr(torch, framework.dtype_str(dtype))
    if isinstance(init, initializer.XavierInitializer) and init.uniform \
            and init.fan_in is None and init.fan_out is None \
            and len(shape) == 2:
        limit = math.sqrt(6.0 / (shape[0] + shape[1]))
        w = torch.empty(tuple(shape), dtype=tdt, device=device)
        return w.uniform_(-limit, limit, generator=generator)
    if isinstance(init, initializer.ConstantInitializer):
        return torch.full(tuple(shape), float(init.value), dtype=tdt,
                          device=device)
    prog = framework.Program()
    blk = prog.global_block()
    v = blk.create_var(name="out", shape=list(shape), dtype=dtype)
    init(v, blk)
    (op,) = blk.ops
    if generator is None:
        generator = torch.Generator(device=device)
    (out,) = run_op(op.type, {}, ["Out"], op.attrs, generator, device)
    return out


class Layer(torch.nn.Module):
    """A dygraph module. ``device`` and ``generator`` (keyword-only in
    the subclasses) place and draw its parameters, resolved when the
    first one is made: a layer without parameters needs no device."""

    def __init__(self, name_scope=None, dtype="float32", device=None,
                 generator=None):
        super().__init__()
        self._full_name = name_scope or type(self).__name__.lower()
        self._dtype = dtype
        self._place = device
        self._generator = generator

    def _param_device(self):
        """(device, generator) the parameters are made with."""
        if not isinstance(self._place, torch.device):
            self._place = device_of(self._place)
            self._generator = _default_generator(self._place,
                                                 self._generator)
        return self._place, self._generator

    def full_name(self):
        return self._full_name

    # -- parameters ----------------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype="float32",
                         is_bias=False, default_initializer=None):
        """A ParamBase of ``shape`` named as the reference names it, or
        None when ``attr`` is False."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        init = attr.initializer or default_initializer or (
            initializer.Constant(0.0) if is_bias else initializer.Xavier())
        device, generator = self._param_device()
        value = _init_value(init, [int(s) for s in shape], dtype, device,
                            generator)
        name = attr.name or unique_name.generate(
            "%s.%s" % (self._full_name, "b" if is_bias else "w"))
        p = ParamBase.make(value, name, trainable=attr.trainable)
        p.regularizer = attr.regularizer
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        return p

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def parameters(self, include_sublayers=True):
        """The parameters as a list (the reference's), own first."""
        return list(super().parameters(recurse=include_sublayers))

    def sublayers(self, include_sublayers=True):
        """Direct sublayers, then each one's own, in the reference's
        order."""
        out = list(self.children())
        if include_sublayers:
            for layer in list(out):
                out.extend(layer.sublayers())
        return out

    # -- state dict ----------------------------------------------------------
    def state_dict(self, include_sublayers=True):
        """{path: parameter}, keyed as ``named_parameters`` (the
        reference's ``state_dict``; the values are the parameters
        themselves)."""
        return dict(self.named_parameters(recurse=include_sublayers))

    def set_dict(self, state_dict, include_sublayers=True):
        """Copy each entry of ``state_dict`` found under a parameter's
        path into it, in place."""
        for name, p in self.named_parameters(recurse=include_sublayers):
            if name in state_dict:
                p.set_value(state_dict[name])

    load_dict = set_dict

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()

