"""Optimizers: append update ops to the program (the port's counterpart
of ``paddle_tpu/fluid/optimizer.py``): ``minimize`` = ``append_backward``
+ ``apply_gradients``; the learning rate and the accumulators are
persistable vars that the startup program fills.

Ported: the ``Optimizer`` base with weight decay (``regularization``,
``regularizer.py``: applied in ``apply_gradients`` to every parameter,
norms' scales and biases included; skipped, with a warning, for a
SelectedRows gradient), ``SGD``, ``Momentum``, ``Adagrad`` and
``Adam``. A SelectedRows gradient passes through ``apply_gradients`` to
its update op, which applies it row-sparse (``ops/optimizer_ops.py``).
``RecomputeOptimizer`` wraps one of them and carries the checkpoint
vars to the ``autodiff`` op (activation recomputation,
``ops/autodiff.py``).

In dygraph mode (``dygraph.guard()``) ``minimize`` takes the eager
branch (``_dygraph_minimize``): the raw gradients (``loss.backward()``
if it has not run), then weight decay, then the update of each
parameter in ``parameter_list``, in place under ``torch.no_grad()``,
by the same ``sgd`` / ``momentum`` / ``adam`` lowering the static
program runs. Eager updates exist for SGD, Momentum and Adam, as in the
reference; the others raise. ``state_dict`` / ``set_dict`` checkpoint
the eager accumulators as ``"<param>@<slot>"`` and a learning-rate decay
object's step. The other optimizers wait for later slices.

Gradient clipping (``clip.py``): ``apply_gradients`` clips the raw
gradients before weight decay, as the reference does: each parameter's
own clip, else the optimizer's ``grad_clip`` (a ``GradientClipBy*``),
else the process-wide one of ``clip.set_gradient_clip``. (The
reference's static ``Adam`` and the others take no ``grad_clip``; its
``set_gradient_clip`` gives the same ops.) The learning rate may be a
Variable, such as a schedule of ``layers.learning_rate_scheduler``.
Clipping in dygraph mode, where ``minimize(grad_clip=)`` passes the
reference's callable strategies (``dygraph_grad_clip.py``), is ROADMAP
queue 1 item 6 and raises.
"""

import logging

import numpy as np
import torch

from . import framework, unique_name
from .backward import append_backward
from .clip import BaseGradientClipAttr, append_gradient_clip_ops
from .framework import Variable, default_main_program
from .initializer import Constant
from .layer_helper import LayerHelper
from .regularizer import L1DecayRegularizer, append_regularization_ops

__all__ = ["SGD", "SGDOptimizer", "Momentum", "MomentumOptimizer",
           "Adagrad", "AdagradOptimizer", "Adam", "AdamOptimizer",
           "RecomputeOptimizer"]


def _refuse_clip(grad_clip):
    """Clipping in dygraph mode, and a clip strategy given to
    ``minimize``, are the reference's ``dygraph_grad_clip.py``."""
    if grad_clip is not None:
        raise NotImplementedError(
            "gradient clipping in dygraph mode (dygraph_grad_clip.py, the "
            "callable strategies minimize(grad_clip=) takes) is not ported "
            "yet (ROADMAP queue 1 item 6); static programs take a "
            "clip.GradientClipBy* as the optimizer's grad_clip")


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None,
                 grad_clip=None):
        if grad_clip is not None and not isinstance(
                grad_clip, BaseGradientClipAttr):
            _refuse_clip(grad_clip)
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._name = name
        self._grad_clip = grad_clip
        self._accumulators = {}  # acc_name -> {param_name: var}
        self._lr_var = None
        # eager state: id(param) -> (param, {slot: tensor}); state that
        # set_dict restored, by "<param>@<slot>", until its first use
        self._eager_state = {}
        self._loaded_state = {}

    def _create_global_learning_rate(self):
        if isinstance(self._learning_rate, Variable):
            self._lr_var = self._learning_rate
            return
        if self._lr_var is not None:
            return
        helper = LayerHelper("learning_rate")
        name = unique_name.generate("learning_rate")
        self._lr_var = helper.main_program.global_block().create_var(
            name=name, shape=(1,), dtype="float32", persistable=True,
            stop_gradient=True)
        sb = helper.startup_program.global_block()
        sv = sb.create_var(name=name, shape=(1,), dtype="float32",
                           persistable=True)
        Constant(float(self._learning_rate))(sv, sb)

    def _add_accumulator(self, name, param, fill_value=0.0, shape=None,
                         dtype=None):
        if param.name in self._accumulators.get(name, {}):
            return self._accumulators[name][param.name]
        helper = LayerHelper("accum")
        shape = shape if shape is not None else param.shape
        dtype = dtype or param.dtype
        var_name = unique_name.generate("%s_%s" % (param.name, name))
        var = helper.main_program.global_block().create_var(
            name=var_name, shape=shape, dtype=dtype, persistable=True,
            stop_gradient=True)
        sb = helper.startup_program.global_block()
        sv = sb.create_var(name=var_name, shape=shape, dtype=dtype,
                           persistable=True)
        Constant(float(fill_value))(sv, sb)
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _lr_for(self, param):
        """The learning-rate var, scaled by the parameter's multiplier."""
        mult = getattr(param, "optimize_attr", {}).get("learning_rate", 1.0)
        if mult == 1.0:
            return self._lr_var
        from .layers import nn

        return nn.scale(self._lr_var, scale=mult)

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return append_backward(loss, parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        block = default_main_program().global_block()
        self._create_global_learning_rate()
        params_grads = append_gradient_clip_ops(params_grads,
                                                self._grad_clip)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        self._create_accumulators(block, [p for p, _ in params_grads])
        for pg in params_grads:
            self._append_optimize_op(block, pg)
        return params_grads

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None):
        _refuse_clip(grad_clip)
        if framework.in_dygraph_mode():
            _refuse_clip(self._grad_clip)
            return self._dygraph_minimize(loss, parameter_list)
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        return self.apply_gradients(params_grads), params_grads

    # -- the dygraph (eager) branch --------------------------------------------
    def _dygraph_minimize(self, loss, parameter_list):
        """Raw gradients (``loss.backward()`` when ops were recorded since
        the last backward), then each parameter's regularizer or
        ``regularization``, then the eager update, in place. Returns
        (None, [(param, the gradient the update took)])."""
        from .dygraph.base import VarBase

        tracer = framework._dygraph_tracer()
        if parameter_list is None:
            raise ValueError("dygraph minimize needs parameter_list "
                             "(e.g. model.parameters())")
        if tracer._recorded:
            loss.backward()
        if isinstance(self._learning_rate, VarBase):
            lr = float(self._learning_rate.numpy().reshape(-1)[0])
        elif callable(self._learning_rate):
            lr = float(self._learning_rate())
        else:
            lr = float(self._learning_rate)
        params_grads = []
        with torch.no_grad():
            for p in parameter_list:
                if p is None or p.stop_gradient or p._ivar.grad is None:
                    continue
                g = p._ivar.grad
                reg = getattr(p, "regularizer", None) or self.regularization
                if reg is not None:
                    decay = torch.sign(p._ivar) if isinstance(
                        reg, L1DecayRegularizer) else p._ivar
                    g = g + decay * reg._coeff
                params_grads.append((p, g))
            lrs = {}
            for p, g in params_grads:
                t = p._ivar
                if t.device not in lrs:
                    lrs[t.device] = torch.full((1,), lr, dtype=torch.float32,
                                               device=t.device)
                self._eager_update(p, g, lrs[t.device])
        return None, params_grads

    def _eager_op(self, p, op_type, inputs, attrs):
        """Run the static update op's lowering on ``p``'s tensors (it
        updates them in place)."""
        from .dygraph.base import run_op

        run_op(op_type, {k: [v] for k, v in inputs.items()}, [], attrs,
               None, p._ivar.device)

    def _eager_state_for(self, p, slots):
        """``p``'s eager accumulators {slot: tensor}, made at first use:
        restored by name from ``set_dict``, else a [1] tensor filled with
        a scalar init, or zeros of ``p``'s shape (init None)."""
        entry = self._eager_state.get(id(p))
        if entry is None:
            t = p._ivar
            st = {}
            for slot, init in slots:
                key = "%s@%s" % (p.name, slot)
                if key in self._loaded_state:
                    st[slot] = torch.tensor(
                        np.asarray(self._loaded_state.pop(key)),
                        dtype=t.dtype, device=t.device)
                elif init is None:
                    st[slot] = torch.zeros_like(t)
                else:
                    st[slot] = torch.full((1,), init, dtype=t.dtype,
                                          device=t.device)
            entry = self._eager_state[id(p)] = (p, st)
        return entry[1]

    def _eager_update(self, p, g, lr):
        raise NotImplementedError(
            "%s has no eager update; use static graph mode"
            % type(self).__name__)

    def state_dict(self):
        """The eager accumulators as numpy, keyed "<param>@<slot>", with
        ``global_step`` when the learning rate is a decay object; state
        restored by ``set_dict`` and not used yet is kept."""
        from .dygraph.learning_rate_scheduler import LearningRateDecay

        if not framework.in_dygraph_mode():
            raise RuntimeError(
                "optimizer.state_dict() is dygraph-only; static graph "
                "optimizer state lives in scope persistables")
        out = dict(self._loaded_state)
        for p, st in self._eager_state.values():
            for slot, t in st.items():
                out["%s@%s" % (p.name, slot)] = t.detach().cpu().numpy()
        if isinstance(self._learning_rate, LearningRateDecay):
            out["global_step"] = np.asarray(
                [self._learning_rate.step_num], np.int64)
        return out

    def set_dict(self, state_dict):
        """Restore ``state_dict``: accumulators by parameter name (copied
        in place where they exist, else at their first use), and a
        decay object's step from ``global_step``."""
        from .dygraph.learning_rate_scheduler import LearningRateDecay

        state = dict(state_dict)
        gs = state.pop("global_step", None)
        if gs is not None:
            step = int(np.asarray(gs).ravel()[0])
            if isinstance(self._learning_rate, LearningRateDecay):
                self._learning_rate.step_num = step
            else:
                logging.getLogger(__name__).warning(
                    "set_dict: the checkpoint carries global_step=%d but "
                    "this optimizer's learning_rate is not a "
                    "LearningRateDecay object; the schedule position is "
                    "dropped", step)
        self._loaded_state = state
        for p, st in self._eager_state.values():
            for slot, t in st.items():
                key = "%s@%s" % (p.name, slot)
                if key in state:
                    t.copy_(torch.tensor(np.asarray(state.pop(key)),
                                         dtype=t.dtype))

    set_state_dict = set_dict


class SGDOptimizer(Optimizer):
    """p -= lr g, one ``sgd`` op a parameter."""

    def __init__(self, learning_rate, regularization=None, name=None,
                 grad_clip=None):
        super().__init__(learning_rate, regularization, name, grad_clip)

    def _eager_update(self, p, g, lr):
        self._eager_op(p, "sgd", {"Param": p._ivar, "Grad": g,
                                  "LearningRate": lr}, {})

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        return block.append_op(
            "sgd",
            inputs={"Param": [param], "Grad": [grad],
                    "LearningRate": [self._lr_for(param)]},
            outputs={"ParamOut": [param]})


class AdagradOptimizer(Optimizer):
    """m += g^2; p -= lr g / (sqrt(m) + eps), one ``adagrad`` op a
    parameter with a ``moment`` accumulator filled with
    ``initial_accumulator_value``."""

    def __init__(self, learning_rate, epsilon=1e-6, regularization=None,
                 name=None, initial_accumulator_value=0.0, grad_clip=None):
        super().__init__(learning_rate, regularization, name, grad_clip)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p, fill_value=self._initial)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator("moment", param)
        return block.append_op(
            "adagrad",
            inputs={"Param": [param], "Grad": [grad], "Moment": [moment],
                    "LearningRate": [self._lr_for(param)]},
            outputs={"ParamOut": [param], "MomentOut": [moment]},
            attrs={"epsilon": self._epsilon})


class AdamOptimizer(Optimizer):
    """Adam; a SelectedRows gradient always takes the lazy update (only
    the touched rows' moments decay), as in the reference, which accepts
    ``lazy_mode`` and records nothing of it."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None,
                 lazy_mode=False, grad_clip=None):
        super().__init__(learning_rate, regularization, name, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _eager_update(self, p, g, lr):
        st = self._eager_state_for(p, [("m", None), ("v", None),
                                       ("b1p", self._beta1),
                                       ("b2p", self._beta2)])
        self._eager_op(p, "adam", {
            "Param": p._ivar, "Grad": g, "Moment1": st["m"],
            "Moment2": st["v"], "Beta1Pow": st["b1p"],
            "Beta2Pow": st["b2p"], "LearningRate": lr},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon})

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=(1,))
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2,
                                  shape=(1,))

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        m1 = self._get_accumulator("moment1", param)
        m2 = self._get_accumulator("moment2", param)
        b1p = self._get_accumulator("beta1_pow_acc", param)
        b2p = self._get_accumulator("beta2_pow_acc", param)
        return block.append_op(
            "adam",
            inputs={"Param": [param], "Grad": [grad], "Moment1": [m1],
                    "Moment2": [m2], "Beta1Pow": [b1p], "Beta2Pow": [b2p],
                    "LearningRate": [self._lr_for(param)]},
            outputs={"ParamOut": [param], "Moment1Out": [m1],
                     "Moment2Out": [m2], "Beta1PowOut": [b1p],
                     "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})


class MomentumOptimizer(Optimizer):
    """v = mu v + g; p -= lr v (Nesterov: p -= (g + mu v) lr), one
    ``momentum`` op a parameter with a ``velocity`` accumulator."""

    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 regularization=None, name=None, grad_clip=None):
        super().__init__(learning_rate, regularization, name, grad_clip)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _eager_update(self, p, g, lr):
        st = self._eager_state_for(p, [("velocity", None)])
        self._eager_op(p, "momentum", {
            "Param": p._ivar, "Grad": g, "Velocity": st["velocity"],
            "LearningRate": lr},
            {"mu": self._momentum, "use_nesterov": self._use_nesterov})

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        velocity = self._get_accumulator("velocity", param)
        return block.append_op(
            "momentum",
            inputs={"Param": [param], "Grad": [grad], "Velocity": [velocity],
                    "LearningRate": [self._lr_for(param)]},
            outputs={"ParamOut": [param], "VelocityOut": [velocity]},
            attrs={"mu": self._momentum,
                   "use_nesterov": self._use_nesterov})


class RecomputeOptimizer:
    """Activation recomputation (the reference's ``RecomputeOptimizer``):
    ``_set_checkpoints(vars)`` names the vars to keep; ``backward`` puts
    them on the ``autodiff`` op (``checkpoints``), whose segments between
    them are run again in the backward instead of keeping their
    activations. Updates are the wrapped optimizer's."""

    def __init__(self, optimizer):
        self._optimizer = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = checkpoints

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None, checkpoints=None):
        return append_backward(loss, parameter_list, no_grad_set,
                               checkpoints=self._checkpoints or checkpoints)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def apply_optimize(self, loss, startup_program, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        return self.apply_gradients(params_grads), params_grads


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
