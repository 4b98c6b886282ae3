"""Optimizers: append update ops to the program (the port's counterpart
of ``paddle_tpu/fluid/optimizer.py``): ``minimize`` = ``append_backward``
+ ``apply_gradients``; the learning rate and the accumulators are
persistable vars that the startup program fills.

Ported: the ``Optimizer`` base with weight decay (``regularization``,
``regularizer.py``: applied in ``apply_gradients`` to every parameter,
norms' scales and biases included), ``Adam`` and ``Momentum``.
Gradient clipping, the other optimizers and dygraph updates wait for
later slices.
"""

from . import unique_name
from .backward import append_backward
from .framework import Variable, default_main_program
from .initializer import Constant
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = ["Adam", "AdamOptimizer", "Momentum", "MomentumOptimizer"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._name = name
        self._accumulators = {}  # acc_name -> {param_name: var}
        self._lr_var = None

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
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        self._create_accumulators(block, [p for p, _ in params_grads])
        for pg in params_grads:
            self._append_optimize_op(block, pg)
        return params_grads

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        return self.apply_gradients(params_grads), params_grads


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

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
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

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


Adam = AdamOptimizer
Momentum = MomentumOptimizer
