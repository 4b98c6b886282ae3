"""Parameter initializers: each appends its init op to the startup
program (the port's copy of the ``Constant``, ``Uniform``, ``Normal``
and ``Xavier`` initializers of ``paddle_tpu/fluid/initializer.py``)."""

import math

import numpy as np

from . import framework

__all__ = ["Constant", "Uniform", "Normal", "Xavier"]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    def _fan_in_out(self, var):
        shape = var.shape
        if len(shape) < 2:
            return (shape[0] if shape else 1,) * 2
        receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
        return shape[1] * receptive, shape[0] * receptive


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op(
            "fill_constant", outputs={"Out": var},
            attrs={"shape": list(var.shape),
                   "dtype": framework.dtype_str(var.dtype),
                   "value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(
            "uniform_random", outputs={"Out": var},
            attrs={"shape": list(var.shape),
                   "dtype": framework.dtype_str(var.dtype),
                   "min": float(self.low), "max": float(self.high),
                   "seed": self.seed})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            "gaussian_random", outputs={"Out": var},
            attrs={"shape": list(var.shape),
                   "dtype": framework.dtype_str(var.dtype),
                   "mean": float(self.loc), "std": float(self.scale),
                   "seed": self.seed})


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in = fan_in
        self.fan_out = fan_out
        self.seed = seed

    def __call__(self, var, block):
        fan_in, fan_out = self._fan_in_out(var)
        fan_in = self.fan_in if self.fan_in is not None else fan_in
        fan_out = self.fan_out if self.fan_out is not None else fan_out
        if self.uniform:
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fan_in + fan_out))
            NormalInitializer(0.0, std, self.seed)(var, block)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
