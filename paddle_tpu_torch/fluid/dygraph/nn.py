"""The dygraph modules of ``paddle_tpu/fluid/dygraph/nn.py`` that the
port lowers: ``Linear``, ``FC``, ``Embedding``, ``LayerNorm``,
``Dropout``, ``Conv2D``, ``Pool2D`` and ``BatchNorm``.

Under ``dygraph.guard()``, on a ``VarBase`` input, each ``forward``
traces the reference's ops with the reference's attrs (``Linear`` is
``matmul`` + ``elementwise_add(axis=-1)`` + its act op; ``LayerNorm`` is
``layer_norm`` with its three outputs), so ``jit.trace`` records the
reference's program. On a torch tensor, ``Linear``, ``Embedding`` and
``LayerNorm`` compute directly in torch, as the decode sessions and
``Predictor``'s models call them; the other modules trace only.

Parameters keep the reference's layouts, so weights carry across as they
are: ``Linear.weight`` is [in, out] (the transpose of
``torch.nn.Linear``'s). Each layer takes keyword-only ``device=`` (the
guard's device under a guard, else the card, which raises where there is
none) and ``generator=`` (the tracer's under a guard). Parameter names
are the reference's (``layers.py``).

Not ported yet (ROADMAP queue 1, item 6): ``Conv3D``, the transposed
convolutions, ``GroupNorm``, ``SpectralNorm``, ``PRelu``,
``BilinearTensorProduct``, ``GRUUnit``, ``NCE`` and ``TreeConv``.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import initializer
from .base import ParamBase, VarBase, _tracer
from .layers import Layer

__all__ = ["Linear", "FC", "Embedding", "LayerNorm", "Dropout", "Conv2D",
           "Pool2D", "BatchNorm"]

# the activations a layer's torch path applies (its traced path emits the
# act op, whatever the registry lowers)
_TORCH_ACTS = {"relu": F.relu}


def _act(t, act, x):
    if act:
        (x,) = t.trace_op(act, {"X": [x]}, ["Out"], {})
    return x


def _torch_act(act):
    """The torch function of ``act`` for a layer's torch path (None: no
    activation); one the torch path lacks raises when called."""
    if act is None or act in _TORCH_ACTS:
        return _TORCH_ACTS.get(act)

    def refuse(x):
        raise ValueError("act %r has no torch path; trace the layer under "
                         "dygraph.guard() with VarBase inputs" % (act,))
    return refuse


def _pair(v, n=2):
    return [v] * n if isinstance(v, int) else list(v)


class Linear(Layer):
    """``out = act(x @ weight + bias)``; weight [input_dim, output_dim]."""

    def __init__(self, input_dim, output_dim, param_attr=None,
                 bias_attr=None, act=None, dtype="float32", *, device=None,
                 generator=None):
        super().__init__(None, dtype, device, generator)
        self._act = act
        self._torch_act = _torch_act(act)
        self.weight = self.create_parameter([input_dim, output_dim],
                                            param_attr, dtype)
        self.bias = self.create_parameter([output_dim], bias_attr, dtype,
                                          is_bias=True)

    def forward(self, input):
        if isinstance(input, VarBase):
            return self._trace(input)
        out = torch.matmul(input, self.weight)
        if self.bias is not None:
            out = out + self.bias
        return out if self._torch_act is None else self._torch_act(out)

    def _trace(self, input):
        t = _tracer()
        (out,) = t.trace_op("matmul", {"X": [input], "Y": [self.weight]},
                            ["Out"], {"transpose_X": False,
                                      "transpose_Y": False, "alpha": 1.0})
        if self.bias is not None:
            (out,) = t.trace_op("elementwise_add",
                                {"X": [out], "Y": [self.bias]}, ["Out"],
                                {"axis": -1})
        return _act(t, self._act, out)


class FC(Layer):
    """The reference's dygraph FC: ``mul`` over the input flattened at
    ``num_flatten_dims``; the weight is made at the first call unless
    ``input_dim`` is given."""

    def __init__(self, name_scope=None, size=None, num_flatten_dims=1,
                 param_attr=None, bias_attr=None, act=None, dtype="float32",
                 input_dim=None, *, device=None, generator=None):
        super().__init__(name_scope, dtype, device, generator)
        self._size = size
        self._num_flatten_dims = num_flatten_dims
        self._act = act
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self.weight = None
        self.bias = None
        if input_dim is not None:
            self._build(input_dim)

    def _build(self, in_features):
        self.weight = self.create_parameter([in_features, self._size],
                                            self._param_attr, self._dtype)
        self.bias = self.create_parameter([self._size], self._bias_attr,
                                          self._dtype, is_bias=True)

    def forward(self, input):
        if self.weight is None:
            self._build(int(np.prod(input.shape[self._num_flatten_dims:])))
        t = _tracer()
        (out,) = t.trace_op(
            "mul", {"X": [input], "Y": [self.weight]}, ["Out"],
            {"x_num_col_dims": self._num_flatten_dims, "y_num_col_dims": 1})
        if self.bias is not None:
            (out,) = t.trace_op("elementwise_add",
                                {"X": [out], "Y": [self.bias]}, ["Out"],
                                {"axis": self._num_flatten_dims})
        return _act(t, self._act, out)


class Embedding(Layer):
    """``lookup_table``: rows of ``weight`` [vocab, dim] by id. As in the
    reference, ids of rank >= 2 with a trailing dim of 1 drop it, so
    [B, 1] ids embed to [B, dim] and [B, 1, 1] ids to [B, 1, dim]; rows
    at ``padding_idx`` read zeros. ``is_sparse`` and ``is_distributed``
    are accepted and unused, as in the reference's dygraph layer."""

    def __init__(self, size=None, is_sparse=False, is_distributed=False,
                 padding_idx=None, param_attr=None, dtype="float32", *,
                 name_scope=None, device=None, generator=None):
        super().__init__(name_scope, dtype, device, generator)
        self._padding_idx = -1 if padding_idx is None else padding_idx
        self.weight = self.create_parameter(
            list(size), param_attr, dtype,
            default_initializer=initializer.Xavier())

    def forward(self, ids):
        if not isinstance(ids, VarBase):
            if ids.dim() >= 2 and ids.shape[-1] == 1:
                ids = ids[..., 0]
            out = F.embedding(ids.long(), self.weight)
            if self._padding_idx >= 0:
                out = out.masked_fill((ids == self._padding_idx)
                                      .unsqueeze(-1), 0.0)
            return out
        (out,) = _tracer().trace_op(
            "lookup_table", {"W": [self.weight], "Ids": [ids]}, ["Out"],
            {"padding_idx": self._padding_idx})
        return out


class LayerNorm(Layer):
    """Normalises over the axes from ``begin_norm_axis`` on, with the
    biased variance and ``epsilon`` inside the square root, then scales
    and shifts by the [prod(normalized_shape)] parameters."""

    def __init__(self, normalized_shape=None, scale=True, shift=True,
                 begin_norm_axis=1, epsilon=1e-5, param_attr=None,
                 bias_attr=None, act=None, dtype="float32", *,
                 name_scope=None, device=None, generator=None):
        super().__init__(name_scope, dtype, device, generator)
        self._epsilon = epsilon
        self._begin_norm_axis = begin_norm_axis
        self._act = act
        self._torch_act = _torch_act(act)
        n = math.prod(normalized_shape)
        self.weight = self.create_parameter(
            [n], param_attr, dtype,
            default_initializer=initializer.Constant(1.0)) if scale else None
        self.bias = self.create_parameter(
            [n], bias_attr, dtype, is_bias=True) if shift else None

    def forward(self, input):
        if not isinstance(input, VarBase):
            shape = input.shape[self._begin_norm_axis:]
            out = F.layer_norm(
                input, shape,
                None if self.weight is None else self.weight.view(shape),
                None if self.bias is None else self.bias.view(shape),
                self._epsilon)
            return out if self._torch_act is None else self._torch_act(out)
        t = _tracer()
        slots = {"X": [input]}
        if self.weight is not None:
            slots["Scale"] = [self.weight]
        if self.bias is not None:
            slots["Bias"] = [self.bias]
        y = t.trace_op("layer_norm", slots, ["Y", "Mean", "Variance"],
                       {"epsilon": self._epsilon,
                        "begin_norm_axis": self._begin_norm_axis})[0]
        return _act(t, self._act, y)


class Dropout(Layer):
    def __init__(self, p=0.5, dropout_implementation="downgrade_in_infer"):
        super().__init__()
        self._p = p
        self._impl = dropout_implementation

    def forward(self, input):
        return _tracer().trace_op(
            "dropout", {"X": [input]}, ["Out", "Mask"],
            {"dropout_prob": self._p, "is_test": not self.training,
             "dropout_implementation": self._impl})[0]


class Conv2D(Layer):
    """``conv2d`` (NCHW input, OIHW filter) + ``elementwise_add(axis=1)``
    of the bias + the act op; the filter drawn Normal(0, sqrt(2 / fan))
    as the reference's."""

    def __init__(self, name_scope=None, num_channels=None, num_filters=None,
                 filter_size=None, stride=1, padding=0, dilation=1,
                 groups=None, param_attr=None, bias_attr=None, act=None,
                 dtype="float32", *, device=None, generator=None):
        super().__init__(name_scope, dtype, device, generator)
        self._groups = groups or 1
        self._stride = _pair(stride)
        self._padding = _pair(padding)
        self._dilation = _pair(dilation)
        self._act = act
        filter_size = _pair(filter_size)
        fan = num_channels * filter_size[0] * filter_size[1] // self._groups
        self.weight = self.create_parameter(
            [num_filters, num_channels // self._groups] + filter_size,
            param_attr, dtype,
            default_initializer=initializer.Normal(0.0, (2.0 / fan) ** 0.5))
        self.bias = self.create_parameter([num_filters], bias_attr, dtype,
                                          is_bias=True)

    def forward(self, input):
        t = _tracer()
        (out,) = t.trace_op(
            "conv2d", {"Input": [input], "Filter": [self.weight]},
            ["Output"], {"strides": self._stride, "paddings": self._padding,
                         "dilations": self._dilation, "groups": self._groups})
        if self.bias is not None:
            (out,) = t.trace_op("elementwise_add",
                                {"X": [out], "Y": [self.bias]}, ["Out"],
                                {"axis": 1})
        return _act(t, self._act, out)


class Pool2D(Layer):
    def __init__(self, name_scope=None, pool_size=-1, pool_type="max",
                 pool_stride=1, pool_padding=0, global_pooling=False,
                 ceil_mode=False, exclusive=True, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._attrs = {
            "pooling_type": pool_type, "ksize": _pair(pool_size),
            "strides": _pair(pool_stride), "paddings": _pair(pool_padding),
            "global_pooling": global_pooling, "ceil_mode": ceil_mode,
            "exclusive": exclusive}

    def forward(self, input):
        (out,) = _tracer().trace_op("pool2d", {"X": [input]}, ["Out"],
                                    self._attrs)
        return out


class BatchNorm(Layer):
    """``batch_norm``; in training the batch's statistics move the
    running ones (``_mean``, ``_variance``: parameters that stop the
    gradient, as the reference's persistable VarBases), in place."""

    def __init__(self, name_scope=None, num_channels=None, act=None,
                 is_test=False, momentum=0.9, epsilon=1e-5, param_attr=None,
                 bias_attr=None, dtype="float32", data_layout="NCHW",
                 use_global_stats=False, *, device=None, generator=None):
        super().__init__(name_scope, dtype, device, generator)
        self._momentum = momentum
        self._epsilon = epsilon
        self._act = act
        self._data_layout = data_layout
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_channels], param_attr, dtype,
            default_initializer=initializer.Constant(1.0))
        self.bias = self.create_parameter([num_channels], bias_attr, dtype,
                                          is_bias=True)
        device = self.weight.device
        self._mean = ParamBase.make(
            torch.zeros(num_channels, device=device), None, trainable=False)
        self._variance = ParamBase.make(
            torch.ones(num_channels, device=device), None, trainable=False)
        for p in (self._mean, self._variance):
            p.name = "eager_var_%d" % next(type(p)._counter)

    def forward(self, input):
        t = _tracer()
        outs = t.trace_op(
            "batch_norm",
            {"X": [input], "Scale": [self.weight], "Bias": [self.bias],
             "Mean": [self._mean], "Variance": [self._variance]},
            ["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"],
            {"momentum": self._momentum, "epsilon": self._epsilon,
             "is_test": not self.training, "data_layout": self._data_layout,
             "use_global_stats": self._use_global_stats})
        if outs[1] is not None:   # training: commit the running statistics
            with torch.no_grad():
                self._mean.copy_(outs[1]._ivar)
                self._variance.copy_(outs[2]._ivar)
        return _act(t, self._act, outs[0])
