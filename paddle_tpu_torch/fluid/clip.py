"""Gradient clipping (counterpart of ``paddle_tpu/fluid/clip.py``): by
value, by each gradient's norm, or by the global norm of all of them,
as ops appended after the backward. A clip is attached to one parameter
(``set_gradient_clip(clip, param_list)``), set for every parameter
(``set_gradient_clip(clip)``, a process-wide setting, as in the
reference), or given to a static optimizer (``grad_clip=``), where it
takes the place of the process-wide one. A SelectedRows gradient is not
clipped. Clipping in dygraph mode (``dygraph_grad_clip.py``) is ROADMAP
queue 1 item 6."""

from . import framework

__all__ = [
    "set_gradient_clip", "ErrorClipByValue", "GradientClipByValue",
    "GradientClipByNorm", "GradientClipByGlobalNorm",
    "append_gradient_clip_ops",
]


class BaseErrorClipAttr:
    pass


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max


class BaseGradientClipAttr:
    def _process(self, params_grads):
        raise NotImplementedError


class GradientClipByValue(BaseGradientClipAttr):
    """Each gradient clamped to [min, max] (min -max by default)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _process(self, params_grads):
        from .layers import nn

        return [(p, nn.clip(g, self.min, self.max)) for p, g in params_grads]


class GradientClipByNorm(BaseGradientClipAttr):
    """Each gradient scaled to L2 norm ``clip_norm`` where larger."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _process(self, params_grads):
        from .layers import nn

        return [(p, nn.clip_by_norm(g, self.clip_norm))
                for p, g in params_grads]


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Every gradient times clip_norm / max(global norm, clip_norm), the
    global norm over all of them."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _process(self, params_grads):
        from .layers import nn, ops, tensor

        sq_sums = [nn.reduce_sum(ops.square(g)) for _, g in params_grads]
        stacked = nn.sum([nn.reshape(s, [1]) for s in sq_sums]) \
            if len(sq_sums) > 1 else nn.reshape(sq_sums[0], [1])
        global_norm = ops.sqrt(stacked)
        clip_var = tensor.fill_constant([1], "float32", self.clip_norm)
        scale = nn.elementwise_div(
            clip_var, nn.elementwise_max(global_norm, clip_var))
        return [(p, nn.elementwise_mul(g, scale)) for p, g in params_grads]


_global_clip = None


def set_gradient_clip(clip, param_list=None, program=None):
    """``clip`` for the parameters of ``param_list`` (names or
    Variables), and for every other parameter of every program built
    after (None clears it)."""
    global _global_clip
    _global_clip = clip
    for p in param_list or ():
        if isinstance(p, str):
            p = framework.default_main_program().global_block().var(p)
        p._grad_clip = clip


def append_gradient_clip_ops(params_grads, default_clip=None):
    """The clipped (param, grad) pairs: a parameter's own clip first, else
    ``default_clip`` or the process-wide clip. A SelectedRows gradient
    passes unclipped (scaling its rows alone would mis-scale a row named
    twice)."""
    default_clip = default_clip or _global_clip
    clipped, todo = [], []
    for p, g in params_grads:
        if g is not None and getattr(g, "type", "lod_tensor") == \
                "selected_rows":
            clipped.append((p, g))
            continue
        attr = getattr(p, "_grad_clip", None)
        if attr is not None:
            clipped.extend(attr._process([(p, g)]))
        else:
            todo.append((p, g))
    if todo:
        clipped.extend(default_clip._process(todo) if default_clip
                       else todo)
    return clipped
