"""Weight-decay regularizers (the port's copy of
``paddle_tpu/fluid/regularizer.py``): each appends ops that add its
decay term to a parameter's gradient, ``scale`` of the parameter (L2) or
of its ``sign`` (L1), then ``elementwise_add``."""

import warnings

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    """grad + coeff * param."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        from .layers import nn

        decay = nn.scale(param, scale=self._coeff)
        return nn.elementwise_add(grad, decay)


class L1DecayRegularizer(WeightDecayRegularizer):
    """grad + coeff * sign(param)."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        from .layers import nn

        decay = nn.scale(nn.sign(param), scale=self._coeff)
        return nn.elementwise_add(grad, decay)


def append_regularization_ops(params_grads, regularization=None):
    """[(param, grad)] -> [(param, regularized grad)]: a parameter's own
    ``regularizer`` wins over ``regularization``. SelectedRows gradients
    pass unchanged, as in the reference (decaying the rows a sparse
    update does not touch would densify the gradient)."""
    out = []
    for param, grad in params_grads:
        regular = getattr(param, "regularizer", None) or regularization
        if regular is None or grad is None:
            out.append((param, grad))
            continue
        if getattr(grad, "type", "lod_tensor") == "selected_rows":
            warnings.warn("regularization skipped for sparse gradient of %r"
                          % param.name)
            out.append((param, grad))
            continue
        out.append((param, regular(param, grad, grad.block)))
    return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
