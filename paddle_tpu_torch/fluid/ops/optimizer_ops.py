"""The ``adam`` op with Paddle's update (counterpart in
``paddle_tpu/fluid/ops/optimizer_ops.py``):

    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
    lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)
    p -= lr_t * m / (sqrt(v) + eps)          (eps outside the correction)

and the beta powers advance inside the op. Unlike the JAX package, whose
arrays are immutable, the parameter, both moments and the beta powers
are updated IN PLACE: a copy of every parameter and moment would add
their full size to the step's peak memory. The executor runs the ops
after ``autodiff`` under ``torch.no_grad()``.
"""

import torch

from ..registry import register


@register("adam")
def _adam(ctx, op):
    p = ctx.get_input(op, "Param")
    g = ctx.get_input(op, "Grad")
    m = ctx.get_input(op, "Moment1")
    v = ctx.get_input(op, "Moment2")
    b1p = ctx.get_input(op, "Beta1Pow")
    b2p = ctx.get_input(op, "Beta2Pow")
    b1, b2 = op.attr("beta1", 0.9), op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-8)
    lr = ctx.get_input(op, "LearningRate").reshape(()).to(p.dtype)
    with torch.no_grad():
        lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        p.sub_(lr_t * m / (v.sqrt() + eps))
        b1p.mul_(b1)
        b2p.mul_(b2)
    for slot, t in (("ParamOut", p), ("Moment1Out", m), ("Moment2Out", v),
                    ("Beta1PowOut", b1p), ("Beta2PowOut", b2p)):
        ctx.set_output(op, slot, t)
