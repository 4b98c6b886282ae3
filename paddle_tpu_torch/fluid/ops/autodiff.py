"""The ``autodiff`` op as torch autograd.

The reference's lowering replays the forward ops under ``jax.grad``
(``paddle_tpu/fluid/ops/autodiff.py``). Here the forward has already run
eagerly with autograd recording: the executor bound every ``wrt``
parameter as a fresh leaf with ``requires_grad=True`` before lowering
the block and detached each ``stop_gradient`` var where it was produced,
so this op only asks autograd for the gradients. Without
``retain_graph`` the saved activations are freed before the optimizer
ops run. Dropout masks need no replay: the graph holds them.

Loss scaling (AMP): the objective is the summed loss times the static
``loss_scale`` attr and, under dynamic scaling, times the value of the
``loss_scale_var`` variable, read on the device (no host sync).

Not ported yet: ``checkpoints`` (recompute), ``sparse_wrt`` and
``dist_push`` (SelectedRows and PS gradients).
"""

import torch

from ..registry import register

_DEFERRED = ("checkpoints", "sparse_wrt", "dist_push")


@register("autodiff")
def _autodiff(ctx, op):
    for attr in _DEFERRED:
        if op.attr(attr):
            raise NotImplementedError(
                "autodiff attr %r (recompute or sparse gradients) is not "
                "ported yet" % attr)
    loss = ctx.get(op.attr("loss"))
    wrt = list(op.attr("wrt"))
    leaves = [ctx.get(n) for n in wrt]
    unbound = [n for n, t in zip(wrt, leaves) if not t.requires_grad]
    if unbound:
        raise RuntimeError(
            "autodiff: %s were not bound as autograd leaves; run the "
            "program through Executor.run" % unbound[:3])
    objective = loss.sum() * op.attr("loss_scale", 1.0)
    scale_var = op.attr("loss_scale_var")
    if scale_var:
        objective = objective * ctx.get(scale_var).detach().reshape(
            ()).float()
    grads = torch.autograd.grad(objective, leaves, allow_unused=True)
    for name, leaf, g in zip(op.attr("grad_names"), leaves, grads):
        ctx.set(name, torch.zeros_like(leaf) if g is None else g)
