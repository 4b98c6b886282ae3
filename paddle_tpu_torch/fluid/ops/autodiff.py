"""The ``autodiff`` op as torch autograd.

The reference's lowering replays the forward ops under ``jax.grad``
(``paddle_tpu/fluid/ops/autodiff.py``). Here the forward has already run
eagerly with autograd recording: the executor bound every dense ``wrt``
parameter as a fresh leaf with ``requires_grad=True`` before lowering
the block and detached each ``stop_gradient`` var where it was produced,
so this op only asks autograd for the gradients. Without
``retain_graph`` the saved activations are freed before the optimizer
ops run. Dropout masks need no replay: the graph holds them.

SelectedRows gradients (``sparse_wrt``: [param, ids, lookup output] for
each parameter that only one sparse lookup reads): the lookup bound its
output as a leaf before its padding mask (``tensor_ops.sparse_leaf``),
so the values are autograd's gradient with respect to that output,
shaped [n, dim], and the rows the flattened ids as int32, one per lookup
position, not deduplicated, as the reference binds them. No dense
[vocab, dim] gradient is built.

Loss scaling (AMP): the objective is the summed loss times the static
``loss_scale`` attr and, under dynamic scaling, times the value of the
``loss_scale_var`` variable, read on the device (no host sync).

Not ported yet: ``checkpoints`` (recompute) and ``dist_push`` (the
parameter-server tier's gradients).
"""

import torch

from ..registry import register

_DEFERRED = (("checkpoints", "recompute, ROADMAP queue 1 item 3"),
             ("dist_push", "the parameter-server tier, ROADMAP queue 8"))


@register("autodiff")
def _autodiff(ctx, op):
    for attr, item in _DEFERRED:
        if op.attr(attr):
            raise NotImplementedError(
                "autodiff attr %r is not ported yet (%s)" % (attr, item))
    loss = ctx.get(op.attr("loss"))
    wrt, grad_names = list(op.attr("wrt")), list(op.attr("grad_names"))
    sparse_wrt = [tuple(s) for s in op.attr("sparse_wrt") or ()]
    sparse_names = {s[0] for s in sparse_wrt}
    dense = [i for i, n in enumerate(wrt) if n not in sparse_names]
    leaves = [ctx.get(wrt[i]) for i in dense]
    unbound = [wrt[i] for i, t in zip(dense, leaves) if not t.requires_grad]
    unbound += [s[2] for s in sparse_wrt if s[2] not in ctx.sparse_leaves]
    if unbound:
        raise RuntimeError(
            "autodiff: %s were not bound as autograd leaves; run the "
            "program through Executor.run" % unbound[:3])
    outs = [ctx.sparse_leaves[s[2]] for s in sparse_wrt]
    objective = loss.sum() * op.attr("loss_scale", 1.0)
    scale_var = op.attr("loss_scale_var")
    if scale_var:
        objective = objective * ctx.get(scale_var).detach().reshape(
            ()).float()
    grads = torch.autograd.grad(objective, leaves + outs, allow_unused=True)
    for i, leaf, g in zip(dense, leaves, grads):
        ctx.set(grad_names[i], torch.zeros_like(leaf) if g is None else g)
    for (pname, ids_name, _), out, g in zip(sparse_wrt, outs,
                                            grads[len(dense):]):
        rows = ctx.get(ids_name).reshape(-1).to(torch.int32)
        g = torch.zeros_like(out) if g is None else g
        gname = grad_names[wrt.index(pname)]
        ctx.set(gname, g.reshape(rows.shape[0], -1))
        ctx.set(gname + "@ROWS", rows)
