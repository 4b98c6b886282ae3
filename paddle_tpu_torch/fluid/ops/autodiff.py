"""The ``autodiff`` op as torch autograd.

The reference's lowering replays the forward ops under ``jax.grad``
(``paddle_tpu/fluid/ops/autodiff.py``). Here the forward has already run
eagerly with autograd recording: the executor bound every dense ``wrt``
parameter as a fresh leaf with ``requires_grad=True`` before lowering
the block and detached each ``stop_gradient`` var where it was produced,
so this op only asks autograd for the gradients. Without
``retain_graph`` the saved activations are freed before the optimizer
ops run. Dropout masks need no replay: the graph holds them.

Control flow: a control-flow op before this one lowers its sub-blocks
in the same autograd mode (``registry.lower_block``), so ``cond``,
``switch``, ``static_rnn`` and the bounded ``while_loop`` differentiate
as the ops they ran, each step's or branch's ``stop_gradient`` outputs
detached where they are produced. As in the reference, whose
``lax.while_loop`` has no reverse mode, no gradient flows through a
``while`` or an unbounded ``while_loop``: the executor's plan refuses
one whose reads depend on a ``wrt`` leaf before any op runs, naming
``while_loop(maximum_trip_count=)``.

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

Recompute (the ``checkpoints`` attr, ``RecomputeOptimizer``): the
executor splits the ops before this op into segments after the op that
last produces each checkpoint (``checkpoint_segments``) and runs every
segment but the last under ``torch.utils.checkpoint``
(``run_checkpointed``), as the reference runs them under
``jax.checkpoint``: autograd keeps a segment's inputs instead of its
activations, and this op's ``torch.autograd.grad`` runs the segment
again to rebuild them. The second run hands each random op the draws of
the first (``registry.DrawRecord``): the same dropout masks and
attention seeds, and no move of the generator. Recompute with
SelectedRows gradients is refused, in the reference's words.

Not ported yet: ``dist_push`` (the parameter-server tier's gradients).
"""

import torch

from ..registry import DrawRecord, lower_op, register

_DEFERRED = (("dist_push", "the parameter-server tier, ROADMAP queue 8"),)

RECOMPUTE_SPARSE = "recompute + sparse embedding grads not supported yet"


def checkpoint_segments(ops, grad_at, checkpoints):
    """[(lo, hi)] of the segments of ``ops[:grad_at]`` to run under
    recompute: the ops are cut after the op that last produces each
    checkpoint, and every segment but the last is recomputed (none when
    the cuts leave one segment)."""
    producer = {}
    for i, op in enumerate(ops[:grad_at]):
        for n in op.output_arg_names():
            producer[n] = i
    segments, lo = [], 0
    for cut in sorted({producer[c] for c in checkpoints if c in producer}):
        segments.append((lo, cut + 1))
        lo = cut + 1
    if lo < grad_at:
        segments.append((lo, grad_at))
    return segments[:-1]


def run_checkpointed(ctx, ops, lo, hi, after_op):
    """Lower ``ops[lo:hi]`` in ``ctx`` under ``torch.utils.checkpoint``
    (non-reentrant, the generator untouched: ``preserve_rng_state``
    saves only torch's default generators, and the ops draw from the
    scope's; no early stop, whose signal would reach ``lower_op`` as an
    op's error). The segment runs on a copy of the environment;
    ``after_op(j, env)`` runs after op j in it (detaching
    ``stop_gradient`` outputs, dropping dead entries). What the segment
    bound or rebound is merged back into ``ctx.env``."""
    from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

    record = DrawRecord()

    def segment(env_in):
        outer, ctx.env = ctx.env, dict(env_in)
        ctx.draw_record = record
        try:
            for j in range(lo, hi):
                record.at_op(j)
                lower_op(ctx, ops[j])
                after_op(j, ctx.env)
            return {n: t for n, t in ctx.env.items()
                    if env_in.get(n) is not t}
        finally:
            ctx.env, ctx.draw_record = outer, None
            # every later run of the segment is the backward's recompute
            record.replaying = True

    with torch.enable_grad(), set_checkpoint_early_stop(False):
        ctx.env.update(checkpoint(segment, dict(ctx.env),
                                  use_reentrant=False,
                                  preserve_rng_state=False))


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
