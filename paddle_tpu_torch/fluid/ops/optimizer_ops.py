"""The optimizer update ops: ``sgd``, ``momentum``, ``adagrad`` and
``adam`` (counterparts in ``paddle_tpu/fluid/ops/optimizer_ops.py``).
Adam with Paddle's update:

    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
    lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)
    p -= lr_t * m / (sqrt(v) + eps)          (eps outside the correction)

and the beta powers advance inside the op. Momentum:

    v = mu v + g
    p -= lr v                 (use_nesterov: p -= (g + mu v) lr)

Adagrad: m += g^2; p -= lr g / (sqrt(m) + eps). SGD: p -= lr g.

Unlike the JAX package, whose arrays are immutable, each op updates its
parameter and accumulators IN PLACE: a copy of every parameter and
accumulator would add their full size to the step's peak memory, and a
captured step would copy each back into its storage inside the graph.
The executor runs the ops after ``autodiff`` under ``torch.no_grad()``.

A SelectedRows gradient (a ``selected_rows`` Grad var: values [n, ...]
bound to its name, int32 rows to name + "@ROWS", one per lookup
position) takes the reference's fused lazy update, O(#lookups) work:
the rows made unique at their static size, the values of duplicate rows
summed, the touched rows of the parameter and its accumulators gathered
and updated, and the masked deltas scatter-added back in place. Rows
the batch does not touch, and their accumulators, stay as they were to
the bit; padded lanes and out-of-range rows add nothing. The sums run
in one fixed order at every run (``tensor_ops.sum_rows``) and each row
takes at most one nonzero delta a scatter (``_Rows.add``), so a captured
step equals an eager one to the bit.
"""

import torch

from ..registry import register
from .tensor_ops import row_index, static_unique, sum_rows


def _lr(ctx, op, p):
    return ctx.get_input(op, "LearningRate").reshape(()).to(p.dtype)


def _sparse_grad(ctx, op):
    """(rows, values) when the Grad input is a SelectedRows var, else
    None."""
    gname = op.input("Grad")[0]
    gvar = ctx.var(gname)
    if gvar is None or getattr(gvar, "type", "lod_tensor") != \
            "selected_rows":
        return None
    return ctx.get(gname + "@ROWS"), ctx.get(gname)


class _Rows:
    """The fused update's touched rows of a [vocab, ...] parameter, one
    lane a distinct raw id (the reference makes the ids unique before
    it counts the negative ones from the end): ``keep`` whether a lane
    holds a distinct in-range id, ``idx`` its row (a masked lane i
    points at row i mod vocab, so the masked lanes do not pile onto one
    row; the +0.0 it adds there leaves every value as it was, only a
    -0.0 would read back +0.0), ``g`` the summed gradient of each lane,
    ``late`` the kept lanes of ids counted from the start. A batch that
    holds both -k and vocab-k updates that row twice, as the reference
    does, each lane from the row as it was."""

    def __init__(self, p, rows, vals):
        n, vocab = rows.shape[0], p.shape[0]
        uniq, inv, valid = static_unique(rows.long())
        idx, ok = row_index(uniq, vocab)
        keep = valid & ok
        spread = torch.arange(n, device=rows.device) % vocab
        self.idx = torch.where(keep, idx, spread)
        shape = (n,) + (1,) * (p.dim() - 1)
        self.early = (keep & (uniq < 0)).reshape(shape)
        self.late = (keep & (uniq >= 0)).reshape(shape)
        self.g = sum_rows(vals.to(p.dtype).reshape((n,) + tuple(p.shape[1:])),
                          inv)

    def gather(self, t):
        return t[self.idx]

    def add(self, dst, delta):
        """dst[row] += delta on the kept lanes, in place: first the
        lanes of negative ids, then the others. Within each pass the
        kept lanes' rows are distinct and every other lane adds +0.0, so
        each row takes at most one nonzero delta a pass and the order of
        ``index_add_``'s atomic adds on the card cannot change a value.
        (The deterministic mode's sorted scatter serialises the lanes of
        one row: with the masked lanes all at row 0 it took 3.5-7 ms a
        call at batch 4096 on the H100, PERF.md §6.)"""
        for lanes in (self.early, self.late):
            dst.index_add_(0, self.idx,
                           torch.where(lanes, delta, 0.0).to(dst.dtype))
        return dst

    def apply(self, dst, new, old):
        return self.add(dst, new - old)


@register("sgd")
def _sgd(ctx, op):
    p = ctx.get_input(op, "Param")
    lr = _lr(ctx, op, p)
    sp = _sparse_grad(ctx, op)
    with torch.no_grad():
        if sp is not None:
            # duplicate rows accumulate, untouched rows stay
            r = _Rows(p, *sp)
            r.add(p, -lr * r.g)
        else:
            p.sub_(lr * ctx.get_input(op, "Grad"))
    ctx.set_output(op, "ParamOut", p)


@register("momentum")
def _momentum(ctx, op):
    p = ctx.get_input(op, "Param")
    v = ctx.get_input(op, "Velocity")
    mu = op.attr("mu")
    nesterov = op.attr("use_nesterov", False)
    lr = _lr(ctx, op, p)
    sp = _sparse_grad(ctx, op)
    with torch.no_grad():
        if sp is not None:
            # lazy: only the touched rows' velocity decays
            r = _Rows(p, *sp)
            g, p_rows, v_rows = r.g, r.gather(p), r.gather(v)
            v_new = mu * v_rows + g
            p_new = p_rows - ((g + mu * v_new) * lr if nesterov
                              else lr * v_new)
            r.apply(p, p_new, p_rows)
            r.apply(v, v_new, v_rows)
        else:
            g = ctx.get_input(op, "Grad")
            v.mul_(mu).add_(g)
            if nesterov:
                p.sub_((g + mu * v) * lr)
            else:
                p.sub_(lr * v)
    ctx.set_output(op, "ParamOut", p)
    ctx.set_output(op, "VelocityOut", v)


@register("adagrad")
def _adagrad(ctx, op):
    p = ctx.get_input(op, "Param")
    m = ctx.get_input(op, "Moment")
    eps = op.attr("epsilon", 1e-6)
    lr = _lr(ctx, op, p)
    sp = _sparse_grad(ctx, op)
    with torch.no_grad():
        if sp is not None:
            r = _Rows(p, *sp)
            g, p_rows, m_rows = r.g, r.gather(p), r.gather(m)
            m_new = m_rows + g * g
            r.apply(p, p_rows - lr * g / (m_new.sqrt() + eps), p_rows)
            r.apply(m, m_new, m_rows)
        else:
            g = ctx.get_input(op, "Grad")
            m.addcmul_(g, g)
            p.sub_(lr * g / (m.sqrt() + eps))
    ctx.set_output(op, "ParamOut", p)
    ctx.set_output(op, "MomentOut", m)


@register("adam")
def _adam(ctx, op):
    p = ctx.get_input(op, "Param")
    m = ctx.get_input(op, "Moment1")
    v = ctx.get_input(op, "Moment2")
    b1p = ctx.get_input(op, "Beta1Pow")
    b2p = ctx.get_input(op, "Beta2Pow")
    b1, b2 = op.attr("beta1", 0.9), op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-8)
    lr = _lr(ctx, op, p)
    sp = _sparse_grad(ctx, op)
    with torch.no_grad():
        lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
        if sp is not None:
            # lazy mode: moments decay and params move on touched rows only
            r = _Rows(p, *sp)
            g = r.g
            p_rows, m_rows, v_rows = r.gather(p), r.gather(m), r.gather(v)
            m_new = b1 * m_rows + (1 - b1) * g
            v_new = b2 * v_rows + (1 - b2) * g * g
            r.apply(m, m_new, m_rows)
            r.apply(v, v_new, v_rows)
            r.apply(p, p_rows - lr_t * m_new / (v_new.sqrt() + eps), p_rows)
        else:
            g = ctx.get_input(op, "Grad")
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(lr_t * m / (v.sqrt() + eps))
        b1p.mul_(b1)
        b2p.mul_(b2)
    for slot, t in (("ParamOut", p), ("Moment1Out", m), ("Moment2Out", v),
                    ("Beta1PowOut", b1p), ("Beta2PowOut", b2p)):
        ctx.set_output(op, slot, t)
