"""Shape/layout ops: reshape, transpose, unsqueeze, squeeze, slice, split,
stack, expand, gather, concat and lookup_table (dense, and sparse with a
SelectedRows gradient), the step counter's increment, the
SelectedRows ops merge_selected_rows and get_tensor_from_selected_rows;
cast (AMP) and the select ops of dynamic loss scaling: assign, where,
zeros_like (counterparts in ``paddle_tpu/fluid/ops/tensor_ops.py``).

Also the row machinery the sparse embedding engine shares
(``embedding_ops.py``, the sparse optimizer updates): the reference's
out-of-range rule (``row_index``), a static-size unique
(``static_unique``) and per-row sums in one fixed order (``sum_rows``,
under ``deterministic()``), none of which syncs with the host."""

import contextlib
import threading

import torch
import torch.nn.functional as F

from ..registry import register, to_torch_dtype


def _resolve_reshape(x, shape):
    # fluid: 0 copies the input's dim at that position
    return [x.shape[i] if int(s) == 0 else int(s) for i, s in enumerate(shape)]


@register("reshape")
def _reshape(ctx, op):
    x = ctx.get_input(op, "X")
    ctx.set_output(op, "Out", torch.reshape(
        x, _resolve_reshape(x, op.attr("shape"))))


@register("transpose")
def _transpose(ctx, op):
    ctx.set_output(op, "Out",
                   ctx.get_input(op, "X").permute(*op.attr("axis")))


@register("unsqueeze")
def _unsqueeze(ctx, op):
    out = ctx.get_input(op, "X")
    for a in sorted(op.attr("axes")):
        out = out.unsqueeze(a)
    ctx.set_output(op, "Out", out)


@register("one_hot")
def _one_hot(ctx, op):
    """float32 rows of ``depth``: 1 at each id (a trailing Ids dim of 1
    is dropped); an id outside [0, depth) reads a row of zeros, as
    ``jax.nn.one_hot`` gives it."""
    x = ctx.get_input(op, "X")
    if x.dim() >= 2 and x.shape[-1] == 1:
        x = x[..., 0]
    depth = int(op.attr("depth"))
    cols = torch.arange(depth, dtype=x.dtype, device=x.device)
    ctx.set_output(op, "Out", (x[..., None] == cols).to(torch.float32))


@register("gather")
def _gather(ctx, op):
    """Rows of X at Index (any shape): out [*Index.shape, *X.shape[1:]]."""
    x = ctx.get_input(op, "X")
    idx = ctx.get_input(op, "Index")
    ctx.set_output(op, "Out", x[idx.long()])


# held while a block runs with torch's deterministic flag set
_DETERMINISTIC_LOCK = threading.Lock()


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms for the block, then the flag as
    it was. The flag is process-wide: it is set and restored under a
    module lock, so two threads cannot restore each other's saved value;
    an op another thread runs in that window runs deterministically
    too."""
    with _DETERMINISTIC_LOCK:
        was = (torch.are_deterministic_algorithms_enabled(),
               torch.is_deterministic_algorithms_warn_only_enabled())
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def row_index(ids, rows):
    """(index, in_range) for int64 ``ids`` into a table of ``rows`` rows,
    the reference's rule for a gather in fill mode and a scatter in drop
    mode: an id in [-rows, -1] counts from the end, any other id outside
    [0, rows) is out of range. ``index`` is 0 where out of range, so a
    gather or scatter through it stays in bounds: no host check, no
    device assert."""
    idx = torch.where(ids < 0, ids + rows, ids)
    ok = (idx >= 0) & (idx < rows)
    return torch.where(ok, idx, 0), ok


def _rows_mask(ok, like):
    return ok.reshape(ok.shape + (1,) * (like.dim() - ok.dim()))


class _Embedding(torch.autograd.Function):
    """Rows of ``w`` at int64 ``ids``, an out-of-range id reading a row
    of NaN (the reference's ``jnp.take``), with a weight gradient that
    is the same at every run. PyTorch's default CUDA embedding backward
    sums the rows of a repeated id in an order that changes from run to
    run (BERT's position and sentence embeddings, whose ids repeat in
    every batch row); under ``deterministic()`` it takes a fixed order,
    at up to 0.2 ms more a call at config 3 (PERF.md §6). An
    out-of-range position passes no gradient back."""

    @staticmethod
    def forward(ctx, w, ids):
        idx, ok = row_index(ids, w.shape[0])
        ctx.save_for_backward(idx, ok)
        ctx.rows = w.shape[0]
        out = F.embedding(idx, w)
        return torch.where(_rows_mask(ok, out), out, float("nan"))

    @staticmethod
    def backward(ctx, grad):
        idx, ok = ctx.saved_tensors
        grad = torch.where(_rows_mask(ok, grad), grad, 0.0)
        with deterministic():
            dw = torch.ops.aten.embedding_dense_backward(
                grad.contiguous(), idx, ctx.rows, -1, False)
        return dw, None


def static_unique(flat):
    """(uniq, inv, valid) of a 1-D int64 tensor of n ids, at the static
    size n (``jnp.unique(size=n, fill_value=0, return_inverse=True)``):
    the distinct ids ascending, padded with 0; each position's lane in
    ``uniq``; whether a lane holds a distinct id. A stable sort, head
    flags and a cumsum: no host sync, so the step stays capturable."""
    n = flat.shape[0]
    s, perm = torch.sort(flat, stable=True)
    head = torch.ones(n, dtype=torch.bool, device=flat.device)
    if n > 1:
        head[1:] = s[1:] != s[:-1]
    lane = torch.cumsum(head, 0) - 1
    inv = torch.empty_like(lane).scatter_(0, perm, lane)
    # every write to a lane carries the same id
    uniq = torch.zeros_like(s).scatter_(0, lane, s)
    valid = torch.arange(n, device=flat.device) < lane[-1:] + 1
    return uniq, inv, valid


def sum_rows(vals, inv):
    """Per-lane sums of ``vals`` [n, ...]: out[u] = sum of vals[i] with
    inv[i] == u, [n, ...], summed in one fixed order at every run
    (PyTorch's embedding backward, sorted, under ``deterministic()``)."""
    n = vals.shape[0]
    flat = vals.reshape(n, -1).contiguous()
    with deterministic():
        out = torch.ops.aten.embedding_dense_backward(flat, inv, n, -1,
                                                      False)
    return out.reshape(vals.shape)


def sparse_leaf(ctx, op, out):
    """A sparse lookup's output, before its padding mask: made an
    autograd leaf when the block's ``autodiff`` op reads its cotangent
    as a SelectedRows gradient (``sparse_wrt``), so the padded positions
    get a zero cotangent and no [vocab, dim] gradient is ever built."""
    name = op.output("Out")[0]
    if name in ctx.sparse_outs and torch.is_grad_enabled():
        out = out.detach().requires_grad_(True)
        ctx.sparse_leaves[name] = out
    return out


def squeeze_ids(ids):
    """int64 ids with a trailing dim of 1 squeezed."""
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    return ids.long()


def pad_mask(op, ids, out):
    """Rows at ``padding_idx`` read (and pass back) zeros."""
    padding_idx = op.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((ids == padding_idx).unsqueeze(-1), 0.0)
    return out


@register("lookup_table_v2")
@register("lookup_table")
def _lookup_table(ctx, op):
    """Embedding lookup: a trailing Ids dim of 1 is squeezed, an
    out-of-range id reads NaN, and rows at ``padding_idx`` read (and
    pass back) zeros. Dense, the weight's gradient is run-to-run
    reproducible (``_Embedding``); with ``is_sparse`` the output is the
    SelectedRows gradient's leaf (``sparse_leaf``)."""
    w = ctx.get_input(op, "W")
    ids = squeeze_ids(ctx.get_input(op, "Ids"))
    if op.attr("is_distributed", False):
        raise NotImplementedError(
            "distributed lookup_table (the parameter-server tier) is not "
            "ported yet (ROADMAP queue 8)")
    out = _Embedding.apply(w, ids)
    if op.attr("is_sparse", False):
        out = sparse_leaf(ctx, op, out)
    ctx.set_output(op, "Out", pad_mask(op, ids, out))


@register("concat")
def _concat(ctx, op):
    ctx.set_output(op, "Out", torch.cat(ctx.get_inputs(op, "X"),
                                        dim=op.attr("axis", 0)))


@register("merge_selected_rows")
def _merge_selected_rows(ctx, op):
    """Sum the duplicate rows of a SelectedRows pair at its static size:
    the rows stay as they are, the first occurrence of each id carries
    its rows' sum and later duplicates zeros."""
    xname = op.input("X")[0]
    rows, vals = ctx.get(xname + "@ROWS"), ctx.get(xname)
    n = rows.shape[0]
    _, inv, _ = static_unique(rows.long())
    pos = torch.arange(n, device=rows.device)
    first = torch.full_like(pos, n).scatter_reduce_(0, inv, pos, "amin")
    is_first = _rows_mask(first[inv] == pos, vals)
    merged = torch.where(is_first, sum_rows(vals, inv)[inv], 0.0)
    out = op.output("Out")[0]
    ctx.set(out, merged.to(vals.dtype))
    ctx.set(out + "@ROWS", rows)


@register("get_tensor_from_selected_rows")
def _get_tensor_from_selected_rows(ctx, op):
    """A SelectedRows var as its dense [height, ...] tensor; rows out of
    range are dropped."""
    xname = op.input("X")[0]
    rows, vals = ctx.get(xname + "@ROWS"), ctx.get(xname)
    height = op.attr("height", None)
    if height is None:
        raise ValueError("get_tensor_from_selected_rows needs a 'height' "
                         "attr")
    idx, ok = row_index(rows.long(), int(height))
    dense = torch.zeros((int(height),) + tuple(vals.shape[1:]),
                        dtype=vals.dtype, device=vals.device)
    with deterministic():      # duplicate rows sum in one fixed order
        dense.index_add_(0, idx, torch.where(_rows_mask(ok, vals), vals,
                                             0.0))
    ctx.set_output(op, "Out", dense)


@register("cast")
def _cast(ctx, op):
    dtype = to_torch_dtype(op.attr("out_dtype", op.attr("dtype", "float32")))
    ctx.set_output(op, "Out", ctx.get_input(op, "X").to(dtype))


@register("assign")
def _assign(ctx, op):
    """Out binds X's tensor: no op writes a tensor in place except
    ``adam``, which writes only its own Param and moments."""
    ctx.set_output(op, "Out", ctx.get_input(op, "X"))


@register("where")
def _where(ctx, op):
    ctx.set_output(op, "Out", torch.where(ctx.get_input(op, "Condition"),
                                          ctx.get_input(op, "X"),
                                          ctx.get_input(op, "Y")))


@register("zeros_like")
def _zeros_like(ctx, op):
    ctx.set_output(op, "Out", torch.zeros_like(ctx.get_input(op, "X")))


@register("squeeze")
def _squeeze(ctx, op):
    """Drop the size-1 dims of ``axes`` (a listed dim of another size
    stays); no axes drops every size-1 dim."""
    x = ctx.get_input(op, "X")
    axes = op.attr("axes") or None
    if axes is None:
        out = x.squeeze()
    else:
        dims = sorted({a % x.dim() for a in axes if x.shape[a] == 1},
                      reverse=True)
        out = x
        for d in dims:
            out = out.squeeze(d)
    ctx.set_output(op, "Out", out)


@register("slice")
def _slice(ctx, op):
    """``Input[starts:ends]`` on each of ``axes``, numpy's rules for
    negative and out-of-range bounds."""
    x = ctx.get_input(op, "Input")
    idx = [slice(None)] * x.dim()
    for ax, st, en in zip(op.attr("axes"), op.attr("starts"),
                          op.attr("ends")):
        idx[ax] = slice(st, en)
    ctx.set_output(op, "Out", x[tuple(idx)])


@register("split")
def _split(ctx, op):
    """``num`` equal parts, or parts of the sizes in ``sections``, along
    ``axis``; one output each."""
    x = ctx.get_input(op, "X")
    axis = op.attr("axis", 0)
    sections = op.attr("sections")
    if sections:
        outs = torch.split(x, list(sections), dim=axis)
    else:
        outs = torch.chunk(x, op.attr("num", 0), dim=axis)
    for name, o in zip(op.output("Out"), outs):
        ctx.set(name, o)


@register("stack")
def _stack(ctx, op):
    ctx.set_output(op, "Y", torch.stack(ctx.get_inputs(op, "X"),
                                        dim=op.attr("axis", 0)))


@register("expand")
def _expand(ctx, op):
    """Tile X ``expand_times`` along each dim (``jnp.tile``)."""
    ctx.set_output(op, "Out", ctx.get_input(op, "X").repeat(
        *[int(t) for t in op.attr("expand_times")]))


@register("increment")
def _increment(ctx, op):
    """X + step in X's type. Where Out is X and X is persistable (the
    step counter of the learning-rate schedules, ``@LR_STEP@``) the
    scope's tensor is added to in place, so a captured step's replays
    advance the counter that the next replay reads; any other X is left
    as it is, so a loop's counter keeps its value from before a trip
    (``while_loop``'s bounded form selects between the two)."""
    x = ctx.get_input(op, "X")
    step = op.attr("step", 1.0)
    if not x.is_floating_point():
        step = int(step)
    var = ctx.var(op.input("X")[0])
    if op.output("Out") == op.input("X") and var is not None and \
            var.persistable:
        ctx.set_output(op, "Out", x.add_(step))
    else:
        ctx.set_output(op, "Out", x + step)
