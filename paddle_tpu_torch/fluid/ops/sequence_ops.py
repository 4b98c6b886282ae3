"""Sequence (LoD) ops (counterpart of
``paddle_tpu/fluid/ops/sequence_ops.py``).

Inputs are bounded-LoD pairs: flat ``[rows, ...]`` data and its int32
lengths under ``name@LOD`` (``fluid/lod.py``). Every op is static-shape
segment arithmetic on the device, as the reference's:

    cum  = cumsum(lengths)                # [n]
    seg  = searchsorted(cum, arange(T))   # token -> sequence, pads get n
    pos  = arange(T) - starts[seg]        # position within the sequence

Rows past ``sum(lengths)`` are padding, masked by ``torch.where``. No op
reads a length on the host, so a step of them captures into a CUDA
graph and lengths change between replays.

Where the reference reduces per sequence with ``segment_sum`` /
``segment_max`` over the flat rows, the port gathers the rows into a
``[n, bound, ...]`` layout (``_pack``), reduces over its time axis and,
where the result is per token again, gathers it back (``_unpack``).
Each gather reads every valid row once, so its backward adds no two
nonzero rows into one place: the gradients are the same bits run to
run, on the card's atomics as on the CPU (``_rows``). ``bound`` is the
value's time bound (``@LOD_BOUND``, at least its longest sequence; the
flat row count where none is known). Only ``sequence_scatter``, whose
updates may hit one cell twice, runs its sum under
``tensor_ops.deterministic()``.

The reference reaches no Pallas kernel here: these lower to torch's own
calls.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..lod import bound_name, lod_name
from ..registry import register, to_torch_dtype
from .tensor_ops import deterministic

_I64 = torch.int64


def _lod(ctx, name):
    key = lod_name(name)
    if key not in ctx.env:
        raise KeyError(
            "%r has no @LOD lengths binding; feed it as "
            "fluid.create_lod_tensor or produce it with a sequence op"
            % name)
    return ctx.env[key]


def _bound(ctx, name, rows):
    """The time bound of LoD value ``name`` over ``rows`` rows: its
    ``@LOD_BOUND`` where known, else the rows."""
    return int(min(ctx.env.get(bound_name(name), rows), rows))


def _seg_info(lengths, total):
    """(seg, starts, cum, valid) of ``total`` flat rows, int64."""
    lengths = lengths.to(_I64)
    cum = torch.cumsum(lengths, 0)
    tok = torch.arange(total, dtype=_I64, device=lengths.device)
    seg = torch.searchsorted(cum, tok, right=True)
    starts = cum - lengths
    valid = tok < cum[-1]
    return seg, starts, cum, valid


def _set_lod(ctx, op, slot, lengths, bound=None):
    names = op.output(slot)
    if names:
        ctx.env[lod_name(names[0])] = lengths
        if bound is not None:
            ctx.env[bound_name(names[0])] = int(bound)


def _bcast(mask, x):
    """``mask`` [T] or [n, B] broadcast over ``x``'s feature dims."""
    return mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - mask.dim()))


def _rows(x, index):
    """``x[index]`` for an integer ``index`` of any shape, by
    ``index_select``, whose backward adds each gradient row into its
    source with ``index_add_``: on the card one atomic add a row where
    advanced indexing sorts the indices first. Every caller masks the
    rows it reads twice (the clamped padding), so a source takes one
    nonzero gradient and zeros, and the sum is the same bits in any
    order."""
    out = x.index_select(0, index.reshape(-1))
    return out.reshape(tuple(index.shape) + tuple(x.shape[1:]))


def _pack(x, lengths, starts, bound, reverse=False, time_major=False):
    """Flat ``x`` [T, ...] -> ``[n, bound, ...]`` (row i, position p:
    token ``starts[i] + p``; ``reverse``: ``starts[i] + len[i] - 1 - p``;
    ``time_major``: ``[bound, n, ...]``) and its mask; zeros past each
    length."""
    lengths = lengths.to(_I64)
    pos = torch.arange(bound, dtype=_I64, device=x.device)
    if time_major:
        pos, lengths, starts = pos[:, None], lengths[None, :], starts[None, :]
    else:
        pos, lengths, starts = pos[None, :], lengths[:, None], starts[:, None]
    inb = pos < lengths
    src = starts + ((lengths - 1 - pos) if reverse else pos)
    src = src.clamp(0, max(x.shape[0] - 1, 0))
    g = _rows(x, src)
    return torch.where(_bcast(inb, g), g, torch.zeros((), dtype=x.dtype,
                                                     device=x.device)), inb


def _unpack(h, lengths, total, reverse=False, time_major=False):
    """``[n, bound, ...]`` (``time_major``: ``[bound, n, ...]``) -> flat
    ``[total, ...]``, tokens front-packed, zeros past ``sum(lengths)``."""
    n = lengths.shape[0]
    seg, starts, _, valid = _seg_info(lengths, total)
    segc = seg.clamp(0, n - 1)
    pos = torch.arange(total, dtype=_I64, device=h.device) - starts[segc]
    if reverse:
        pos = lengths.to(_I64)[segc] - 1 - pos
    bound = h.shape[0] if time_major else h.shape[1]
    pos = pos.clamp(0, bound - 1)
    flat = h.reshape((-1,) + tuple(h.shape[2:]))
    out = _rows(flat, pos * n + segc if time_major else segc * bound + pos)
    return torch.where(_bcast(valid, out), out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


@register("sequence_pool")
def _sequence_pool(ctx, op):
    """SUM, AVERAGE, SQRT and MAX reduce the packed ``[n, bound, ...]``
    layout over time; FIRST and LAST gather one row; an empty sequence
    reads ``pad_value``. MaxIndex is the first token reaching the max
    (int32 max for an empty sequence, the reference's segment_min
    identity)."""
    x = ctx.get_input(op, "X")
    name = op.input("X")[0]
    lengths = _lod(ctx, name)
    T = x.shape[0]
    _, starts, cum, _ = _seg_info(lengths, T)
    ptype = str(op.attr("pooltype", "AVERAGE")).upper()
    pad_value = float(op.attr("pad_value", 0.0))
    empty = (lengths == 0).reshape((-1,) + (1,) * (x.dim() - 1))
    if ptype in ("SUM", "AVERAGE", "SQRT", "MAX"):
        xg, inb = _pack(x, lengths, starts, _bound(ctx, name, T))
        if ptype == "MAX":
            low = (-float("inf") if x.is_floating_point()
                   else torch.iinfo(x.dtype).min)
            xm = torch.where(_bcast(inb, xg), xg, torch.full(
                (), low, dtype=x.dtype, device=x.device))
            out = xm.amax(1)
            if op.output("MaxIndex"):
                with torch.no_grad():
                    B = xg.shape[1]
                    hit = (xm == out[:, None]) & _bcast(inb, xg)
                    p = torch.arange(B, dtype=_I64, device=x.device)
                    first = torch.where(hit, _bcast(p[None, :], xg),
                                        B).amin(1)
                    idx = starts.reshape((-1,) + (1,) * (first.dim() - 1)) \
                        + first
                    idx = torch.where(empty, torch.iinfo(torch.int32).max,
                                      idx)
                ctx.set_output(op, "MaxIndex", idx.to(torch.int32))
            out = torch.where(empty, _zero(out), out)
        else:
            out = xg.sum(1)
            denom = lengths.clamp_min(1).to(x.dtype)
            denom = denom.reshape((-1,) + (1,) * (out.dim() - 1))
            if ptype == "AVERAGE":
                out = out / denom
            elif ptype == "SQRT":
                out = out / torch.sqrt(denom)
    elif ptype == "FIRST":
        out = x[starts.clamp(0, T - 1)]
    elif ptype == "LAST":
        out = x[(cum - 1).clamp(0, T - 1)]
    else:
        raise NotImplementedError("sequence_pool type %r" % ptype)
    out = torch.where(empty, torch.full((), pad_value, dtype=x.dtype,
                                        device=x.device), out)
    ctx.set_output(op, "Out", out.to(x.dtype))


@register("sequence_softmax")
def _sequence_softmax(ctx, op):
    """A softmax over each sequence's tokens, per column."""
    x = ctx.get_input(op, "X")
    name = op.input("X")[0]
    lengths = _lod(ctx, name)
    T = x.shape[0]
    x1 = x.reshape(T, -1)
    _, starts, _, _ = _seg_info(lengths, T)
    bound = _bound(ctx, name, T)
    xg, inb = _pack(x1, lengths, starts, bound)
    mask = inb[..., None]
    xm = torch.where(mask, xg, torch.full((), -1e30, dtype=x1.dtype,
                                          device=x.device))
    m = xm.amax(1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, _zero(m))
    e = torch.where(mask, torch.exp(torch.where(mask, xg, m) - m), _zero(xg))
    s = e.sum(1, keepdim=True).clamp_min(1e-30)
    out = _unpack(e / s, lengths, T).reshape(x.shape)
    ctx.set_output(op, "Out", out.to(x.dtype))
    _set_lod(ctx, op, "Out", lengths, bound)


@register("sequence_reverse")
def _sequence_reverse(ctx, op):
    x = ctx.get_input(op, "X")
    name = op.input("X")[0]
    lengths = _lod(ctx, name)
    T = x.shape[0]
    n = lengths.shape[0]
    seg, starts, cum, valid = _seg_info(lengths, T)
    segc = seg.clamp(0, n - 1)
    tok = torch.arange(T, dtype=_I64, device=x.device)
    idx = (starts[segc] + cum[segc] - 1 - tok).clamp(0, T - 1)
    out = torch.where(_bcast(valid, x), x[idx], _zero(x))
    ctx.set_output(op, "Out", out)
    _set_lod(ctx, op, "Out", lengths, ctx.env.get(bound_name(name)))


def _rows_to_tokens(x, ylen, T, bound):
    """Row i of dense ``x`` [n, ...] on every token of sequence i of a
    ``T``-row value with lengths ``ylen``: through the ``[n, bound, ...]``
    expansion, so the backward sums each row's tokens over the time
    axis."""
    xe = x.unsqueeze(1).expand((x.shape[0], bound) + tuple(x.shape[1:]))
    return _unpack(xe, ylen, T)


@register("sequence_expand")
def _sequence_expand(ctx, op):
    """``x``'s rows (dense: one per sequence of Y) or its sequences
    (ragged) laid out on Y's tokens."""
    x = ctx.get_input(op, "X")
    y_name = op.input("Y")[0]
    ylen = _lod(ctx, y_name)
    y = ctx.get(y_name)
    T = y.shape[0]
    n = ylen.shape[0]
    seg, starts, _, valid = _seg_info(ylen, T)
    ybound = ctx.env.get(bound_name(y_name))
    xlod_key = lod_name(op.input("X")[0])
    if xlod_key in ctx.env:
        xlen = ctx.env[xlod_key]
        _, xstarts, _, _ = _seg_info(xlen, x.shape[0])
        segc = seg.clamp(0, n - 1)
        pos = torch.arange(T, dtype=_I64, device=x.device) - starts[segc]
        src = x[(xstarts[segc] + pos).clamp(0, x.shape[0] - 1)]
        out = torch.where(_bcast(valid, src), src, _zero(x))
    else:
        out = _rows_to_tokens(x, ylen, T, _bound(ctx, y_name, T))
    ctx.set_output(op, "Out", out.to(x.dtype))
    _set_lod(ctx, op, "Out", ylen, ybound)


@register("sequence_expand_as")
def _sequence_expand_as(ctx, op):
    x = ctx.get_input(op, "X")
    y_name = op.input("Y")[0]
    ylen = _lod(ctx, y_name)
    T = ctx.get(y_name).shape[0]
    out = _rows_to_tokens(x, ylen, T, _bound(ctx, y_name, T))
    ctx.set_output(op, "Out", out.to(x.dtype))
    _set_lod(ctx, op, "Out", ylen, ctx.env.get(bound_name(y_name)))


@register("sequence_pad")
def _sequence_pad(ctx, op):
    """[n, maxlen, ...] with ``pad_value`` past each length; ``maxlen``
    the attr, or the reference's worst case, the row count. The gather
    runs over the time bound; the rest of the row count is
    ``pad_value``."""
    x = ctx.get_input(op, "X")
    pad_value = ctx.get_input(op, "PadValue")
    name = op.input("X")[0]
    lengths = _lod(ctx, name)
    n = lengths.shape[0]
    T = x.shape[0]
    maxlen = int(op.attr("padded_length", -1))
    if maxlen <= 0:
        maxlen = T
    _, starts, _, _ = _seg_info(lengths, T)
    feat = tuple(x.shape[1:])
    width = min(maxlen, _bound(ctx, name, T))
    pad = pad_value.to(x.dtype).reshape((1, 1) + (1,) * len(feat))
    g, inb = _pack(x, lengths.clamp_max(maxlen), starts, width)
    out = torch.where(_bcast(inb, g), g, pad)
    if width < maxlen:
        out = torch.cat([out, pad.expand((n, maxlen - width) + feat)], 1)
    ctx.set_output(op, "Out", out)
    if op.output("Length"):
        ctx.set_output(op, "Length", lengths.clamp_max(maxlen).to(_I64))


@register("sequence_unpad")
def _sequence_unpad(ctx, op):
    x = ctx.get_input(op, "X")  # [n, maxlen, ...]
    length = ctx.get_input(op, "Length").reshape(-1).to(torch.int32)
    n, maxlen = x.shape[0], x.shape[1]
    out = _unpack(x, length, n * maxlen)
    ctx.set_output(op, "Out", out)
    _set_lod(ctx, op, "Out", length, maxlen)


@register("sequence_reshape")
def _sequence_reshape(ctx, op):
    x = ctx.get_input(op, "X")
    name = op.input("X")[0]
    lengths = _lod(ctx, name)
    new_dim = int(op.attr("new_dim"))
    d = int(np.prod(x.shape[1:]))
    out = x.reshape(-1, new_dim)
    bound = ctx.env.get(bound_name(name))
    ctx.set_output(op, "Out", out)
    _set_lod(ctx, op, "Out", ((lengths * d) // new_dim).to(torch.int32),
             None if bound is None else
             min(-(-bound * d // new_dim), out.shape[0]))


@register("sequence_concat")
def _sequence_concat(ctx, op):
    """Interleave: out sequence i = concat_k(input_k sequence i)."""
    names = op.input("X")
    xs = [ctx.get(nm) for nm in names]
    lens = [_lod(ctx, nm).to(torch.int32) for nm in names]
    n = lens[0].shape[0]
    out_len = lens[0]
    for ln in lens[1:]:
        out_len = out_len + ln
    outT = int(sum(x.shape[0] for x in xs))
    feat = tuple(xs[0].shape[1:])
    _, ostarts, _, _ = _seg_info(out_len, outT)
    # one dump row past the end takes the padding rows, then goes
    out = torch.zeros((outT + 1,) + feat, dtype=xs[0].dtype,
                      device=xs[0].device)
    run = torch.zeros(n, dtype=_I64, device=xs[0].device)
    for x, ln in zip(xs, lens):
        seg, starts, _, valid = _seg_info(ln, x.shape[0])
        segc = seg.clamp(0, n - 1)
        pos = torch.arange(x.shape[0], dtype=_I64, device=x.device) - \
            starts[segc]
        dst = torch.where(valid, ostarts[segc] + run[segc] + pos, outT)
        out = out.index_put((dst,), torch.where(_bcast(valid, x), x,
                                                _zero(x)))
        run = run + ln.to(_I64)
    bounds = [ctx.env.get(bound_name(nm)) for nm in names]
    ctx.set_output(op, "Out", out[:outT])
    _set_lod(ctx, op, "Out", out_len,
             None if None in bounds else min(sum(bounds), outT))


@register("sequence_slice")
def _sequence_slice(ctx, op):
    """Each sequence's [offset, offset + length) tokens, front-packed;
    the output keeps the row count, and its lengths are Length (no time
    bound: they are read on the device)."""
    x = ctx.get_input(op, "X")
    offset = ctx.get_input(op, "Offset").reshape(-1).to(_I64)
    length = ctx.get_input(op, "Length").reshape(-1).to(torch.int32)
    lengths = _lod(ctx, op.input("X")[0])
    n = lengths.shape[0]
    T = x.shape[0]
    _, starts_i, _, _ = _seg_info(lengths, T)
    oseg, ostarts, _, ovalid = _seg_info(length, T)
    osegc = oseg.clamp(0, n - 1)
    pos = torch.arange(T, dtype=_I64, device=x.device) - ostarts[osegc]
    src = (starts_i[osegc] + offset[osegc] + pos).clamp(0, T - 1)
    out = torch.where(_bcast(ovalid, x), x[src], _zero(x))
    ctx.set_output(op, "Out", out)
    _set_lod(ctx, op, "Out", length)


@register("sequence_enumerate")
def _sequence_enumerate(ctx, op):
    """[T, win]: each token's next ``win`` ids inside its sequence,
    ``pad_value`` past its end."""
    x = ctx.get_input(op, "X")
    name = op.input("X")[0]
    lengths = _lod(ctx, name)
    win = int(op.attr("win_size"))
    pad = op.attr("pad_value", 0)
    flat = x.reshape(-1)
    T = flat.shape[0]
    n = lengths.shape[0]
    seg, _, cum, valid = _seg_info(lengths, T)
    tok = torch.arange(T, dtype=_I64, device=x.device)
    end = cum[seg.clamp(0, n - 1)]
    cols = []
    for j in range(win):
        idx = (tok + j).clamp(0, T - 1)
        same = ((tok + j) < end) & valid
        cols.append(torch.where(same, flat[idx], torch.full(
            (), pad, dtype=flat.dtype, device=flat.device)))
    ctx.set_output(op, "Out", torch.stack(cols, 1))
    _set_lod(ctx, op, "Out", lengths, ctx.env.get(bound_name(name)))


@register("sequence_scatter")
def _sequence_scatter(ctx, op):
    """Dense X [n, cols] plus, for each token of sequence i, its update
    at column Ids; two updates of one cell add, under torch's
    deterministic algorithms."""
    x = ctx.get_input(op, "X")
    ids = ctx.get_input(op, "Ids").reshape(-1)
    upd = ctx.get_input(op, "Updates").reshape(-1)
    lengths = _lod(ctx, op.input("Ids")[0])
    n = lengths.shape[0]
    seg, _, _, valid = _seg_info(lengths, ids.shape[0])
    row = torch.where(valid, seg.clamp(0, n - 1), x.shape[0])
    col = ids.to(_I64).clamp(0, x.shape[1] - 1)
    dump = torch.zeros((1,) + tuple(x.shape[1:]), dtype=x.dtype,
                       device=x.device)
    with deterministic():
        out = torch.cat([x, dump]).index_put(
            (row, col), torch.where(valid, upd.to(x.dtype), _zero(x)),
            accumulate=True)
    ctx.set_output(op, "Out", out[:x.shape[0]])


@register("sequence_conv")
def _sequence_conv(ctx, op):
    """Context-window projection over tokens, windows clipped at
    sequence boundaries: ``contextLength`` masked row gathers side by
    side, times the filter."""
    x = ctx.get_input(op, "X")
    w = ctx.get_input(op, "Filter")
    name = op.input("X")[0]
    lengths = _lod(ctx, name)
    n = lengths.shape[0]
    start = int(op.attr("contextStart", op.attr("context_start", 0)))
    clen = int(op.attr("contextLength", op.attr("context_length", 3)))
    T, D = x.shape[0], int(np.prod(x.shape[1:]))
    x2 = x.reshape(T, D)
    seg, starts, cum, valid = _seg_info(lengths, T)
    segc = seg.clamp(0, n - 1)
    s0, s1 = starts[segc], cum[segc]
    tok = torch.arange(T, dtype=_I64, device=x.device)
    cols = []
    for j in range(clen):
        idx = tok + start + j
        inb = (idx >= s0) & (idx < s1) & valid
        cols.append(torch.where(inb[:, None],
                                _rows(x2, idx.clamp(0, T - 1)), _zero(x2)))
    out = torch.cat(cols, 1) @ w.reshape(clen * D, -1)
    out = torch.where(valid[:, None], out, _zero(out))
    ctx.set_output(op, "Out", out.to(x.dtype))
    _set_lod(ctx, op, "Out", lengths, ctx.env.get(bound_name(name)))


@register("sequence_erase")
def _sequence_erase(ctx, op):
    """Tokens equal to any of ``tokens`` removed: the survivors
    front-packed per sequence in the same rows, the lengths shrunk."""
    x = ctx.get_input(op, "X")
    name = op.input("X")[0]
    lengths = _lod(ctx, name)
    tokens = list(op.attr("tokens", []))
    flat = x.reshape(-1)
    T = flat.shape[0]
    n = lengths.shape[0]
    seg, starts, _, valid = _seg_info(lengths, T)
    keep = valid
    for t in tokens:
        keep = keep & (flat != t)
    segc = seg.clamp(0, n - 1)
    kept, _ = _pack(keep.to(_I64), lengths, starts, _bound(ctx, name, T))
    new_len = kept.sum(1)
    nstarts = torch.cumsum(new_len, 0) - new_len
    cums = torch.cumsum(keep.to(_I64), 0)
    first = starts[segc]
    prior = torch.where(first > 0, cums[(first - 1).clamp(0, T - 1)], 0)
    rank = cums - 1 - prior
    dst = torch.where(keep, nstarts[segc] + rank, T)
    out = torch.zeros(T + 1, dtype=flat.dtype, device=flat.device)
    out = out.index_put((dst,), torch.where(keep, flat, _zero(flat)))[:T]
    ctx.set_output(op, "Out", out.reshape((-1,) + tuple(x.shape[1:])))
    _set_lod(ctx, op, "Out", new_len.to(torch.int32),
             ctx.env.get(bound_name(name)))


@register("im2sequence")
def _im2sequence(ctx, op):
    """Image [N, C, H, W] -> one token a kernel patch (flattened as C,
    kh, kw), one sequence of Ho*Wo tokens an image."""
    x = ctx.get_input(op, "X")
    ksizes = [int(k) for k in op.attr("kernels")]
    strides = [int(s) for s in op.attr("strides", [1, 1])]
    pads = [int(p) for p in op.attr("paddings", [0, 0, 0, 0])]
    xp = F.pad(x, (pads[1], pads[3], pads[0], pads[2]))
    oh = (xp.shape[2] - ksizes[0]) // strides[0] + 1
    ow = (xp.shape[3] - ksizes[1]) // strides[1] + 1
    patches = F.unfold(xp, tuple(ksizes), stride=tuple(strides))
    n, ckk = patches.shape[0], patches.shape[1]
    out = patches.transpose(1, 2).reshape(n * oh * ow, ckk)
    ctx.set_output(op, "Out", out)
    _set_lod(ctx, op, "Out", torch.full((n,), oh * ow, dtype=torch.int32,
                                        device=x.device), oh * ow)


@register("row_conv")
def _row_conv(ctx, op):
    """Lookahead row convolution (DeepSpeech2): over token rows with the
    window clipped at each sequence's end; over the time axis of a
    [B, T, D] input without an @LOD binding."""
    x = ctx.get_input(op, "X")
    w = ctx.get_input(op, "Filter")  # [future_context + 1, D]
    k = w.shape[0]
    name = op.input("X")[0]
    if lod_name(name) not in ctx.env:
        t = x.shape[-2]
        out = torch.zeros_like(x)
        for j in range(k):
            shifted = F.pad(x, (0, 0, 0, j))[..., j:j + t, :]
            out = out + shifted * w[j]
        ctx.set_output(op, "Out", out)
        return
    lengths = _lod(ctx, name)
    n = lengths.shape[0]
    T = x.shape[0]
    seg, _, cum, valid = _seg_info(lengths, T)
    tok = torch.arange(T, dtype=_I64, device=x.device)
    s1 = cum[seg.clamp(0, n - 1)]
    out = torch.zeros_like(x)
    for j in range(k):
        idx = tok + j
        inb = (idx < s1) & valid
        out = out + torch.where(inb[:, None],
                                x[idx.clamp(0, T - 1)] * w[j][None, :],
                                _zero(x))
    ctx.set_output(op, "Out", out.to(x.dtype))
    _set_lod(ctx, op, "Out", lengths, ctx.env.get(bound_name(name)))


@register("sequence_mask")
def _sequence_mask(ctx, op):
    """[n, maxlen] of ``out_dtype``: 1 where the position is below the
    row's length X. ``maxlen`` is the attr, or the MaxLenTensor's value
    when the attr is not positive (read on the host: a program that is
    captured into a CUDA graph gives the attr)."""
    x = ctx.get_input(op, "X").reshape(-1)
    maxlen = op.attr("maxlen", -1)
    if maxlen is None or int(maxlen) <= 0:
        mv = ctx.get_input(op, "MaxLenTensor")
        if mv is None:
            raise ValueError("sequence_mask needs a maxlen attr or a "
                             "MaxLenTensor input")
        maxlen = int(mv.reshape(-1)[0])
    out = torch.arange(int(maxlen), dtype=x.dtype,
                       device=x.device)[None, :] < x[:, None]
    ctx.set_output(op, "Out", out.to(to_torch_dtype(
        op.attr("out_dtype", "int64"))))
