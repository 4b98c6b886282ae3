"""Recurrent and beam-search op lowerings (counterpart of
``paddle_tpu/fluid/ops/rnn_ops.py``): one LSTM step (``lstm_unit``), one
GRU step (``gru_unit``), and the dense beam search over
``[batch * beam]`` rows (``beam_pos``, ``beam_search``, ``gather_tree``,
``beam_search_decode``).

Gate layouts (the reference's):
  lstm_unit X[4H] = [i, f, c~, o]; ``forget_bias`` is added inside f's
      sigmoid; c = f c_prev + i tanh(c~); h = o tanh(c)
  gru_unit gates[3H] = [u, r, c~] = Input + Bias, then
      u, r = gate_act(gates[:2H] + h_prev W[:, :2H])
      c~ = act(gates[2H:] + (r h_prev) W[:, 2H:])
      h = (1 - u) h_prev + u c~  (``origin_mode``: u h_prev + (1 - u) c~)
  The activations come as names or as the reference's integer codes
  (0 identity, 1 sigmoid, 2 tanh, 3 relu).

Beam search selects, for each batch row, the ``beam`` best of its
``beam * V`` candidates in a fixed order: score descending, then flat
candidate index ascending, the order ``jax.lax.top_k`` gives equal
scores. Equal scores are common here: a finished beam offers -1e30 in
every column but ``end_id``, and at step 0 every beam but the first
carries -1e9. ``torch.topk`` leaves the order of equal values
unspecified, so the selection runs on int64 keys that hold the score's
order in the high 32 bits and the inverted index in the low 32: no two
keys are equal. Nothing here reads a value on the host, so a decode
loop of these ops can be captured into a CUDA graph.

``dynamic_lstm`` / ``dynamic_lstmp`` run over bounded-LoD rows
(``fluid/lod.py``), gate layout [c~, i, f, o] with peepholes
checkI/F/O from the 7H bias: c = c~ i + c_prev f, h = o act(c) (the
reference's ``lstm_kernel.h``). The gates are packed time-major to
``[bound, n, 4H]``, a reversed LSTM packing each sequence back to front,
so every sequence starts at step 0 and no step needs a mask: a step
past a sequence's end computes values that are never read, and
``_unpack`` front-packs the valid ones back to token rows. ``bound`` is
the input's time bound (``@LOD_BOUND``, from the host's lengths), where
the reference scans the flat row count; the values below each length
are the same. The time loop is a Python loop of torch ops, so a step
captures into one CUDA graph. ``dynamic_gru``, ``cudnn_lstm`` and
``lstm`` wait for the next part of ROADMAP queue 1 item 4.
"""

import torch
import torch.nn.functional as F

from ..lod import bound_name, lod_name
from ..registry import register
from .sequence_ops import _bound, _lod, _pack, _seg_info, _unpack

_ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": F.relu,
         "identity": (lambda x: x)}
_ACT_CODES = {0: "identity", 1: "sigmoid", 2: "tanh", 3: "relu"}


def _act(op, attr, default):
    """The activation named (or coded) by ``op``'s ``attr``."""
    v = op.attr(attr, default)
    if isinstance(v, int) and not isinstance(v, bool):
        v = _ACT_CODES.get(v, _ACT_CODES[default])
    return _ACTS[str(v or _ACT_CODES[default])]


@register("lstm_unit")
def _lstm_unit(ctx, op):
    g = ctx.get_input(op, "X")
    c_prev = ctx.get_input(op, "C_prev")
    H = c_prev.shape[-1]
    i = torch.sigmoid(g[:, :H])
    f = torch.sigmoid(g[:, H:2 * H] + float(op.attr("forget_bias", 0.0)))
    cand = torch.tanh(g[:, 2 * H:3 * H])
    o = torch.sigmoid(g[:, 3 * H:])
    c = f * c_prev + i * cand
    ctx.set_output(op, "C", c)
    ctx.set_output(op, "H", o * torch.tanh(c))


@register("gru_unit")
def _gru_unit(ctx, op):
    g = ctx.get_input(op, "Input")
    h_prev = ctx.get_input(op, "HiddenPrev")
    w = ctx.get_input(op, "Weight")
    b = ctx.get_input(op, "Bias")
    H = h_prev.shape[-1]
    act_gate = _act(op, "gate_activation", 1)
    act_cand = _act(op, "activation", 2)
    if b is not None:
        g = g + b.reshape(1, -1)
    ur = act_gate(g[:, :2 * H] + h_prev @ w[:, :2 * H])
    u, r = ur[:, :H], ur[:, H:]
    reset_h = r * h_prev
    cand = act_cand(g[:, 2 * H:] + reset_h @ w[:, 2 * H:])
    if op.attr("origin_mode", False):
        h = u * h_prev + (1 - u) * cand
    else:
        h = (1 - u) * h_prev + u * cand
    ctx.set_output(op, "Gate", torch.cat([u, r, cand], dim=1))
    ctx.set_output(op, "ResetHiddenPrev", reset_h)
    ctx.set_output(op, "Hidden", h)


@register("beam_pos")
def _beam_pos(ctx, op):
    """[B*beam, 1] int64: each row's position in its beam group."""
    ref = ctx.get_input(op, "X")
    pos = torch.arange(ref.shape[0], dtype=torch.int64, device=ref.device)
    ctx.set_output(op, "Out", (pos % int(op.attr("beam_size")))[:, None])


def ordered_topk(flat, k):
    """(values, positions) of the ``k`` largest of each row of the fp32
    ``flat``, largest first and, among equal values, the lower position
    first. Each element becomes one int64 key: its value's order as an
    int32 (a float's bits, the magnitude bits flipped where negative) in
    the high half, 2^32 - 1 - its position in the low half."""
    bits = flat.contiguous().view(torch.int32)
    order = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    pos = torch.arange(flat.shape[-1], dtype=torch.int64, device=flat.device)
    key = order * (1 << 32) + ((1 << 32) - 1 - pos)
    _, top = torch.topk(key, k, dim=-1)
    return flat.gather(-1, top), top


@register("beam_search")
def _beam_search(ctx, op):
    pre_ids = ctx.get_input(op, "pre_ids").reshape(-1)
    pre_scores = ctx.get_input(op, "pre_scores").reshape(-1)
    scores = ctx.get_input(op, "scores")
    b = int(op.attr("beam_size"))
    end_id = int(op.attr("end_id"))
    bw, V = scores.shape
    if op.attr("is_accumulated", True):
        acc = scores
    else:
        acc = pre_scores[:, None] + torch.log(scores.clamp_min(1e-30))
    acc = acc.float()
    # a finished beam (pre_id == end_id) offers one candidate: end_id at
    # its own score
    fin_row = torch.full_like(acc, -1e30)
    fin_row[:, end_id] = pre_scores.float()
    acc = torch.where((pre_ids == end_id)[:, None], fin_row, acc)
    top_scores, top = ordered_topk(acc.reshape(bw // b, b * V), b)
    base = torch.arange(0, bw, b, dtype=torch.int64,
                        device=acc.device)[:, None]
    ctx.set_output(op, "selected_ids", (top % V).reshape(-1, 1))
    ctx.set_output(op, "selected_scores", top_scores.reshape(-1, 1))
    ctx.set_output(op, "parent_idx",
                   (top // V + base).reshape(-1).to(torch.int32))


def _backtrack(ids, parents):
    """Full sequences from per-step ids and parent rows, both [T, ...]:
    a reverse walk over the static T carrying each final row's pointer,
    index ops only."""
    T = ids.shape[0]
    flat_ids = ids.reshape(T, -1)
    flat_par = parents.reshape(T, -1).long()
    ptr = torch.arange(flat_ids.shape[1], device=ids.device)
    steps = [None] * T
    for t in range(T - 1, -1, -1):
        steps[t] = flat_ids[t][ptr]
        ptr = flat_par[t][ptr]
    return torch.stack(steps).reshape(ids.shape)


@register("gather_tree")
def _gather_tree(ctx, op):
    ctx.set_output(op, "Out", _backtrack(ctx.get_input(op, "Ids"),
                                         ctx.get_input(op, "Parents")))


@register("beam_search_decode")
def _beam_search_decode(ctx, op):
    """The stacked [T, B*beam] ids backtracked through Parents when
    given, and the scores as they are."""
    ids = ctx.get_input(op, "Ids")
    parents = ctx.get_input(op, "Parents")
    if parents is not None:
        ids = _backtrack(ids, parents)
    ctx.set_output(op, "SentenceIds", ids)
    ctx.set_output(op, "SentenceScores", ctx.get_input(op, "Scores"))


def _lstm_steps(gp, w, h, c, checks, cell_clip, act_gate, act_cell,
                act_cand, proj=None, act_proj=None):
    """The LSTM over time-major gates ``gp`` [bound, n, 4H] (x W + bias)
    from (h, c): [bound, n, P] outputs (h, or act_proj(h @ proj)) and
    [bound, n, H] cells. ``unbind`` and ``stack`` keep the backward
    linear in the bound (one node each, not one full-size gradient a
    step)."""
    H = c.shape[1]
    if checks is not None:
        # [n, H] views: a step's peephole gradient is added, not reduced
        # over the batch; the one reduction runs after the loop
        checks = [k.expand_as(c) for k in checks]
    hs, cs = [], []
    for g_t in gp.unbind(0):
        g = torch.addmm(g_t, h, w)
        gi, gf, go = g[:, H:2 * H], g[:, 2 * H:3 * H], g[:, 3 * H:]
        if checks is not None:
            gi = torch.addcmul(gi, c, checks[0])
            gf = torch.addcmul(gf, c, checks[1])
        c = torch.addcmul(act_cand(g[:, :H]) * act_gate(gi), c,
                          act_gate(gf))
        if cell_clip > 0:
            c = c.clamp(-cell_clip, cell_clip)
        if checks is not None:
            go = torch.addcmul(go, c, checks[2])
        h = act_gate(go) * act_cell(c)
        if proj is not None:
            h = act_proj(h @ proj)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


@register("dynamic_lstm")
@register("dynamic_lstmp")
def _dynamic_lstm(ctx, op):
    """Input [T, 4H] (the projected gates), Weight [H or P, 4H], Bias [1,
    4H] or [1, 7H] with peepholes, ProjWeight [H, P] (lstmp), H0/C0 [n,
    P]/[n, H]; Hidden (Projection) and Cell [T, H or P] with the input's
    @LOD."""
    x = ctx.get_input(op, "Input")
    w = ctx.get_input(op, "Weight")
    b = ctx.get_input(op, "Bias")
    proj = ctx.get_input(op, "ProjWeight")
    name = op.input("Input")[0]
    lengths = _lod(ctx, name)
    n, total = lengths.shape[0], x.shape[0]
    H = w.shape[1] // 4
    P = proj.shape[1] if proj is not None else H
    reverse = bool(op.attr("is_reverse", False))
    cell_clip = float(op.attr("cell_clip", 0.0) or 0.0)
    gates, checks = x, None
    if b is not None:
        flat = b.reshape(-1)
        gates = gates + flat[:4 * H][None, :]
        if op.attr("use_peepholes", True) and flat.shape[0] >= 7 * H:
            checks = (flat[4 * H:5 * H], flat[5 * H:6 * H],
                      flat[6 * H:7 * H])
    bound = _bound(ctx, name, total)
    _, starts, _, _ = _seg_info(lengths, total)
    gp, _ = _pack(gates, lengths, starts, bound, reverse=reverse,
                  time_major=True)
    h0 = ctx.get_input(op, "H0")
    c0 = ctx.get_input(op, "C0")
    if h0 is None:
        h0 = torch.zeros((n, P), dtype=x.dtype, device=x.device)
    if c0 is None:
        c0 = torch.zeros((n, H), dtype=x.dtype, device=x.device)
    hs, cs = _lstm_steps(
        gp, w, h0, c0, checks, cell_clip,
        _act(op, "gate_activation", 1), _act(op, "cell_activation", 2),
        _act(op, "candidate_activation", 2), proj,
        _act(op, "proj_activation", 0) if proj is not None else None)
    out_slot = "Projection" if proj is not None else "Hidden"
    for slot, v in ((out_slot, hs), ("Cell", cs)):
        ctx.set_output(op, slot, _unpack(v, lengths, total, reverse=reverse,
                                         time_major=True))
        names = op.output(slot)
        if names:
            ctx.env[lod_name(names[0])] = lengths
            ctx.env[bound_name(names[0])] = bound
