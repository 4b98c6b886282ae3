"""Structured and sampled losses (counterpart of
``paddle_tpu/fluid/ops/structured_loss_ops.py``): the linear-chain CRF
(``linear_chain_crf``, Viterbi ``crf_decoding``), CTC (``warpctc``,
greedy ``ctc_align``), ``edit_distance``, and the sampled losses
``nce``, ``hierarchical_sigmoid`` and ``sampled_softmax_with_cross_entropy``
/ ``sample_logits``.

The reference runs the CRF's forward and Viterbi passes, CTC and edit
distance as ``lax.scan``s of XLA ops, and reaches no Pallas kernel; the
port unrolls the same recurrences as Python loops of torch ops over a
LoD value's time bound (``@LOD_BOUND``; ``sequence_ops._pack``
time-major), so a step captures into one CUDA graph and no value is
read on the host. The values below each length are the reference's,
which scans the flat row count.

Every backward here is the same bits run to run on the card, so a
graphed step equals an eager one:

- the CRF's gold-path score is built from one-hot products (the
  transitions a sequence takes, counted by a product of one-hot labels,
  times the transition matrix, summed), where the reference gathers
  ``T[prev, label]``, whose backward would add many rows into one
  transition cell with atomics;
- CTC is optax's log-space alpha recursion (``optax.ctc_loss``:
  logits in, a log-softmax inside, masked padding, log(0) taken as
  -1e5 so an impossible alignment gives a finite loss), differentiated
  by autograd (its logaddexp with JAX's derivative, ``_LogAddExp``),
  where ``F.ctc_loss``'s CUDA backward is not deterministic;
- the sampled losses gather weight rows and logits through
  ``tensor_ops._Embedding``, whose backward sums a repeated row in one
  fixed order.

``nce`` and the sampled softmax draw their negatives uniformly from the
op's generator (``LowerCtx.randint``), so recompute replays them.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..lod import bound_name
from ..registry import register
from .sequence_ops import _bound, _lod, _pack, _seg_info, _set_lod, _unpack
from .tensor_ops import _Embedding

_I64 = torch.int64
# optax.ctc_loss's log_epsilon: log(0) in the alpha recursion
_CTC_LOG_EPS = -1e5


def _packed(ctx, op, slot, x):
    """(lengths, [bound, n, ...] time-major, its [bound, n] mask) of the
    LoD input ``x`` in ``slot``."""
    name = op.input(slot)[0]
    lengths = _lod(ctx, name)
    total = x.shape[0]
    _, starts, _, _ = _seg_info(lengths, total)
    xp, inb = _pack(x, lengths, starts, _bound(ctx, name, total),
                    time_major=True)
    return lengths, xp, inb


def _one_hot(labels, k, dtype):
    """float one-hot rows of int ``labels`` (zeros where out of [0, k),
    as ``jax.nn.one_hot``)."""
    return (labels[..., None] == torch.arange(k, device=labels.device)).to(
        dtype)


@register("linear_chain_crf")
def _linear_chain_crf(ctx, op):
    """Emission [T, K] (LoD), Transition [K + 2, K] (rows 0 and 1 the
    start and end weights, then T[from, to]), Label [T, 1]:
    LogLikelihood [n, 1] = the gold path's score - log Z, in log space;
    Alpha the last step's log alpha [n, K]; EmissionExps and
    TransitionExps the exponentials of the inputs."""
    em = ctx.get_input(op, "Emission")
    trans = ctx.get_input(op, "Transition")
    label = ctx.get_input(op, "Label")
    lengths, ep, inb = _packed(ctx, op, "Emission", em)
    # the labels ride the emission's lengths and bound
    _, lp, _ = _packed(ctx, op, "Emission", label.reshape(-1, 1).to(_I64))
    K = em.shape[1]
    start_w, end_w, T = trans[0], trans[1], trans[2:]
    alpha = start_w + ep[0]
    for t in range(1, ep.shape[0]):
        nxt = torch.logsumexp(alpha[:, :, None] + T, dim=1) + ep[t]
        alpha = torch.where(inb[t][:, None], nxt, alpha)
    log_z = torch.logsumexp(alpha + end_w, dim=1)
    # the gold path: its first label unmasked (label 0 of an empty
    # sequence, as the reference reads it), then the masked steps
    oh = _one_hot(lp[..., 0], K, em.dtype)
    ohm = oh * inb[..., None].to(em.dtype)
    pos = torch.arange(ep.shape[0], device=em.device)[:, None]
    last = (pos == (lengths.to(_I64) - 1).clamp_min(0)).to(em.dtype)
    counts = torch.einsum("tnk,tnj->nkj", oh[:-1], ohm[1:])
    gold = ((oh[0] * (start_w + ep[0])).sum(1)
            + (ohm[1:] * ep[1:]).sum((0, 2))
            + (counts * T).sum((1, 2))
            + ((oh * last[..., None]).sum(0) * end_w).sum(1))
    ctx.set_output(op, "LogLikelihood", (gold - log_z)[:, None])
    ctx.set_output(op, "Alpha", alpha)
    ctx.set_output(op, "EmissionExps", torch.exp(em))
    ctx.set_output(op, "TransitionExps", torch.exp(trans))


@register("crf_decoding")
def _crf_decoding(ctx, op):
    """The Viterbi path of each sequence: ViterbiPath [T, 1] int64 with
    the emission's @LOD, zeros past the tokens. Among equal scores the
    lower tag wins, as ``jnp.argmax`` picks."""
    em = ctx.get_input(op, "Emission")
    trans = ctx.get_input(op, "Transition")
    lengths, ep, inb = _packed(ctx, op, "Emission", em)
    start_w, end_w, T = trans[0], trans[1], trans[2:]
    delta = start_w + ep[0]
    backs = []
    for t in range(1, ep.shape[0]):
        best, arg = torch.max(delta[:, :, None] + T, dim=1)
        keep = inb[t][:, None]
        delta = torch.where(keep, best + ep[t], delta)
        backs.append(torch.where(keep, arg, -1))
    lab = torch.argmax(delta + end_w, dim=1)
    path = [None] * ep.shape[0]
    for t in range(ep.shape[0] - 1, 0, -1):
        path[t] = lab
        prev = backs[t - 1].gather(1, lab[:, None])[:, 0]
        lab = torch.where(prev >= 0, prev, lab)
    path[0] = lab
    total = em.shape[0]
    out = _unpack(torch.stack(path)[..., None], lengths, total,
                  time_major=True)
    ctx.set_output(op, "ViterbiPath", out)
    _set_lod(ctx, op, "ViterbiPath", lengths, ep.shape[0])


class _LogAddExp(torch.autograd.Function):
    """log(exp(a) + exp(b)) with JAX's derivative, g * exp(a - out), where
    torch's is g / (1 + exp(b - a)). They part where both terms are near
    -1e5 (an impossible alignment's log(0)s), where the output's rounding
    moves JAX's weights by up to 1e-2: the port takes the reference's."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


def _ctc_loss(logits, logit_pad, labels, label_pad, blank):
    """``optax.ctc_loss`` in torch: logits [B, T, K], labels [B, N] int64,
    the paddings 1.0 where padded (labels right-padded); [B] losses."""
    B, Tn, K = logits.shape
    N = labels.shape[1]
    dt = logits.dtype
    logprobs = F.log_softmax(logits, dim=-1)
    labellens = N - label_pad.sum(1).to(_I64)
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(dt), (0, 1))
    lp_phi = logprobs[:, :, blank:blank + 1].transpose(0, 1)
    lp_emit = torch.einsum("btk,bnk->btn", logprobs,
                           _one_hot(labels, K, dt)).transpose(0, 1)
    phi = torch.full((B, N + 1), _CTC_LOG_EPS, dtype=dt,
                     device=logits.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], 1)
    emit = torch.full((B, N), _CTC_LOG_EPS, dtype=dt, device=logits.device)

    def add_phi(p, score):
        return torch.cat([p[:, :1], _LogAddExp.apply(p[:, 1:], score)], 1)

    pads = logit_pad.transpose(0, 1).to(dt)
    for t in range(Tn):
        phi_orig = phi
        phi = add_phi(phi, emit + _CTC_LOG_EPS * repeat)
        le, lphi, pad = lp_emit[t], lp_phi[t], pads[t][:, None]
        next_emit = _LogAddExp.apply(phi[:, :-1] + le, emit + le)
        next_phi = add_phi(phi + lphi,
                           emit + lphi + _CTC_LOG_EPS * (1.0 - repeat))
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * phi_orig + (1.0 - pad) * next_phi
    phi = add_phi(phi, emit)
    return -phi.gather(1, labellens[:, None])[:, 0]


@register("warpctc")
def _warpctc(ctx, op):
    """CTC loss [n, 1] of logits (before the softmax) against label
    sequences: LoD Logits [T, V] and Label [N, 1], or (``padded``) Logits
    [B, T, V], Label [B, N] with LogitsLength and LabelLength. With
    ``norm_by_times`` each loss is divided by its logits' length."""
    logits = ctx.get_input(op, "Logits")
    label = ctx.get_input(op, "Label")
    blank = int(op.attr("blank", 0))
    if op.attr("padded", False):
        llen = ctx.get_input(op, "LogitsLength").reshape(-1).to(_I64)
        tlen = ctx.get_input(op, "LabelLength").reshape(-1).to(_I64)
        lpad = logits
        ypad = label.reshape(label.shape[0], -1).to(_I64)
        dev = logits.device
        lmask = torch.arange(lpad.shape[1], device=dev)[None, :] < \
            llen[:, None]
        ymask = torch.arange(ypad.shape[1], device=dev)[None, :] < \
            tlen[:, None]
    else:
        llen, lpad, lmask = _packed(ctx, op, "Logits", logits)
        lpad, lmask = lpad.transpose(0, 1), lmask.transpose(0, 1)
        tlen, ypad, ymask = _packed(ctx, op, "Label",
                                    label.reshape(-1, 1).to(_I64))
        ypad, ymask = ypad[..., 0].transpose(0, 1), ymask.transpose(0, 1)
    loss = _ctc_loss(lpad, ~lmask, ypad, ~ymask, blank)
    if op.attr("norm_by_times", False):
        loss = loss / llen.clamp_min(1).to(loss.dtype)
    ctx.set_output(op, "Loss", loss[:, None])
    ctx.set_output(op, "WarpCTCGrad", torch.zeros_like(lpad))


@register("ctc_align")
def _ctc_align(ctx, op):
    """Greedy CTC decode of argmax ids Input [T, 1] (LoD): repeats
    collapsed, then blanks dropped, the survivors front-packed per
    sequence; Output [T, 1] int64 with the new lengths. The lengths are
    device values, so the output keeps the input's time bound (it is
    never longer)."""
    x = ctx.get_input(op, "Input")
    name = op.input("Input")[0]
    lengths = _lod(ctx, name)
    flat = x.reshape(-1).to(_I64)
    T = flat.shape[0]
    n = lengths.shape[0]
    seg, starts, _, valid = _seg_info(lengths, T)
    segc = seg.clamp(0, n - 1)
    tok = torch.arange(T, device=flat.device)
    first = starts[segc]
    prev = torch.where(tok > first, flat[(tok - 1).clamp_min(0)], -1)
    keep = valid & (flat != int(op.attr("blank", 0))) & (flat != prev)
    kept, _ = _pack(keep.to(_I64), lengths, starts, _bound(ctx, name, T))
    new_len = kept.sum(1)
    nstarts = torch.cumsum(new_len, 0) - new_len
    cums = torch.cumsum(keep.to(_I64), 0)
    prior = torch.where(first > 0, cums[(first - 1).clamp(0, T - 1)], 0)
    dst = torch.where(keep, nstarts[segc] + cums - 1 - prior, T)
    out = torch.zeros(T + 1, dtype=_I64, device=flat.device)
    out = out.index_put((dst,), torch.where(keep, flat, 0))[:T]
    ctx.set_output(op, "Output", out[:, None])
    _set_lod(ctx, op, "Output", new_len.to(torch.int32),
             ctx.env.get(bound_name(name)))


@register("edit_distance")
def _edit_distance(ctx, op):
    """Levenshtein distance Out [n, 1] (float32) of each hypothesis
    against its reference: LoD Hyps and Refs, or (``padded``) [B, L]
    with HypsLength and RefsLength; ``normalized`` divides by the
    reference's length. One DP row a hypothesis step, over every
    reference position at once: with c[0] = i and c[j] = min(dp[j] + 1,
    dp[j-1] + (ref[j] != hyp[i])), the left neighbour's term makes the
    new row j + cummin(c[k] - k) (a prefix minimum), where the
    reference scans the row position by position."""
    hyp = ctx.get_input(op, "Hyps")
    ref = ctx.get_input(op, "Refs")
    if op.attr("padded", False):
        hlen = ctx.get_input(op, "HypsLength").reshape(-1).to(_I64)
        rlen = ctx.get_input(op, "RefsLength").reshape(-1).to(_I64)
        n = hlen.shape[0]
        hpad = hyp.reshape(n, -1).to(_I64).t()
        rpad = ref.reshape(n, -1).to(_I64).t()
    else:
        hlen, hpad, _ = _packed(ctx, op, "Hyps", hyp.reshape(-1, 1).to(_I64))
        rlen, rpad, _ = _packed(ctx, op, "Refs", ref.reshape(-1, 1).to(_I64))
        hlen, rlen = hlen.to(_I64), rlen.to(_I64)
        hpad, rpad = hpad[..., 0], rpad[..., 0]
        n = hlen.shape[0]
    Hb, Rb = hpad.shape[0], rpad.shape[0]
    f32 = torch.float32
    j = torch.arange(Rb + 1, dtype=f32, device=hyp.device)
    dp = j.expand(n, Rb + 1)
    rows = [dp]
    for i in range(1, Hb + 1):
        sub = (rpad.t() != hpad[i - 1][:, None]).to(f32)
        c = torch.minimum(dp[:, 1:] + 1, dp[:, :-1] + sub)
        c = torch.cat([torch.full((n, 1), float(i), dtype=f32,
                                  device=hyp.device), c], 1)
        dp = j + torch.cummin(c - j, dim=1).values
        rows.append(dp)
    d = torch.stack(rows)[hlen.clamp(0, Hb), torch.arange(
        n, device=hyp.device), rlen.clamp(0, Rb)]
    if op.attr("normalized", False):
        d = d / rlen.clamp_min(1).to(f32)
    ctx.set_output(op, "Out", d[:, None])
    ctx.set_output(op, "SequenceNum", torch.full((), n, dtype=torch.int32,
                                                 device=hyp.device))


def _take(table, idx):
    """Rows of ``table`` [R, ...] at int64 ``idx`` (any shape), with a
    gradient summed in one fixed order (``tensor_ops._Embedding``)."""
    flat = table.reshape(table.shape[0], -1)
    out = _Embedding.apply(flat, idx)
    return out.reshape(tuple(idx.shape) + tuple(table.shape[1:]))


def _log_ratio(num, den, dtype):
    """log(num / den) rounded as the reference computes it, in ``dtype``."""
    return float(torch.log(torch.tensor(num / den, dtype=dtype)))


@register("nce")
def _nce(ctx, op):
    """Noise-contrastive estimation with ``num_neg_samples`` negatives a
    row drawn uniformly from [0, num_total_classes): Cost [B, 1] =
    -(log s(pos - log q) + sum log s(-(neg - log q))), q = S / C;
    SampleLogits [B, S]; SampleLabels [B, S] int64 (the draws)."""
    x = ctx.get_input(op, "Input")
    label = ctx.get_input(op, "Label").reshape(-1).to(_I64)
    w = ctx.get_input(op, "Weight")
    b = ctx.get_input(op, "Bias")
    S = int(op.attr("num_neg_samples", 10))
    C = int(op.attr("num_total_classes"))
    neg = ctx.randint((x.shape[0], S), C)
    pos_logit = (x * _take(w, label)).sum(1)
    neg_logit = torch.einsum("bd,bsd->bs", x, _take(w, neg))
    if b is not None:
        bias = b.reshape(-1, 1)
        pos_logit = pos_logit + _take(bias, label)[:, 0]
        neg_logit = neg_logit + _take(bias, neg)[..., 0]
    logq = _log_ratio(S, C, x.dtype)
    cost = -(F.logsigmoid(pos_logit - logq)
             + F.logsigmoid(-(neg_logit - logq)).sum(1))
    ctx.set_output(op, "Cost", cost[:, None])
    ctx.set_output(op, "SampleLogits", neg_logit)
    ctx.set_output(op, "SampleLabels", neg)


@register("hierarchical_sigmoid")
def _hierarchical_sigmoid(ctx, op):
    """Hierarchical sigmoid over the complete binary tree (the
    reference's heap code: a label's leaf is label + num_classes, its
    path the leaf's binary prefixes, each step's sign the next bit):
    Out [B, 1] = -sum log s(sign * (x . W[node] + b[node])) over the
    path; PreOut [B, max_len] the logits."""
    x = ctx.get_input(op, "X")
    w = ctx.get_input(op, "W")
    b = ctx.get_input(op, "Bias")
    label = ctx.get_input(op, "Label").reshape(-1).to(_I64)
    C = int(op.attr("num_classes"))
    max_len = int(np.ceil(np.log2(max(C, 2)))) + 1
    code = label + C
    length = torch.floor(torch.log2(code.to(torch.float32))).to(_I64)
    ks = torch.arange(max_len, dtype=_I64, device=x.device)
    shift = length[:, None] - ks[None, :]
    node = torch.bitwise_right_shift(code[:, None], shift.clamp_min(1))
    bit = torch.bitwise_right_shift(code[:, None],
                                    (shift - 1).clamp_min(0)) & 1
    nidx = (node - 1).clamp(0, w.shape[0] - 1)
    logits = torch.einsum("bd,bkd->bk", x, _take(w, nidx))
    if b is not None:
        logits = logits + _take(b.reshape(-1, 1), nidx)[..., 0]
    sign = torch.where(bit == 1, 1.0, -1.0).to(x.dtype)
    logp = F.logsigmoid(sign * logits)
    cost = -torch.where(shift >= 1, logp, torch.zeros(
        (), dtype=x.dtype, device=x.device)).sum(1)
    ctx.set_output(op, "Out", cost[:, None])
    ctx.set_output(op, "PreOut", logits)


@register("sampled_softmax_with_cross_entropy")
@register("sample_logits")
def _sampled_softmax(ctx, op):
    """Softmax cross-entropy over the true class and ``num_samples``
    classes drawn uniformly a row, the drawn logits corrected by -log q
    (q = S / C) and an accidental hit of the true class masked out:
    Loss [B, 1]; Samples [B, S] int64."""
    logits = ctx.get_input(op, "Logits")
    label = ctx.get_input(op, "Label").reshape(-1).to(_I64)
    S = int(op.attr("num_samples", 5))
    B, C = logits.shape
    neg = ctx.randint((B, S), C)
    base = torch.arange(B, dtype=_I64, device=logits.device) * C
    flat = logits.reshape(-1, 1)
    true_logit = _take(flat, base + label)
    neg_logit = _take(flat, base[:, None] + neg)[..., 0]
    logq = _log_ratio(S, C, logits.dtype)
    cat = torch.cat([true_logit, torch.where(
        neg == label[:, None], torch.full((), -1e30, dtype=logits.dtype,
                                          device=logits.device),
        neg_logit - logq)], 1)
    ctx.set_output(op, "Loss", -F.log_softmax(cat, dim=1)[:, :1])
    ctx.set_output(op, "Samples", neg)
