"""Attention: the fused training attention, and incremental-decode
attention over KV ring caches and paged pools.

Counterpart of ``paddle_tpu/kernels/attention.py``. Hand-written CUDA
kernels replace all fourteen of its Pallas TPU kernels:

* training (``csrc/fused_attention.cu``, reached through
  ``fused_attention`` and ``flash_attention`` /
  ``flash_attention_backward``): ``fused_attention_fwd_kernel`` replaces
  the three forward kernels of the TPU package's tiers, ``_fwd_kernel``
  (S <= 1024), ``_fwd_kernel_long`` (1024 < S <= 4096) and
  ``_flash_fwd_kernel`` (longer); ``fused_attention_bwd_dq_kernel`` and
  ``fused_attention_bwd_dkdv_kernel`` together replace ``_bwd_kernel``
  and ``_bwd_kernel_long``, and one each of the flash tier's split pair,
  ``_flash_dq_kernel`` and ``_flash_dkdv_kernel``;
* training in the packed [B, S, H*d] layout (``fused_attention_packed``:
  the same three wrappers on the heads' strided [B, H, S, d] views, no
  copy): the forward kernel replaces ``_packed_fwd_kernel`` and
  ``_res_fwd_kernel``; the dq and dk/dv kernels together replace
  ``_packed_bwd_kernel`` (one pass for dq, dk, dv and dbias on the TPU),
  and one each of the resident tier's split pair, ``_res_dq_kernel`` (dq
  and dbias; here dbias comes with dk/dv) and ``_res_dkdv_kernel``;
* decode (``csrc/decode_attention.cu``): ``decode_attention_kernel``
  replaces ``_decode_fwd_kernel`` (dense ring cache, reached through
  ``attention_with_cache``); ``paged_attention_kernel`` replaces
  ``_paged_decode_fwd_kernel`` (paged pool, ``paged_attention_cache``).

The TPU package splits training attention into tiers because VMEM
bounds what one kernel can hold: a whole [S, S] tile up to S 1024,
K/V of one head up to S 4096, past that both q and k tiled. The CUDA
kernels tile both q and k at every S (the flash-attention-2 scheme:
online softmax, row logsumexp, split backward), so one family takes
every S, and also the cases the TPU package sends to its blockwise
fallback: a per-row head-broadcast bias in the long range, a per-row
bias in the flash range, an S that no flash tile divides. Dropout is
one Philox mask keyed on (b·H+h, row, column) at every S, where the
TPU tiers draw differently from one another.

Each public function takes the plain PyTorch version for tensors on the
CPU and the kernel for tensors on a CUDA device; anything else raises.
The training kernels take float32, bfloat16 and float16 (on the tensor
cores up to d 128: float32 as 3xTF32, its backward up to d 64, the
16-bit types by bf16/fp16 products, their backward also at d 256) and head
widths 16, 32, 64, 128 and 256, and past 256 any multiple of 64;
``flash_attention`` and ``flash_attention_backward``, which every route
reaches, zero-pad any other d to the next of these (``built_width``).
The decode kernels take the same three types and key rows of any width
(past 2048 bytes a row's output columns split across blocks), hold
every q-row of a (batch, head) in one block, and where batch × heads
would leave SMs idle cut the key axis into pieces (``decode_splits``,
chosen from shapes alone) whose partials a second launch merges; the
decode sessions pad their caches' rows to a multiple of 16 bytes
(``decode_row_width``), which ``attention_with_cache`` and
``paged_attention_cache`` read with q zero-padded to match.
Every decode capacity goes to the kernel: the TPU package's capacity
threshold for its kernel tier is not carried over.

Unlike the JAX package, whose arrays are immutable, the cache and pool
updates here write IN PLACE: copying a whole pool every decode step
would cost its full size in bytes. They still return the (same) tensor,
so call sites read like the reference's.
"""

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from ..fluid import monitor as _monitor
from . import _build

_MASKED = -1e30     # not -inf: exp(-inf - -inf) would turn empty rows NaN

_M_DECODE_LAUNCH = _monitor.counter(
    "attn_decode_kernel_dispatch_total",
    "dense decode-attention CUDA kernel launches")
_M_PAGED_LAUNCH = _monitor.counter(
    "attn_paged_kernel_dispatch_total",
    "paged decode-attention CUDA kernel launches")
_M_FWD_LAUNCH = _monitor.counter(
    "attn_fused_fwd_kernel_dispatch_total",
    "fused training-attention forward CUDA kernel launches")
_M_BWD_DQ_LAUNCH = _monitor.counter(
    "attn_fused_bwd_dq_kernel_dispatch_total",
    "fused training-attention dq CUDA kernel launches")
_M_BWD_DKDV_LAUNCH = _monitor.counter(
    "attn_fused_bwd_dkdv_kernel_dispatch_total",
    "fused training-attention dk/dv CUDA kernel launches")


# -- fused training attention -----------------------------------------------
# the head widths the fused kernels are built for up to 256; past it they
# take any multiple of _WIDE_CHUNK, each block writing one chunk of the
# outputs' columns. ``flash_attention`` and ``flash_attention_backward``
# zero-pad any other d up to the next built width (``built_width``).
_HEAD_DIMS = (16, 32, 64, 128, 256)
_WIDE_CHUNK = 64


# Philox4x32-10 (Random123's constants), the generator of the kernels'
# dropout masks (csrc/fused_attention.cu)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _mulhilo(m, x):
    """(hi, lo) 32-bit halves of the 64-bit product of the constant ``m``
    and ``x`` (int64 tensor of values below 2**32). The factors are split
    into 16-bit halves, because their full product overflows int64."""
    ml, mh = m & 0xFFFF, m >> 16
    xl, xh = x & 0xFFFF, x >> 16
    ll = ml * xl
    mid = mh * xl + ml * xh + (ll >> 16)
    return mh * xh + (mid >> 16), ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)


def philox4x32(counter, key):
    """Philox4x32-10 on int64 tensors: ``counter`` four broadcastable
    tensors of 32-bit values, ``key`` two. Returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_keep_mask(B, H, S, p, seed, first_pair=0):
    """The fused kernels' dropout mask [B, H, S, S] (True = kept), built in
    plain PyTorch: element (b, h, row, col) takes word ``row & 3`` of the
    Philox call keyed on ``seed`` (int64 tensor [1]) with counter
    (col, row >> 2, first_pair + b * H + h, 0), and is kept where
    (bits >> 8) * 2**-24 >= p in fp32. ``first_pair`` b0 * H' + h0 gives
    the mask of the one (b0, h0) pair of a larger [B', H'] call (B = H =
    1), which the pairs' independence lets a check build alone."""
    dev = seed.device
    r4 = (S + 3) // 4
    ar = functools.partial(torch.arange, device=dev, dtype=torch.int64)
    s = seed.reshape(()).to(torch.int64)
    words = philox4x32(
        (ar(S).view(1, 1, S), ar(r4).view(1, r4, 1),
         ar(B * H).view(B * H, 1, 1) + first_pair,
         torch.zeros((), dtype=torch.int64, device=dev)),
        (s & _MASK32, (s >> 32) & _MASK32))
    shape = (B * H, r4, S)
    bits = torch.stack([w.expand(shape) for w in words], dim=2)
    bits = bits.reshape(B * H, 4 * r4, S)[:, :S]
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return (u >= p).view(B, H, S, S)


def _ref_scores(q, k, bias, scale):
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    return s if bias is None else s + bias.float()


def _ref_fused_attention(q, k, v, bias, scale, dropout_prob, seed,
                         first_pair=0):
    """Plain version of the fused kernels (the einsum form of the
    reference's ``_ref_attention``), differentiated by autograd: fp32
    scores plus bias, softmax, dropout of the normalised weights with the
    kernels' Philox mask and a 1/(1-p) upscale, PV, cast to q's type.
    ``first_pair`` as ``dropout_keep_mask``."""
    B, H, S, _ = q.shape
    p = torch.softmax(_ref_scores(q, k, bias, scale), dim=-1)
    if dropout_prob > 0.0:
        keep = dropout_keep_mask(B, H, S, dropout_prob, seed, first_pair)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_prob)), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def fused_attention(q, k, v, bias=None, scale=None, dropout_prob=0.0,
                    seed=None):
    """softmax(q·kᵀ·scale + bias)·v over heads, with dropout of the
    normalised weights.

    q, k, v [B, H, S, d] of one dtype; bias additive, broadcastable as
    [B|1, 1|H, 1|S, S] (0 keep / -1e4 mask); ``seed`` an int64 tensor [1]
    on q's device, required when ``dropout_prob`` > 0. Returns
    [B, H, S, d] in q's dtype, differentiable in q, k, v and bias.

    A CPU tensor takes the plain version, a ``meta`` tensor gives the
    shape only, a CUDA tensor the kernels, at any S; operands whose rows
    of d elements are contiguous reach them without a copy, and the
    gradients come back in their layouts."""
    scale, p = _scalars(q.shape[-1], scale, dropout_prob, seed)
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return _ref_fused_attention(q, k, v, bias, scale, p, seed)
    return _FusedAttention.apply(q, k, v, bias, seed, scale, p)


def _scalars(d, scale, dropout_prob, seed):
    scale = float(1.0 / math.sqrt(d) if scale is None else scale)
    p = float(dropout_prob)
    if p > 0.0 and seed is None:
        raise ValueError("dropout_prob > 0 needs a seed tensor")
    return scale, p


def _ref_flash_attention(q, k, v, bias, scale, dropout_prob, seed):
    """Plain version of ``flash_attention``: the plain forward, and the
    row logsumexp of the biased fp32 scores."""
    lse = torch.logsumexp(_ref_scores(q, k, bias, scale), dim=-1)
    return _ref_fused_attention(q, k, v, bias, scale, dropout_prob,
                                seed), lse


def _ref_flash_attention_backward(q, k, v, bias, seed, do, o, lse, scale,
                                  dropout_prob, bias_grad):
    """Plain version of ``flash_attention_backward``: autograd of the
    plain forward, which recomputes what ``o`` and ``lse`` hold (they are
    not read)."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    want_db = bias is not None and bias_grad
    if want_db:
        leaves.append(bias.detach().requires_grad_(True))
    with torch.enable_grad():
        o = _ref_fused_attention(*leaves[:3], leaves[3] if want_db else bias,
                                 scale, dropout_prob, seed)
        grads = torch.autograd.grad(o, leaves, do)
    return tuple(grads[:3]) + ((grads[3].float() if want_db else None),)


def flash_attention(q, k, v, bias=None, scale=None, dropout_prob=0.0,
                    seed=None):
    """The flash tier's forward contract (counterpart of the TPU
    package's ``_pallas_attention_flash``), which ring attention needs per
    hop: returns (o [B, H, S, d] in q's type, lse [B, H, S] fp32, the
    row logsumexp of the biased scores; the TPU package's lse is
    [B, H, S, 1]). Arguments as ``fused_attention``; not differentiable:
    ``flash_attention_backward`` is its backward. A CPU tensor takes the
    plain version, a CUDA tensor the forward kernel; a head width the
    kernels are not built for is zero-padded (``padded_forward``), any d
    up to 256."""
    scale, p = _scalars(q.shape[-1], scale, dropout_prob, seed)
    if q.device.type == "cpu":
        return _ref_flash_attention(q, k, v, bias, scale, p, seed)
    return padded_forward(_launch_forward, q, k, v, bias, scale, p, seed)


def _launch_forward(q, k, v, bias, scale, p, seed):
    """The forward kernel on operands of a built head width."""
    q, k, v = (_rows(t) for t in (q, k, v))
    B, H, S, _ = q.shape
    bias_f, strides = _bias_operand(bias, B, H, S)
    return fused_attention_fwd_kernel(q, k, v, bias_f, strides, seed, scale,
                                      p)


def flash_attention_backward(q, k, v, bias, seed, do, o, lse, scale=None,
                             dropout_prob=0.0, bias_grad=True):
    """The flash tier's backward contract (counterpart of the TPU
    package's ``_pallas_attention_flash_bwd``): from the forward's
    operands, its upstream gradient ``do`` and its (o, lse), returns
    (dq, dk, dv in q's type, dbias fp32 reduced to the bias's own
    broadcast shape, or None without a bias or with ``bias_grad``
    False). A CPU tensor takes the plain version (autograd of the plain
    forward), a CUDA tensor the dq kernel and then the dk/dv kernel, on
    operands zero-padded as the forward's (``padded_backward``)."""
    scale, p = _scalars(q.shape[-1], scale, dropout_prob, seed)
    if q.device.type == "cpu":
        return _ref_flash_attention_backward(q, k, v, bias, seed, do, o, lse,
                                             scale, p, bias_grad)
    return padded_backward(_launch_backward, q, k, v, bias, seed, do, o, lse,
                           scale, p, bias_grad)


def _launch_backward(q, k, v, bias, seed, do, o, lse, scale, p, bias_grad):
    """The dq and dk/dv kernels on operands of a built head width; dbias
    summed over a batch-broadcast bias's batch."""
    q, k, v = (_rows(t) for t in (q, k, v))
    B, H, S, _ = q.shape
    bias_f, strides = _bias_operand(bias, B, H, S)
    dq, dk, dv, dbias = fused_attention_backward(
        q, k, v, bias_f, strides, seed, _rows(o), lse, _rows(do), scale, p,
        bias_grad=bias is not None and bias_grad)
    if dbias is not None and bias.shape[0] == 1 < B:
        dbias = dbias.sum(0, keepdim=True)
    return dq, dk, dv, dbias


def built_width(d):
    """The narrowest head width the fused kernels are built for that
    holds ``d``: one of ``_HEAD_DIMS`` up to 256, past it d rounded up
    to a multiple of ``_WIDE_CHUNK``."""
    for width in _HEAD_DIMS:
        if d <= width:
            return width
    return -(-d // _WIDE_CHUNK) * _WIDE_CHUNK


def column_chunks(d):
    """The blocks among which the kernels split a tile's output columns
    at the built width of ``d``: one chunk of ``_WIDE_CHUNK`` columns
    each past 256 (each block computes the scores over the whole d), else
    1 (at d 256 the 16-bit backward still splits its outputs in two
    halves, a choice of its own)."""
    width = built_width(d)
    return width // _WIDE_CHUNK if width > _HEAD_DIMS[-1] else 1


def _pad_heads(t, width):
    """``t`` [.., d] with zero columns appended up to ``width`` (``t``
    itself, with its strides, when d is ``width`` already)."""
    d = t.shape[-1]
    return t if d == width else F.pad(t, (0, width - d))


def padded_forward(forward, q, k, v, bias, scale, p, seed):
    """``forward`` (q, k, v, bias, scale, p, seed) -> (o, lse), the
    forward kernel's launch or the plain version, on q, k and v
    zero-padded along d to ``built_width(d)`` (any d); o comes back
    sliced to d.
    Zero columns add nothing to q·kᵀ, so lse is the true one, and v's
    zero columns give o zero columns; ``scale`` is the true d's, fixed
    before the padding."""
    d = q.shape[-1]
    width = built_width(d)
    o, lse = forward(*(_pad_heads(t, width) for t in (q, k, v)), bias,
                     scale, p, seed)
    return o[..., :d], lse


def padded_backward(backward, q, k, v, bias, seed, do, o, lse, scale, p,
                    bias_grad):
    """``backward`` (q, k, v, bias, seed, do, o, lse, scale, p, bias_grad)
    -> (dq, dk, dv, dbias) on q, k, v, do and o zero-padded along d as
    ``padded_forward``'s; dq, dk and dv come back sliced to d. The padded
    columns of dq, dk and dv are zero (products with the zero columns of
    k, q and do), and delta = rowsum(do·o) and dbias are unchanged."""
    d = q.shape[-1]
    width = built_width(d)
    q, k, v, do, o = (_pad_heads(t, width) for t in (q, k, v, do, o))
    dq, dk, dv, dbias = backward(q, k, v, bias, seed, do, o, lse, scale, p,
                                 bias_grad)
    return dq[..., :d], dk[..., :d], dv[..., :d], dbias


def _rows(t):
    """``t`` as the kernels read it: any strides whose rows of d elements
    are contiguous pass as they are (a packed layout's heads, no copy),
    an operand the tensor-core kernels copy by 16 bytes when every row
    also starts on a 16-byte boundary (``_rows_aligned``); anything else
    is copied contiguous, into a fresh (aligned) buffer. The copy changes
    the layout only: every operand goes to the same kernels."""
    if t.stride(-1) == 1 and _rows_aligned(t):
        return t
    return t.clone(memory_format=torch.contiguous_format)


# bytes the tensor-core kernels copy a row in (16-byte cp.async)
_ROW_ALIGN = 16


def _rows_aligned(t):
    """Whether each row of a [.., d] operand that the tensor-core kernels
    copy by 16-byte ``cp.async`` (bfloat16 and float16 at every d,
    float32 up to d 128, the 3xTF32 kernels' widths) starts on a 16-byte
    boundary: its first element aligned and every stride of a dimension
    longer than 1 (batch, head, row) a multiple of 16 bytes. float32
    rows past d 128 pass: the SIMT kernels read elements one by one."""
    if t.dtype == torch.float32 and t.shape[-1] > _TF32_MAX_D:
        return True
    step = _ROW_ALIGN // t.element_size()
    return t.data_ptr() % _ROW_ALIGN == 0 and all(
        st % step == 0 for st, n in zip(t.stride()[:-1], t.shape[:-1])
        if n > 1)


def _bias_operand(bias, B, H, S):
    """(fp32 contiguous bias, its element strides (b, h, row)) for the
    kernels; a broadcast dimension gets stride 0. None passes through."""
    if bias is None:
        return None, (0, 0, 0)
    shape = tuple(bias.shape)
    if len(shape) != 4 or shape[0] not in (1, B) or shape[1] not in (1, H) \
            or shape[2] not in (1, S) or shape[3] != S:
        raise ValueError("bias must broadcast as [B|1, 1|H, 1|S, S] = "
                         "[%d, %d, %d, %d], got %s" % (B, H, S, S, shape))
    bias = bias.to(torch.float32).contiguous()
    rows, heads = shape[2], shape[1]
    return bias, ((shape[0] > 1) * heads * rows * S, (heads > 1) * rows * S,
                  (rows > 1) * S)


class _FusedAttention(torch.autograd.Function):
    """The kernels under autograd: the forward (``flash_attention``)
    saves q, k, v, o and the row logsumexp; the backward
    (``flash_attention_backward``) runs the dq and dk/dv kernels."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, scale, p):
        o, lse = flash_attention(q, k, v, bias, scale, p, seed)
        ctx.save_for_backward(q, k, v, bias, seed, o, lse)
        ctx.scale, ctx.p = scale, p
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, seed, o, lse = ctx.saved_tensors
        want_db = bias is not None and ctx.needs_input_grad[3]
        dq, dk, dv, dbias = flash_attention_backward(
            q, k, v, bias, seed, do, o, lse, ctx.scale, ctx.p,
            bias_grad=want_db)
        if want_db:
            dbias = dbias.to(bias.dtype)
        return dq, dk, dv, dbias, None, None, None


# -- packed layout --------------------------------------------------------------
def _split_heads(t, n_heads):
    """The [B, H, S, d] view of a packed [B, S, H*d] tensor: no copy, and
    strides (S*H*d, d, H*d, 1), when ``t`` is contiguous."""
    B, S, HD = t.shape
    return t.reshape(B, S, n_heads, HD // n_heads).transpose(1, 2)


def _merge_heads(t):
    """[B, H, S, d] -> packed [B, S, H*d] (a copy unless ``t`` is a
    ``_split_heads`` view)."""
    B, H, S, d = t.shape
    return t.transpose(1, 2).reshape(B, S, H * d)


def _ref_fused_attention_packed(q, k, v, bias, n_heads, scale, dropout_prob,
                                seed):
    """Plain version of ``fused_attention_packed``, as the reference's
    ``_packed_fallback``: split the heads, the plain per-head version,
    merge the heads; differentiated by autograd."""
    o = _ref_fused_attention(*(_split_heads(t, n_heads) for t in (q, k, v)),
                             bias, scale, dropout_prob, seed)
    return _merge_heads(o)


def _packed_heads(q, n_heads):
    if q.dim() != 3:
        raise ValueError("packed q must be [B, S, H*d], got %s"
                         % (tuple(q.shape),))
    n_heads = int(n_heads)
    if n_heads < 1 or q.shape[2] % n_heads:
        raise ValueError("H*d = %d is not a multiple of n_heads = %d"
                         % (q.shape[2], n_heads))
    return n_heads


def fused_attention_packed(q, k, v, bias=None, n_heads=1, scale=None,
                           dropout_prob=0.0, seed=None):
    """Multi-head attention on packed q, k, v [B, S, H*d] (the layout the
    q/k/v projections write): ``fused_attention`` on the heads'
    [B, H, S, d] views, returned packed [B, S, H*d] in q's dtype. bias
    additive, broadcastable as [B|1, 1|H, 1|S, S]; ``seed`` as
    ``fused_attention``, whose Philox mask it draws. Differentiable in q,
    k, v and bias.

    A CPU tensor takes the plain version, a ``meta`` tensor gives the
    shape only, a CUDA tensor the kernels through the heads' strides
    (S*H*d, d, H*d): the views, the kernels' outputs (allocated in their
    inputs' layout) and the merge back are all copy-free on the card."""
    n_heads = _packed_heads(q, n_heads)
    o = fused_attention(*(_split_heads(t, n_heads) for t in (q, k, v)),
                        bias, scale, dropout_prob, seed)
    return _merge_heads(o)


# -- KV ring cache -----------------------------------------------------------
def decode_row_width(d, dtype):
    """Elements of a KV-cache row that holds d elements of ``dtype``,
    rounded up to a multiple of 16 bytes: the width the decode sessions
    allocate their caches and pools at, so that every row travels by
    16-byte copies (the columns past d stay zero)."""
    step = 16 // torch.empty((), dtype=dtype).element_size()
    return -(-int(d) // step) * step


def kv_cache_update(cache, new, cache_len):
    """Write ``new`` [B, H, T, d] into the ring buffer ``cache``
    [B, H, C, d'] (d' >= d: a cache whose rows are padded takes ``new``
    in its first d columns) at per-sequence slot ``cache_len % C`` (in
    place) and return ``(cache, cache_len + T)``.

    ``cache_len`` [B] int32 counts every token ever written (not clamped
    to C). One write must not cross the ring boundary; where it would,
    the start slot is clamped to C - T, as the reference's
    ``dynamic_update_slice`` clamps it."""
    B, H, C, _ = cache.shape
    T, d = new.shape[2], new.shape[3]
    lens = cache_len.reshape(B).to(torch.int32)
    pos = torch.clamp(torch.remainder(lens, C), max=C - T).long()
    slots = pos[:, None] + torch.arange(T, device=cache.device)[None, :]
    rows = torch.arange(B, device=cache.device)[:, None].expand(B, T)
    # advanced indices around a slice put their dims first: [B, T, H, d]
    cache[rows, :, slots, :d] = new.to(cache.dtype).permute(0, 2, 1, 3)
    return cache, lens + T


def _ref_attention_cache(q, k_cache, v_cache, cache_len, scale,
                         causal_window=False):
    """Plain version of both decode kernels: fp32 scores over the FULL
    capacity, columns >= min(cache_len, C) masked to -1e30, softmax, PV.
    With ``causal_window`` row r of Q also masks the columns written
    after it (col < valid - (Q-1-r)); a row whose window is empty
    averages V uniformly, like the kernels."""
    B, H, Q, d = q.shape
    C = k_cache.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k_cache.float()) * scale
    valid = torch.clamp(cache_len.reshape(B).to(torch.int32), max=C)
    col = torch.arange(C, device=q.device).view(1, 1, 1, C)
    limit = valid.view(B, 1, 1, 1)
    if causal_window:
        row = torch.arange(Q, device=q.device).view(1, 1, Q, 1)
        limit = limit - (Q - 1) + row
    s = torch.where(col < limit, s, torch.full_like(s, _MASKED))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v_cache.float()).to(q.dtype)


def _pad_to_rows(q, cache):
    """q zero-padded along d to the width of the cache's rows (q itself
    when they match): a session's cache rows are padded to 16 bytes
    (``decode_row_width``), and zero columns add nothing to q·kᵀ."""
    d, width = q.shape[-1], cache.shape[-1]
    if width < d:
        raise ValueError("the cache rows hold %d elements, q has %d"
                         % (width, d))
    return q if width == d else F.pad(q, (0, width - d))


def attention_with_cache(q, k_cache, v_cache, cache_len, scale=None,
                         causal_window=False, longest=None):
    """Decode-step attention against a KV ring buffer.

    q [B, H, Q, d] (Q=1 for incremental decode), k_cache/v_cache
    [B, H, C, d'] with d' = d, or the session's rows padded to 16 bytes
    (d' = ``decode_row_width(d)``: q is zero-padded to d' and the output
    sliced back; the scale keeps the true d), cache_len [B] int32 =
    tokens written so far, after the update (so the current token sees
    itself). Only the first min(cache_len, C) slots take part; slot order
    does not matter, so a wrapped ring needs no unscrambling.
    ``causal_window=True`` (speculative verify, Q > 1): row r masks the
    columns written after it, which assumes the ring has not wrapped.
    ``longest`` (a Python int, optional) is the largest cache_len as the
    caller holds it on the host; on the card it sets how the kernel cuts
    the key axis (``decode_splits``), never the result beyond the order
    of its sums. Returns [B, H, Q, d] in q's dtype, accumulated in
    fp32."""
    d = q.shape[-1]
    scale = float(1.0 / math.sqrt(d) if scale is None else scale)
    q = _pad_to_rows(q, k_cache)
    if q.device.type == "cpu":
        out = _ref_attention_cache(q, k_cache, v_cache, cache_len, scale,
                                   causal_window=causal_window)
    else:
        out = decode_attention_kernel(q, k_cache, v_cache, cache_len, scale,
                                      causal_window=causal_window,
                                      longest=longest)
    return out[..., :d]


# -- paged KV pool -----------------------------------------------------------
# A pool [P, H, ptok, d] shared by every slot, indexed by per-slot page
# tables [B, npages]: logical ring position p of slot b lives in pool row
# table[b, p // ptok] at offset p % ptok, so the paged cache holds exactly
# the dense ring of capacity npages * ptok. Page 0 is the scratch page that
# idle slots and unallocated table entries point at; no live slot ever
# reads it, so the many concurrent writes it takes are harmless (on CUDA a
# scatter with duplicate indices keeps an arbitrary one of them).

def paged_kv_cache_update(pool, new, page_table, cache_len):
    """Write ``new`` [B, H, T, d] through ``page_table`` [B, npages] into
    the shared pool [P, H, ptok, d'] (d' >= d, as ``kv_cache_update``;
    in place) and return ``(pool, cache_len + T)``. Token t of slot b
    lands at logical ring position (cache_len[b] + t) % (npages * ptok);
    unlike the dense ring a write may cross page and ring boundaries."""
    P, H, ptok, _ = pool.shape
    B, _, T, d = new.shape
    cap = page_table.shape[1] * ptok
    lens = cache_len.reshape(B).to(torch.int32)
    pos = torch.remainder(
        lens.long()[:, None] + torch.arange(T, device=pool.device)[None, :],
        cap)                                                   # [B, T]
    page = torch.gather(page_table.long(), 1, pos // ptok)     # [B, T]
    vals = new.to(pool.dtype).permute(0, 2, 1, 3).reshape(B * T, H, d)
    pool[page.reshape(-1), :, (pos % ptok).reshape(-1), :d] = vals
    return pool, lens + T


def gather_paged_cache(pool, page_table):
    """The dense [B, H, npages * ptok, d] view of a paged cache: pool rows
    in table order, pages concatenated along the slot axis. The plain
    paged path and the paged/dense equivalence oracle."""
    B, npages = page_table.shape
    _, H, ptok, d = pool.shape
    g = pool[page_table.reshape(-1).long()].view(B, npages, H, ptok, d)
    return g.permute(0, 2, 1, 3, 4).reshape(B, H, npages * ptok, d)


def paged_attention_cache(q, k_pool, v_pool, page_table, cache_len,
                          scale=None, longest=None):
    """Decode-step attention against a PAGED KV cache.

    q [B, H, Q, d], pools [P, H, ptok, d'] (d' = d, or padded rows as
    ``attention_with_cache`` takes them), page_table [B, npages] int32,
    cache_len [B] int32 (after the update). Live slots are the first
    min(cache_len, npages * ptok) logical positions in table order; the
    result equals ``attention_with_cache`` of the gathered cache (at the
    same ``longest``)."""
    d = q.shape[-1]
    scale = float(1.0 / math.sqrt(d) if scale is None else scale)
    q = _pad_to_rows(q, k_pool)
    if q.device.type == "cpu":
        out = _ref_attention_cache(q, gather_paged_cache(k_pool, page_table),
                                   gather_paged_cache(v_pool, page_table),
                                   cache_len, scale)
    else:
        out = paged_attention_kernel(q, k_pool, v_pool, page_table,
                                     cache_len, scale, longest=longest)
    return out[..., :d]


# -- CUDA kernels -------------------------------------------------------------
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16"}
_VOIDP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


# the longest key row one lane group of the decode kernels covers: 32
# lanes of four 16-byte pieces (fp32 d 512, bfloat16 and float16 d 1024);
# a longer row's output columns are split across blocks in chunks of it
_DECODE_CHUNK_BYTES = 2048


def decode_lanes(row_bytes):
    """(lanes, pieces a lane) that cover one key row of ``row_bytes``
    bytes, or one 2048-byte chunk of it, in the decode kernels
    (csrc/decode_attention.cu): the row rounded up to 16-byte pieces; up
    to 512 bytes one piece a lane, the pieces rounded up to a power of
    two of lanes (1 to 32; the lanes past the row stay idle), past that
    32 lanes of 2 or 4 pieces, and past 2048 bytes 32 lanes of 4 pieces
    on each chunk (``decode_chunks``). A row of no bytes raises."""
    if row_bytes < 1:
        raise ValueError("a decode key row must span 1 byte or more "
                         "(d * itemsize), got %d" % row_bytes)
    pieces = -(-row_bytes // 16)
    if pieces > 32:
        return 32, 2 if pieces <= 64 else 4
    lanes = 1
    while lanes < pieces:
        lanes *= 2
    return lanes, 1


def decode_chunks(row_bytes):
    """The blocks among which the decode kernels split a q-row's output
    columns: one 2048-byte chunk each (1 up to 2048 bytes); each block
    computes the full-row scores over the row's chunks."""
    return -(-row_bytes // _DECODE_CHUNK_BYTES)


# a piece of the decode kernels' key axis is a multiple of this many
# columns: whole tiles (of at most 32 keys), and whole pages for every
# page size that divides it (the serving preset's 128 tokens)
DECODE_PIECE_COLS = 128
# B * H * row blocks at least this many times the SMs fill the card in one
# piece; below it, the key axis is split until the blocks reach
# _DECODE_SPLIT_BLOCKS times the SMs, in at most _DECODE_MAX_SPLITS pieces
# (past them the short pieces' blocks cost more than they spread: PERF.md)
_DECODE_FULL_WAVES = 4
_DECODE_SPLIT_BLOCKS = 8
_DECODE_MAX_SPLITS = 8


def decode_block_rows(Q, row_bytes):
    """The q-rows one block of the decode kernels takes (all of a (b, h)
    up to this; more rows take more blocks): 1 at Q 1, else 4, or 8 for
    rows of one 16-byte slice a lane, 2 for rows of four (the
    accumulators of 8 / slices rows stay in registers); 1 past 2048
    bytes, where each q-row has blocks of its own. The launch passes it
    to the library, which has a kernel for each of these counts."""
    if decode_chunks(row_bytes) > 1:
        return 1
    most = 8 // decode_lanes(row_bytes)[1]
    if Q == 1:
        return 1
    return min(4, most) if Q <= min(4, most) else most


def decode_piece(capacity, splits, granule=DECODE_PIECE_COLS):
    """Columns of each piece when the decode kernels cut a key axis of
    ``capacity`` columns into ``splits``: the even share rounded up to a
    multiple of ``granule`` (at most the capacity). The pieces are
    ``ceil(capacity / piece)``, the last one short."""
    if capacity < 1 or splits < 1:
        raise ValueError("capacity and splits must be at least 1, got %r, "
                         "%r" % (capacity, splits))
    share = -(-capacity // splits)
    return min(capacity, -(-share // granule) * granule)


def decode_span(capacity, longest=None):
    """The key columns the decode kernels' pieces are cut over: the
    capacity, or where the caller knows the longest live length on the
    host (``longest``, a Python int: the largest cache_len after the
    update, or any bound on it) that length, between 1 and the
    capacity."""
    if longest is None:
        return capacity
    if not isinstance(longest, int) or isinstance(longest, bool):
        raise TypeError("longest is a Python int held on the host, got %r"
                        % (type(longest),))
    return max(1, min(capacity, longest))


def decode_splits(B, H, Q, capacity, d, dtype, sms, longest=None):
    """The pieces into which the decode kernels cut each (b, h)'s key
    axis, from shapes and, where the caller holds it on the host, the
    longest live length (``decode_span``), never from the lengths on the
    card (reading them would sync the host every step): one where B * H
    * the blocks of its q-rows (``decode_block_rows``) fill the ``sms``
    SMs _DECODE_FULL_WAVES times over (a dense batch of 64 streams of 16
    heads), else enough that the blocks reach _DECODE_SPLIT_BLOCKS times
    ``sms`` (a serving batch of 8), at most _DECODE_MAX_SPLITS, in pieces
    of ``decode_piece`` over the span; so one wherever every row ends
    within 128 columns, and one for rows past 2048 bytes. A paged cache
    and its gathered dense cache of the same capacity and span get the
    same count, so they cut the same pieces."""
    ints = (B, H, Q, capacity, d, sms)
    if not all(isinstance(x, int) and not isinstance(x, bool) for x in ints):
        raise TypeError("decode_splits takes Python ints (shapes), got %r"
                        % (ints,))
    span = decode_span(capacity, longest)
    row_bytes = d * dtype.itemsize
    if decode_chunks(row_bytes) > 1:
        return 1
    blocks = B * H * -(-Q // decode_block_rows(Q, row_bytes))
    if blocks >= _DECODE_FULL_WAVES * sms:
        return 1
    want = min(_DECODE_MAX_SPLITS, -(-_DECODE_SPLIT_BLOCKS * sms // blocks))
    return -(-span // decode_piece(span, want))


def decode_pieces(B, H, Q, capacity, d, dtype, sms, longest=None,
                  splits=None):
    """(piece, splits) of a decode launch: ``splits`` pieces of ``piece``
    columns cut over ``decode_span``, the last running on to the
    capacity, so a span shorter than a row costs time, never columns;
    ``decode_splits`` unless ``splits`` forces a count (rows past 2048
    bytes refuse more than one). With one piece, the piece is the
    capacity."""
    if splits is None:
        splits = decode_splits(B, H, Q, capacity, d, dtype, sms, longest)
    elif splits > 1 and decode_chunks(d * dtype.itemsize) > 1:
        raise ValueError("rows past %d bytes take one piece"
                         % _DECODE_CHUNK_BYTES)
    span = decode_span(capacity, longest)
    piece = decode_piece(span, splits)
    n = -(-span // piece)
    return (piece, n) if n > 1 else (capacity, 1)


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _decode_launch_args(q, capacity, longest, splits):
    """(piece, splits, q-rows a block, workspace) of a decode launch: the
    pieces (``decode_pieces``), ``decode_block_rows`` and, for more than
    one piece, the fp32 workspace of the partials."""
    B, H, Q, d = q.shape
    piece, n = decode_pieces(B, H, Q, capacity, d, q.dtype,
                             _sm_count(q.device), longest, splits)
    ws = torch.empty(B * H * Q * n * (d + 2), dtype=torch.float32,
                     device=q.device) if n > 1 else None
    return piece, n, decode_block_rows(Q, d * q.element_size()), ws


def _entry(name, n_ptrs, n_ints):
    """The C entry ``name`` of the decode-attention library, with its
    argument types declared: pointers, ints, the scale, the stream."""
    fn = getattr(_library("decode_attention", name), name)
    if fn.argtypes is None:
        fn.argtypes = [_VOIDP] * n_ptrs + [_INT] * n_ints + [_FLOAT, _VOIDP]
        fn.restype = _INT
    return fn


def _check(name, t, device, dtype, shape, align=1):
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))
    if t.dtype != dtype:
        raise TypeError("%s has dtype %s, expected %s"
                        % (name, t.dtype, dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s"
                         % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)
    if t.data_ptr() % align:
        raise ValueError("%s must start on a %d-byte boundary" % (name,
                                                                align))


def _check_q(q):
    if q.device.type != "cuda":
        raise ValueError("the decode-attention kernels take CUDA tensors, "
                         "got one on %s" % q.device)
    if q.dtype not in _DTYPES:
        raise TypeError("the decode-attention kernels take float32, "
                        "bfloat16 or float16, got %s" % q.dtype)
    if q.dim() != 4 or min(q.shape) < 1:
        raise ValueError("q must be [B, H, Q, d], got %s"
                         % (tuple(q.shape),))
    decode_lanes(q.shape[3] * q.element_size())


def _library(stem, entry):
    """The library of ``csrc/<stem>.cu``, for its C entry ``entry``. A
    library that is not loaded yet would be built (minutes of ``nvcc``)
    and loaded at this call: inside a CUDA graph capture, which records
    launches and runs nothing, that raises instead, naming the entry (the
    executor runs every step once eagerly before it captures one)."""
    if not _build.loaded(stem) and torch.cuda.is_current_stream_capturing():
        raise _build.BuildError(
            "%s: csrc/%s.cu is not built yet, and a CUDA graph capture "
            "cannot build it; run the step once eagerly first"
            % (entry, stem))
    return _build.library(stem)


# -- launch counts ------------------------------------------------------------
# A wrapper counts a launch where it launches its kernel, and nowhere
# else. While the executor captures a step into a CUDA graph, a call on
# the capturing stream records its kernel in the graph and launches
# nothing, so it counts nothing; a replay launches the graph's kernels
# without calling any wrapper, so its kernels are counted by name in a
# profiler trace (``chip_smoke.traced_launches``), never here.
def _launched(wrapper, monitor, tensor_cores=False):
    """Count one launch of ``wrapper``'s kernel (in its ``launches``, its
    ``tensor_core_launches`` where ``tensor_cores``, and its ``monitor``
    series), unless the call went to a capturing stream (the backward's
    calls come from autograd's thread, on that stream)."""
    if torch.cuda.is_current_stream_capturing():
        return
    wrapper.launches += 1
    if tensor_cores:
        wrapper.tensor_core_launches += 1
    monitor.inc()


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d" % (what,
                                                                     rc))


def decode_attention_kernel(q, k_cache, v_cache, cache_len, scale,
                            causal_window=False, longest=None, _splits=None):
    """Launch the dense decode kernel (replaces ``_decode_fwd_kernel``,
    ``paddle_tpu/kernels/attention.py``): q [B, H, Q, d], k/v caches
    [B, H, C, d] in q's dtype (float32, bfloat16 or float16), cache_len
    [B] int32, all contiguous on one CUDA device; a key row of any width
    (``decode_lanes``; past 2048 bytes split across blocks,
    ``decode_chunks``). Rows of a multiple of 16
    bytes in caches that start 16-byte aligned (the sessions' padded
    caches) travel by 16-byte asynchronous copies, others element by
    element. Returns a new [B, H, Q, d] tensor in q's dtype.

    Bound on the card: the bytes of the live K and V rows over the HBM
    rate (3.35 TB/s on the H100 SXM); the kernel reads only live rows,
    each once for all q-rows, through a pipeline of asynchronous 16-byte
    copies, and cuts the key axis into ``decode_splits`` pieces whose
    partials a second launch merges where B * H alone would leave SMs
    idle and the rows are long (design note in
    ``csrc/decode_attention.cu``). ``longest``, a Python int, is the
    largest cache_len as the caller holds it on the host (the decode
    sessions pass it; none reads the lengths on the card): the pieces
    cover that many columns, and any value gives the same output up to
    the order of the sums. ``_splits`` forces the count of pieces (card
    tests and fault checks only)."""
    _check_q(q)
    B, H, Q, d = q.shape
    C = k_cache.shape[2] if k_cache.dim() == 4 else 0
    _check("k_cache", k_cache, q.device, q.dtype, (B, H, C, d))
    _check("v_cache", v_cache, q.device, q.dtype, (B, H, C, d))
    _check("cache_len", cache_len, q.device, torch.int32, (B,))
    if C < 1:
        raise ValueError("k_cache must hold at least one slot")
    piece, splits, rows, ws = _decode_launch_args(q, C, longest, _splits)
    out = torch.empty_like(q)
    fn = _entry("pt_decode_attention_" + _DTYPES[q.dtype], 6, 9)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                cache_len.data_ptr(), out.data_ptr(), _ptr(ws), B, H, Q, d,
                C, int(bool(causal_window)), piece, splits, rows,
                float(scale), _stream(q.device))
    _raise_on(rc, "decode-attention")
    _launched(decode_attention_kernel, _M_DECODE_LAUNCH)
    return out


decode_attention_kernel.launches = 0


def paged_attention_kernel(q, k_pool, v_pool, page_table, cache_len, scale,
                           longest=None, _splits=None):
    """Launch the paged decode kernel (replaces
    ``_paged_decode_fwd_kernel``, ``paddle_tpu/kernels/attention.py``;
    same bound and design as ``decode_attention_kernel``, whose template
    it shares, and the same pieces for the capacity npages * ptok and
    the same ``longest``): q
    [B, H, Q, d], pools [P, H, ptok, d] in q's dtype, page_table
    [B, npages] int32, cache_len [B] int32, all contiguous on one CUDA
    device, with the same row terms. Each block reads its piece's page
    indices from the table; the dense cache is never materialised. Table
    entries must index the pool (the sessions guarantee it; checking
    here would sync the host every step). Returns a new [B, H, Q, d]
    tensor in q's dtype."""
    _check_q(q)
    B, H, Q, d = q.shape
    P, ptok = (k_pool.shape[0], k_pool.shape[2]) if k_pool.dim() == 4 \
        else (0, 0)
    npages = page_table.shape[1] if page_table.dim() == 2 else 0
    _check("k_pool", k_pool, q.device, q.dtype, (P, H, ptok, d))
    _check("v_pool", v_pool, q.device, q.dtype, (P, H, ptok, d))
    _check("page_table", page_table, q.device, torch.int32, (B, npages))
    _check("cache_len", cache_len, q.device, torch.int32, (B,))
    if P < 1 or ptok < 1 or npages < 1:
        raise ValueError("the pool and the page table must be non-empty")
    piece, splits, rows, ws = _decode_launch_args(q, npages * ptok, longest,
                                                  _splits)
    out = torch.empty_like(q)
    fn = _entry("pt_paged_attention_" + _DTYPES[q.dtype], 7, 9)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                page_table.data_ptr(), cache_len.data_ptr(), out.data_ptr(),
                _ptr(ws), B, H, Q, d, ptok, npages, piece, splits, rows,
                float(scale), _stream(q.device))
    _raise_on(rc, "paged-attention")
    _launched(paged_attention_kernel, _M_PAGED_LAUNCH)
    return out


paged_attention_kernel.launches = 0


# -- fused training-attention CUDA kernels -----------------------------------
# the type code of the C entries: float32 as 3xTF32 on the tensor cores
# (the forward up to d 128, the backward up to d 64; else the SIMT
# kernels), bfloat16 and float16 on the tensor cores (the forward up to
# d 128; at d 256 it runs on the SIMT kernel); past d 256 every type on
# the SIMT kernels that split the outputs' columns
_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_TF32_MAX_D = 128
_I64 = ctypes.c_longlong


def _fused_entry(name, signature):
    """The C entry ``name`` of the fused-attention library with its
    argument types: ``signature`` is a string of p (pointer), i (int),
    l (int64), f (float), one letter per argument."""
    fn = getattr(_library("fused_attention", name), name)
    if fn.argtypes is None:
        types = {"p": _VOIDP, "i": _INT, "l": _I64, "f": _FLOAT}
        fn.argtypes = [types[c] for c in signature]
        fn.restype = _INT
    return fn


def _check_qkv(q, k, v, aligned=False):
    if q.device.type != "cuda":
        raise ValueError("the fused-attention kernels take CUDA tensors, "
                         "got one on %s" % q.device)
    if q.dtype not in _TYPE_CODES:
        raise TypeError("the fused-attention kernels take float32, "
                        "bfloat16 or float16, got %s" % q.dtype)
    if q.dim() != 4 or min(q.shape) < 1 or \
            built_width(q.shape[3]) != q.shape[3]:
        raise ValueError("q must be [B, H, S, d] with d in %s or a multiple "
                         "of %d past them, got %s" % (
                             _HEAD_DIMS, _WIDE_CHUNK, tuple(q.shape)))
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q, aligned)


def _check_operand(name, t, q, aligned=False):
    """``t`` a [B, H, S, d] operand in q's device, type and shape whose d
    elements are contiguous (any batch, head and row strides >= 0); with
    ``aligned``, a 16-bit operand's rows also start on 16-byte
    boundaries (``_rows_aligned``)."""
    if t.device != q.device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device,
                                                       q.device))
    if t.dtype != q.dtype:
        raise TypeError("%s has dtype %s, expected %s"
                        % (name, t.dtype, q.dtype))
    if tuple(t.shape) != tuple(q.shape):
        raise ValueError("%s has shape %s, expected %s"
                         % (name, tuple(t.shape), tuple(q.shape)))
    if t.stride(3) != 1 or min(t.stride()) < 0:
        raise ValueError("%s must have contiguous rows of d elements, got "
                         "strides %s" % (name, t.stride()))
    if aligned and not _rows_aligned(t):
        raise ValueError("%s must start every row on a %d-byte boundary, "
                         "got strides %s at address %d" % (
                             name, _ROW_ALIGN, t.stride(), t.data_ptr()))


def _strides(*ts):
    """The host array of (batch, head, row) element strides of each
    [B, H, S, d] operand, in order, for the C entries."""
    flat = [s for t in ts for s in t.stride()[:3]]
    return (_I64 * len(flat))(*flat)


def _check_extras(q, bias, strides, seed, p):
    B, H, S, _ = q.shape
    if bias is not None:
        if bias.device != q.device or bias.dtype != torch.float32 or \
                not bias.is_contiguous():
            raise ValueError("bias must be contiguous float32 on %s"
                             % q.device)
        need = (strides[0] * (B - 1) + strides[1] * (H - 1) +
                strides[2] * (S - 1) + S)
        if any(s < 0 for s in strides) or bias.numel() < need:
            raise ValueError("bias strides %s reach past its %d elements"
                             % (tuple(strides), bias.numel()))
    if not 0.0 <= p < 1.0:
        raise ValueError("dropout_prob must be in [0, 1), got %r" % p)
    if p > 0.0:
        _check("seed", seed, q.device, torch.int64, (1,))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def fused_attention_fwd_kernel(q, k, v, bias, strides, seed, scale, p):
    """Launch the forward kernel (replaces ``_fwd_kernel``,
    ``_fwd_kernel_long``, ``_flash_fwd_kernel``, ``_packed_fwd_kernel``
    and ``_res_fwd_kernel``, ``paddle_tpu/kernels/attention.py``): q, k, v
    [B, H, S, d] of one type (float32, bfloat16 or float16, d in
    16/32/64/128/256 or a multiple of 64 past it, any S) on one CUDA
    device, each row of d elements contiguous (an operand the tensor-core
    kernels copy by 16 bytes on 16-byte boundaries: ``_rows``); bias None
    or contiguous float32 read at element strides ``strides`` (batch,
    head, row; 0 broadcasts); seed int64 [1] when ``p`` > 0. Returns
    (o [B, H, S, d] in q's type and memory layout, lse [B, H, S] fp32).

    Bound on the card: 4·B·H·S²·d operations on the bytes of q, k, v and
    o, S / itemsize operations a byte: in bf16 and fp16 the bytes up to
    S 590, the tensor cores' rate above; in fp32 three TF32 products a
    product (165 TFLOP/s), the operations from S 200. Up to d 128 it runs
    on the tensor cores: float32 as 3xTF32 (``attn_fwd_tf32x3``:
    ``mma.sync`` m16n8k8 on TF32 hi/lo pairs), bfloat16 and float16 on
    ``attn_fwd_mma`` (``mma.sync`` m16n8k16, P in pieces of the input
    type, each tile's P·V joined to O in fp32); d 256 on the SIMT cores
    in fp32, past 256 on ``attn_fwd_wide`` (design notes in
    ``csrc/fused_attention.cu``). ``launches`` counts every launch,
    ``tensor_core_launches`` those on the tensor cores."""
    _check_qkv(q, k, v, aligned=True)
    _check_extras(q, bias, strides, seed, p)
    o = torch.empty_like(q)
    B, H, S, d = q.shape
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    fn = _fused_entry("pt_fused_attention_fwd",
                      "i" "pppp" "lll" "ppp" "p" "iiii" "fff" "p")
    with torch.cuda.device(q.device):
        rc = fn(_TYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), _ptr(bias), *strides, _ptr(seed), o.data_ptr(),
                lse.data_ptr(), _strides(q, k, v, o), B, H, S, d,
                float(scale), float(p), _keep_scale(p), _stream(q.device))
    _raise_on(rc, "fused-attention forward")
    _launched(fused_attention_fwd_kernel, _M_FWD_LAUNCH,
              on_tensor_cores(0, q.dtype, d))
    return o, lse


fused_attention_fwd_kernel.launches = 0
fused_attention_fwd_kernel.tensor_core_launches = 0


def _keep_scale(p):
    return 1.0 / (1.0 - p) if p > 0.0 else 1.0


def fused_attention_bwd_dq_kernel(q, k, v, bias, strides, seed, o, lse,
                                  dout, scale, p):
    """Launch the dq kernel (with the dk/dv kernel it replaces
    ``_bwd_kernel`` and ``_bwd_kernel_long``; alone it replaces
    ``_flash_dq_kernel``): the forward's operands plus o, lse and dout
    [B, H, S, d] in q's type; a 16-bit operand's rows start on 16-byte
    boundaries (``_rows`` copies one that does not). Returns (dq
    [B, H, S, d] in q's type and layout, delta [B, H, S] fp32 =
    rowsum(dout * o), which the dk/dv kernel reads).

    Bound on the card: operations, 6·B·H·S²·d (q·kᵀ and dO·vᵀ again, then
    dS·k) at the input type's peak, from S 256 or so at d 64 (below, the
    bytes). bfloat16 and float16 run on the tensor cores (``mma.sync``
    m16n8k16, fp32 accumulators; K/V tiles double-buffered by
    ``cp.async``; dS rounded to q's type for its product); float32 up to
    d 64 too, as 3xTF32 (``attn_bwd_dq_tf32x3``: dS split into a TF32
    pair in registers), at d 128 and 256 on the SIMT cores, which ran
    faster there (design notes in ``csrc/fused_attention.cu``). ``tensor_core_launches`` counts the
    launches on the tensor cores."""
    _check_qkv(q, k, v, aligned=True)
    _check_extras(q, bias, strides, seed, p)
    B, H, S, d = q.shape
    for name, t in (("o", o), ("dout", dout)):
        _check_operand(name, t, q, aligned=True)
    _check("lse", lse, q.device, torch.float32, (B, H, S))
    dq = torch.empty_like(q)
    delta = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    fn = _fused_entry("pt_fused_attention_bwd_dq",
                      "i" "pppp" "lll" "pppppp" "p" "iiii" "fff" "p")
    with torch.cuda.device(q.device):
        rc = fn(_TYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), _ptr(bias), *strides, _ptr(seed), o.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), _strides(q, k, v, o, dout, dq), B, H, S, d,
                float(scale), float(p), _keep_scale(p), _stream(q.device))
    _raise_on(rc, "fused-attention dq")
    _launched(fused_attention_bwd_dq_kernel, _M_BWD_DQ_LAUNCH,
              on_tensor_cores(1, q.dtype, d))
    return dq, delta


fused_attention_bwd_dq_kernel.launches = 0
fused_attention_bwd_dq_kernel.tensor_core_launches = 0


def fused_attention_bwd_dkdv_kernel(q, k, v, bias, strides, seed, lse,
                                    delta, dout, scale, p, dbias_shape=None):
    """Launch the dk/dv kernel (with the dq kernel it replaces
    ``_bwd_kernel`` and ``_bwd_kernel_long``; alone it replaces
    ``_flash_dkdv_kernel``); operands as the dq kernel's, plus its delta.
    ``dbias_shape`` (B, 1|H, 1|S, S) asks for the bias gradient in fp32,
    reduced over the broadcast heads and rows (a head-broadcast bias is
    summed with fp32 atomics into a zeroed buffer). Returns (dk, dv
    [B, H, S, d] in k's and v's layouts, dbias or None).

    Bound on the card: operations, 8·B·H·S²·d (q·kᵀ and dO·vᵀ again, Pᵀ·dO
    and dSᵀ·q), as the dq kernel. bfloat16 and float16 on the tensor
    cores: Sᵀ = k·qᵀ and dPᵀ = v·dOᵀ, so Pᵀ and dSᵀ are A operands of the
    next products in registers (rounded to q's type there; dbias from the
    fp32 dS); Q, dO, lse and delta tiles double-buffered by ``cp.async``.
    float32 up to d 64 the same as 3xTF32 (``attn_bwd_dkdv_tf32x3``, Pᵀ
    and dSᵀ split into TF32 pairs), at d 128 and 256 on the SIMT cores.
    ``tensor_core_launches`` counts the launches on the tensor cores."""
    _check_qkv(q, k, v, aligned=True)
    _check_extras(q, bias, strides, seed, p)
    B, H, S, d = q.shape
    _check_operand("dout", dout, q, aligned=True)
    _check("lse", lse, q.device, torch.float32, (B, H, S))
    _check("delta", delta, q.device, torch.float32, (B, H, S))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dbias, heads, rows = None, 1, 1
    if dbias_shape is not None:
        _, heads, rows, _ = dbias_shape
        if tuple(dbias_shape) != (B, heads, rows, S) or heads not in (1, H) \
                or rows not in (1, S):
            raise ValueError("dbias_shape must be [B, 1|H, 1|S, S], got %s"
                             % (tuple(dbias_shape),))
        alloc = torch.zeros if heads == 1 < H else torch.empty
        dbias = alloc(B, heads, rows, S, dtype=torch.float32,
                      device=q.device)
    fn = _fused_entry("pt_fused_attention_bwd_dkdv",
                      "i" "pppp" "lll" "ppppppp" "ii" "p" "iiii" "fff" "p")
    with torch.cuda.device(q.device):
        rc = fn(_TYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), _ptr(bias), *strides, _ptr(seed), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), _ptr(dbias), heads, rows,
                _strides(q, k, v, dout, dk, dv), B, H, S, d, float(scale),
                float(p), _keep_scale(p), _stream(q.device))
    _raise_on(rc, "fused-attention dk/dv")
    _launched(fused_attention_bwd_dkdv_kernel, _M_BWD_DKDV_LAUNCH,
              on_tensor_cores(2, q.dtype, d))
    return dk, dv, dbias


fused_attention_bwd_dkdv_kernel.launches = 0
fused_attention_bwd_dkdv_kernel.tensor_core_launches = 0


def fused_attention_backward(q, k, v, bias, strides, seed, o, lse, dout,
                             scale, p, bias_grad=False):
    """The backward of the fused kernels: the dq kernel (which also
    writes delta), then the dk/dv kernel. Returns (dq, dk, dv, dbias);
    dbias [B, 1|H, 1|S, S] fp32 when ``bias_grad``, else None."""
    dq, delta = fused_attention_bwd_dq_kernel(q, k, v, bias, strides, seed,
                                              o, lse, dout, scale, p)
    B, H, S, _ = q.shape
    dbias_shape = _dbias_shape(bias_grad, strides, B, H, S)
    dk, dv, dbias = fused_attention_bwd_dkdv_kernel(
        q, k, v, bias, strides, seed, lse, delta, dout, scale, p,
        dbias_shape)
    return dq, dk, dv, dbias


def fused_attention_smem_bytes(which, dtype, d):
    """Dynamic shared memory a block of the forward (``which`` 0), dq (1)
    or dk/dv (2) kernel takes at head width ``d`` for operands of
    ``dtype``, as the library launches it (builds the library)."""
    fn = getattr(_build.library("fused_attention"),
                 "pt_fused_attention_smem")
    fn.argtypes, fn.restype = [_INT, _INT, _INT], _I64
    return int(fn(int(which), _TYPE_CODES[dtype], int(d)))


@functools.lru_cache(maxsize=None)
def on_tensor_cores(which, dtype, d):
    """Whether the forward (``which`` 0), dq (1) or dk/dv (2) kernel runs
    on the tensor cores for operands of ``dtype`` at head width ``d``, as
    the library itself dispatches it (builds the library)."""
    fn = getattr(_build.library("fused_attention"),
                 "pt_fused_attention_tensor_cores")
    fn.argtypes, fn.restype = [_INT, _INT, _INT], _INT
    return bool(fn(int(which), _TYPE_CODES[dtype], int(d)))


def _dbias_shape(bias_grad, strides, B, H, S):
    if not bias_grad:
        return None
    return (B, H if strides[1] else 1, S if strides[2] else 1, S)
