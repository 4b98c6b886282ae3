"""Incremental-decode attention: KV ring-cache and paged-pool writes, and
attention of the new token(s) over the cache.

Counterpart of the decode half of ``paddle_tpu/kernels/attention.py``.
Two hand-written CUDA kernels (``csrc/decode_attention.cu``) replace the
two Pallas TPU kernels of that half:

* ``decode_attention_kernel`` replaces ``_decode_fwd_kernel`` (dense ring
  cache, reached through ``attention_with_cache``);
* ``paged_attention_kernel`` replaces ``_paged_decode_fwd_kernel`` (paged
  pool, reached through ``paged_attention_cache``).

Each public function takes the plain PyTorch version for tensors on the
CPU and the kernel for tensors on a CUDA device; anything else raises.
Every capacity goes to the kernel: the TPU package's capacity threshold
for its kernel tier is not carried over.

Unlike the JAX package, whose arrays are immutable, the cache and pool
updates here write IN PLACE: copying a whole pool every decode step
would cost its full size in bytes. They still return the (same) tensor,
so call sites read like the reference's.
"""

import ctypes
import math

import torch

from ..fluid import monitor as _monitor
from . import _build

_MASKED = -1e30     # not -inf: exp(-inf - -inf) would turn empty rows NaN

_M_DECODE_LAUNCH = _monitor.counter(
    "attn_decode_kernel_dispatch_total",
    "dense decode-attention CUDA kernel launches")
_M_PAGED_LAUNCH = _monitor.counter(
    "attn_paged_kernel_dispatch_total",
    "paged decode-attention CUDA kernel launches")


# -- KV ring cache -----------------------------------------------------------
def kv_cache_update(cache, new, cache_len):
    """Write ``new`` [B, H, T, d] into the ring buffer ``cache``
    [B, H, C, d] at per-sequence slot ``cache_len % C`` (in place) and
    return ``(cache, cache_len + T)``.

    ``cache_len`` [B] int32 counts every token ever written (not clamped
    to C). One write must not cross the ring boundary; where it would,
    the start slot is clamped to C - T, as the reference's
    ``dynamic_update_slice`` clamps it."""
    B, H, C, d = cache.shape
    T = new.shape[2]
    lens = cache_len.reshape(B).to(torch.int32)
    pos = torch.clamp(torch.remainder(lens, C), max=C - T).long()
    slots = pos[:, None] + torch.arange(T, device=cache.device)[None, :]
    rows = torch.arange(B, device=cache.device)[:, None].expand(B, T)
    # advanced indices around a slice put their dims first: [B, T, H, d]
    cache[rows, :, slots, :] = new.to(cache.dtype).permute(0, 2, 1, 3)
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


def attention_with_cache(q, k_cache, v_cache, cache_len, scale=None,
                         causal_window=False):
    """Decode-step attention against a KV ring buffer.

    q [B, H, Q, d] (Q=1 for incremental decode), k_cache/v_cache
    [B, H, C, d], cache_len [B] int32 = tokens written so far, after the
    update (so the current token sees itself). Only the first
    min(cache_len, C) slots take part; slot order does not matter, so a
    wrapped ring needs no unscrambling. ``causal_window=True``
    (speculative verify, Q > 1): row r masks the columns written after
    it, which assumes the ring has not wrapped. Returns [B, H, Q, d] in
    q's dtype, accumulated in fp32."""
    d = q.shape[-1]
    scale = float(1.0 / math.sqrt(d) if scale is None else scale)
    if q.device.type == "cpu":
        return _ref_attention_cache(q, k_cache, v_cache, cache_len, scale,
                                    causal_window=causal_window)
    return decode_attention_kernel(q, k_cache, v_cache, cache_len, scale,
                                   causal_window=causal_window)


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
    the shared pool [P, H, ptok, d] (in place) and return
    ``(pool, cache_len + T)``. Token t of slot b lands at logical ring
    position (cache_len[b] + t) % (npages * ptok); unlike the dense ring
    a write may cross page and ring boundaries."""
    P, H, ptok, d = pool.shape
    B, _, T, _ = new.shape
    cap = page_table.shape[1] * ptok
    lens = cache_len.reshape(B).to(torch.int32)
    pos = torch.remainder(
        lens.long()[:, None] + torch.arange(T, device=pool.device)[None, :],
        cap)                                                   # [B, T]
    page = torch.gather(page_table.long(), 1, pos // ptok)     # [B, T]
    vals = new.to(pool.dtype).permute(0, 2, 1, 3).reshape(B * T, H, d)
    pool[page.reshape(-1), :, (pos % ptok).reshape(-1), :] = vals
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
                          scale=None):
    """Decode-step attention against a PAGED KV cache.

    q [B, H, Q, d], pools [P, H, ptok, d], page_table [B, npages] int32,
    cache_len [B] int32 (after the update). Live slots are the first
    min(cache_len, npages * ptok) logical positions in table order; the
    result equals ``attention_with_cache`` of the gathered cache."""
    d = q.shape[-1]
    scale = float(1.0 / math.sqrt(d) if scale is None else scale)
    if q.device.type == "cpu":
        return _ref_attention_cache(q, gather_paged_cache(k_pool, page_table),
                                    gather_paged_cache(v_pool, page_table),
                                    cache_len, scale)
    return paged_attention_kernel(q, k_pool, v_pool, page_table, cache_len,
                                  scale)


# -- CUDA kernels -------------------------------------------------------------
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# a key row is copied in 16-byte pieces by a group of 2..32 lanes
# (csrc/decode_attention.cu), so its bytes must be one of these
_ROW_BYTES = (32, 64, 128, 256, 512)
_VOIDP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _entry(name, n_ptrs, n_ints):
    """The C entry ``name`` of the decode-attention library, with its
    argument types declared: pointers, ints, the scale, the stream."""
    fn = getattr(_build.library("decode_attention"), name)
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
        raise TypeError("the decode-attention kernels take float32 or "
                        "bfloat16, got %s" % q.dtype)
    if q.dim() != 4 or min(q.shape) < 1 or \
            q.shape[3] * q.element_size() not in _ROW_BYTES:
        raise ValueError("q must be [B, H, Q, d] with d * itemsize one of "
                         "%s bytes, got %s %s" % (_ROW_BYTES, tuple(q.shape),
                                                  q.dtype))


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d" % (what,
                                                                     rc))


def decode_attention_kernel(q, k_cache, v_cache, cache_len, scale,
                            causal_window=False):
    """Launch the dense decode kernel (replaces ``_decode_fwd_kernel``,
    ``paddle_tpu/kernels/attention.py``): q [B, H, Q, d], k/v caches
    [B, H, C, d] in q's dtype (float32 or bfloat16), cache_len [B] int32,
    all contiguous on one CUDA device; a key row of d elements spans 32 to
    512 bytes (a power of two) and the caches start 16-byte aligned, as
    fresh allocations do. Returns a new [B, H, Q, d] tensor in q's dtype.

    Bound on the card: the bytes of the live K and V rows over the HBM
    rate (3.35 TB/s on the H100 SXM); the kernel reads only live rows
    through a pipeline of asynchronous 16-byte copies, pads nothing and
    keeps the softmax carry on chip (design note in
    ``csrc/decode_attention.cu``)."""
    _check_q(q)
    B, H, Q, d = q.shape
    C = k_cache.shape[2] if k_cache.dim() == 4 else 0
    _check("k_cache", k_cache, q.device, q.dtype, (B, H, C, d), 16)
    _check("v_cache", v_cache, q.device, q.dtype, (B, H, C, d), 16)
    _check("cache_len", cache_len, q.device, torch.int32, (B,))
    if C < 1:
        raise ValueError("k_cache must hold at least one slot")
    out = torch.empty_like(q)
    fn = _entry("pt_decode_attention_" + _DTYPES[q.dtype], 5, 6)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                cache_len.data_ptr(), out.data_ptr(), B, H, Q, d, C,
                int(bool(causal_window)), float(scale), stream)
    _raise_on(rc, "decode-attention")
    decode_attention_kernel.launches += 1
    _M_DECODE_LAUNCH.inc()
    return out


decode_attention_kernel.launches = 0


def paged_attention_kernel(q, k_pool, v_pool, page_table, cache_len, scale):
    """Launch the paged decode kernel (replaces
    ``_paged_decode_fwd_kernel``, ``paddle_tpu/kernels/attention.py``;
    same bound and design as ``decode_attention_kernel``, whose template
    it shares): q [B, H, Q, d], pools [P, H, ptok, d]
    in q's dtype, page_table [B, npages] int32, cache_len [B] int32, all
    contiguous on one CUDA device, with the same head-width and alignment
    terms. Each block reads its own page indices
    from the table; the dense cache is never materialised. Table entries
    must index the pool (the sessions guarantee it; checking here would
    sync the host every step). Returns a new [B, H, Q, d] tensor in q's
    dtype."""
    _check_q(q)
    B, H, Q, d = q.shape
    P, ptok = (k_pool.shape[0], k_pool.shape[2]) if k_pool.dim() == 4 \
        else (0, 0)
    npages = page_table.shape[1] if page_table.dim() == 2 else 0
    _check("k_pool", k_pool, q.device, q.dtype, (P, H, ptok, d), 16)
    _check("v_pool", v_pool, q.device, q.dtype, (P, H, ptok, d), 16)
    _check("page_table", page_table, q.device, torch.int32, (B, npages))
    _check("cache_len", cache_len, q.device, torch.int32, (B,))
    if P < 1 or ptok < 1 or npages < 1:
        raise ValueError("the pool and the page table must be non-empty")
    out = torch.empty_like(q)
    fn = _entry("pt_paged_attention_" + _DTYPES[q.dtype], 6, 6)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                page_table.data_ptr(), cache_len.data_ptr(), out.data_ptr(),
                B, H, Q, d, ptok, npages, float(scale), stream)
    _raise_on(rc, "paged-attention")
    paged_attention_kernel.launches += 1
    _M_PAGED_LAUNCH.inc()
    return out


paged_attention_kernel.launches = 0
