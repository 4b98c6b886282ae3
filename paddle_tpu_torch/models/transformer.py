"""Transformer NMT model, its training forward through the dygraph
tracer, and its greedy decode sessions, in PyTorch.

Counterpart of ``paddle_tpu/models/transformer.py``: the encoder-decoder
``Transformer`` (``big`` is BASELINE config 5), ``loss_fn`` and
``synthetic_batch`` for teacher-forced training, its prefill /
decode-step methods, the dense ring-cache ``DecodeSession`` and the
paged ``PagedDecodeSession`` with its page pool and prefix cache, and
``run_cached_phases``, which runs one program once and feeds its fetches
to a second on the device.

The modules are dygraph ``Layer``s. Called on ``VarBase``s under
``dygraph.guard()``, the training ``forward`` traces the reference's
ops in the reference's order: the embedding's ``scale`` op, attention
as ``matmul(alpha=1/sqrt(d))``, ``+ bias``, ``softmax``, ``dropout``,
``matmul``, then ``transpose`` / ``reshape``, the residual adds from the
VarBase sugar, so ``dygraph.jit.trace`` records the reference's program
(no fused attention: the reference's training forward has none). Called
on torch tensors, the same ``forward`` and every decode method compute
directly in torch and never reach a tracer, guard or not; a session
calls ``prefill`` / ``decode_step`` / ``decode_step_paged`` eagerly, and
the self-attention over the KV cache runs in the CUDA decode kernels of
``kernels/attention.py`` (their plain versions on the CPU).

Module and parameter paths match the reference's ``named_parameters()``
(``enc_0.attn.q_fc.weight``, ...), so ``load_jax_params`` carries a
reference model's weights across unchanged; under one
``unique_name.guard()`` the parameters' names match too. KV caches and
pools are updated in place (see ``kernels/attention.py``); tokens and
lengths cross the decode-step boundary as int32 device tensors, and the
public results are int64 numpy arrays, as in the reference. The
model's entry points run their fp32 products without TF32
(``fp32_products``), as the executor and the dygraph guard do.
"""

import collections
import hashlib
import math
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import fp32_products
from ..fluid import monitor
from ..fluid.dygraph.base import VarBase, _tracer, device_of
from ..fluid.dygraph.layers import Layer
from ..fluid.dygraph.nn import Embedding, LayerNorm, Linear
from ..fluid.resilience import Overloaded
from ..kernels.attention import (attention_with_cache, decode_row_width,
                                 kv_cache_update, paged_attention_cache,
                                 paged_kv_cache_update)


def _op(type, inputs, outs, attrs=None):
    return _tracer().trace_op(type, inputs, outs, attrs or {})


def _reshape(x, shape):
    (out,) = _op("reshape", {"X": [x]}, ["Out"], {"shape": list(shape)})
    return out


def _transpose(x, perm):
    (out,) = _op("transpose", {"X": [x]}, ["Out"], {"axis": list(perm)})
    return out


def _matmul(x, y, transpose_y=False, alpha=1.0):
    (out,) = _op("matmul", {"X": [x], "Y": [y]}, ["Out"],
                 {"transpose_X": False, "transpose_Y": transpose_y,
                  "alpha": alpha})
    return out


def _dropout(x, p, training):
    """Dropout at ``p`` in training: the ``dropout`` op (upscale in
    train) on a VarBase, ``F.dropout`` on a tensor."""
    if not (training and p):
        return x
    if isinstance(x, VarBase):
        (out,) = _op("dropout", {"X": [x]}, ["Out"],
                     {"dropout_prob": p,
                      "dropout_implementation": "upscale_in_train"})
        return out
    return F.dropout(x, p)


class MultiHeadAttention(Layer):
    def __init__(self, d_model, n_heads, dropout_rate=0.1, *, device=None,
                 generator=None):
        super().__init__()
        self.n_heads = n_heads
        self.d_key = d_model // n_heads
        self.dropout_rate = dropout_rate
        kw = dict(device=device, generator=generator)
        self.q_fc = Linear(d_model, d_model, **kw)
        self.k_fc = Linear(d_model, d_model, **kw)
        self.v_fc = Linear(d_model, d_model, **kw)
        self.out_fc = Linear(d_model, d_model, **kw)

    def _split(self, t):
        """[B, S, H*d] -> [B, H, S, d]."""
        if isinstance(t, VarBase):
            t = _reshape(t, [t.shape[0], -1, self.n_heads, self.d_key])
            return _transpose(t, [0, 2, 1, 3])
        t = t.reshape(t.shape[0], -1, self.n_heads, self.d_key)
        return t.transpose(1, 2)

    def _q_head(self, q):
        return self._split(self.q_fc(q))

    def _kv_heads(self, kv):
        """Projected split-head K/V [B, H, S, d]: what prefill writes into
        the KV caches, and the precomputed cross-attention K/V."""
        return self._split(self.k_fc(kv)), self._split(self.v_fc(kv))

    def _attend(self, qh, kh, vh, bias):
        if isinstance(qh, VarBase):
            scores = _matmul(qh, kh, transpose_y=True,
                             alpha=1.0 / math.sqrt(self.d_key))
            if bias is not None:
                scores = scores + bias
            (w,) = _op("softmax", {"X": [scores]}, ["Out"], {"axis": -1})
            w = _dropout(w, self.dropout_rate, self.training)
            return self._merge_out(_matmul(w, vh))
        scores = torch.matmul(qh, kh.transpose(-1, -2)) * (
            1.0 / math.sqrt(self.d_key))
        if bias is not None:
            scores = scores + bias
        w = _dropout(torch.softmax(scores, dim=-1), self.dropout_rate,
                     self.training)
        return self._merge_out(torch.matmul(w, vh))

    def _merge_out(self, ctx):
        if isinstance(ctx, VarBase):
            ctx = _transpose(ctx, [0, 2, 1, 3])
            return self.out_fc(_reshape(
                ctx, [ctx.shape[0], -1, self.n_heads * self.d_key]))
        ctx = ctx.transpose(1, 2)
        return self.out_fc(ctx.reshape(ctx.shape[0], -1,
                                       self.n_heads * self.d_key))

    def forward(self, q, kv, bias):
        qh = self._q_head(q)
        kh, vh = self._kv_heads(kv)
        return self._attend(qh, kh, vh, bias)

    def forward_cached(self, x, k_cache, v_cache, cache_len,
                       causal_window=False, longest=None):
        """ONE decode step of self-attention: project the incoming
        token(s), write K/V into the ring caches at slot cache_len % C
        (in place), attend q against the cache with the post-update
        length (``longest``: its largest value, where the caller holds
        it on the host; ``attention_with_cache``). Returns (out, k_cache,
        v_cache, cache_len + T)."""
        qh = self._q_head(x).contiguous()
        kh, vh = self._kv_heads(x)
        k_cache, new_len = kv_cache_update(k_cache, kh, cache_len)
        v_cache, _ = kv_cache_update(v_cache, vh, cache_len)
        ctx = attention_with_cache(qh, k_cache, v_cache, new_len,
                                   scale=1.0 / math.sqrt(self.d_key),
                                   causal_window=causal_window,
                                   longest=longest)
        return self._merge_out(ctx), k_cache, v_cache, new_len

    def forward_paged(self, x, k_pool, v_pool, page_table, cache_len,
                      longest=None):
        """forward_cached against the shared page pools: K/V land at the
        pool page the slot's table maps its write position to, and
        attention reads back through the same table."""
        qh = self._q_head(x).contiguous()
        kh, vh = self._kv_heads(x)
        k_pool, new_len = paged_kv_cache_update(k_pool, kh, page_table,
                                                cache_len)
        v_pool, _ = paged_kv_cache_update(v_pool, vh, page_table, cache_len)
        ctx = paged_attention_cache(qh, k_pool, v_pool, page_table, new_len,
                                    scale=1.0 / math.sqrt(self.d_key),
                                    longest=longest)
        return self._merge_out(ctx), k_pool, v_pool, new_len


class FFN(Layer):
    def __init__(self, d_model, d_inner, dropout_rate=0.1, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.fc1 = Linear(d_model, d_inner, act="relu", **kw)
        self.fc2 = Linear(d_inner, d_model, **kw)
        self.dropout_rate = dropout_rate

    def forward(self, x):
        return self.fc2(_dropout(self.fc1(x), self.dropout_rate,
                                 self.training))


class EncoderLayer(Layer):
    def __init__(self, d_model, n_heads, d_inner, dropout_rate=0.1, *,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.attn = MultiHeadAttention(d_model, n_heads, dropout_rate, **kw)
        self.ffn = FFN(d_model, d_inner, dropout_rate, **kw)
        self.ln1 = LayerNorm([d_model], begin_norm_axis=2, device=device)
        self.ln2 = LayerNorm([d_model], begin_norm_axis=2, device=device)
        self.dropout_rate = dropout_rate

    def forward(self, x, bias):
        y = self.attn(x, x, bias)
        x = self.ln1(x + _dropout(y, self.dropout_rate, self.training))
        y = self.ffn(x)
        return self.ln2(x + _dropout(y, self.dropout_rate, self.training))


class DecoderLayer(Layer):
    def __init__(self, d_model, n_heads, d_inner, dropout_rate=0.1, *,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.self_attn = MultiHeadAttention(d_model, n_heads, dropout_rate,
                                            **kw)
        self.cross_attn = MultiHeadAttention(d_model, n_heads, dropout_rate,
                                             **kw)
        self.ffn = FFN(d_model, d_inner, dropout_rate, **kw)
        self.ln1 = LayerNorm([d_model], begin_norm_axis=2, device=device)
        self.ln2 = LayerNorm([d_model], begin_norm_axis=2, device=device)
        self.ln3 = LayerNorm([d_model], begin_norm_axis=2, device=device)
        self.dropout_rate = dropout_rate

    def _tail(self, x, y, cross):
        """Residual + norm after self-attention output ``y``, then
        cross-attention (``cross(x)``) and the FFN block."""
        p, t = self.dropout_rate, self.training
        x = self.ln1(x + _dropout(y, p, t))
        x = self.ln2(x + _dropout(cross(x), p, t))
        return self.ln3(x + _dropout(self.ffn(x), p, t))

    def forward(self, x, enc, self_bias, cross_bias):
        y = self.self_attn(x, x, self_bias)
        return self._tail(x, y, lambda h: self.cross_attn(h, enc,
                                                          cross_bias))

    def forward_prefill(self, x, enc, self_bias, cross_bias, k_cache,
                        v_cache, cache_len):
        """Prompt pass: the math of forward() while also writing this
        layer's prompt K/V into the ring caches (cache_len = 0, so slots
        0..T-1)."""
        qh = self.self_attn._q_head(x)
        kh, vh = self.self_attn._kv_heads(x)
        k_cache, _ = kv_cache_update(k_cache, kh, cache_len)
        v_cache, _ = kv_cache_update(v_cache, vh, cache_len)
        y = self.self_attn._attend(qh, kh, vh, self_bias)
        return self._tail(x, y, lambda h: self.cross_attn(
            h, enc, cross_bias)), k_cache, v_cache

    def _cross_cached(self, cross_k, cross_v, cross_bias):
        return lambda h: self.cross_attn._attend(
            self.cross_attn._q_head(h), cross_k, cross_v, cross_bias)

    def forward_step(self, x, cross_k, cross_v, k_cache, v_cache,
                     cache_len, cross_bias, causal_window=False,
                     longest=None):
        """ONE decode step: cached self-attention (q_len=1 against the
        KV ring) and cross-attention against the precomputed encoder
        K/V."""
        y, k_cache, v_cache, new_len = self.self_attn.forward_cached(
            x, k_cache, v_cache, cache_len, causal_window=causal_window,
            longest=longest)
        x = self._tail(x, y, self._cross_cached(cross_k, cross_v,
                                                cross_bias))
        return x, k_cache, v_cache, new_len

    def forward_step_paged(self, x, cross_k, cross_v, k_pool, v_pool,
                           page_table, cache_len, cross_bias, longest=None):
        """forward_step with the self-attention KV state in the shared
        page pools."""
        y, k_pool, v_pool, new_len = self.self_attn.forward_paged(
            x, k_pool, v_pool, page_table, cache_len, longest=longest)
        x = self._tail(x, y, self._cross_cached(cross_k, cross_v,
                                                cross_bias))
        return x, k_pool, v_pool, new_len


class Transformer(Layer):
    """Encoder-decoder transformer (NMT). Weights are drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the guard's
    under ``dygraph.guard()``, else the card)."""

    def __init__(self, src_vocab, tgt_vocab, d_model=512, n_heads=8,
                 d_inner=2048, n_layers=6, max_len=256, dropout_rate=0.1,
                 seq_parallel=False, model_axis=None, *, device=None, seed=0):
        if model_axis is not None or seq_parallel:
            raise NotImplementedError(
                "model_axis (Megatron tensor parallelism) and seq_parallel "
                "(ring / Ulysses attention) need a device mesh, which the "
                "port has not ported yet (ROADMAP queue 7)")
        super().__init__()
        device = device_of(device)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        kw = dict(device=device, generator=gen)
        self.d_model = d_model
        self.n_heads = n_heads
        self.max_len = max_len
        self.src_emb = Embedding([src_vocab, d_model], **kw)
        self.tgt_emb = Embedding([tgt_vocab, d_model], **kw)
        self.pos_emb = Embedding([max_len, d_model], **kw)
        self.enc_layers = [EncoderLayer(d_model, n_heads, d_inner,
                                        dropout_rate, **kw)
                           for _ in range(n_layers)]
        self.dec_layers = [DecoderLayer(d_model, n_heads, d_inner,
                                        dropout_rate, **kw)
                           for _ in range(n_layers)]
        for i, l in enumerate(self.enc_layers):
            self.add_sublayer("enc_%d" % i, l)
        for i, l in enumerate(self.dec_layers):
            self.add_sublayer("dec_%d" % i, l)
        self.proj = Linear(d_model, tgt_vocab, **kw)
        self.dropout_rate = dropout_rate
        self.last_checkpoints = []

    def checkpoint_vars(self, program):
        """The layer-output Variables of the last traced forward (each
        encoder and decoder layer's), found in ``program`` (the
        ``jit.trace`` output): give them to
        ``RecomputeOptimizer._set_checkpoints`` to recompute each layer
        in the backward instead of keeping its activations."""
        blk = program.global_block()
        return [blk.var(n) for n in self.last_checkpoints]

    def _checkpoint(self, x):
        if isinstance(x, VarBase):
            self.last_checkpoints.append(x.name)

    @staticmethod
    def big(src_vocab=32000, tgt_vocab=32000, **kw):
        return Transformer(src_vocab, tgt_vocab, d_model=1024, n_heads=16,
                           d_inner=4096, n_layers=6, **kw)

    @staticmethod
    def tiny(src_vocab=512, tgt_vocab=512, **kw):
        return Transformer(src_vocab, tgt_vocab, d_model=32, n_heads=4,
                           d_inner=64, n_layers=2, max_len=64, **kw)

    def _embed(self, ids, emb, pos_ids):
        x = emb(ids)
        if isinstance(x, VarBase):
            (x,) = _op("scale", {"X": [x]}, ["Out"],
                       {"scale": math.sqrt(self.d_model), "bias": 0.0,
                        "bias_after_scale": True})
            x = x + self.pos_emb(pos_ids)
        else:
            x = x * math.sqrt(self.d_model) + self.pos_emb(pos_ids)
        return _dropout(x, self.dropout_rate, self.training)

    def _encode(self, src_ids, pos_src, src_bias):
        enc = self._embed(src_ids, self.src_emb, pos_src)
        for l in self.enc_layers:
            enc = l(enc, src_bias)
            self._checkpoint(enc)
        return enc

    @fp32_products()
    def forward(self, src_ids, tgt_ids, pos_src, pos_tgt, causal_bias,
                src_bias=None):
        """Teacher-forced logits [B, S_tgt, V]. src_bias: optional
        [B, 1, 1, S_src] additive padding mask. On VarBases under
        ``dygraph.guard()`` every op is traced (``jit.trace`` records
        it), and ``last_checkpoints`` names each layer's output; on torch
        tensors it runs in torch."""
        self.last_checkpoints = []
        enc = self._encode(src_ids, pos_src, src_bias)
        dec = self._embed(tgt_ids, self.tgt_emb, pos_tgt)
        for l in self.dec_layers:
            dec = l(dec, enc, causal_bias, src_bias)
            self._checkpoint(dec)
        return self.proj(dec)

    # -- incremental decode (prefill + per-token step) -----------------------
    @fp32_products()
    def prefill(self, src_ids, tgt_ids, pos_src, pos_tgt, causal_bias,
                cache_len, *rest):
        """Run the encoder and the prompt through the decoder stack once,
        writing each layer's prompt K/V into its ring caches and
        precomputing the cross-attention K/V. ``rest`` is L self-K
        caches, L self-V caches [B, H, C, d] (zeros, C >= prompt length),
        then an optional src padding bias. Returns (prompt logits
        [B, P, V], L K caches, L V caches, L cross-K, L cross-V)."""
        L = len(self.dec_layers)
        k_caches, v_caches = rest[:L], rest[L:2 * L]
        src_bias = rest[2 * L] if len(rest) > 2 * L else None
        enc = self._encode(src_ids, pos_src, src_bias)
        dec = self._embed(tgt_ids, self.tgt_emb, pos_tgt)
        out_k, out_v, cross_k, cross_v = [], [], [], []
        for l, kc, vc in zip(self.dec_layers, k_caches, v_caches):
            # stored contiguous: every decode step multiplies by them, and
            # a strided view would be copied again on each of those steps
            ck, cv = l.cross_attn._kv_heads(enc)
            cross_k.append(ck.contiguous())
            cross_v.append(cv.contiguous())
            dec, k_new, v_new = l.forward_prefill(
                dec, enc, causal_bias, src_bias, kc, vc, cache_len)
            out_k.append(k_new)
            out_v.append(v_new)
        return tuple([self.proj(dec)] + out_k + out_v + cross_k + cross_v)

    def _decode_input(self, tok, cache_len):
        # a [B, 1, 1] id keeps the q_len=1 axis through lookup_table's
        # trailing-dim squeeze; the position is the pre-update length
        B = tok.shape[0]
        return self._embed(tok.reshape(B, 1, 1), self.tgt_emb,
                           cache_len.reshape(B, 1, 1))

    @fp32_products()
    def decode_step(self, tok, finished, end_ids, cache_len, *rest,
                    longest=None):
        """ONE greedy decode step (q_len=1) against the KV ring caches.
        ``rest`` is L cross-K, L cross-V, L self-K caches, L self-V
        caches, then an optional src padding bias. ``longest`` (a Python
        int, optional) is the largest new_len as the caller holds it on
        the host; the decode kernels cut their key axis by it. Returns
        (next_tok [B, 1] int32, new_len [B] int32, finished' [B, 1] bool,
        L K caches, L V caches)."""
        L = len(self.dec_layers)
        cross_k, cross_v = rest[:L], rest[L:2 * L]
        k_caches, v_caches = rest[2 * L:3 * L], rest[3 * L:4 * L]
        src_bias = rest[4 * L] if len(rest) > 4 * L else None
        x = self._decode_input(tok, cache_len)
        new_k, new_v, new_len = [], [], None
        for l, ck, cv, kc, vc in zip(self.dec_layers, cross_k, cross_v,
                                     k_caches, v_caches):
            x, k_new, v_new, new_len = l.forward_step(
                x, ck, cv, kc, vc, cache_len, src_bias, longest=longest)
            new_k.append(k_new)
            new_v.append(v_new)
        nxt, fin = self._next_token(self.proj(x), finished, end_ids)
        return tuple([nxt, new_len, fin] + new_k + new_v)

    def _next_token(self, logits, finished, end_ids):
        """Greedy argmax (first maximum) -> end_id forcing -> finished
        mask advance."""
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = torch.where(finished, end_ids, nxt)
        return nxt, finished | (nxt == end_ids)

    @fp32_products()
    def decode_step_paged(self, tok, finished, end_ids, cache_len,
                          page_table, *rest, longest=None):
        """decode_step with the self-attention KV state in SHARED page
        pools: ``page_table`` [B, n_pages] int32 maps each slot's logical
        ring pages to pool rows (row 0 = the scratch page). ``rest`` is
        L cross-K, L cross-V, L K pools, L V pools [P, H, ptok, d], then
        an optional src padding bias; ``longest`` as ``decode_step``.
        Returns (next_tok, new_len, finished', L K pools, L V pools)."""
        L = len(self.dec_layers)
        cross_k, cross_v = rest[:L], rest[L:2 * L]
        k_pools, v_pools = rest[2 * L:3 * L], rest[3 * L:4 * L]
        src_bias = rest[4 * L] if len(rest) > 4 * L else None
        x = self._decode_input(tok, cache_len)
        new_k, new_v, new_len = [], [], None
        for l, ck, cv, kp, vp in zip(self.dec_layers, cross_k, cross_v,
                                     k_pools, v_pools):
            x, k_new, v_new, new_len = l.forward_step_paged(
                x, ck, cv, kp, vp, page_table, cache_len, src_bias,
                longest=longest)
            new_k.append(k_new)
            new_v.append(v_new)
        nxt, fin = self._next_token(self.proj(x), finished, end_ids)
        return tuple([nxt, new_len, fin] + new_k + new_v)

    @fp32_products()
    def decode_step_draft(self, tok, finished, end_ids, cache_len, *rest,
                          longest=None):
        """decode_step through only the first len(rest)//4 decoder layers:
        the self-speculative draft (the same embeddings and output
        projection, its own shallow KV caches). ``rest`` is Ld cross-K,
        Ld cross-V, Ld K caches, Ld V caches; ``longest`` as
        ``decode_step``. The draft only sets how many proposals the
        verify step accepts, never which tokens are emitted."""
        Ld = len(rest) // 4
        cross_k, cross_v = rest[:Ld], rest[Ld:2 * Ld]
        k_caches, v_caches = rest[2 * Ld:3 * Ld], rest[3 * Ld:4 * Ld]
        x = self._decode_input(tok, cache_len)
        new_k, new_v, new_len = [], [], None
        for l, ck, cv, kc, vc in zip(self.dec_layers[:Ld], cross_k, cross_v,
                                     k_caches, v_caches):
            x, k_new, v_new, new_len = l.forward_step(
                x, ck, cv, kc, vc, cache_len, None, longest=longest)
            new_k.append(k_new)
            new_v.append(v_new)
        nxt, fin = self._next_token(self.proj(x), finished, end_ids)
        return tuple([nxt, new_len, fin] + new_k + new_v)

    @fp32_products()
    def verify_step(self, toks, step_ids, cache_len, *rest, longest=None):
        """Speculative verify: consume k proposed tokens ``toks`` [B, k]
        int32 in one pass. They are embedded at positions cache_len +
        ``step_ids`` ([1, k] int32, arange(k)), written into the ring
        caches, and attended with the per-row causal window: q row r sees
        the columns < cache_len + r + 1, what r + 1 single-token steps
        would have seen. ``rest`` is L cross-K, L cross-V, L K caches, L V
        caches; ``longest`` is the largest cache_len + k as the caller
        holds it on the host. Returns (greedy [B, k] int32, new_len [B],
        L K caches, L V caches): greedy[:, i] is the target's next token
        after toks[:, :i+1]. The caller keeps the window inside the ring
        (no wraparound) and rolls a rejected tail back by its length:
        rows above the length are masked until overwritten."""
        L = len(self.dec_layers)
        cross_k, cross_v = rest[:L], rest[L:2 * L]
        k_caches, v_caches = rest[2 * L:3 * L], rest[3 * L:4 * L]
        B, K = toks.shape
        pos = cache_len.reshape(B, 1, 1) + step_ids.reshape(1, K, 1)
        x = self._embed(toks.reshape(B, K, 1), self.tgt_emb, pos)
        new_k, new_v, new_len = [], [], None
        for l, ck, cv, kc, vc in zip(self.dec_layers, cross_k, cross_v,
                                     k_caches, v_caches):
            x, k_new, v_new, new_len = l.forward_step(
                x, ck, cv, kc, vc, cache_len, None, causal_window=True,
                longest=longest)
            new_k.append(k_new)
            new_v.append(v_new)
        greedy = torch.argmax(self.proj(x), dim=-1).to(torch.int32)
        return tuple([greedy, new_len] + new_k + new_v)


class EncoderTower(Layer):
    """Encoder-only LM tower (embed -> N encoder layers -> vocab
    projection), the reference's: every layer boundary carries the same
    [B, S, D] activation. ``last_checkpoints`` names each layer's output
    var of the last traced forward (recompute's checkpoints, and the
    reference's pipeline cut candidates)."""

    def __init__(self, vocab, d_model=64, n_heads=4, d_inner=128,
                 n_layers=4, max_len=64, dropout_rate=0.0, model_axis=None,
                 *, device=None, seed=0):
        if model_axis is not None:
            raise NotImplementedError(
                "model_axis (Megatron tensor parallelism) needs a device "
                "mesh, which the port has not ported yet (ROADMAP queue 7)")
        super().__init__()
        device = device_of(device)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        kw = dict(device=device, generator=gen)
        self.d_model = d_model
        self.emb = Embedding([vocab, d_model], **kw)
        self.pos_emb = Embedding([max_len, d_model], **kw)
        self.layers_ = [EncoderLayer(d_model, n_heads, d_inner,
                                     dropout_rate, **kw)
                        for _ in range(n_layers)]
        for i, l in enumerate(self.layers_):
            self.add_sublayer("tower_%d" % i, l)
        self.proj = Linear(d_model, vocab, **kw)
        self.dropout_rate = dropout_rate
        self.last_checkpoints = []

    checkpoint_vars = Transformer.checkpoint_vars

    @fp32_products()
    def forward(self, ids, pos):
        self.last_checkpoints = []
        x = self.emb(ids)
        (x,) = _op("scale", {"X": [x]}, ["Out"],
                   {"scale": math.sqrt(self.d_model), "bias": 0.0,
                    "bias_after_scale": True})
        x = _dropout(x + self.pos_emb(pos), self.dropout_rate,
                     self.training)
        for l in self.layers_:
            x = l(x, None)
            self.last_checkpoints.append(x.name)
        return self.proj(x)


def run_cached_phases(exe, scope, phase1, feed1, fetch1, phase2, feed2,
                      fetch2, bridge, return_numpy=True):
    """Run ``phase1`` once, then ``phase2`` fed some of phase 1's fetches
    as they are, on the device (``bridge``: phase-2 feed name -> phase-1
    fetch index), so the work of phase 1 stays out of whatever loop
    drives phase 2. The seq2seq encoder -> beam decode split uses it
    (``models/seq2seq.py``, ``run_split_infer``)."""
    outs = exe.run(phase1, feed=feed1, fetch_list=fetch1, scope=scope,
                   return_numpy=False)
    feed = dict(feed2 or {})
    for name, idx in bridge.items():
        feed[name] = outs[idx]
    return exe.run(phase2, feed=feed, fetch_list=fetch2, scope=scope,
                   return_numpy=return_numpy)


def make_causal_bias(seq_len):
    m = np.triu(np.full((seq_len, seq_len), -1e4, np.float32), k=1)
    return m.reshape(1, 1, seq_len, seq_len)


def loss_fn(logits, labels):
    """Mean token cross-entropy of traced ``logits`` [B, S, V] against
    ``labels`` [B, S, 1] int64: ``softmax_with_cross_entropy``, then
    ``reduce_sum`` over everything and ``scale`` by 1 / (B * S)."""
    ce = _op("softmax_with_cross_entropy", {"Logits": [logits],
                                            "Label": [labels]},
             ["Softmax", "Loss"], {"soft_label": False})[1]
    (total,) = _op("reduce_sum", {"X": [ce]}, ["Out"],
                   {"dim": [], "keep_dim": False, "reduce_all": True})
    (loss,) = _op("scale", {"X": [total]}, ["Out"],
                  {"scale": 1.0 / float(np.prod(labels.shape)), "bias": 0.0,
                   "bias_after_scale": True})
    return loss


def synthetic_batch(src_vocab, tgt_vocab, batch, seq_len, seed=0):
    """(src, tgt, labels [B, S, 1], pos) int64 numpy arrays, drawn as the
    reference draws them."""
    rng = np.random.RandomState(seed)
    src = rng.randint(1, src_vocab, (batch, seq_len)).astype("int64")
    tgt = rng.randint(1, tgt_vocab, (batch, seq_len)).astype("int64")
    labels = rng.randint(1, tgt_vocab, (batch, seq_len, 1)).astype("int64")
    pos = np.tile(np.arange(seq_len, dtype="int64"), (batch, 1))
    return src, tgt, labels, pos


@torch.no_grad()
def load_jax_params(model, arrays):
    """Copy weights keyed by the reference model's ``named_parameters()``
    paths (``{name: np.ndarray}``, e.g. ``enc_0.attn.q_fc.weight``) into
    ``model``. Layouts are the reference's (``Linear.weight`` is
    [in, out]), so every array is copied as it is. Raises on a missing,
    extra or mis-shaped entry."""
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(arrays))
    extra = sorted(set(arrays) - set(own))
    if missing or extra:
        raise KeyError("parameter names differ: missing %s, unexpected %s"
                       % (missing, extra))
    for name, p in own.items():
        a = np.asarray(arrays[name])
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError("%s: shape %s, model expects %s"
                             % (name, a.shape, tuple(p.shape)))
        p.copy_(torch.tensor(a, dtype=p.dtype))
    return model


# ---------------------------------------------------------------------------
# Incremental decode sessions.
# ---------------------------------------------------------------------------

_M_DECODE_STEPS = monitor.counter(
    "decode_steps_total", "decode steps dispatched")
_M_DECODE_SECONDS = monitor.histogram(
    "decode_step_seconds", "per-token decode dispatch latency (async: "
    "excludes the device sync, which happens once per generation)")
_M_DECODE_CACHE = monitor.gauge(
    "decode_cache_tokens", "live KV-cache tokens across the batch after "
    "the last generation (sum of min(len, capacity))")
_M_SLOT_JOIN = monitor.counter(
    "decode_slot_join_total", "requests prefilled into a vacant slot of "
    "a live continuous-batching decode stream")
_M_SLOT_RETIRE = monitor.counter(
    "decode_slot_retire_total", "continuous-batching slots retired "
    "(sequence finished or token budget reached)")
_M_SLOT_OCC = monitor.histogram(
    "decode_slot_occupancy", "active slots / batch width observed at "
    "each continuous-batching decode step",
    buckets=(0.0625, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
_M_SCATTER_DISPATCH = monitor.counter(
    "decode_slot_scatter_dispatch_total", "multi-tensor slot scatters "
    "of a continuous-batching join (one a join, whatever the depth)")
_M_PAGES_ALLOC = monitor.counter(
    "decode_pages_allocated_total", "KV pages taken from the paged "
    "decode free list (prompt prefills, ring growth, copy-on-write "
    "splits)")
_M_PAGES_FREED = monitor.counter(
    "decode_pages_freed_total", "KV pages returned to the paged decode "
    "free list (refcount hit zero)")
_M_PAGES_SHARED = monitor.counter(
    "decode_pages_shared_total", "KV page aliasings: a joining slot's "
    "table pointed at already-resident prefix pages")
_M_PREFIX_HIT = monitor.counter(
    "decode_prefix_hit_total", "paged joins whose (src, prompt prefix) "
    "was served from the prefix cache (prefill skipped)")
_M_PREFIX_MISS = monitor.counter(
    "decode_prefix_miss_total", "paged joins that had to prefill with "
    "prefix caching enabled")


def _model_device(model):
    return model.proj.weight.device


def _check_positions(model, src_len, prompt_len, last_pos):
    """Every position id must index the position table: on the card an
    out-of-range id is a device-side fault, not a clamped lookup."""
    if max(src_len, prompt_len, last_pos + 1) > model.max_len:
        raise ValueError(
            "positions reach %d but the model's position table holds %d "
            "(src_len=%d, prompt_len=%d)" % (max(src_len, prompt_len,
                                                 last_pos + 1),
                                             model.max_len, src_len,
                                             prompt_len))


def _check_ids(model, src, prompt):
    """Token ids come from clients: check them against the vocabularies
    on the host, for the same reason as positions."""
    for name, ids, emb in (("src", src, model.src_emb),
                           ("prompt", prompt, model.tgt_emb)):
        vocab = emb.weight.shape[0]
        if ids.size and (ids.min() < 0 or ids.max() >= vocab):
            raise ValueError("%s ids must be in [0, %d) (the vocabulary), "
                             "got [%d, %d]" % (name, vocab, ids.min(),
                                               ids.max()))


def build_decode_session(model, batch_size, src_len, prompt_len,
                         cache_capacity, end_id=1, slot_prefill=False):
    """A dense ring-cache ``DecodeSession`` over ``model`` at fixed
    shapes, on the model's device. Puts the model in eval() mode.

    ``slot_prefill=True`` also keeps the batch-1 prefill state (zero
    caches and positions) that ``session.open_stream()`` uses to prefill
    ONE request into a vacant slot of a live decode batch (continuous
    batching) without touching the other slots."""
    if cache_capacity < prompt_len:
        raise ValueError(
            "cache_capacity=%d < prompt_len=%d: the prefill write would "
            "cross the ring boundary" % (cache_capacity, prompt_len))
    _check_positions(model, src_len, prompt_len, 0)
    model.eval()
    return DecodeSession(model, batch_size, src_len, prompt_len,
                         cache_capacity, end_id, slot_prefill)


class DecodeSession:
    """Batched greedy autoregressive decoding with per-layer KV ring
    caches [B, H, C, d'] that stay on the device, d' the head width d
    rounded up to 16 bytes (``decode_row_width``; columns past d stay
    zero), so the decode kernel copies every row in 16-byte pieces.
    Tokens, lengths and the finished mask feed back as device tensors,
    so a generation syncs the host once, after the last step."""

    def __init__(self, model, batch_size, src_len, prompt_len,
                 cache_capacity, end_id=1, slot_prefill=False):
        self.model = model
        self.device = dev = _model_device(model)
        self._L = L = len(model.dec_layers)
        self.batch_size = B = int(batch_size)
        self.src_len = int(src_len)
        self.prompt_len = int(prompt_len)
        self.cache_capacity = C = int(cache_capacity)
        self.end_id = int(end_id)
        self.n_heads = H = model.n_heads
        self.d_key = model.d_model // model.n_heads
        d = decode_row_width(self.d_key, torch.float32)
        self._caches = [torch.zeros(B, H, C, d, device=dev)
                        for _ in range(2 * L)]
        self._pos_src = torch.arange(src_len, device=dev).repeat(B, 1)
        self._pos_tgt = torch.arange(prompt_len, device=dev).repeat(B, 1)
        self._causal = torch.from_numpy(make_causal_bias(prompt_len)).to(dev)
        self._end_ids = torch.tensor([self.end_id], dtype=torch.int32,
                                     device=dev)
        self.slot_prefill = bool(slot_prefill)
        if self.slot_prefill:
            self._caches1 = [torch.zeros(1, H, C, d, device=dev)
                             for _ in range(2 * L)]

    def _check_request(self, src, prompt, plens, max_new_tokens):
        """src, prompt and prompt_lens [B] as int64 numpy arrays, checked
        against the session's shapes and tables."""
        B = self.batch_size
        src = np.ascontiguousarray(src, np.int64)
        prompt = np.ascontiguousarray(prompt, np.int64)
        plens = np.asarray(plens, np.int64).reshape(B)
        if src.shape != (B, self.src_len) or \
                prompt.shape != (B, self.prompt_len):
            raise ValueError(
                "shape mismatch: session built for src %s / prompt %s, "
                "got %s / %s" % ((B, self.src_len), (B, self.prompt_len),
                                 src.shape, prompt.shape))
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if plens.min() < 1 or plens.max() > self.prompt_len:
            raise ValueError("prompt_lens must be in [1, %d]"
                             % self.prompt_len)
        _check_ids(self.model, src, prompt)
        return src, prompt, plens

    def _prefill(self, src, prompt, caches):
        """Prefill (prompt logits, L K caches, L V caches, L cross-K, L
        cross-V) of int64 numpy ``src``/``prompt`` into ``caches``, zeroed
        first: this session's batch caches, or the batch-1 slot-prefill
        ones."""
        dev = self.device
        n = src.shape[0]
        for c in caches:
            c.zero_()
        return self.model.prefill(
            torch.from_numpy(src).to(dev), torch.from_numpy(prompt).to(dev),
            self._pos_src[:n], self._pos_tgt[:n], self._causal,
            torch.zeros(n, dtype=torch.int32, device=dev), *caches)

    @torch.no_grad()
    def generate(self, src, prompt, prompt_lens, max_new_tokens):
        """Greedy-decode ``max_new_tokens`` tokens per sequence.

        src [B, src_len] int64; prompt [B, prompt_len] int64 right-padded
        (first token is the GO symbol); prompt_lens [B] = true prompt
        lengths (pad slots are masked out of attention and overwritten by
        later decode writes). Returns (tokens [B, max_new_tokens] int64,
        finished [B] bool) as numpy arrays."""
        B, L, dev = self.batch_size, self._L, self.device
        src, prompt, plens = self._check_request(src, prompt, prompt_lens,
                                                 max_new_tokens)
        _check_positions(self.model, self.src_len, self.prompt_len,
                         int(plens.max()) + max_new_tokens - 2)
        outs = self._prefill(src, prompt, self._caches)
        kc, vc = outs[1:1 + L], outs[1 + L:1 + 2 * L]
        cross = outs[1 + 2 * L:1 + 4 * L]
        last = torch.from_numpy(plens - 1).to(dev)
        first = outs[0][torch.arange(B, device=dev), last].argmax(-1)
        tok = first.to(torch.int32)[:, None]
        finished = tok == self.end_id
        cache_len = torch.from_numpy(plens.astype(np.int32)).to(dev)
        toks = [tok]
        for step in range(max_new_tokens - 1):
            t0 = time.perf_counter()
            # the lengths after this step's write, as the host knows them
            outs = self.model.decode_step(
                tok, finished, self._end_ids, cache_len, *cross, *kc, *vc,
                longest=int(plens.max()) + step + 1)
            tok, cache_len, finished = outs[0], outs[1], outs[2]
            toks.append(tok)
            _M_DECODE_STEPS.inc()
            _M_DECODE_SECONDS.observe(time.perf_counter() - t0)
        _M_DECODE_CACHE.set(float(np.minimum(
            plens + max_new_tokens, self.cache_capacity).sum()))
        tokens = torch.cat(toks, dim=1).cpu().numpy().astype(np.int64)
        return tokens, finished.cpu().numpy().reshape(B)

    def open_stream(self):
        """A ``ContinuousDecodeSession`` over this session's model: a live
        fixed-width decode batch that requests join mid-stream (batch-1
        prefill into a vacant slot) and leave as they finish, without
        draining the batch. Needs ``slot_prefill=True``."""
        if not self.slot_prefill:
            raise ValueError(
                "continuous batching needs the batch-1 slot-prefill "
                "state: build_decode_session(..., slot_prefill=True)")
        return ContinuousDecodeSession(self)


class _SlotState:
    """Host-side bookkeeping for one active continuous-batching slot."""

    def __init__(self, tokens, budget):
        self.tokens = tokens        # emitted token ids (ints, grows)
        self.budget = int(budget)   # max_new_tokens for this request


def _slot_scatter(state, updates, slot):
    """Write the batch-1 rows ``updates`` into row ``slot`` of each batch
    tensor in ``state`` (ring caches, cross K/V), in place, in one
    multi-tensor copy: on the card a few launches for every tensor
    together, where a copy per tensor would launch 4L times a join."""
    torch._foreach_copy_([s[slot] for s in state], [u[0] for u in updates])
    return state


class ContinuousDecodeSession:
    """Slot-level continuous batching over a dense ``DecodeSession``: a
    decode batch of FIXED width (``session.batch_size`` slots) stepped
    as a whole, where between steps finished slots retire and waiting
    requests join vacant ones (batch-1 prefill, then its K/V copied into
    the slot's rows of the live caches by ``_slot_scatter``), so the
    batch stays full under ragged generation lengths.

    Tokens [B, 1], the finished mask and the lengths stay on the device;
    each slot's length is also kept on the host (its prompt length plus
    its steps, 1 when idle), and its maximum is passed to the decode
    step as ``longest``, so no step reads the lengths on the card. A
    step syncs the host once, for the tokens and finished flags the
    scheduler needs. Slot rows are independent through the whole step,
    so a request's tokens are the same whether it shares the batch or
    runs alone.

    Single-threaded by design: serialise calls externally (the serving
    tier holds one dispatch lock)."""

    def __init__(self, session):
        s = self._s = session
        B, H, C, L, dev = (s.batch_size, s.n_heads, s.cache_capacity, s._L,
                           s.device)
        dp = decode_row_width(s.d_key, torch.float32)
        self._tok = torch.full((B, 1), s.end_id, dtype=torch.int32,
                               device=dev)
        self._fin = torch.ones(B, 1, dtype=torch.bool, device=dev)
        # idle slots sit at cache_len=1 over zero caches: attention sees
        # one all-zero key (a finite softmax), and their position ids stay
        # in range however long the stream runs (``_clamp_idle``)
        self._len = torch.ones(B, dtype=torch.int32, device=dev)
        self._hlen = np.ones(B, np.int64)
        self._kc = [torch.zeros(B, H, C, dp, device=dev) for _ in range(L)]
        self._vc = [torch.zeros(B, H, C, dp, device=dev) for _ in range(L)]
        self._cross = [torch.zeros(B, H, s.src_len, s.d_key, device=dev)
                       for _ in range(2 * L)]
        self._slots = [None] * B    # _SlotState or None (vacant)

    @property
    def width(self):
        return self._s.batch_size

    @property
    def active_count(self):
        return sum(st is not None for st in self._slots)

    def vacant_slots(self):
        return [i for i, st in enumerate(self._slots) if st is None]

    @torch.no_grad()
    def join(self, src, prompt, prompt_len=None, max_new_tokens=1):
        """Prefill ONE request into a vacant slot while the rest of the
        batch keeps its decode state. src: [src_len] or [1, src_len];
        prompt likewise. Returns ``(slot, done)`` where ``done`` is None
        while the request decodes, or ``(tokens [n] int64, finished)`` if
        it completed at join (budget 1, or the first token is end_id).
        Raises RuntimeError when no slot is vacant: callers queue and
        retry after a ``step`` retires one."""
        s = self._s
        vacant = self.vacant_slots()
        if not vacant:
            raise RuntimeError(
                "no vacant slot (all %d active) — step() until one "
                "retires" % s.batch_size)
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        src = np.ascontiguousarray(src, np.int64).reshape(1, s.src_len)
        prompt = np.ascontiguousarray(prompt, np.int64).reshape(
            1, s.prompt_len)
        plen = int(s.prompt_len if prompt_len is None else prompt_len)
        if not 1 <= plen <= s.prompt_len:
            raise ValueError("prompt_len must be in [1, %d], got %d"
                             % (s.prompt_len, plen))
        _check_positions(s.model, s.src_len, s.prompt_len,
                         plen + int(max_new_tokens) - 2)
        _check_ids(s.model, src, prompt)
        slot = vacant[0]
        outs = s._prefill(src, prompt, s._caches1)
        first = int(outs[0][0, plen - 1].argmax())
        _M_SLOT_JOIN.inc()
        if int(max_new_tokens) == 1 or first == s.end_id:
            _M_SLOT_RETIRE.inc()
            return slot, (np.array([first], np.int64), first == s.end_id)
        L = s._L
        _slot_scatter(self._kc + self._vc + self._cross, outs[1:1 + 4 * L],
                      slot)
        _M_SCATTER_DISPATCH.inc()
        self._tok[slot, 0] = first
        self._fin[slot, 0] = False
        self._len[slot] = plen
        self._hlen[slot] = plen
        self._slots[slot] = _SlotState([first], max_new_tokens)
        return slot, None

    @torch.no_grad()
    def step(self):
        """ONE decode step of the whole batch. Appends each active slot's
        new token, retires slots that finished or exhausted their budget,
        and returns the completions ``[(slot, tokens [n] int64,
        finished), ...]``."""
        s = self._s
        if self.active_count == 0:
            raise RuntimeError("step() with no active slot — join first")
        _M_SLOT_OCC.observe(self.active_count / float(s.batch_size))
        self._clamp_idle()
        t0 = time.perf_counter()
        outs = s.model.decode_step(
            self._tok, self._fin, s._end_ids, self._len, *self._cross,
            *self._kc, *self._vc, longest=int(self._hlen.max()) + 1)
        L = s._L
        self._tok, self._len, self._fin = outs[0], outs[1], outs[2]
        self._kc = list(outs[3:3 + L])
        self._vc = list(outs[3 + L:3 + 2 * L])
        self._hlen += 1
        _M_DECODE_STEPS.inc()
        _M_DECODE_SECONDS.observe(time.perf_counter() - t0)
        # the step's one sync: tokens and finished flags in one copy
        got = torch.cat([self._tok, self._fin.to(torch.int32)],
                        dim=1).cpu().numpy()
        completed = []
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            st.tokens.append(int(got[slot, 0]))
            finished = bool(got[slot, 1])
            if finished or len(st.tokens) >= st.budget:
                completed.append((slot, np.array(st.tokens, np.int64),
                                  finished))
                self._slots[slot] = None
                self._fin[slot, 0] = True
                _M_SLOT_RETIRE.inc()
        return completed

    def _clamp_idle(self):
        """Pin idle slots to cache_len=1 before each step, so a long-lived
        stream never walks their (discarded) position ids past the
        position table. A slot is idle exactly where its finished flag is
        set (a step retires every slot it finishes, and a retired slot's
        flag is set), so the card clamps by that flag and the host sends
        nothing."""
        self._hlen[[st is None for st in self._slots]] = 1
        self._len = torch.where(self._fin.view(-1), 1, self._len)


def _paged_pack(pools, caches, rows):
    """Scatter one prefilled request's [1, H, C, d] ring caches into its
    pool pages, in place. ``rows`` [n_pages] holds the slot's pool page
    per logical page; the unallocated tail points at scratch page 0."""
    for pool, c in zip(pools, caches):
        _, h, ptok, d = pool.shape
        pool[rows] = c[0].reshape(h, -1, ptok, d).transpose(0, 1)
    return pools


def _paged_cow(pools, src_page, dst_page):
    """Copy one pool page across all pools: the copy-on-write split."""
    for p in pools:
        p[dst_page].copy_(p[src_page])
    return pools


class _PagePool:
    """Host-side free list + refcounts over the shared KV page pool.

    Page 0 is the permanently resident SCRATCH page: every unallocated
    table entry (and every idle slot's whole table) points at it, so the
    decode step writes unconditionally; its contents are never read
    through a live table entry (attention masks by cache_len)."""

    def __init__(self, n_pages):
        self.n_pages = int(n_pages)
        # pop() takes from the end -> lowest page ids allocated first
        self._free = list(range(self.n_pages - 1, 0, -1))
        self.refs = np.zeros((self.n_pages,), np.int64)

    @property
    def live_pages(self):
        return int((self.refs > 0).sum())

    def alloc(self, n):
        """Take ``n`` pages (refcount 1 each) or raise typed
        ``Overloaded`` without touching any state."""
        if len(self._free) < n:
            raise Overloaded(
                "KV page pool exhausted: need %d page(s), %d free of %d "
                "usable — retire a stream, shrink prompts, or raise "
                "PADDLE_DECODE_POOL_PAGES"
                % (n, len(self._free), self.n_pages - 1))
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self.refs[p] = 1
        _M_PAGES_ALLOC.inc(n)
        return pages

    def share(self, pages):
        """Add one reference to each (already live) page."""
        for p in pages:
            assert self.refs[p] > 0, "share of a dead page"
            self.refs[p] += 1
        _M_PAGES_SHARED.inc(len(pages))

    def release(self, pages):
        """Drop one reference per page; pages at refcount zero return to
        the free list."""
        freed = 0
        for p in pages:
            assert self.refs[p] > 0, "release of a dead page"
            self.refs[p] -= 1
            if self.refs[p] == 0:
                self._free.append(p)
                freed += 1
        if freed:
            _M_PAGES_FREED.inc(freed)


class _PrefixEntry:
    """One cached prompt prefix: its pool pages, the precomputed cross
    K/V, and the first greedy token."""

    __slots__ = ("pages", "cross", "first", "plen")

    def __init__(self, pages, cross, first, plen):
        self.pages = tuple(pages)
        self.cross = list(cross)
        self.first = int(first)
        self.plen = int(plen)


class PrefixCache:
    """Content-addressed LRU cache of prefilled prompt prefixes, keyed by
    sha256 over (src, prompt[:plen], plen). The cache holds its own
    reference on every entry's pages; a hit aliases them into the
    joining slot's table copy-on-write."""

    def __init__(self, capacity, pool):
        self.capacity = int(capacity)
        self._pool = pool
        self._entries = collections.OrderedDict()

    @staticmethod
    def key(src, prompt, plen):
        h = hashlib.sha256()
        h.update(np.int64(plen).tobytes())
        h.update(np.ascontiguousarray(src, np.int64).tobytes())
        h.update(np.ascontiguousarray(
            np.asarray(prompt)[..., :plen], np.int64).tobytes())
        return h.hexdigest()

    def lookup(self, key):
        e = self._entries.get(key)
        if e is not None:
            self._entries.move_to_end(key)
        return e

    def insert(self, key, entry):
        if self.capacity <= 0 or key in self._entries:
            return
        self._pool.share(entry.pages)      # the cache's own reference
        self._entries[key] = entry
        while len(self._entries) > self.capacity:
            _, old = self._entries.popitem(last=False)
            self._pool.release(old.pages)


def build_paged_decode_session(model, batch_size, src_len, prompt_len,
                               cache_capacity, end_id=1, page_tokens=None,
                               pool_pages=None, prefix_cache_size=0):
    """A ``PagedDecodeSession`` over ``model`` on the model's device:
    continuous-batching greedy decode whose per-slot KV state lives in
    shared page pools indexed by per-slot page tables.

    ``page_tokens`` (default $PADDLE_DECODE_PAGE_TOKENS or 16) is the
    page size; ``cache_capacity`` must divide into pages. ``pool_pages``
    (default $PADDLE_DECODE_POOL_PAGES, else every slot at full capacity
    plus the scratch page) sizes the pool; joins that cannot seat a
    prompt shed with ``Overloaded``. ``prefix_cache_size`` > 0 keeps that
    many prompt prefixes resident for copy-on-write aliasing. Puts the
    model in eval() mode."""
    ptok = int(page_tokens if page_tokens is not None
               else os.environ.get("PADDLE_DECODE_PAGE_TOKENS", "16"))
    if ptok < 1:
        raise ValueError("page_tokens must be >= 1, got %d" % ptok)
    C = int(cache_capacity)
    if C % ptok:
        raise ValueError(
            "cache_capacity=%d must be a multiple of page_tokens=%d"
            % (C, ptok))
    if C < prompt_len:
        raise ValueError(
            "cache_capacity=%d < prompt_len=%d: the prefill write would "
            "cross the ring boundary" % (C, prompt_len))
    B = int(batch_size)
    n_pages = C // ptok
    if pool_pages is None:
        pool_pages = os.environ.get("PADDLE_DECODE_POOL_PAGES")
    P = int(pool_pages) if pool_pages is not None else B * n_pages + 1
    if P < n_pages + 1:
        raise ValueError(
            "pool_pages=%d cannot seat even ONE full slot (%d pages) "
            "plus the scratch page" % (P, n_pages))
    _check_positions(model, src_len, prompt_len, 0)
    model.eval()
    return PagedDecodeSession(model, B, src_len, prompt_len, C, end_id,
                              ptok, P, prefix_cache_size)


class PagedDecodeSession:
    """Continuous-batching greedy decode over PAGED KV state.

    * Self-attention K/V of all slots lives in 2L shared pools
      [P, H, page_tokens, d'] (d' as ``DecodeSession``'s rows: d rounded
      up to 16 bytes); each slot owns pages through a
      [B, n_pages] int32 table sent to the decode step every step
      (host-authoritative, like the token/length state). Retiring a slot
      returns its pages to the free list, with no device work.
    * ``join`` sheds with typed ``Overloaded`` when the pool cannot seat
      the prompt, and raises RuntimeError when no slot is vacant.
    * A prefix-cache hit skips the prefill: the slot's table aliases the
      cached pages, and ``_ensure_writable`` splits a private
      copy-on-write page the step before the slot would dirty shared
      state.
    * A slot that needs a page mid-stream when the pool is dry retires
      early (unfinished) instead of corrupting a neighbour.

    Single-threaded by design: serialise calls externally (the serving
    tier holds one dispatch lock)."""

    def __init__(self, model, batch_size, src_len, prompt_len,
                 cache_capacity, end_id, page_tokens, pool_pages,
                 prefix_cache_size=0):
        self.model = model
        self.device = dev = _model_device(model)
        self._L = L = len(model.dec_layers)
        self.batch_size = B = int(batch_size)
        self.src_len = int(src_len)
        self.prompt_len = int(prompt_len)
        self.cache_capacity = C = int(cache_capacity)
        self.end_id = int(end_id)
        self.n_heads = H = model.n_heads
        self.d_key = d = model.d_model // model.n_heads
        dp = decode_row_width(d, torch.float32)   # rows of the pools
        self.page_tokens = ptok = int(page_tokens)
        self.n_pages = C // ptok
        self.pool_pages = P = int(pool_pages)
        self.pool = _PagePool(P)
        self.prefix_cache = (PrefixCache(prefix_cache_size, self.pool)
                             if prefix_cache_size else None)
        self._tok = np.full((B, 1), self.end_id, np.int32)
        self._fin = np.ones((B, 1), bool)
        self._len = np.ones((B,), np.int32)
        self._table = np.zeros((B, self.n_pages), np.int32)
        self._kpool = [torch.zeros(P, H, ptok, dp, device=dev)
                       for _ in range(L)]
        self._vpool = [torch.zeros(P, H, ptok, dp, device=dev)
                       for _ in range(L)]
        self._cross = [torch.zeros(B, H, self.src_len, d, device=dev)
                       for _ in range(2 * L)]
        self._slots = [None] * B
        self._owned = [[] for _ in range(B)]  # pages each slot refs
        self._caches1 = [torch.zeros(1, H, C, dp, device=dev)
                         for _ in range(2 * L)]
        self._pos_src1 = torch.arange(src_len, device=dev).reshape(1, -1)
        self._pos_tgt1 = torch.arange(prompt_len, device=dev).reshape(1, -1)
        self._causal = torch.from_numpy(make_causal_bias(prompt_len)).to(dev)
        self._end_ids = torch.tensor([self.end_id], dtype=torch.int32,
                                     device=dev)

    @property
    def width(self):
        return self.batch_size

    @property
    def active_count(self):
        return sum(st is not None for st in self._slots)

    def vacant_slots(self):
        return [i for i, st in enumerate(self._slots) if st is None]

    @torch.no_grad()
    def join(self, src, prompt, prompt_len=None, max_new_tokens=1):
        """Admit ONE request into a vacant slot. Returns ``(slot, done)``:
        ``done`` is None while the request decodes, or ``(tokens [n]
        int64, finished)`` if it completed at join (budget 1, or the
        first token is end_id). Raises RuntimeError when no slot is
        vacant and typed ``Overloaded`` when the page pool cannot seat
        the prompt."""
        vacant = self.vacant_slots()
        if not vacant:
            raise RuntimeError(
                "no vacant slot (all %d active) — step() until one "
                "retires" % self.batch_size)
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        src = np.ascontiguousarray(src, np.int64).reshape(
            1, self.src_len)
        prompt = np.ascontiguousarray(prompt, np.int64).reshape(
            1, self.prompt_len)
        plen = int(self.prompt_len if prompt_len is None else prompt_len)
        if not 1 <= plen <= self.prompt_len:
            raise ValueError("prompt_len must be in [1, %d], got %d"
                             % (self.prompt_len, plen))
        _check_positions(self.model, self.src_len, self.prompt_len,
                         plen + int(max_new_tokens) - 2)
        _check_ids(self.model, src, prompt)
        slot = vacant[0]
        n_prompt_pages = -(-plen // self.page_tokens)
        L, dev = self._L, self.device
        key = entry = None
        if self.prefix_cache is not None:
            key = PrefixCache.key(src, prompt, plen)
            entry = self.prefix_cache.lookup(key)
        if entry is not None:
            _M_PREFIX_HIT.inc()
            _M_SLOT_JOIN.inc()
            first = entry.first
            if int(max_new_tokens) == 1 or first == self.end_id:
                _M_SLOT_RETIRE.inc()
                return slot, (np.array([first], np.int64),
                              first == self.end_id)
            self.pool.share(entry.pages)
            self._owned[slot] = list(entry.pages)
            self._table[slot, :] = 0
            self._table[slot, :n_prompt_pages] = entry.pages
            _slot_scatter(self._cross, entry.cross, slot)
        else:
            if self.prefix_cache is not None:
                _M_PREFIX_MISS.inc()
            # reserve pages BEFORE the prefill so an exhausted pool sheds
            # without wasting device work
            pages = self.pool.alloc(n_prompt_pages)
            for c in self._caches1:
                c.zero_()
            outs = self.model.prefill(
                torch.from_numpy(src).to(dev),
                torch.from_numpy(prompt).to(dev), self._pos_src1,
                self._pos_tgt1, self._causal,
                torch.zeros(1, dtype=torch.int32, device=dev),
                *self._caches1)
            first = int(outs[0][0, plen - 1].argmax())
            _M_SLOT_JOIN.inc()
            if int(max_new_tokens) == 1 or first == self.end_id:
                self.pool.release(pages)
                _M_SLOT_RETIRE.inc()
                return slot, (np.array([first], np.int64),
                              first == self.end_id)
            self._owned[slot] = list(pages)
            self._table[slot, :] = 0
            self._table[slot, :n_prompt_pages] = pages
            rows = torch.zeros(self.n_pages, dtype=torch.long, device=dev)
            rows[:n_prompt_pages] = torch.tensor(pages, device=dev)
            _paged_pack(self._kpool + self._vpool, outs[1:1 + 2 * L], rows)
            cross1 = list(outs[1 + 2 * L:1 + 4 * L])
            _slot_scatter(self._cross, cross1, slot)
            if self.prefix_cache is not None:
                self.prefix_cache.insert(key, _PrefixEntry(
                    pages, cross1, first, plen))
        self._tok[slot, 0] = first
        self._fin[slot, 0] = False
        self._len[slot] = plen
        self._slots[slot] = _SlotState([first], max_new_tokens)
        return slot, None

    @torch.no_grad()
    def step(self):
        """ONE decode step of the whole batch. Before it, every active
        slot's next write position is made exclusively writable
        (first-touch allocation, copy-on-write splits); slots the pool
        cannot serve retire early, unfinished. Returns the completions
        ``[(slot, tokens [n] int64, finished), ...]``."""
        if self.active_count == 0:
            raise RuntimeError("step() with no active slot — join first")
        _M_SLOT_OCC.observe(self.active_count / float(self.batch_size))
        completed = []
        self._clamp_idle()
        self._ensure_writable(completed)
        if self.active_count == 0:
            return completed
        t0 = time.perf_counter()
        dev = self.device
        outs = self.model.decode_step_paged(
            torch.from_numpy(self._tok).to(dev),
            torch.from_numpy(self._fin).to(dev), self._end_ids,
            torch.from_numpy(self._len).to(dev),
            torch.from_numpy(self._table).to(dev),
            *self._cross, *self._kpool, *self._vpool,
            longest=int(self._len.max()) + 1)
        _M_DECODE_STEPS.inc()
        _M_DECODE_SECONDS.observe(time.perf_counter() - t0)
        tok_np = outs[0].cpu().numpy()      # [B,1] — the per-step sync
        fin_np = outs[2].cpu().numpy()
        self._tok = np.array(tok_np, np.int32)
        self._fin = np.array(fin_np, bool)
        self._len = self._len + 1           # mirrors the step's new_len
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            st.tokens.append(int(tok_np[slot, 0]))
            finished = bool(fin_np[slot, 0])
            if finished or len(st.tokens) >= st.budget:
                completed.append((slot, np.array(st.tokens, np.int64),
                                  finished))
                self._retire(slot)
                _M_SLOT_RETIRE.inc()
        return completed

    def _retire(self, slot):
        self._slots[slot] = None
        self._fin[slot, 0] = True
        self._tok[slot, 0] = self.end_id
        if self._owned[slot]:
            self.pool.release(self._owned[slot])
            self._owned[slot] = []
        self._table[slot, :] = 0

    def _shed(self, slot, completed):
        """Early-retire ``slot`` (unfinished): the pool could not serve
        its next write."""
        st = self._slots[slot]
        completed.append((slot, np.array(st.tokens, np.int64), False))
        self._retire(slot)
        _M_SLOT_RETIRE.inc()

    def _ensure_writable(self, completed):
        """Make every active slot's NEXT write position land on a page it
        owns alone: allocate on first touch (ring growth past the prompt
        pages), split copy-on-write when the page is shared."""
        ptok, C = self.page_tokens, self.cache_capacity
        for b, st in enumerate(self._slots):
            if st is None:
                continue
            j = (int(self._len[b]) % C) // ptok
            page = int(self._table[b, j])
            if page == 0:
                try:
                    (new,) = self.pool.alloc(1)
                except Overloaded:
                    self._shed(b, completed)
                    continue
                self._table[b, j] = new
                self._owned[b].append(new)
            elif self.pool.refs[page] > 1:
                try:
                    (new,) = self.pool.alloc(1)
                except Overloaded:
                    self._shed(b, completed)
                    continue
                _paged_cow(self._kpool + self._vpool, page, new)
                self._table[b, j] = new
                self._owned[b][self._owned[b].index(page)] = new
                self.pool.release([page])

    def _clamp_idle(self):
        """Idle slots sit at cache_len=1 over the scratch page, so their
        (discarded) position ids stay in range however long the stream
        runs."""
        for b, st in enumerate(self._slots):
            if st is None:
                self._len[b] = 1


# ---------------------------------------------------------------------------
# Greedy self-speculative decoding over a dense session.
# ---------------------------------------------------------------------------

_M_SPEC_ACCEPT = monitor.histogram(
    "decode_spec_accepted_tokens", "tokens emitted per speculative "
    "verify step (1 = draft rejected at the first proposal, k = whole "
    "window accepted)", buckets=(1, 2, 3, 4, 6, 8, 12, 16))


def build_speculative_session(model, session, k=4, draft_layers=None):
    """Wrap a dense ``DecodeSession`` in a ``SpeculativeDecodeSession``: a
    self-speculative draft (the first ``draft_layers`` decoder layers,
    default L // 2 and at least 1, with the shared embeddings and output
    projection: no second model) proposes ``k`` tokens a round, and the
    full model verifies them in one step (q_len k with the per-row causal
    window), accepting the longest matching greedy prefix. The tokens
    equal ``session.generate``'s: the draft changes only how many
    positions the target computes at once. ``model`` is the session's
    model; puts it in eval() mode."""
    k = int(k)
    if k < 2:
        raise ValueError(
            "speculative k must be >= 2 (k=1 is the plain decode step)")
    L = session._L
    Ld = int(draft_layers) if draft_layers is not None else max(1, L // 2)
    if not 1 <= Ld <= L:
        raise ValueError("draft_layers must be in [1, %d], got %d"
                         % (L, Ld))
    model.eval()
    return SpeculativeDecodeSession(session, k, Ld)


class SpeculativeDecodeSession:
    """Greedy speculative decoding over a base ``DecodeSession``.

    A round: the draft runs k single-token steps (k-1 proposals, then one
    that only writes the last proposal into its caches, so they never
    hold a gap), then the target verifies the k-token window in one step
    and the host accepts the longest prefix where the draft's proposal
    equals the target's greedy choice, so each target step emits between
    1 and k tokens. The proposals stay on the device until the round's
    one sync. Rollback is a host-side length edit: rejected cache rows
    sit above the rolled-back length, masked until overwritten, which is
    why a generation must never wrap the ring (checked in generate)."""

    def __init__(self, session, k, draft_layers):
        s = self._s = session
        self.k = int(k)
        self.draft_layers = Ld = int(draft_layers)
        B, H, C = s.batch_size, s.n_heads, s.cache_capacity
        dp = decode_row_width(s.d_key, torch.float32)
        self._dcaches = [torch.zeros(B, H, C, dp, device=s.device)
                         for _ in range(2 * Ld)]
        self._step_ids = torch.arange(self.k, dtype=torch.int32,
                                      device=s.device).reshape(1, -1)

    @torch.no_grad()
    def generate(self, src, prompt, prompt_lens, max_new_tokens):
        """Drop-in for ``DecodeSession.generate``: the same arguments, the
        same greedy tokens, fewer target steps. Requires max(prompt_lens)
        + max_new_tokens + k <= cache_capacity: the verify window must
        never wrap the ring (rollback only moves the length, which is
        sound only while every stale row sits above it)."""
        s, k, Ld, L = self._s, self.k, self.draft_layers, self._s._L
        B, dev, model = s.batch_size, s.device, s.model
        src, prompt, plens = s._check_request(src, prompt, prompt_lens,
                                              max_new_tokens)
        need = int(max_new_tokens)
        if int(plens.max()) + need + k > s.cache_capacity:
            raise ValueError(
                "speculative decode must not wrap the KV ring: "
                "max prompt_len %d + max_new_tokens %d + k %d > "
                "cache_capacity %d"
                % (plens.max(), need, k, s.cache_capacity))
        # a row that stops early keeps stepping (its outputs discarded)
        # for up to two more windows past its last live position
        _check_positions(model, s.src_len, s.prompt_len,
                         int(plens.max()) + need + 2 * k - 3)

        outs = s._prefill(src, prompt, s._caches)
        kc, vc = outs[1:1 + L], outs[1 + L:1 + 2 * L]
        cross = outs[1 + 2 * L:1 + 4 * L]
        dcross = cross[:Ld] + cross[L:L + Ld]
        last = torch.from_numpy(plens - 1).to(dev)
        first = outs[0][torch.arange(B, device=dev), last].argmax(-1).to(
            torch.int32).cpu().numpy()
        cur = first[:, None].copy()          # [B, 1] pending token
        emitted = [[int(t)] for t in first]
        fin = first == s.end_id              # [B] host finished mask
        tlen = plens.astype(np.int32)        # target cache lengths

        # draft prompt ingestion: the prompt through the draft one position
        # a step; rows shorter than the longest prompt rewrite their last
        # prompt position, which changes nothing
        dkc, dvc = self._dcaches[:Ld], self._dcaches[Ld:]
        for c in self._dcaches:
            c.zero_()
        no_fin = torch.zeros(B, 1, dtype=torch.bool, device=dev)
        steps = int(plens.max())
        lens = np.minimum(np.arange(steps)[:, None], plens - 1)   # [T, B]
        toks = prompt[np.arange(B), lens]
        ingest = torch.from_numpy(np.stack([lens, toks], axis=1).astype(
            np.int32)).to(dev)                                 # [T, 2, B]
        for t in range(steps):
            model.decode_step_draft(ingest[t, 1, :, None], no_fin,
                                    s._end_ids, ingest[t, 0], *dcross,
                                    *dkc, *dvc,
                                    longest=int(lens[t].max()) + 1)

        while any(len(emitted[b]) < need and not fin[b] for b in range(B)):
            # draft: k-1 proposals, then one step that writes the last
            longest = int(tlen.max())
            both = torch.from_numpy(np.stack([cur[:, 0], tlen])).to(dev)
            dt, tlen_dev = both[0, :, None], both[1]
            dlen = tlen_dev
            d_toks = [dt]
            for i in range(k):
                outs = model.decode_step_draft(
                    dt, no_fin, s._end_ids, dlen, *dcross, *dkc, *dvc,
                    longest=longest + i + 1)
                if i < k - 1:
                    dt, dlen = outs[0], outs[1]
                    d_toks.append(dt)
            # target: the whole window in one step
            toks = torch.cat(d_toks, dim=1)                  # [B, k] int32
            outs = model.verify_step(toks, self._step_ids, tlen_dev, *cross,
                                     *kc, *vc, longest=longest + k)
            # the round's one sync: proposals and greedy choices together
            got = torch.cat([toks, outs[0]], dim=1).cpu().numpy()
            toks_np, g = got[:, :k], got[:, k:]

            new_tlen = tlen.copy()
            for b in range(B):
                if len(emitted[b]) >= need or fin[b]:
                    continue        # frozen: length pinned, writes inert
                a = 1
                while a < k and int(toks_np[b, a]) == int(g[b, a - 1]):
                    a += 1
                _M_SPEC_ACCEPT.observe(a)
                for t in g[b, :a]:
                    t = s.end_id if fin[b] else int(t)
                    emitted[b].append(t)
                    if t == s.end_id:
                        fin[b] = True
                    if len(emitted[b]) >= need:
                        break
                cur[b, 0] = g[b, a - 1]
                new_tlen[b] = tlen[b] + a
            tlen = new_tlen

        tokens = np.full((B, need), s.end_id, np.int64)
        for b in range(B):
            t = emitted[b][:need]
            tokens[b, :len(t)] = t
        _M_DECODE_CACHE.set(float(np.minimum(
            plens + need, s.cache_capacity).sum()))
        return tokens, fin.copy()
