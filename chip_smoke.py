"""On-card smoke run of paddle_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels build for sm_90a), nvcc and the
port's sources beside this file. It imports nothing of JAX or of the JAX
package. Phases, each printed as one JSON line; any failure raises and
the script exits non-zero without its final line:

1. card      nvidia-smi name and power limit; build every CUDA kernel;
             each fused-attention kernel's registers and spills (ptxas)
             and shared memory a block.
2. kernels   each kernel against its plain PyTorch version at the main
             paths' shapes and at the edge cases, with its time (CUDA
             events, median of 25 cold-L2 launches), the plain
             version's, one PyTorch library call's where one computes the
             same function, and the least time the card could take. The
             times are device time: the host's launch overhead is kept
             out of the timed span. Decode attention: ragged capacity,
             causal window, wrapped ring, paged; fp32 and bf16; untimed,
             dense and paged, key rows of 16 and 192 bytes (bf16 d 8,
             fp32 d 48, bf16 d 96), fp16, rows that are not a multiple
             of 16 bytes (fp32 d 6, bf16 d 12), rows past 512 bytes
             (fp32 d 192 and 512, bf16 d 512) and past 2048 bytes,
             split across blocks (fp32 d 640, bf16 d 1536), also padded
             to 16 bytes as the sessions hold them. Fused training
             attention (forward, and the backward's dq, dk, dv and
             dbias; up to d 128 on the tensor cores, fp32 as 3xTF32
             with its backward up to d 64; TFLOP/s beside each time):
             BERT-base's shape
             (batch 32, 12 heads of 64, S 512, padding-mask bias) at
             dropout 0.1 and 0, every other bias mode, a ragged S and
             d 128; fp32 and bf16 (fp32 also with its bound at the SIMT
             rate and the kernels SDPA ran, by the profiler's names);
             untimed, head widths 48, 80 and 160 (zero-padded to 64, 128
             and 256), 256, 320 and 512 (past 256 the outputs' columns
             split across blocks) in fp32, bf16 and fp16, and fp16 at
             BERT-base's shape. The same
             kernels past S 1024, where they stand in for the TPU
             package's long and flash tiers: batch 1, 12 heads of 64, at
             S 2048, 4096 and 8192, p = 0, fp32 and bf16, each kernel of
             the backward also timed alone; at S 2048 dropout 0.1 and a
             per-row [1, 12, S, S] bias; untimed, bf16 at dropout 0.1 at
             each shape of bert_long (S 2048 x 8, 4096 x 4, 8192 x 2; at
             S 8192 the plain version runs one (batch, head) pair at a
             time). Each output of these is held to a limit relative to
             the plain output's largest magnitude (LONG_RTOL). The same
             kernels on packed [B, S, H*d] operands, through the heads'
             strides, at the bert_packed path's shapes: BERT-base at
             batch 128, S 128 (the TPU's resident tier) with a padding
             mask and with a per-head bias, and BERT-tiny at batch 128,
             S 128 (4 heads of 16: the TPU's packed tier), p 0 timed and
             p 0.1 untimed; untimed, batch 8, S 256, 3 heads (an odd H);
             fp32 and bf16, held to LONG_RTOL; and the packed entry equal
             to the per-head one on contiguous copies at p 0.1.
3. dense     GenerativePredictor(Transformer.big(), batch 64, src 128,
             prompt 64, capacity 1024).run for 32 new tokens: the dense
             decode kernel launches once per decoder layer per step, and
             one whole-model decode step with the kernels agrees with the
             same step on the plain versions.
4. serving   GenerativeServer over the paged stream (width 8, pages of
             128 tokens, 25-page pool, prefix cache of 8): 16 requests
             from 4 threads, some repeated; every future resolves through
             the paged kernel and the prefix cache hits.
5. bert      BERT-base MLM pretraining at S 512 through the Program IR:
             build_pretrain_program -> Executor.run (startup, then train
             steps) on one synthetic batch of 32. One step with the fused
             kernels agrees with the same step on the plain attention from
             a cloned scope and generator (``bert_step_check``); then 6
             timed steps, each through 12 forward and 12 + 12 backward
             kernel launches, all on the tensor cores (3xTF32), with
             finite losses that fall (the batch is memorised).
6. bert_long BERT-base long-context pretraining in bf16 AMP
             (use_amp=True, dropout 0.1, max_seq = S), the reference's
             long-sequence run: first one step with the kernels against
             one with the plain attention at S 2048, batch 1, from a
             cloned scope and generator, at data seeds 0-5, judged
             together (``step_verdict``); then (S 2048, batch 8),
             (S 4096, batch 4) and (S 8192, batch 2), each one warm step
             and 4 timed steps through 12 forward (all attn_fwd_mma, the
             tensor-core forward), 12 dq and 12 dk/dv launches a step,
             reported under the TPU tier they stand in for
             (``reference_tier``: long at S 2048, flash above), with
             finite losses that fall.
7. bert_packed  BASELINE config 3 in the packed layout: BERT-base MLM
             pretraining at batch 128, S 128, bf16 AMP with
             use_fused_attention="packed" (the reference's bench_bert
             shapes): one step against the plain attention at batch 2,
             at data seeds 0-5, judged together; one warm and 4 timed
             steps through 12 forward (attn_fwd_mma), 12 dq and 12
             dk/dv launches a step on the heads' strided views (the
             program's only attention op is the packed one), with
             falling losses; the same with "auto" (the einsum chain) and
             True (per-head kernels behind transposes) for their step
             times; BERT-tiny at the same shapes, which the TPU runs in
             its packed tier.
8. encoder_serving  a BERT-base packed encoder saved with
             save_inference_model, loaded as a Predictor behind a Server
             (batches up to 32, 2 ms delay, ladder warmed up): 64
             requests of 1-4 rows from 8 threads, each held to a direct
             Predictor.run of its rows; latency, occupancy, launches.
9. summary   the kernels line, the card line, then the result line.
"""

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.float32: 67e12,      # fp32, no tensor cores
                  torch.bfloat16: 989e12,    # bf16 tensor cores, dense
                  torch.float16: 989e12}     # fp16 the same
# The fused attention's least time: fp32-accurate products on the tensor
# cores take three TF32 products each (3xTF32, 494.7 TFLOP/s dense), so
# about 165 TFLOP/s, which beats the SIMT cores' 67; the 16-bit types at
# the tensor cores' rate. Decode, bound by bytes, keeps PEAK_OPS_PER_S.
TF32_OPS_PER_S = 494.7e12
FUSED_PEAK_OPS_PER_S = dict(PEAK_OPS_PER_S)
FUSED_PEAK_OPS_PER_S[torch.float32] = TF32_OPS_PER_S / 3
REPS, WARMUP = 25, 3
HOLD_CYCLES = 2_000_000            # about 1 ms of SM clock
FP32_ATOL, BF16_ATOL = 2e-5, 2e-2
# fused training attention, kernel vs plain, as a share of max(1, the
# plain result's largest magnitude): fp32 sums in another order; bf16
# outputs are rounded to bf16 by both, at different points (fp16, with
# three more mantissa bits, is held to bf16's limit)
FUSED_ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2,
              torch.float16: 3e-2}
PAGED_VS_DENSE_ATOL = 1e-6
# whole-model fp32 step, kernel vs plain: about ten times the 1.1e-6 to
# 1.3e-6 read on the H100 (PERF.md), so a wrong live window in one layer
# fails it
STEP_LOGITS_ATOL = 1e-5


def emit(**rec):
    print(json.dumps(rec), flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def kernel_resources(_build, A):
    """Each fused-attention kernel's registers and spills, as ptxas
    reported them when this build compiled it (``-Xptxas -v``, kept in
    ``_build/fused_attention.log``), and its dynamic shared memory a
    block, from the library itself; one record per kernel, head width
    and type."""
    with open(os.path.join(_build.BUILD_DIR, "fused_attention.log")) as f:
        log = f.read()
    types = {"f": ("float", torch.float32),
             "13__nv_bfloat16": ("bf16", torch.bfloat16),
             "6__half": ("f16", torch.float16)}
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(attn_\w+?)I"
                      r"(f|13__nv_bfloat16|6__half)(?:Li(\d+))?E", line)
        if m:
            kind, dtype = types[m.group(2)]
            # the kernels past d 256 take d at run time: "wide"
            d = int(m.group(3)) if m.group(3) else "wide"
            cur = dict(kernel="%s<%s%s>" % (m.group(1), kind, (
                ", %d" % d) if m.group(3) else ""), d=d)
            which = ("attn_fwd", "attn_bwd_dq", "attn_bwd_dkdv").index(
                re.sub("_(mma|tf32x3|wide)$", "", m.group(1)))
            cur["smem_bytes"] = A.fused_attention_smem_bytes(
                which, dtype, 320 if d == "wide" else d)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            out.append(cur)
            cur = None
    return out


def time_ms(fn, flush):
    """Median milliseconds of ``fn`` over REPS launches, each timed with
    CUDA events after a write of 128 MiB that evicts the 50 MB L2. The
    stream then spins for about a millisecond before the start event, so
    the host has queued all of ``fn`` by the time it starts: the span is
    device work, not the host's launch overhead."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_times(prof):
    """{kernel name: (device us, calls)} from a finished torch.profiler
    profile."""
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            out[e.key] = (us, e.count)
    return out


def device_kernels(fn):
    """The CUDA kernels one call of ``fn`` runs, by the profiler's names
    (which backend a PyTorch call took), with their device microseconds;
    "not measured" where the profiler returned no device events."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {name[:120]: us for name, (us, _) in kernel_times(prof).items()
            } or "not measured"


def bound(q, live_cols, extra_bytes):
    """(bound_ms, bound_by) for decode attention of q [B, H, Q, d] over
    ``live_cols`` live key columns in total (summed over the batch):
    bytes = q + live K and V rows + output + ``extra_bytes``; operations
    = 4 d per (row, live column, head) (QK^T and PV) at the peak rate of
    the input type."""
    B, H, Q, d = q.shape
    e = q.element_size()
    nbytes = 2 * q.numel() * e + 2 * live_cols * H * d * e + extra_bytes
    ops = 4.0 * d * Q * H * live_cols
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dense_case(A, dev, gen, flush, name, B, H, Q, C, d, lens, dtype,
               causal=False):
    q, k, v = (torch.randn(*s, device=dev, generator=gen).to(dtype)
               for s in ((B, H, Q, d), (B, H, C, d), (B, H, C, d)))
    cache_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(d)
    got = A.decode_attention_kernel(q, k, v, cache_len, scale, causal)
    want = A._ref_attention_cache(q, k, v, cache_len, scale, causal)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    atol = FP32_ATOL if dtype == torch.float32 else BF16_ATOL
    if not err <= atol:
        raise AssertionError("%s: decode kernel vs plain max |err| %g > %g"
                             % (name, err, atol))
    valid = torch.clamp(cache_len, max=C).view(B, 1, 1, 1)
    col = torch.arange(C, device=dev).view(1, 1, 1, C)
    limit = valid - (Q - 1) + torch.arange(Q, device=dev).view(1, 1, Q, 1) \
        if causal else valid
    mask = col < limit
    live = int(torch.clamp(torch.clamp(cache_len, max=C), min=1).sum())
    b_ms, b_by = bound(q, live, 4 * B)
    rec = dict(
        name=name, B=B, H=H, Q=Q, C=C, d=d, dtype=str(dtype), causal=causal,
        max_abs_err=err, atol=atol,
        kernel_ms=time_ms(lambda: A.decode_attention_kernel(q, k, v, cache_len,
                                                     scale, causal), flush),
        plain_ms=time_ms(lambda: A._ref_attention_cache(
            q, k, v, cache_len, scale, causal), flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale), flush),
        bound_ms=b_ms, bound_by=b_by)
    emit(phase="kernels", kernel="decode_attention", **rec)
    return rec


def decode_width_check(A, dev, gen, dtype, d):
    """Untimed: the dense and paged decode kernels at a key row of
    d * itemsize bytes that is not a power of two of 16-byte pieces, not
    a multiple of 16 bytes (element-by-element copies), longer than 512
    bytes (2 or 4 pieces a lane) or than 2048 (the output's columns in
    2048-byte chunks, one block each), on unpadded caches, against the plain
    version; ragged lengths, a wrapped ring; then ``attention_with_cache``
    on the same cache with its rows padded to 16 bytes, as the sessions
    allocate them, against the unpadded result."""
    B, H, C, ptok = 8, 4, 320, 64
    q, k, v = (torch.randn(*s, device=dev, generator=gen).to(dtype)
               for s in ((B, H, 1, d), (B, H, C, d), (B, H, C, d)))
    cache_len = torch.tensor([1, 2, 63, 64, 65, 299, 320, 777],
                             dtype=torch.int32, device=dev)
    n0 = (A.decode_attention_kernel.launches,
          A.paged_attention_kernel.launches)
    got = A.attention_with_cache(q, k, v, cache_len)
    want = A._ref_attention_cache(q, k, v, cache_len, d ** -0.5)
    table = torch.arange(B * C // ptok, dtype=torch.int32,
                         device=dev).view(B, C // ptok)
    pools = [t.view(B, H, C // ptok, ptok, d).permute(0, 2, 1, 3, 4)
             .reshape(B * C // ptok, H, ptok, d).contiguous() for t in (k, v)]
    paged = A.paged_attention_cache(q, *pools, table, cache_len)
    width = A.decode_row_width(d, dtype)
    padded = A.attention_with_cache(q, *(F.pad(t, (0, width - d))
                                         for t in (k, v)), cache_len)
    torch.cuda.synchronize()
    if (A.decode_attention_kernel.launches - n0[0],
            A.paged_attention_kernel.launches - n0[1]) != (2, 1):
        raise AssertionError("decode d %d %s: the kernels were not launched"
                             % (d, dtype))
    err = (got.float() - want.float()).abs().max().item()
    err_paged = (paged.float() - got.float()).abs().max().item()
    err_padded = (padded.float() - got.float()).abs().max().item()
    atol = FP32_ATOL if dtype == torch.float32 else BF16_ATOL
    if not (err <= atol and err_paged <= PAGED_VS_DENSE_ATOL and
            err_padded <= atol):
        raise AssertionError(
            "decode d %d %s: kernel vs plain max |err| %g (> %g?), paged vs "
            "dense %g (> %g?), padded rows vs unpadded %g" % (
                d, dtype, err, atol, err_paged, PAGED_VS_DENSE_ATOL,
                err_padded))
    emit(phase="kernels", kernel="decode_attention_width", d=d,
         dtype=str(dtype), row_bytes=d * q.element_size(),
         padded_row_bytes=width * q.element_size(),
         lanes_and_pieces=A.decode_lanes(d * q.element_size()),
         column_chunks=A.decode_chunks(d * q.element_size()),
         max_abs_err=err, paged_vs_dense=err_paged,
         padded_vs_unpadded=err_padded, atol=atol)


def paged_case(A, dev, gen, flush):
    """Paged kernel at the serving path's geometry: width 8, 16 heads of
    64, pages of 128 tokens, 8 pages per slot, a 25-page pool; five live
    slots (one full, one across three pages) and three idle slots whose
    tables point at scratch page 0."""
    B, H, d, ptok, npages, P = 8, 16, 64, 128, 8, 25
    k_pool, v_pool = (torch.randn(P, H, ptok, d, device=dev, generator=gen)
                      for _ in range(2))
    q = torch.randn(B, H, 1, d, device=dev, generator=gen)
    lens = [1024, 300, 96, 70, 65, 1, 1, 1]
    table = torch.zeros(B, npages, dtype=torch.int32, device=dev)
    pages = (torch.randperm(P - 1, device=dev, generator=gen) + 1).tolist()
    for b, n in enumerate(lens):
        if n > 1:
            need = -(-n // ptok)
            table[b, :need] = torch.tensor(pages[:need], device=dev)
            pages = pages[need:]
    cache_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(d)
    got = A.paged_attention_kernel(q, k_pool, v_pool, table, cache_len,
                                   scale)
    kd, vd = (A.gather_paged_cache(p, table).contiguous()
              for p in (k_pool, v_pool))
    want = A._ref_attention_cache(q, kd, vd, cache_len, scale)
    dense = A.decode_attention_kernel(q, kd, vd, cache_len, scale)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    err_dense = (got - dense).abs().max().item()
    if not (err <= FP32_ATOL and err_dense <= PAGED_VS_DENSE_ATOL):
        raise AssertionError("paged kernel: vs plain %g (> %g?), vs dense "
                             "kernel %g (> %g?)" % (err, FP32_ATOL,
                                                    err_dense,
                                                    PAGED_VS_DENSE_ATOL))
    b_ms, b_by = bound(q, sum(lens), 4 * B + 4 * B * npages)
    rec = dict(
        name="paged_path", B=B, H=H, ptok=ptok, npages=npages, pool_pages=P,
        d=d, lens=lens, max_abs_err=err, max_abs_err_vs_dense=err_dense,
        atol=FP32_ATOL,
        kernel_ms=time_ms(lambda: A.paged_attention_kernel(
            q, k_pool, v_pool, table, cache_len, scale), flush),
        plain_ms=time_ms(lambda: A._ref_attention_cache(
            q, A.gather_paged_cache(k_pool, table),
            A.gather_paged_cache(v_pool, table), cache_len, scale), flush),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    emit(phase="kernels", kernel="paged_attention", **rec)
    return rec


def fused_bound(q, bias, backward, peak=FUSED_PEAK_OPS_PER_S):
    """(bound_ms, bound_by) of fused attention on q [B, H, S, d]: the
    bytes each input is read and each output written once (forward: q,
    k, v, bias, o, lse; backward: q, k, v, o, dO, lse, bias, dq, dk, dv,
    dbias) over the HBM rate, against the operations (forward 4 B H S^2 d:
    q.k^T and p.v; backward 10 B H S^2 d: q.k^T again, dO.v^T, dV, dK and
    dQ) at ``peak`` for the input type (FUSED_PEAK_OPS_PER_S: fp32 as
    3xTF32; PEAK_OPS_PER_S gives fp32 on the SIMT cores)."""
    B, H, S, d = q.shape
    n, e = q.numel(), q.element_size()
    if backward:
        nbytes = 8 * n * e + 4 * B * H * S + 2 * 4 * bias.numel()
        ops = 10.0 * B * H * S * S * d
    else:
        nbytes = 4 * n * e + 4 * B * H * S + 4 * bias.numel()
        ops = 4.0 * B * H * S * S * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fused_case(A, dev, gen, flush, name, B, H, S, d, bias_shape, p, dtype):
    """The fused training-attention kernels against the plain version on
    the same inputs and seed: forward output, and dq, dk, dv, dbias of
    one random upstream gradient. ``bias_shape`` "padding" is BERT's
    [B, 1, 1, S] mask (0 on the first len_b keys, -1e4 after them, lengths
    S/2..S), else a random bias of that shape. Times the forward kernel,
    the two backward kernels together, the plain version (autograd for its
    backward) and SDPA with the same float mask at p = 0."""
    q, k, v, do = (torch.randn(B, H, S, d, device=dev, generator=gen)
                   .to(dtype) for _ in range(4))
    if bias_shape == "padding":
        lens = torch.randint(S // 2, S + 1, (B, 1), device=dev,
                             generator=gen)
        bias = torch.where(torch.arange(S, device=dev)[None] < lens, 0.0,
                           -1e4).view(B, 1, 1, S)
    else:
        bias = torch.randn(*bias_shape, device=dev, generator=gen)
    seed = torch.tensor([7919 * S + d], dtype=torch.int64, device=dev)
    scale = d ** -0.5
    bias_f, strides = A._bias_operand(bias, B, H, S)

    def forward():
        return A.fused_attention_fwd_kernel(q, k, v, bias_f, strides, seed,
                                            scale, p)

    o, lse = forward()

    def backward():
        return A.fused_attention_backward(q, k, v, bias_f, strides, seed, o,
                                          lse, do, scale, p, bias_grad=True)

    got = (o,) + tuple(backward())
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v,
                                                                 bias)]
    ref = A._ref_fused_attention(*leaves, scale, p, seed)
    want = (ref.detach(),) + tuple(torch.autograd.grad(ref, leaves, do,
                                                       retain_graph=True))
    torch.cuda.synchronize()
    errs = {}
    for key, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        err = (a.float() - b.float()).abs().max().item()
        limit = FUSED_ATOL[dtype] * max(1.0, b.float().abs().max().item())
        if not err <= limit:
            raise AssertionError("%s: fused attention %s kernel vs plain "
                                 "max |err| %g > %g" % (name, key, err,
                                                        limit))
        errs[key] = err
    mask = bias.to(dtype)
    lib_leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_leaves, attn_mask=mask,
                                             scale=scale)
    f_ms, f_by = fused_bound(q, bias, False)
    b_ms, b_by = fused_bound(q, bias, True)
    extra = {}
    if dtype == torch.float32:
        # the bound at the SIMT cores' rate, the kernels SDPA runs, and
        # SDPA's own distance from the plain version at p 0 (TF32 alone
        # would read about 1e-3 of max(1, the largest magnitude))
        plain_p0 = A._ref_fused_attention(q, k, v, bias, scale, 0.0, seed)
        extra = dict(
            library_rel_err=((lib_out.detach() - plain_p0).abs().max() /
                             max(1.0, plain_p0.abs().max().item())).item(),
            bound_simt_ms={kind: fused_bound(q, bias, kind == "bwd",
                                             PEAK_OPS_PER_S)[0]
                           for kind in ("fwd", "bwd")},
            library_kernels=dict(
                fwd=device_kernels(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale)),
                bwd=device_kernels(lambda: torch.autograd.grad(
                    lib_out, lib_leaves, do, retain_graph=True))))
    rec = dict(
        name=name, B=B, H=H, S=S, d=d, dtype=str(dtype),
        bias=list(bias.shape), dropout=p, max_abs_err=errs,
        fwd=dict(
            max_abs_err=errs["out"],
            kernel_ms=time_ms(forward, flush),
            plain_ms=time_ms(lambda: A._ref_fused_attention(
                q, k, v, bias, scale, p, seed), flush),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=scale), flush),
            bound_ms=f_ms, bound_by=f_by),
        bwd=dict(
            max_abs_err=max(errs[x] for x in ("dq", "dk", "dv", "dbias")),
            kernel_ms=time_ms(backward, flush),
            plain_ms=time_ms(lambda: torch.autograd.grad(
                ref, leaves, do, retain_graph=True), flush),
            library_ms=time_ms(lambda: torch.autograd.grad(
                lib_out, lib_leaves, do, retain_graph=True), flush),
            library_fwd_bwd_ms=time_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(*lib_leaves, attn_mask=mask,
                                               scale=scale),
                lib_leaves, do), flush),
            bound_ms=b_ms, bound_by=b_by), **extra)
    for kind in ("fwd", "bwd"):
        rec[kind]["tflops"] = achieved_tflops(q, kind, rec[kind]["kernel_ms"])
    emit(phase="kernels", kernel="fused_attention", **rec)
    return rec


# The TPU package's training tiers (paddle_tpu/kernels/attention.py), by
# which the summary line names the TPU kernel each launch of the one CUDA
# family stands in for: _fwd_kernel/_bwd_kernel up to S 1024, the long
# kernels up to S 4096 where _long_qb finds a query tile, the flash kernels
# past that; in the packed layout the resident kernels (S <= 1024, heads
# in pairs of 128 lanes, a batch block in VMEM), else the packed kernels
# (S <= 256), else the per-head tiers after a transpose.
TPU_MAX_FUSED_SEQ, TPU_MAX_LONG_SEQ, TPU_PACKED_MAX_SEQ = 1024, 4096, 256
MIB = 1024 * 1024


def long_qb(S, d):
    """The TPU package's query tile for its long kernels: 128 or 64 rows
    whose VMEM footprint estimate stays under 13 MB, else None."""
    for qb in (128, 64):
        if S % qb == 0 and 7.5 * qb * S * 4 + 24 * S * d <= 13 * 1024 * 1024:
            return qb
    return None


def _largest_divisor(B, fits):
    best = None
    for bb in range(1, B + 1):
        if B % bb == 0 and fits(bb):
            best = bb
    return best


def res_blocks(B, S, HD, itemsize):
    """The TPU package's resident batch block (``_res_blocks``): the
    largest divisor of B whose six double-buffered [Bb, S, H*d] blocks
    and ten [Bb, S, S] fp32 temporaries fit 13 MB, else None."""
    return _largest_divisor(B, lambda bb: 6 * bb * S * HD * itemsize * 2 +
                            10 * bb * S * S * 4 <= 13 * MIB)


def packed_hc(H, S):
    """The TPU package's packed-tier head chunk (``_packed_hc``)."""
    return next((hc for hc in range(H, 0, -1)
                 if H % hc == 0 and 22 * hc * S * S * 4 <= 8 * MIB), None)


def packed_bb(B, S, HD, H):
    """The TPU package's packed-tier batch block (``_packed_bb``)."""
    if packed_hc(H, S) is None:
        return None
    return _largest_divisor(B, lambda bb: 42 * bb * S * HD + 8 * MIB <=
                            15 * MIB)


def reference_tier(S, d, packed=None):
    """The TPU package tier whose kernels a launch at sequence length S
    and head width d stands in for: "fused", "long" or "flash" for
    [B, H, S, d] operands; with ``packed`` = (B, H, itemsize, bias shape)
    for the packed [B, S, H*d] entry, "resident" or "packed" (a copy of
    ``_use_res_kernel`` and ``_use_packed_kernel``), else the per-head
    tier that entry falls back to."""
    if packed is not None:
        B, H, itemsize, bias_shape = packed
        bias_ok = bias_shape[2] == 1 and bias_shape[1] in (1, H)
        if S <= TPU_MAX_FUSED_SEQ and H % 2 == 0 and (2 * d) % 128 == 0 \
                and res_blocks(B, S, H * d, itemsize) and bias_ok:
            return "resident"
        if S <= TPU_PACKED_MAX_SEQ and packed_bb(B, S, H * d, H) \
                and bias_ok:
            return "packed"
    if S <= TPU_MAX_FUSED_SEQ:
        return "fused"
    if S <= TPU_MAX_LONG_SEQ and long_qb(S, d) is not None:
        return "long"
    return "flash"


def long_bound(q, bias, kind):
    """(bound_ms, bound_by) of one kernel of the long-sequence family on
    q [B, H, S, d]: ``kind`` "fwd" (q, k, v, bias in; o, lse out; q.k^T
    and p.v, 4 B H S^2 d), "dq" (q, k, v, o, dO, lse, bias in; dq, delta
    out; q.k^T, dO.v^T and dS.K, 6 B H S^2 d) or "dkdv" (q, k, v, dO,
    lse, delta, bias in; dk, dv, dbias out; q.k^T, dO.v^T, P^T.dO and
    dS^T.Q, 8 B H S^2 d), or "bwd" for the whole backward as in
    ``fused_bound``."""
    if kind in ("fwd", "bwd"):
        return fused_bound(q, bias, kind == "bwd")
    B, H, S, d = q.shape
    n, e, rows = q.numel(), q.element_size(), 4 * B * H * S
    if kind == "dq":
        nbytes, ops = 6 * n * e + 2 * rows + 4 * bias.numel(), 6.0
    else:
        nbytes, ops = 6 * n * e + 2 * rows + 2 * 4 * bias.numel(), 8.0
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops * B * H * S * S * d / FUSED_PEAK_OPS_PER_S[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the products each kernel computes, in units of B*H*S^2*d operations:
# the forward 4 (q.k^T, p.v), dq 6 (q.k^T and dO.v^T again, dS.k), dk/dv
# 8 (q.k^T and dO.v^T again, P^T.dO, dS^T.q), the backward pair 14
KERNEL_UNITS = {"fwd": 4, "dq": 6, "dkdv": 8, "bwd": 14}


def achieved_tflops(q, kind, ms):
    """TFLOP/s of kernel ``kind`` on q [B, H, S, d] in ``ms``, counted
    on the work it does (KERNEL_UNITS)."""
    B, H, S, d = q.shape
    return KERNEL_UNITS[kind] * B * H * S * S * d / (ms * 1e-3) / 1e12


LONG_OUTPUTS = ("out", "lse", "dq", "dk", "dv", "dbias")
# what a backward kernel's library_ms times: no PyTorch call computes dq
# or dk/dv alone, so each carries the SDPA backward of the pair
LIBRARY_OF = {"dq": "SDPA backward of the dq + dk/dv pair",
              "dkdv": "SDPA backward of the dq + dk/dv pair",
              "bwd": "SDPA backward"}
# The kernels past S 1024 against the plain version: each output's
# max |kernel - plain| as a share of the plain output's own largest
# magnitude, held to a limit per output and type that lies between the
# readings of the sound kernels and of planted faults on the H100
# (tools/attention_fault_check.py; PERF.md). Largest sound readings over
# the cases: fp32 4.1e-6 (out), 2.0e-7 (lse), 9.6e-7 (gradients); bf16,
# whose outputs both sides round to bf16, 2.5e-3 (out), 4.0e-3 (dq),
# 3.3e-3 (dk), 2.3e-3 (dv), 4.0e-4 (dbias, fp32). Smallest fault
# readings: 2.2e-3 (lse, one 64-key tile skipped at S 8192), 9.9e-2
# (dbias), 0.22 or more for the rest.
LONG_RTOL = {
    torch.float32: dict(out=1e-4, lse=1e-5, dq=1e-4, dk=1e-4, dv=1e-4,
                        dbias=1e-4),
    torch.bfloat16: dict(out=1e-2, lse=1e-5, dq=1e-2, dk=1e-2, dv=1e-2,
                         dbias=1e-2)}
# float16 runs the same kernels as bfloat16 with three more mantissa
# bits: bf16's limits hold it
LONG_RTOL[torch.float16] = LONG_RTOL[torch.bfloat16]


def long_case_list():
    """Every long-sequence kernel case as (name, B, H, S, bias_shape, p,
    dtype, backward, by_pair): batch 1 with the full 12 heads of 64 at
    S 2048, 4096 and 8192, p = 0, fp32 and bf16; at S 2048 dropout 0.1
    and a per-row [1, 12, S, S] bias; then bf16 with dropout 0.1 at each
    shape of the bert_long phase (S 2048 x 8, 4096 x 4, 8192 x 2), the
    last one held to the plain version one (batch, head) pair at a time,
    whose [B, H, S, S] tensors would not fit the card whole."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for S in (2048, 4096, 8192):
            cases.append(("S%d_%s" % (S, tag), 1, 12, S, "padding", 0.0,
                          dtype, True, False))
        cases.append(("S2048_dropout_" + tag, 1, 12, 2048, "padding", 0.1,
                      dtype, True, False))
        cases.append(("S2048_bias_1x12xSxS_" + tag, 1, 12, 2048,
                      (1, 12, 2048, 2048), 0.0, dtype, True, False))
    for S, B in ((2048, 8), (4096, 4), (8192, 2)):
        cases.append(("S%d_batch%d_dropout_bf16" % (S, B), B, 12, S,
                      "padding", 0.1, torch.bfloat16, True, S == 8192))
    return cases


def long_plain(A, q, k, v, do, bias, seed, scale, p, backward, first_pair=0):
    """{output: tensor} of the plain version: the forward, the row
    logsumexp of the biased fp32 scores and, with ``backward``, autograd's
    dq, dk, dv and dbias for the upstream gradient ``do``."""
    leaves = [t.detach().clone().requires_grad_(backward)
              for t in (q, k, v, bias)]
    o = A._ref_fused_attention(*leaves, scale, p, seed, first_pair)
    want = {"lse": torch.logsumexp(A._ref_scores(q, k, bias, scale), dim=-1)}
    if backward:
        want.update(zip(("dq", "dk", "dv", "dbias"),
                        torch.autograd.grad(o, leaves, do)))
    want["out"] = o.detach()
    return want


def long_check(A, dev, name, B, H, S, bias_shape, p, dtype, backward=True,
               by_pair=False):
    """The kernels past S 1024 (d 64) against the plain version on the
    same inputs and seed: flash_attention's output and row logsumexp, and
    flash_attention_backward's dq, dk, dv, dbias of one random upstream
    gradient. ``bias_shape`` as ``fused_case``. ``by_pair`` runs the plain
    version one (batch, head) pair at a time with that pair's dropout
    mask, and sums its bias gradients over the pairs that share a bias
    row. The inputs come from a generator seeded by the case, so every
    run of a case sees the same data. Returns (record, inputs): the
    record holds each output's max |err|, the plain output's largest
    magnitude, their ratio and its limit; nothing is raised here."""
    d = 64
    gen = torch.Generator(device=dev).manual_seed(zlib.crc32(name.encode()))
    q, k, v, do = (torch.randn(B, H, S, d, device=dev, generator=gen)
                   .to(dtype) for _ in range(4))
    if bias_shape == "padding":
        lens = torch.randint(S // 2, S + 1, (B, 1), device=dev,
                             generator=gen)
        bias = torch.where(torch.arange(S, device=dev)[None] < lens, 0.0,
                           -1e4).view(B, 1, 1, S)
    else:
        bias = torch.randn(*bias_shape, device=dev, generator=gen)
    seed = torch.tensor([7919 * S + B], dtype=torch.int64, device=dev)
    scale = d ** -0.5
    o, lse = A.flash_attention(q, k, v, bias, scale, p, seed)
    got = {"out": o, "lse": lse}
    if backward:
        got.update(zip(("dq", "dk", "dv", "dbias"),
                       A.flash_attention_backward(q, k, v, bias, seed, do, o,
                                                  lse, scale, p)))
    err = dict.fromkeys(got, 0.0)
    ref = dict.fromkeys(got, 0.0)

    def compare(key, a, b):
        err[key] = max(err[key], (a.float() - b.float()).abs().max().item())
        ref[key] = max(ref[key], b.float().abs().max().item())

    if not by_pair:
        want = long_plain(A, q, k, v, do, bias, seed, scale, p, backward)
        for key in got:
            compare(key, got[key], want[key])
        del want
    else:
        dbias = torch.zeros_like(got["dbias"]) if backward else None
        for b in range(B):
            for h in range(H):
                one = [t[b:b + 1, h:h + 1] for t in (q, k, v, do)]
                bb, bh = (b if bias.shape[0] > 1 else 0,
                          h if bias.shape[1] > 1 else 0)
                want = long_plain(A, *one, bias[bb:bb + 1, bh:bh + 1], seed,
                                  scale, p, backward, first_pair=b * H + h)
                for key in got:
                    if key != "dbias":
                        compare(key, got[key][b:b + 1, h:h + 1], want[key])
                if backward:
                    dbias[bb:bb + 1, bh:bh + 1] += want["dbias"].float()
                del want
        if backward:
            compare("dbias", got["dbias"], dbias)
    rtol = LONG_RTOL[dtype]
    rec = dict(name=name, B=B, H=H, S=S, d=d, dtype=str(dtype),
               bias=list(bias.shape), dropout=p, by_pair=by_pair,
               tier=reference_tier(S, d), max_abs_err=err, ref_max_abs=ref,
               rel_err={key: err[key] / ref[key] for key in err},
               rtol={key: rtol[key] for key in err})
    del got
    return rec, (q, k, v, do, bias, seed, scale, p, o, lse)


def long_case(A, dev, flush, case, timed):
    """One long-sequence case (``long_case_list``): held to its limits,
    then with ``timed`` the forward kernel, the dq kernel and the dk/dv
    kernel alone and together, the plain version (autograd for its
    backward) and SDPA with the same float mask at p = 0."""
    name, B, H, S, bias_shape, p, dtype, backward, by_pair = case
    rec, (q, k, v, do, bias, seed, scale, p, o, lse) = long_check(
        A, dev, name, B, H, S, bias_shape, p, dtype, backward, by_pair)
    for key, rel in rec["rel_err"].items():
        if not rel <= rec["rtol"][key]:
            raise AssertionError(
                "%s: long attention %s kernel vs plain max |err| %g = %g of "
                "the plain's largest magnitude > %g" % (
                    name, key, rec["max_abs_err"][key], rel,
                    rec["rtol"][key]))
    if timed:
        bias_f, strides = A._bias_operand(bias, B, H, S)
        f_ms, f_by = long_bound(q, bias, "fwd")
        rec["fwd"] = dict(
            kernel_ms=time_ms(lambda: A.fused_attention_fwd_kernel(
                q, k, v, bias_f, strides, seed, scale, p), flush),
            plain_ms=time_ms(lambda: A._ref_fused_attention(
                q, k, v, bias, scale, p, seed), flush),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias.to(dtype), scale=scale), flush),
            bound_ms=f_ms, bound_by=f_by,
            max_abs_err=max(rec["max_abs_err"][x] for x in ("out", "lse")))
        rec["fwd"]["tflops"] = achieved_tflops(q, "fwd",
                                               rec["fwd"]["kernel_ms"])
    if timed and backward:
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (q, k, v, bias)]
        ref = A._ref_fused_attention(*leaves, scale, p, seed)
        _, delta = A.fused_attention_bwd_dq_kernel(
            q, k, v, bias_f, strides, seed, o, lse, do, scale, p)
        dbias_shape = (B, H if strides[1] else 1, S if strides[2] else 1, S)
        lib_leaves = [t.detach().clone().requires_grad_(True)
                      for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(
            *lib_leaves, attn_mask=bias.to(dtype), scale=scale)
        plain_bwd = time_ms(lambda: torch.autograd.grad(
            ref, leaves, do, retain_graph=True), flush)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            lib_out, lib_leaves, do, retain_graph=True), flush)
        errs = {"dq": ("dq",), "dkdv": ("dk", "dv", "dbias"),
                "bwd": ("dq", "dk", "dv", "dbias")}
        for kind, fn in (
                ("dq", lambda: A.fused_attention_bwd_dq_kernel(
                    q, k, v, bias_f, strides, seed, o, lse, do, scale, p)),
                ("dkdv", lambda: A.fused_attention_bwd_dkdv_kernel(
                    q, k, v, bias_f, strides, seed, lse, delta, do, scale,
                    p, dbias_shape)),
                ("bwd", lambda: A.flash_attention_backward(
                    q, k, v, bias, seed, do, o, lse, scale, p))):
            b_ms, b_by = long_bound(q, bias, kind)
            # dq and dk/dv carry the SDPA backward's time of the pair
            rec[kind] = dict(
                kernel_ms=time_ms(fn, flush), plain_ms=plain_bwd,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_bwd,
                library_of=LIBRARY_OF[kind],
                max_abs_err=max(rec["max_abs_err"][x] for x in errs[kind]))
            rec[kind]["tflops"] = achieved_tflops(q, kind,
                                                  rec[kind]["kernel_ms"])
        rec["bwd"]["library_bwd_of_both_halves_ms"] = lib_bwd
        del ref, leaves, lib_out, lib_leaves
    emit(phase="kernels", kernel="long_attention", **rec)
    del q, k, v, do, bias, o, lse
    torch.cuda.empty_cache()
    return rec


def long_cases(A, dev, flush):
    """Every long-sequence case, the batch-1 ones timed; returns the bf16
    records at S 2048 (the long tier's path length) and S 8192 (the flash
    tier's), p = 0, which the summary line reports."""
    recs = {}
    for case in long_case_list():
        recs[case[0]] = long_case(A, dev, flush, case, timed=case[1] == 1)
    return recs["S2048_bf16"], recs["S8192_bf16"]


def packed_case_list():
    """Every packed-layout kernel case as (name, B, S, H, d, bias_shape,
    p, dtype, timed), fp32 and bf16: BERT-base at batch 128, S 128 (the
    bert_packed path, where the TPU runs its resident tier) with the
    padding mask [B, 1, 1, S] and with a per-head bias [B, 12, 1, S];
    BERT-tiny at the same batch and S (4 heads of 16, the padding mask:
    the bert_packed path's BERT-tiny run, where the TPU runs its packed
    tier); each at p 0 timed and at p 0.1 untimed; and, untimed, batch
    8, S 256, 3 heads of 64 with a per-head bias, where the odd H fails
    the resident gate and the TPU runs its packed tier."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for name, H, d, heads in (("resident_bcast", 12, 64, 1),
                                  ("resident_heads", 12, 64, 12),
                                  ("tiny_path", 4, 16, 1)):
            for p in (0.0, 0.1):
                cases.append(("%s%s_%s" % (name, "_dropout" if p else "",
                                           tag), 128, 128, H, d,
                              (128, heads, 1, 128), p, dtype, p == 0.0))
        cases.append(("odd_heads_" + tag, 8, 256, 3, 64, (8, 3, 1, 256),
                      0.0, dtype, False))
    return cases


def packed_check(A, dev, name, B, S, H, d, bias_shape, p, dtype, salt=0):
    """The kernels on packed [B, S, H*d] operands, read through the heads'
    [B, H, S, d] views (strides S*H*d, d, H*d), against the plain version
    on the same inputs and seed: the forward's output and row logsumexp,
    and the backward's dq, dk, dv and dbias of one random upstream
    gradient. The bias is a padding mask (lengths S/2..S) plus, for a
    per-head shape, a random term per head. The inputs come from a
    generator seeded by the case and ``salt`` (0 in chip_smoke; others
    give the spread of the readings over data and dropout masks).
    Returns (record, inputs) as ``long_check``; raises nothing."""
    gen = torch.Generator(device=dev).manual_seed(
        zlib.crc32(name.encode()) + salt)
    q, k, v, do = (A._split_heads(torch.randn(B, S, H * d, device=dev,
                                              generator=gen).to(dtype), H)
                   for _ in range(4))
    lens = torch.randint(S // 2, S + 1, (B, 1), device=dev, generator=gen)
    bias = torch.where(torch.arange(S, device=dev)[None] < lens, 0.0,
                       -1e4).view(B, 1, 1, S)
    if bias_shape[1] > 1:
        bias = bias + torch.randn(*bias_shape, device=dev, generator=gen)
    seed = torch.tensor([7919 * S + B + salt], dtype=torch.int64,
                        device=dev)
    scale = d ** -0.5
    bias_f, strides = A._bias_operand(bias, B, H, S)
    o, lse = A.fused_attention_fwd_kernel(q, k, v, bias_f, strides, seed,
                                          scale, p)
    got = dict(zip(LONG_OUTPUTS, (o, lse) + A.fused_attention_backward(
        q, k, v, bias_f, strides, seed, o, lse, do, scale, p,
        bias_grad=True)))
    if not all(got[key].stride() == q.stride()
               for key in ("out", "dq", "dk", "dv")):
        raise AssertionError("%s: the kernels' outputs left the packed "
                             "layout: %s" % (name, {
                                 key: got[key].stride() for key in got}))
    want = long_plain(A, q, k, v, do, bias, seed, scale, p, True)
    err = {key: (got[key].float() - want[key].float()).abs().max().item()
           for key in LONG_OUTPUTS}
    ref = {key: want[key].float().abs().max().item() for key in LONG_OUTPUTS}
    rtol = LONG_RTOL[dtype]
    rec = dict(name=name, B=B, S=S, H=H, d=d, dtype=str(dtype),
               bias=list(bias.shape), dropout=p,
               tier=reference_tier(S, d, (B, H, q.element_size(),
                                          bias.shape)), salt=salt,
               max_abs_err=err, ref_max_abs=ref,
               rel_err={key: err[key] / ref[key] for key in err},
               rtol={key: rtol[key] for key in err})
    del got, want
    return rec, (q, k, v, do, bias, bias_f, strides, seed, scale, o, lse)


def packed_case(A, dev, flush, case):
    """One packed-layout case (``packed_case_list``): held to its limits
    (LONG_RTOL), then when timed the forward kernel, the dq kernel and the
    dk/dv kernel alone and together on the heads' views, the plain
    version (autograd for its backward), and SDPA on the heads' views with
    the same float mask at p = 0, its layout copies counted (it returns
    the packed [B, S, H*d] output, as the kernels do). Bounds as
    ``long_bound`` on the [B, H, S, d] view: at S 128 the bytes bound
    both directions."""
    name, B, S, H, d, bias_shape, p, dtype, timed = case
    rec, (q, k, v, do, bias, bias_f, strides, seed, scale, o, lse) = \
        packed_check(A, dev, name, B, S, H, d, bias_shape, p, dtype)
    for key, rel in rec["rel_err"].items():
        if not rel <= rec["rtol"][key]:
            raise AssertionError(
                "%s: packed attention %s kernel vs plain max |err| %g = %g "
                "of the plain's largest magnitude > %g" % (
                    name, key, rec["max_abs_err"][key], rel,
                    rec["rtol"][key]))
    if timed:
        mask = bias.to(dtype)
        packed = [A._merge_heads(t) for t in (q, k, v)]

        def library(q_, k_, v_):
            return A._merge_heads(F.scaled_dot_product_attention(
                *(A._split_heads(t, H) for t in (q_, k_, v_)),
                attn_mask=mask, scale=scale))

        f_ms, f_by = long_bound(q, bias, "fwd")
        rec["fwd"] = dict(
            kernel_ms=time_ms(lambda: A.fused_attention_fwd_kernel(
                q, k, v, bias_f, strides, seed, scale, p), flush),
            plain_ms=time_ms(lambda: A._ref_fused_attention_packed(
                *packed, bias, H, scale, p, seed), flush),
            library_ms=time_ms(lambda: library(*packed), flush),
            bound_ms=f_ms, bound_by=f_by,
            max_abs_err=max(rec["max_abs_err"][x] for x in ("out", "lse")))
        rec["fwd"]["tflops"] = achieved_tflops(q, "fwd",
                                               rec["fwd"]["kernel_ms"])
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in packed + [bias]]
        ref = A._ref_fused_attention_packed(*leaves, H, scale, p, seed)
        lib_leaves = [t.detach().clone().requires_grad_(True)
                      for t in packed]
        lib_out = library(*lib_leaves)
        do_packed = A._merge_heads(do)
        plain_bwd = time_ms(lambda: torch.autograd.grad(
            ref, leaves, do_packed, retain_graph=True), flush)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            lib_out, lib_leaves, do_packed, retain_graph=True), flush)
        _, delta = A.fused_attention_bwd_dq_kernel(
            q, k, v, bias_f, strides, seed, o, lse, do, scale, p)
        dbias_shape = (B, bias_shape[1], 1, S)
        errs = {"dq": ("dq",), "dkdv": ("dk", "dv", "dbias"),
                "bwd": ("dq", "dk", "dv", "dbias")}
        for kind, fn in (
                ("dq", lambda: A.fused_attention_bwd_dq_kernel(
                    q, k, v, bias_f, strides, seed, o, lse, do, scale, p)),
                ("dkdv", lambda: A.fused_attention_bwd_dkdv_kernel(
                    q, k, v, bias_f, strides, seed, lse, delta, do, scale,
                    p, dbias_shape)),
                ("bwd", lambda: A.fused_attention_backward(
                    q, k, v, bias_f, strides, seed, o, lse, do, scale, p,
                    bias_grad=True))):
            b_ms, b_by = long_bound(q, bias, kind)
            # dq and dk/dv carry the SDPA backward's time of the pair
            rec[kind] = dict(
                kernel_ms=time_ms(fn, flush), plain_ms=plain_bwd,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_bwd,
                library_of=LIBRARY_OF[kind],
                max_abs_err=max(rec["max_abs_err"][x] for x in errs[kind]))
            rec[kind]["tflops"] = achieved_tflops(q, kind,
                                                  rec[kind]["kernel_ms"])
        rec["bwd"]["library_bwd_of_both_halves_ms"] = lib_bwd
        del ref, leaves, lib_out, lib_leaves, packed
    emit(phase="kernels", kernel="packed_attention", **rec)
    del q, k, v, do, bias, o, lse
    torch.cuda.empty_cache()
    return rec


def packed_cases(A, dev, flush):
    """Every packed-layout case; returns the timed bf16 records at the
    bert_packed path's two shapes, BERT-base (the TPU's resident tier)
    and BERT-tiny (its packed tier), which the summary line reports."""
    recs = {}
    for case in packed_case_list():
        recs[case[0]] = packed_case(A, dev, flush, case)
    return recs["resident_bcast_bf16"], recs["tiny_path_bf16"]


def packed_equals_per_head(A, dev):
    """The packed entry (the kernels on the heads' strided views) and
    fused_attention on contiguous transposed copies of the operands at
    p 0.1 with one seed (BERT-base's heads, batch 16, S 128, padding
    mask): out, dq, dk and dv equal to the last bit, dbias (summed over
    heads by fp32 atomics in the order blocks finish) within 1e-6 of its
    largest magnitude."""
    B, S, H, d, p = 16, 128, 12, 64, 0.1
    gen = torch.Generator(device=dev).manual_seed(16)
    q, k, v, do = (torch.randn(B, S, H * d, device=dev, generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    lens = torch.randint(S // 2, S + 1, (B, 1), device=dev, generator=gen)
    bias = torch.where(torch.arange(S, device=dev)[None] < lens, 0.0,
                       -1e4).view(B, 1, 1, S)
    seed = torch.tensor([4242], dtype=torch.int64, device=dev)

    def run(fn):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (q, k, v, bias)]
        out = fn(*leaves)
        return [out.detach()] + list(torch.autograd.grad(out, leaves, do))

    packed = run(lambda q_, k_, v_, b_: A.fused_attention_packed(
        q_, k_, v_, b_, n_heads=H, dropout_prob=p, seed=seed))
    heads = run(lambda q_, k_, v_, b_: A._merge_heads(A.fused_attention(
        *(A._split_heads(t, H).contiguous() for t in (q_, k_, v_)), b_,
        dropout_prob=p, seed=seed)))
    torch.cuda.synchronize()
    equal = {key: bool(torch.equal(a, b)) for key, a, b in
             zip(("out", "dq", "dk", "dv"), packed, heads)}
    dbias_rel = ((packed[4] - heads[4]).abs().max() /
                 heads[4].abs().max()).item()
    if not (all(equal.values()) and dbias_rel <= 1e-6):
        raise AssertionError("packed vs per-head at p %g: bit-equal %s, "
                             "dbias rel %g (> 1e-6?)" % (p, equal,
                                                         dbias_rel))
    emit(phase="kernels", kernel="packed_vs_per_head", B=B, S=S, H=H, d=d,
         dropout=p, bit_equal=equal, dbias_rel=dbias_rel)


def width_case(A, dev, name, B, H, S, d, p, dtype):
    """Untimed: ``fused_attention`` (the entry every route takes, which
    zero-pads a head width the kernels are not built for) forward and
    backward against the plain version, padding mask, each output held
    to LONG_RTOL relative to the plain output's largest magnitude."""
    gen = torch.Generator(device=dev).manual_seed(zlib.crc32(name.encode()))
    q, k, v, do = (torch.randn(B, H, S, d, device=dev, generator=gen)
                   .to(dtype) for _ in range(4))
    lens = torch.randint(S // 2, S + 1, (B, 1), device=dev, generator=gen)
    bias = torch.where(torch.arange(S, device=dev)[None] < lens, 0.0,
                       -1e4).view(B, 1, 1, S)
    seed = torch.tensor([7919 * S + d], dtype=torch.int64, device=dev)
    got, want = [], []
    for fn, out in ((lambda *t: A.fused_attention(
            *t, dropout_prob=p, seed=seed), got),
            (lambda *t: A._ref_fused_attention(*t, d ** -0.5, p, seed),
             want)):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (q, k, v, bias)]
        o = fn(*leaves)
        out.extend([o.detach()] + list(torch.autograd.grad(o, leaves, do)))
    torch.cuda.synchronize()
    rtol = LONG_RTOL[dtype]
    rel = {}
    for key, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        rel[key] = ((a.float() - b.float()).abs().max() /
                    b.float().abs().max()).item()
        if not rel[key] <= rtol[key]:
            raise AssertionError("%s: fused attention %s kernel vs plain "
                                 "%g of the plain's largest magnitude > %g"
                                 % (name, key, rel[key], rtol[key]))
    emit(phase="kernels", kernel="fused_attention_width", name=name, B=B,
         H=H, S=S, d=d, built_width=A.built_width(d),
         column_chunks=A.column_chunks(d), dtype=str(dtype), dropout=p,
         rel_err=rel, rtol=rtol)


def fused_cases(A, dev, gen, flush):
    """Every case of the fused kernels; returns the BERT path's fp32
    records at dropout 0.1 and 0, which the summary line reports. fp32
    runs on the tensor cores as 3xTF32 up to d 128. Untimed, head widths
    the kernels reach zero-padded (48, 80, 160), built at d 256 (the
    SIMT forward in every type, the backward's outputs in two column
    halves on the tensor cores, 32-row tiles in fp32) and past 256 (d 320
    and 512: the outputs' columns in 64-column chunks, one block each) in
    fp32, bf16 and fp16, and fp16 at the BERT path's shape."""
    path = path_p0 = None
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        rec = fused_case(A, dev, gen, flush, "path_" + tag, 32, 12, 512, 64,
                         "padding", 0.1, dtype)
        path = path or rec
        rec = fused_case(A, dev, gen, flush, "path_p0_" + tag, 32, 12, 512,
                         64, "padding", 0.0, dtype)
        path_p0 = path_p0 or rec
        for bias_shape in ((4, 12, 1, 256), (4, 1, 256, 256),
                           (4, 12, 256, 256)):
            fused_case(A, dev, gen, flush, "bias_%s_%s" % (
                "x".join(map(str, bias_shape[1:3])), tag), 4, 12, 256, 64,
                bias_shape, 0.1, dtype)
        fused_case(A, dev, gen, flush, "ragged_" + tag, 8, 12, 500, 64,
                   "padding", 0.1, dtype)
        fused_case(A, dev, gen, flush, "d128_" + tag, 8, 8, 512, 128,
                   "padding", 0.1, dtype)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16"),
                       (torch.float16, "f16")):
        width_case(A, dev, "d48_" + tag, 4, 16, 512, 48, 0.1, dtype)
        width_case(A, dev, "d80_" + tag, 4, 8, 384, 80, 0.0, dtype)
        width_case(A, dev, "d160_" + tag, 2, 4, 300, 160, 0.1, dtype)
        width_case(A, dev, "d256_" + tag, 2, 4, 520, 256, 0.0, dtype)
        width_case(A, dev, "d320_" + tag, 2, 4, 300, 320, 0.1, dtype)
        width_case(A, dev, "d512_" + tag, 2, 2, 260, 512, 0.0, dtype)
    for p in (0.0, 0.1):
        width_case(A, dev, "path_f16_p%g" % p, 32, 12, 512, 64, p,
                   torch.float16)
    return path, path_p0


FUSED_KERNELS = ("fused_attention_fwd_kernel", "fused_attention_bwd_dq_kernel",
                 "fused_attention_bwd_dkdv_kernel")
# each fused wrapper's launches that ran on the tensor cores (fp32 as
# 3xTF32, bfloat16 and float16 by their own products; up to d 128, the
# 16-bit backward also at d 256)
TENSOR_CORES = tuple(name + ":tensor_cores" for name in FUSED_KERNELS)
FWD_TC, DQ_TC, DKDV_TC = TENSOR_CORES


def reset_launches(A):
    A.decode_attention_kernel.launches = 0
    A.paged_attention_kernel.launches = 0
    for name in FUSED_KERNELS:
        getattr(A, name).launches = 0
        getattr(A, name).tensor_core_launches = 0


def launches(A, names):
    """{wrapper: launches} of ``names`` and, for each fused wrapper among
    them, {wrapper:tensor_cores: its launches on the tensor cores}."""
    got = {name: getattr(A, name).launches for name in names}
    for name, tc in zip(FUSED_KERNELS, TENSOR_CORES):
        if name in names:
            got[tc] = getattr(A, name).tensor_core_launches
    return got


@contextlib.contextmanager
def plain_attention(T, A):
    """Route the model's dense decode attention through the plain
    version (the whole-model kernel-vs-plain step comparison)."""
    def plain(q, k, v, cache_len, scale=None, causal_window=False):
        return A._ref_attention_cache(q, k, v, cache_len, scale,
                                      causal_window)

    saved, T.attention_with_cache = T.attention_with_cache, plain
    try:
        yield
    finally:
        T.attention_with_cache = saved


def dense_path(T, A, inference, monitor, dev):
    B, SRC, PROMPT, CAP, NEW = 64, 128, 64, 1024, 32
    model = T.Transformer.big(device=dev, seed=0)
    pred = inference.GenerativePredictor(
        model, batch_size=B, src_len=SRC, prompt_len=PROMPT,
        cache_capacity=CAP, device=dev)
    rng = np.random.RandomState(0)
    src = rng.randint(2, 32000, (B, SRC)).astype(np.int64)
    prompt = rng.randint(2, 32000, (B, PROMPT)).astype(np.int64)
    plens = rng.randint(PROMPT // 2, PROMPT + 1, B).astype(np.int64)
    feed = {"src": src, "prompt": prompt, "prompt_lens": plens}
    pred.run(feed, max_new_tokens=2)                      # warm-up
    t0 = time.perf_counter()
    pred.run(feed, max_new_tokens=1)                      # prefill only
    t_prefill = time.perf_counter() - t0

    steps0 = monitor.counter("decode_steps_total").value
    reset_launches(A)
    t0 = time.perf_counter()
    tokens, finished = pred.run(feed, max_new_tokens=NEW)
    t_full = time.perf_counter() - t0
    launches = A.decode_attention_kernel.launches
    paged_launches = A.paged_attention_kernel.launches
    steps = monitor.counter("decode_steps_total").value - steps0
    L = len(model.dec_layers)
    if steps != NEW - 1 or launches != L * steps or paged_launches:
        raise AssertionError(
            "dense path: %d decode-kernel launches over %d steps (want %d "
            "per step), %d paged launches" % (launches, steps, L,
                                              paged_launches))
    if tokens.shape != (B, NEW) or tokens.dtype != np.int64 or \
            tokens.min() < 0 or tokens.max() >= 32000:
        raise AssertionError("dense path: bad tokens %s %s"
                             % (tokens.shape, tokens.dtype))
    again, _ = pred.run(feed, max_new_tokens=NEW)
    if not np.array_equal(again, tokens):
        raise AssertionError("dense path: generation is not deterministic")

    # one whole-model decode step, kernels vs plain versions, from the
    # same prefilled state
    sess = pred._session
    with torch.no_grad():
        caches = [torch.zeros_like(c) for c in sess._caches]
        outs = model.prefill(
            torch.from_numpy(src).to(dev), torch.from_numpy(prompt).to(dev),
            sess._pos_src, sess._pos_tgt, sess._causal,
            torch.zeros(B, dtype=torch.int32, device=dev), *caches)
        cross = outs[1 + 2 * L:1 + 4 * L]
        tok = torch.from_numpy(tokens[:, :1].astype(np.int32)).to(dev)
        fin = torch.zeros(B, 1, dtype=torch.bool, device=dev)
        lens = torch.from_numpy(plens.astype(np.int32)).to(dev)
        logits = {}
        for route, ctx in (("kernel", contextlib.nullcontext()),
                           ("plain", plain_attention(T, A))):
            state = [c.clone() for c in caches]
            captured = []
            hook = model.proj.register_forward_hook(
                lambda m, i, o: captured.append(o))
            try:
                with ctx:
                    model.decode_step(tok, fin, sess._end_ids, lens,
                                      *cross, *state)
            finally:
                hook.remove()
            logits[route] = captured[0]
        torch.cuda.synchronize()
    step_err = (logits["kernel"] - logits["plain"]).abs().max().item()
    if not (torch.isfinite(logits["kernel"]).all() and
            step_err <= STEP_LOGITS_ATOL):
        raise AssertionError("dense path: decode-step logits kernel vs "
                             "plain max |err| %g > %g"
                             % (step_err, STEP_LOGITS_ATOL))
    emit(phase="dense", batch=B, src_len=SRC, prompt_len=PROMPT,
         cache_capacity=CAP, new_tokens=NEW, decode_steps=steps,
         decode_kernel_launches=launches, launches_per_step=launches / steps,
         prefill_s=t_prefill, generate_s=t_full,
         step_ms=(t_full - t_prefill) / (NEW - 1) * 1e3,
         tokens_per_s=B * NEW / t_full,
         decode_tokens_per_s=B * (NEW - 1) / (t_full - t_prefill),
         finished=int(finished.sum()), step_logits_max_abs_err=step_err,
         step_logits_atol=STEP_LOGITS_ATOL,
         step_logits_max_abs=logits["plain"].abs().max().item())
    return pred, launches, feed


def serving_path(T, A, inference, monitor, dev, dense_pred, dense_feed):
    W, SRC, PROMPT, CAP = 8, 128, 64, 1024
    model = dense_pred._session.model
    pred = inference.GenerativePredictor(
        model, batch_size=W, src_len=SRC, prompt_len=PROMPT,
        cache_capacity=CAP, paged=True, page_tokens=128, pool_pages=25,
        prefix_cache_size=8, device=dev)
    # 16 requests over 10 distinct (src, prompt) pairs: rows of the dense
    # path's batch, so the dense session's tokens are the yardstick
    rng = np.random.RandomState(1)
    rows = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 0, 3, 5, 0, 8, 3]
    budgets = rng.randint(8, 33, len(rows)).tolist()
    src, prompt, plens = (dense_feed[k] for k in ("src", "prompt",
                                                  "prompt_lens"))
    results, latency = [None] * len(rows), [None] * len(rows)
    hits0 = monitor.counter("decode_prefix_hit_total").value
    steps0 = monitor.counter("decode_steps_total").value
    occ = monitor.histogram("serving_batch_occupancy",
                            labels={"model": "smoke"})
    occ0 = (occ.sum, occ.count)
    reset_launches(A)
    t0 = time.perf_counter()
    with inference.GenerativeServer(pred.open_stream(), model="smoke") as srv:
        def client(k):
            # submit this client's requests back to back, then poll them:
            # a request's latency is submit -> its future resolving
            pending = {}
            for j in range(k, len(rows), 4):
                i = rows[j]
                pending[j] = (time.perf_counter(), srv.submit(
                    src[i], prompt[i], prompt_len=int(plens[i]),
                    max_new_tokens=budgets[j]))
            while pending:
                for j, (ts, fut) in list(pending.items()):
                    if fut.done():
                        latency[j] = time.perf_counter() - ts
                        results[j] = fut.result()
                        del pending[j]
                time.sleep(0.001)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            if t.is_alive():
                raise AssertionError("serving client thread hung")
    wall = time.perf_counter() - t0
    launches = A.paged_attention_kernel.launches
    dense_launches = A.decode_attention_kernel.launches
    steps = monitor.counter("decode_steps_total").value - steps0
    hits = monitor.counter("decode_prefix_hit_total").value - hits0
    if any(r is None for r in results):
        raise AssertionError("serving: unresolved futures")
    if not (launches > 0 and launches == len(model.dec_layers) * steps
            and dense_launches == 0 and hits > 0):
        raise AssertionError(
            "serving: %d paged launches over %d steps, %d dense launches, "
            "%d prefix hits" % (launches, steps, dense_launches, hits))
    for (tok, fin), budget in zip(results, budgets):
        if tok.dtype != np.int64 or not 1 <= len(tok) <= budget or \
                tok.min() < 0 or tok.max() >= 32000:
            raise AssertionError("serving: bad tokens %r" % (tok,))
    dense_tokens, _ = dense_pred.run(dense_feed, max_new_tokens=max(budgets))
    agree = sum(np.array_equal(tok, dense_tokens[i, :len(tok)])
                for (tok, _), i in zip(results, rows))
    lat = np.array(latency)
    emit(phase="serving", width=W, page_tokens=128, pool_pages=25,
         prefix_cache_size=8, requests=len(rows), distinct=len(set(rows)),
         wall_s=wall, decode_steps=steps, paged_kernel_launches=launches,
         launches_per_step=launches / steps, prefix_hits=hits,
         request_p50_s=float(np.percentile(lat, 50)),
         request_p99_s=float(np.percentile(lat, 99)),
         occupancy_mean=(occ.sum - occ0[0]) / (occ.count - occ0[1]),
         tokens_served=int(sum(len(t) for t, _ in results)),
         agree_with_dense=agree)
    return launches


BERT_BATCH, BERT_SEQ, BERT_STEPS = 32, 512, 6
# One BERT-base training step, kernels vs plain attention from the same
# cloned scope and generator (the same dropout masks), fp32 with TF32 off.
# Loss: relative difference. Gradients: the Adam first moments after the
# step, (1 - beta1) * grad, as a share of each tensor's largest
# magnitude. Only summation order differs; a wrong mask or bias term in
# one layer moves both by orders of magnitude more.
# Limits: about ten times the first reading on the H100 (loss identical
# to the last bit, gradients 6.0e-6; PERF.md), a few ulps for the loss.
BERT_LOSS_RTOL = 1e-6
BERT_GRAD_RTOL = 1e-4
BERT_WATCH = ("word_emb", "layer_0_attn_q.w_0", "layer_5_attn_k.w_0",
              "layer_11_ffn2.w_0", "mlm_out_bias")


def clone_scope(fluid, scope):
    """A copy of every tensor of ``scope`` and of its generator's state."""
    c = fluid.Scope()
    for n in scope.local_var_names():
        c.set_var(n, scope.find_var(n).clone())
    c.generator = torch.Generator(device=scope.generator.device)
    c.generator.set_state(scope.generator.get_state())
    return c


@contextlib.contextmanager
def plain_fused_attention(A):
    """Route the program's fused_multihead_attention ops through the plain
    version on the card (the whole-step kernel-vs-plain comparison)."""
    def plain(q, k, v, bias=None, scale=None, dropout_prob=0.0, seed=None):
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        return A._ref_fused_attention(q, k, v, bias, float(scale),
                                      float(dropout_prob), seed)

    saved, A.fused_attention = A.fused_attention, plain
    try:
        yield
    finally:
        A.fused_attention = saved


def bert_program(fluid, bert):
    """(cfg, main, startup, loss, build seconds) of the fp32 BERT-base
    pretraining program at BERT_SEQ."""
    cfg = bert.BertConfig.base()
    t0 = time.perf_counter()
    with fluid.unique_name.guard():
        main, startup, loss = bert.build_pretrain_program(cfg,
                                                          seq_len=BERT_SEQ)
    return cfg, main, startup, loss, time.perf_counter() - t0


def bert_step_check(A, exe, fluid, prog, feed, scope):
    """One fp32 step of ``prog`` (``bert_program``) on ``feed`` with the
    fused kernels and one with the plain attention, each from a clone of
    ``scope`` (its tensors and generator): the record of the loss's
    relative difference and the watched first moments' (BERT_WATCH)
    against BERT_LOSS_RTOL and BERT_GRAD_RTOL, ``passes``, and the
    kernel step's ``launches`` (``launches``: the caller holds them to
    their route). Raises if the kernel step did not launch each fused
    kernel once a layer, or the plain step launched any."""
    cfg, main, _, loss, _ = prog
    res = {}
    for route, ctx in (("kernel", contextlib.nullcontext()),
                       ("plain", plain_fused_attention(A))):
        sc = clone_scope(fluid, scope)
        reset_launches(A)
        with ctx:
            step_loss = exe.run(main, feed=feed, fetch_list=[loss],
                                scope=sc)[0]
        launched = launches(A, FUSED_KERNELS)
        if [launched[n] for n in FUSED_KERNELS] != [
                cfg.n_layers * (route == "kernel")] * 3:
            raise AssertionError("bert: the %s step launched the fused "
                                 "kernels %s times" % (route, launched))
        if route == "kernel":
            kernel_launches = launched
        res[route] = (float(step_loss[0]),
                      {n: sc.find_var(n + "_moment1_0") for n in BERT_WATCH},
                      {n: sc.find_var(n) for n in BERT_WATCH})
        del sc
    loss_rel = abs(res["kernel"][0] - res["plain"][0]) / abs(res["plain"][0])
    grad_rel = {n: ((res["kernel"][1][n] - res["plain"][1][n]).abs().max() /
                    res["plain"][1][n].abs().max()).item()
                for n in BERT_WATCH}
    # parameter moves differ in units of the learning rate (the first Adam
    # step moves each entry by about lr, whatever its gradient)
    param_lr = max((res["kernel"][2][n] - res["plain"][2][n]).abs().max()
                   .item() for n in BERT_WATCH) / 1e-4
    return dict(loss_kernel=res["kernel"][0], loss_plain=res["plain"][0],
                loss_rel=loss_rel, loss_rtol=BERT_LOSS_RTOL,
                grad_rel=grad_rel, grad_rel_max=max(grad_rel.values()),
                grad_rtol=BERT_GRAD_RTOL, param_diff_in_lr=param_lr,
                passes=bool(math.isfinite(res["kernel"][0]) and
                            loss_rel <= BERT_LOSS_RTOL and
                            max(grad_rel.values()) <= BERT_GRAD_RTOL),
                launches=kernel_launches)


def bert_path(A, dev):
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg, main, startup, loss, build_s = prog = bert_program(fluid, bert)
    ops = main.global_block().ops
    fused = [op for op in ops if op.type == "fused_multihead_attention"]
    if len(fused) != cfg.n_layers or any(
            op.attr("dropout_prob") != cfg.attn_dropout for op in fused):
        raise AssertionError("bert: %d fused attention ops (want %d with "
                             "dropout %g)" % (len(fused), cfg.n_layers,
                                              cfg.attn_dropout))
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    feed = bert.synthetic_batch(cfg, BERT_BATCH, BERT_SEQ, seed=0)
    exe = fluid.Executor(dev)
    scope = fluid.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0

    # one step with the kernels and one with the plain attention
    check = bert_step_check(A, exe, fluid, prog, feed, scope)
    if list(check["launches"].values()) != [cfg.n_layers] * 6:
        raise AssertionError("bert: the kernel step's launches %s (want %d "
                             "each, all on the tensor cores)"
                             % (check["launches"], cfg.n_layers))
    if not check["passes"]:
        raise AssertionError("bert: step kernel vs plain: loss %r vs %r "
                             "(rel %g > %g?), gradients rel %g (> %g?)"
                             % (check["loss_kernel"], check["loss_plain"],
                                check["loss_rel"], BERT_LOSS_RTOL,
                                check["grad_rel_max"], BERT_GRAD_RTOL))
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_launches(A)
    losses, step_s = [], []
    for _ in range(BERT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(out[0]))
    got = launches(A, FUSED_KERNELS)
    want = cfg.n_layers * BERT_STEPS
    if any(n != want for n in got.values()):
        raise AssertionError("bert: fused kernel launches %s over %d steps "
                             "(want %d each, all on the tensor cores)"
                             % (got, BERT_STEPS, want))
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError("bert: losses not finite and falling: %s"
                             % losses)
    steady = statistics.median(step_s[1:])
    emit(phase="bert", config="BertConfig.base", params=n_params,
         batch=BERT_BATCH, seq_len=BERT_SEQ, dropout=cfg.hidden_dropout,
         ops=len(ops), fused_attention_ops=len(fused), build_s=build_s,
         startup_s=startup_s, losses=losses, step_s=step_s,
         step_ms=steady * 1e3, tokens_per_s=BERT_BATCH * BERT_SEQ / steady,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
         launches=got,
         launches_per_step={k: v / BERT_STEPS for k, v in got.items()},
         step_vs_plain=check)
    return got


LONG_SHAPES = ((2048, 8), (4096, 4), (8192, 2))   # bench.py bench_longseq
LONG_CHECK_SEQ, LONG_CHECK_BATCH, LONG_STEPS = 2048, 1, 4
# One bf16 AMP step, kernels vs plain attention from a cloned scope and
# generator (the same dropout masks), as the bert phase compares fp32,
# at each data seed of STEP_SEEDS. Both compute attention in fp32 from
# the same bf16 q, k, v and round their output to bf16, but they sum in
# another order, so an output that lies near a rounding boundary comes
# out one bf16 step (2^-8 relative) apart, and the bf16 products of the
# 12 layers below carry that on. The loss is judged over the seeds
# together (STEP_LOSS_MAX, STEP_LOSS_MEAN). Each watched tensor's Adam
# first moment, 0.1 of its gradient, is held at every seed to its own
# limit as a share of its largest magnitude, about five times its first
# reading on the H100 (tools/attention_fault_check.py, PERF.md): word_emb
# 1.1e-2, the query weight 1.3e-2 (0.16 with one k-tile skipped in every
# kernel), the last FFN weight 9.0e-3, the output bias 7.4e-5. The key
# weight stands apart at 2.7e-2 (0.14 with the tile skipped): its
# gradient passes through the softmax's Jacobian, which cancels most of
# it (the key bias's entirely), so the rounding differences of the layers
# above stand out. The path's batch pads nothing (its bias is 0), so this
# step cannot see a fault of the mask; the kernel cases with padding do.
LONG_GRAD_RTOL = {"word_emb": 6e-2, "layer_0_attn_q.w_0": 6e-2,
                  "layer_5_attn_k.w_0": 2 ** -3,
                  "layer_11_ffn2.w_0": 4.5e-2, "mlm_out_bias": 4e-4}


def long_program(fluid, bert, S):
    """(cfg, main, startup, loss, build seconds) of the AMP program."""
    t0 = time.perf_counter()
    cfg = bert.BertConfig.base()
    cfg.max_seq = S
    with fluid.unique_name.guard():
        main, startup, loss = bert.build_pretrain_program(cfg, seq_len=S,
                                                          use_amp=True)
    return cfg, main, startup, loss, time.perf_counter() - t0


# The loss of the one-step checks (bert_long's and bert_packed's), read
# at data seeds 0-5 and judged together: the signed relative differences
# (kernel - plain) / plain, their largest magnitude under STEP_LOSS_MAX
# and the magnitude of their mean under the phase's STEP_LOSS_MEAN, the
# latter for a forward whose rounding leans to one side. A reading is set
# by which attention outputs land on the other side of a bf16 rounding
# boundary, so it scatters with the data: the check's earlier limit, 1e-5
# on one seed, failed the accepted SIMT forward at 4 of these 6 seeds.
# Readings of seeds 0-5 on the H100, 700 W, with the SIMT forward
# (tools/attention_fault_check.py --forward simt, PERF.md):
#   bert_long   +4.04e-6 +5.35e-6 -1.47e-6 -5.90e-6 -7.19e-6 +5.54e-6,
#               mean +6.0e-8 (spread 5.5e-6, so a mean of six 2.2e-6);
#   bert_packed -1.66e-6 +3.13e-6 -6.83e-5 +9.82e-5 -5.55e-5 -3.06e-5,
#               mean -9.1e-6 (spread 5.5e-5, a mean of six 2.3e-5).
# The planted faults' largest |reading| and mean, bert_packed: a skipped
# tile 9.98e-4 and +2.75e-4, no mask 3.49e-4 and -5.37e-5, the mask keyed
# on the head 3.37e-4 and -4.47e-5 (+1.78e-4 at seed 0, the smallest
# fault reading of the one-seed check), a row stride of d 8.6e-3 and
# +1.5e-3;
# bert_long (no padding, batch 1: the mask faults do not show) a skipped
# tile 3.7e-5, a row stride of d 2.8e-3; a transposed K in dq moves only
# the first moments. STEP_LOSS_MAX lies between the SIMT forward's 9.8e-5
# and the smallest fault reading, 1.78e-4; each STEP_LOSS_MEAN about six
# and two of its phase's standard errors of a six-seed mean. Every fault
# fails a first-moment limit in at least one phase; those limits are
# unchanged.
STEP_SEEDS = tuple(range(6))
STEP_LOSS_MAX = 1.7e-4
STEP_LOSS_MEAN = {"bert_long": 1.5e-5, "bert_packed": 4.5e-5}


def step_check_seeds(A, exe, fluid, bert, prog, check, seeds=STEP_SEEDS):
    """The records of the one-step check ``check`` (``long_step_check``
    or ``packed_step_check``) of ``prog`` at each data seed."""
    return [check(A, exe, fluid, bert, prog, data_seed=s) for s in seeds]


def step_verdict(records, grad_rtol, loss_mean, loss_max=STEP_LOSS_MAX):
    """The multi-seed step check's verdict on ``records`` (one per data
    seed, each with its signed loss reading ``loss_signed_rel``, its
    ``loss_kernel`` and its first moments' ``grad_rel``): the largest
    |reading| under ``loss_max``, |mean reading| under ``loss_mean`` (the
    phase's STEP_LOSS_MEAN), and every first moment under its limit in
    ``grad_rtol`` at every seed.
    Returns a dict with the readings, the limits, ``over`` (the limits
    passed: "loss_max", "loss_mean", "first_moments", "loss_not_finite")
    and ``passes``."""
    signed = [r["loss_signed_rel"] for r in records]
    worst = max(abs(x) for x in signed)
    mean = sum(signed) / len(signed)
    grads_over = {"%s@seed%d" % (n, r["data_seed"]): v for r in records
                  for n, v in r["grad_rel"].items() if not v <= grad_rtol[n]}
    over = [name for name, bad in (
        ("loss_not_finite", not all(math.isfinite(r["loss_kernel"])
                                    for r in records)),
        ("loss_max", not worst <= loss_max),
        ("loss_mean", not abs(mean) <= loss_mean),
        ("first_moments", bool(grads_over))) if bad]
    return dict(seeds=[r["data_seed"] for r in records],
                loss_signed_rel=signed, loss_max_abs=worst,
                loss_max=loss_max, loss_mean_rel=mean, loss_mean=loss_mean,
                grad_rel_max={n: max(r["grad_rel"][n] for r in records)
                              for n in grad_rtol},
                grad_rtol=grad_rtol, grads_over=grads_over, over=over,
                passes=not over)


def long_step_check(A, exe, fluid, bert, prog, data_seed=0):
    """One bf16 AMP step of ``prog`` (``long_program`` at LONG_CHECK_SEQ)
    on a batch of LONG_CHECK_BATCH with the kernels, and one with the
    plain attention, from one cloned scope and generator. Returns the
    record: the loss's signed relative difference and each watched
    tensor's first-moment difference as a share of its largest
    magnitude. Raises here only if a route launched the wrong kernels.
    ``data_seed`` seeds the synthetic batch (``step_check_seeds`` reads
    STEP_SEEDS)."""
    cfg, main, startup, loss, _ = prog
    feed = bert.synthetic_batch(cfg, LONG_CHECK_BATCH, LONG_CHECK_SEQ,
                                seed=data_seed)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    res = {}
    for route, ctx in (("kernel", contextlib.nullcontext()),
                       ("plain", plain_fused_attention(A))):
        sc = clone_scope(fluid, scope)
        reset_launches(A)
        with ctx:
            step_loss = exe.run(main, feed=feed, fetch_list=[loss],
                                scope=sc)[0]
        launched = [getattr(A, name).launches for name in FUSED_KERNELS]
        if launched != [cfg.n_layers * (route == "kernel")] * 3:
            raise AssertionError("bert_long: the %s step launched the fused "
                                 "kernels %s times" % (route, launched))
        res[route] = (float(step_loss[0]),
                      {n: sc.find_var(n + "_moment1_0") for n in BERT_WATCH})
        del sc
    del scope
    grad_rel = {n: ((res["kernel"][1][n] - res["plain"][1][n]).abs().max() /
                    res["plain"][1][n].abs().max()).item()
                for n in BERT_WATCH}
    return dict(seq_len=LONG_CHECK_SEQ, batch=LONG_CHECK_BATCH,
                data_seed=data_seed, loss_kernel=res["kernel"][0],
                loss_plain=res["plain"][0],
                loss_signed_rel=(res["kernel"][0] - res["plain"][0]) /
                res["plain"][0], grad_rel=grad_rel)


def bert_long_path(A, dev):
    """The long-context AMP path; returns {tier: {kernel: launches}} over
    the timed steps of every shape."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    exe = fluid.Executor(dev)
    # one step with the kernels and one with the plain attention, at each
    # data seed of STEP_SEEDS
    cfg, main, startup, loss, build_s = prog = long_program(fluid, bert,
                                                            LONG_CHECK_SEQ)
    rec = step_verdict(step_check_seeds(A, exe, fluid, bert, prog,
                                        long_step_check), LONG_GRAD_RTOL,
                       STEP_LOSS_MEAN["bert_long"])
    emit(phase="bert_long", check="step_vs_plain", seq_len=LONG_CHECK_SEQ,
         batch=LONG_CHECK_BATCH, **rec)
    if not rec["passes"]:
        raise AssertionError("bert_long: step kernel vs plain over data "
                             "seeds %s: past %s" % (rec["seeds"], rec["over"]))
    torch.cuda.empty_cache()

    tiers = {t: dict.fromkeys(FUSED_KERNELS + TENSOR_CORES, 0)
             for t in ("fused", "long", "flash")}
    for S, batch in LONG_SHAPES:
        if S != LONG_CHECK_SEQ:
            cfg, main, startup, loss, build_s = long_program(fluid, bert, S)
        ops = main.global_block().ops
        fused = [op for op in ops if op.type == "fused_multihead_attention"]
        casts = sum(op.type == "cast" for op in ops)
        if len(fused) != cfg.n_layers or not casts:
            raise AssertionError("bert_long S %d: %d fused attention ops, %d "
                                 "casts" % (S, len(fused), casts))
        feed = bert.synthetic_batch(cfg, batch, S, seed=0)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope)[0][0])]       # warm step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(A)
        step_s = []
        for _ in range(LONG_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(out[0]))
        tier = reference_tier(S, cfg.hidden // cfg.n_heads)
        got = launches(A, FUSED_KERNELS)
        want = cfg.n_layers * LONG_STEPS
        if any(n != want for n in got.values()):
            raise AssertionError(
                "bert_long S %d: fused kernel launches %s (want %d each, "
                "all on the tensor cores)" % (S, got, want))
        if not (all(math.isfinite(x) for x in losses) and
                losses[-1] < losses[0]):
            raise AssertionError("bert_long S %d: losses not finite and "
                                 "falling: %s" % (S, losses))
        for name in got:
            tiers[tier][name] += got[name]
        steady = statistics.median(step_s)
        emit(phase="bert_long", config="BertConfig.base, max_seq %d" % S,
             amp="bf16", seq_len=S, batch=batch, dropout=cfg.hidden_dropout,
             masked_positions=bert.max_predictions(S), ops=len(ops),
             casts=casts, build_s=build_s, losses=losses, step_s=step_s,
             step_ms=steady * 1e3, tokens_per_s=batch * S / steady,
             max_memory_allocated_gb=torch.cuda.max_memory_allocated()
             / 2 ** 30, tier=tier,
             launches_per_step={k: v / LONG_STEPS for k, v in got.items()})
        del scope, main, startup
        torch.cuda.empty_cache()
    return tiers


PACKED_BATCH, PACKED_SEQ, PACKED_STEPS = 128, 128, 4   # bench.py bench_bert
PACKED_CHECK_BATCH, TIER_STEPS = 2, 2
# the three attention layouts of config 3 run in this order, each from a
# fresh scope, so a drift of the host's speed over the phase falls on
# all three alike: (label, use_fused_attention)
LAYOUT_ROUNDS = (("packed", "packed"), ("auto", "auto"), ("per_head", True),
                 ("per_head", True), ("auto", "auto"), ("packed", "packed"))
# One BERT-base AMP step at S 128 with the packed kernels against one
# with the plain packed attention, from a cloned scope and generator (the
# same dropout masks), batch 2, at each data seed of STEP_SEEDS, as
# long_step_check does at S 2048: the loss judged over the seeds
# together (STEP_LOSS_MAX, STEP_LOSS_MEAN), each watched tensor's Adam
# first moment as a share of its largest magnitude at every seed;
# bert_long's limits. First readings on the H100 (PERF.md): sound,
# word_emb 1.1e-2, the query weight 1.1e-2, the key weight 3.2e-2, the
# last FFN weight 8.3e-3, the output bias 1.8e-5; every planted fault (a
# skipped tile, no mask, the head-keyed dropout mask, a row stride of d)
# moves the query and key weights' moments by 0.11 or more. The second
# row is padded, so this step also sees faults of the mask.
PACKED_GRAD_RTOL = {"word_emb": 6e-2, "layer_0_attn_q.w_0": 6e-2,
                    "layer_5_attn_k.w_0": 2 ** -3,
                    "layer_11_ffn2.w_0": 4.5e-2, "mlm_out_bias": 4e-4}


def packed_program(fluid, bert, cfg, attention, seq=PACKED_SEQ):
    """(cfg, main, startup, loss, build seconds) of the AMP pretraining
    program with ``use_fused_attention=attention``."""
    t0 = time.perf_counter()
    cfg.max_seq = max(cfg.max_seq, seq)
    cfg.use_fused_attention = attention
    with fluid.unique_name.guard():
        main, startup, loss = bert.build_pretrain_program(cfg, seq_len=seq,
                                                          use_amp=True)
    return cfg, main, startup, loss, time.perf_counter() - t0


@contextlib.contextmanager
def plain_packed_attention(A):
    """Route the program's fused_multihead_attention_packed ops through
    the plain version on the card."""
    def plain(q, k, v, bias=None, n_heads=1, scale=None, dropout_prob=0.0,
              seed=None):
        d = q.shape[-1] // n_heads
        scale = d ** -0.5 if scale is None else scale
        return A._ref_fused_attention_packed(q, k, v, bias, n_heads,
                                             float(scale),
                                             float(dropout_prob), seed)

    saved, A.fused_attention_packed = A.fused_attention_packed, plain
    try:
        yield
    finally:
        A.fused_attention_packed = saved


def packed_step_check(A, exe, fluid, bert, prog, data_seed=0):
    """One bf16 AMP step of ``prog`` (``packed_program``, BERT-base) on a
    batch of PACKED_CHECK_BATCH at S 128 with the packed kernels, and one
    with the plain packed attention, from one cloned scope and generator.
    Returns the record (as ``long_step_check``); raises here only if a
    route launched the wrong kernels."""
    cfg, main, startup, loss, _ = prog
    feed = bert.synthetic_batch(cfg, PACKED_CHECK_BATCH, PACKED_SEQ,
                                seed=data_seed)
    # padding: the second row keeps 96 of its 128 tokens
    feed["input_mask"][1, 96:] = 0.0
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    res = {}
    for route, ctx in (("kernel", contextlib.nullcontext()),
                       ("plain", plain_packed_attention(A))):
        sc = clone_scope(fluid, scope)
        reset_launches(A)
        with ctx:
            step_loss = exe.run(main, feed=feed, fetch_list=[loss],
                                scope=sc)[0]
        launched = [getattr(A, name).launches for name in FUSED_KERNELS]
        if launched != [cfg.n_layers * (route == "kernel")] * 3:
            raise AssertionError("bert_packed: the %s step launched the "
                                 "kernels %s times" % (route, launched))
        res[route] = (float(step_loss[0]),
                      {n: sc.find_var(n + "_moment1_0") for n in BERT_WATCH})
        del sc
    del scope
    grad_rel = {n: ((res["kernel"][1][n] - res["plain"][1][n]).abs().max() /
                    res["plain"][1][n].abs().max()).item()
                for n in BERT_WATCH}
    return dict(seq_len=PACKED_SEQ, batch=PACKED_CHECK_BATCH,
                data_seed=data_seed, loss_kernel=res["kernel"][0],
                loss_plain=res["plain"][0],
                loss_signed_rel=(res["kernel"][0] - res["plain"][0]) /
                res["plain"][0], grad_rel=grad_rel)


def timed_steps(A, exe, fluid, bert, prog, batch, steps):
    """One warm step and ``steps`` timed steps of ``prog`` on one
    synthetic batch: (losses, step seconds, peak GB, launches of the
    fused wrappers over the timed steps)."""
    cfg, main, startup, loss, _ = prog
    feed = bert.synthetic_batch(cfg, batch, PACKED_SEQ, seed=0)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0][0])]          # warm step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(A)
    step_s = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(out[0]))
    got = launches(A, FUSED_KERNELS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del scope
    torch.cuda.empty_cache()
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError("bert_packed (%s): losses not finite and "
                             "falling: %s" % (cfg.use_fused_attention,
                                              losses))
    return losses, step_s, peak, got


def bert_packed_path(A, dev):
    """BASELINE config 3 in the packed layout: BERT-base MLM pretraining
    at batch 128, S 128, bf16 AMP, use_fused_attention="packed". First
    the one-step check against the plain version; then, in the order of
    LAYOUT_ROUNDS, runs of one warm and PACKED_STEPS timed steps with
    "packed" (12 + 12 + 12 launches a step on the heads' strided views:
    the TPU's resident tier), "auto" (the einsum chain below S 256,
    bench_bert's default, no launch) and True (the same kernels on
    contiguous per-head operands behind transposes), for their step
    times side by side; then BERT-tiny at the same batch and S, whose
    d 16 the TPU runs in its packed tier. A packed run's program holds
    one fused_multihead_attention_packed op a layer and no other
    attention op, so its launches are the packed layout's. Returns
    {tier: {wrapper: launches}} of the last packed run and the BERT-tiny
    run."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    exe = fluid.Executor(dev)
    prog = packed_program(fluid, bert, bert.BertConfig.base(), "packed")
    rec = step_verdict(step_check_seeds(A, exe, fluid, bert, prog,
                                        packed_step_check), PACKED_GRAD_RTOL,
                       STEP_LOSS_MEAN["bert_packed"])
    emit(phase="bert_packed", check="step_vs_plain", seq_len=PACKED_SEQ,
         batch=PACKED_CHECK_BATCH, **rec)
    if not rec["passes"]:
        raise AssertionError("bert_packed: step kernel vs plain over data "
                             "seeds %s: past %s" % (rec["seeds"], rec["over"]))
    torch.cuda.empty_cache()

    progs = {"packed": prog}
    for label, attention in LAYOUT_ROUNDS[1:3]:
        progs[label] = packed_program(fluid, bert, bert.BertConfig.base(),
                                      attention)
    runs = [(label, "base", attention, PACKED_BATCH, PACKED_STEPS)
            for label, attention in LAYOUT_ROUNDS]
    runs.append(("tiny_packed", "tiny", "packed", PACKED_BATCH, TIER_STEPS))
    progs["tiny_packed"] = packed_program(fluid, bert,
                                          bert.BertConfig.tiny(), "packed")
    tiers, step_s_of = {}, {}
    for label, size, attention, batch, steps in runs:
        prog = progs[label]
        cfg, main = prog[0], prog[1]
        ops = main.global_block().ops
        types = {t: sum(op.type == t for op in ops) for t in (
            "fused_multihead_attention_packed", "fused_multihead_attention",
            "einsum", "cast")}
        losses, step_s, peak, got = timed_steps(A, exe, fluid, bert, prog,
                                                batch, steps)
        want = cfg.n_layers * steps * (attention != "auto")
        op = {"packed": "fused_multihead_attention_packed",
              True: "fused_multihead_attention"}.get(attention)
        if [got[n] for n in FUSED_KERNELS + TENSOR_CORES] != [want] * 6 or any(
                types[t] != (cfg.n_layers if t == op else 0) for t in (
                    "fused_multihead_attention_packed",
                    "fused_multihead_attention")):
            raise AssertionError("bert_packed (%s): launches %s over %d "
                                 "steps (all on the tensor cores), ops %s"
                                 % (label, got, steps, types))
        d = cfg.hidden // cfg.n_heads
        tier = reference_tier(PACKED_SEQ, d, (batch, cfg.n_heads, 2,
                                              (batch, 1, 1, PACKED_SEQ))) \
            if attention == "packed" else None
        if tier is not None:
            tiers[tier] = got
        step_s_of.setdefault(label, []).extend(step_s)
        steady = statistics.median(step_s)
        emit(phase="bert_packed",
             config="BertConfig.%s" % size, attention=label,
             amp="bf16", seq_len=PACKED_SEQ, batch=batch,
             dropout=cfg.hidden_dropout,
             masked_positions=bert.max_predictions(PACKED_SEQ),
             ops=len(ops), op_counts=types, build_s=prog[4], losses=losses,
             step_s=step_s, step_ms=steady * 1e3,
             tokens_per_s=batch * PACKED_SEQ / steady,
             max_memory_allocated_gb=peak, tier=tier,
             launches_per_step={k: v / steps for k, v in got.items() if v})
        del prog, main
        torch.cuda.empty_cache()
    del progs
    emit(phase="bert_packed",
         compare="BertConfig.base, batch 128, S 128, bf16 AMP: median step "
                 "ms over both runs of each layout",
         step_ms={label: statistics.median(v) * 1e3
                  for label, v in step_s_of.items() if label != "tiny_packed"},
         auto_rule="einsum below S 256, fused from S 256 (measured on a TPU)")
    return tiers


SERVE_SEQ, SERVE_REQUESTS, SERVE_CLIENTS = 128, 64, 8
# Each served request's encoder output against a direct Predictor.run of
# the same rows (fp32): the attention kernels treat every (row, head)
# alone, so only the cuBLAS products, whose algorithm may change with
# the batch's row count, sum in another order.
SERVE_ATOL = 1e-4


def encoder_serving_path(A, inference, monitor, dev):
    """The non-generative serving tier: a BERT-base encoder (S 128,
    use_fused_attention="packed", fp32) built, started on the card,
    saved with save_inference_model and loaded back as a Predictor,
    behind a Server (batches up to 32, 2 ms queue delay, ladder warmed
    up); SERVE_REQUESTS requests of 1-4 padded rows from SERVE_CLIENTS
    threads. Every future is held to a direct Predictor.run of its rows.
    Returns the forward kernel's launches over the served batches."""
    import tempfile

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base()
    cfg.use_fused_attention = "packed"
    feeds = ["src_ids", "pos_ids", "sent_ids", "input_mask"]
    with fluid.unique_name.guard():
        main, startup, enc = bert.build_encoder_program(cfg,
                                                        seq_len=SERVE_SEQ)
    exe, scope = fluid.Executor(dev), fluid.Scope()
    rng = np.random.RandomState(5)
    rows = bert.synthetic_batch(cfg, 4 * SERVE_REQUESTS, SERVE_SEQ, seed=5)
    lens = rng.randint(SERVE_SEQ // 2, SERVE_SEQ + 1, 4 * SERVE_REQUESTS)
    rows["input_mask"][np.arange(SERVE_SEQ)[None, :] >= lens[:, None]] = 0.0
    sizes = rng.randint(1, 5, SERVE_REQUESTS)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    reqs = [{n: rows[n][s:s + k] for n in feeds}
            for s, k in zip(starts, sizes)]
    with tempfile.TemporaryDirectory() as model_dir:
        with fluid.scope_guard(scope):
            exe.run(startup, scope=scope)
            fluid.io.save_inference_model(model_dir, feeds, [enc], exe,
                                          main_program=main)
        t0 = time.perf_counter()
        pred = inference.create_predictor(inference.Config(model_dir))
        load_s = time.perf_counter() - t0
    direct = pred.clone()
    lbl = {"model": "bert_encoder"}
    occ = monitor.histogram("serving_batch_occupancy", labels=lbl)
    batches = monitor.counter("serving_batches_total", labels=lbl)
    results, latency = [None] * len(reqs), [None] * len(reqs)
    with inference.Server() as srv:
        t0 = time.perf_counter()
        ladder = srv.register(
            "bert_encoder", pred,
            config=inference.ServeConfig(max_batch_size=32,
                                         max_queue_delay_ms=2.0),
            warmup_feed={n: reqs[0][n][:1] for n in feeds})
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        occ0, batches0 = (occ.sum, occ.count), batches.value
        reset_launches(A)
        t0 = time.perf_counter()

        def client(c):
            for i in range(c, len(reqs), SERVE_CLIENTS):
                ts = time.perf_counter()
                results[i] = srv.submit("bert_encoder", reqs[i]).result(
                    timeout=600)
                latency[i] = time.perf_counter() - ts

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            if t.is_alive():
                raise AssertionError("encoder_serving client thread hung")
        wall = time.perf_counter() - t0
    served = launches(A, FUSED_KERNELS)
    n_batches = batches.value - batches0
    if any(r is None for r in results):
        raise AssertionError("encoder_serving: unresolved futures")
    if not (served["fused_attention_fwd_kernel"] == served[FWD_TC] ==
            cfg.n_layers * n_batches > 0 and
            sum(served[n] for n in FUSED_KERNELS) ==
            served["fused_attention_fwd_kernel"]):
        raise AssertionError("encoder_serving: launches %s over %d batches"
                             % (served, n_batches))
    err = ref = 0.0
    for req, got in zip(reqs, results):
        want = direct.run(req)[0]
        if got[0].shape != want.shape or not np.isfinite(got[0]).all():
            raise AssertionError("encoder_serving: output %s, want %s"
                                 % (got[0].shape, want.shape))
        err = max(err, float(np.abs(got[0] - want).max()))
        ref = max(ref, float(np.abs(want).max()))
    if not err <= SERVE_ATOL:
        raise AssertionError("encoder_serving: served vs direct max |err| "
                             "%g > %g" % (err, SERVE_ATOL))
    lat = np.array(latency)
    emit(phase="encoder_serving", config="BertConfig.base encoder, packed",
         seq_len=SERVE_SEQ, dtype="float32", requests=len(reqs),
         rows=int(sizes.sum()), clients=SERVE_CLIENTS, max_batch_size=32,
         max_queue_delay_ms=2.0, ladder=ladder, load_s=load_s,
         warmup_s=warmup_s, wall_s=wall, batches=n_batches,
         occupancy_mean=(occ.sum - occ0[0]) / (occ.count - occ0[1]),
         request_p50_s=float(np.percentile(lat, 50)),
         request_p99_s=float(np.percentile(lat, 99)),
         rows_per_s=float(sizes.sum()) / wall,
         packed_fwd_launches=served["fused_attention_fwd_kernel"],
         vs_direct_max_abs_err=err, vs_direct_atol=SERVE_ATOL,
         output_max_abs=ref)
    return served["fused_attention_fwd_kernel"]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.fluid import monitor
    from paddle_tpu_torch.kernels import _build, attention as A
    from paddle_tpu_torch.models import transformer as T

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    libs = _build.build_all()
    emit(phase="card", nvidia_smi=card, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=time.perf_counter() - t0,
         libraries=sorted(libs),
         fused_attention_resources=kernel_resources(_build, A))

    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    path_lens = np.random.RandomState(2).randint(64, 97, 64).tolist()
    dense_rec = None
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        rec = dense_case(A, dev, gen, flush, "path_" + tag, 64, 16, 1, 1024,
                         64, path_lens, dtype)
        dense_rec = dense_rec or rec
        dense_case(A, dev, gen, flush, "ragged_" + tag, 64, 16, 1, 1000, 64,
                   np.random.RandomState(3).randint(1, 1001, 64).tolist(),
                   dtype)
        dense_case(A, dev, gen, flush, "causal_" + tag, 64, 16, 4, 1024, 64,
                   [2, 3, 4, 5] + list(range(64, 1024, 16)), dtype,
                   causal=True)
        dense_case(A, dev, gen, flush, "wrapped_" + tag, 64, 16, 1, 1024, 64,
                   list(range(1025, 1025 + 64 * 37, 37)), dtype)
    for dtype, d in ((torch.bfloat16, 8), (torch.float32, 48),
                     (torch.bfloat16, 96), (torch.float16, 64),
                     (torch.float32, 6), (torch.bfloat16, 12),
                     (torch.float32, 192), (torch.float32, 512),
                     (torch.bfloat16, 512), (torch.float32, 640),
                     (torch.bfloat16, 1536)):
        decode_width_check(A, dev, gen, dtype, d)
    paged_rec = paged_case(A, dev, gen, flush)
    fused_rec, fused_p0_rec = fused_cases(A, dev, gen, flush)
    long_rec, flash_rec = long_cases(A, dev, flush)
    res_rec, packed_rec = packed_cases(A, dev, flush)
    packed_equals_per_head(A, dev)
    del flush
    torch.cuda.empty_cache()

    dense_pred, dense_launches, feed = dense_path(T, A, inference, monitor,
                                                  dev)
    paged_launches = serving_path(T, A, inference, monitor, dev, dense_pred,
                                  feed)
    del dense_pred
    torch.cuda.empty_cache()
    bert_launches = bert_path(A, dev)
    torch.cuda.empty_cache()
    long_launches = bert_long_path(A, dev)
    torch.cuda.empty_cache()
    packed_launches = bert_packed_path(A, dev)
    torch.cuda.empty_cache()
    encoder_serving_path(A, inference, monitor, dev)

    src = "paddle_tpu_torch/kernels/csrc/decode_attention.cu"
    kernels = []
    for name, rec, launches, replaces in (
            ("decode_attention", dense_rec, dense_launches,
             "paddle_tpu/kernels/attention.py:1653"),
            ("paged_attention", paged_rec, paged_launches,
             "paddle_tpu/kernels/attention.py:1829")):
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches, max_abs_err=rec["max_abs_err"],
            ms=rec["kernel_ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec["library_ms"]))
    fused_src = "paddle_tpu_torch/kernels/csrc/fused_attention.cu"
    # each row counts its kernels' launches on the tensor cores (a
    # backward row the dq kernel's: the pair launches together)
    for name, rec, launches, replaces in (
            ("fused_attention_fwd (attn_fwd_tf32x3, fp32)", dict(
                fused_rec["fwd"], ms_p0=fused_p0_rec["fwd"]["kernel_ms"]),
             bert_launches[FWD_TC], "paddle_tpu/kernels/attention.py:294"),
            ("fused_attention_bwd (attn_bwd_dq_tf32x3 + "
             "attn_bwd_dkdv_tf32x3, fp32)", fused_rec["bwd"],
             bert_launches[DQ_TC], "paddle_tpu/kernels/attention.py:307"),
            ("fused_attention_fwd (attn_fwd_mma), long tier",
             long_rec["fwd"], long_launches["long"][FWD_TC],
             "paddle_tpu/kernels/attention.py:362"),
            ("fused_attention_bwd (dq + dk/dv kernels), long tier",
             long_rec["bwd"], long_launches["long"][DQ_TC],
             "paddle_tpu/kernels/attention.py:390"),
            ("fused_attention_fwd (attn_fwd_mma), flash tier",
             flash_rec["fwd"], long_launches["flash"][FWD_TC],
             "paddle_tpu/kernels/attention.py:602"),
            ("fused_attention_bwd_dq (attn_bwd_dq_mma), flash tier",
             flash_rec["dq"], long_launches["flash"][DQ_TC],
             "paddle_tpu/kernels/attention.py:650"),
            ("fused_attention_bwd_dkdv (attn_bwd_dkdv_mma), flash tier",
             flash_rec["dkdv"], long_launches["flash"][DKDV_TC],
             "paddle_tpu/kernels/attention.py:697"),
            ("fused_attention_fwd (attn_fwd_mma), packed layout, packed "
             "tier", packed_rec["fwd"], packed_launches["packed"][FWD_TC],
             "paddle_tpu/kernels/attention.py:917"),
            ("fused_attention_bwd (dq + dk/dv kernels), packed layout, "
             "packed tier", packed_rec["bwd"],
             packed_launches["packed"][DQ_TC],
             "paddle_tpu/kernels/attention.py:960"),
            ("fused_attention_fwd (attn_fwd_mma), packed layout, resident "
             "tier", res_rec["fwd"], packed_launches["resident"][FWD_TC],
             "paddle_tpu/kernels/attention.py:1170"),
            ("fused_attention_bwd_dq (attn_bwd_dq_mma), packed layout, "
             "resident tier", res_rec["dq"],
             packed_launches["resident"][DQ_TC],
             "paddle_tpu/kernels/attention.py:1195"),
            ("fused_attention_bwd_dkdv (attn_bwd_dkdv_mma), packed layout, "
             "resident tier", res_rec["dkdv"],
             packed_launches["resident"][DKDV_TC],
             "paddle_tpu/kernels/attention.py:1228")):
        row = dict(
            name=name, route="cuda", source=fused_src, replaces=replaces,
            launches=launches, max_abs_err=rec["max_abs_err"],
            ms=rec["kernel_ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec["library_ms"])
        for key in ("library_of", "ms_p0"):
            if key in rec:
                row[key] = rec[key]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
