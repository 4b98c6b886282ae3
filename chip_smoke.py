"""On-card smoke run of paddle_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels build for sm_90a), nvcc and the
port's sources beside this file. It imports nothing of JAX or of the JAX
package. Phases, each printed as one JSON line; any failure raises and
the script exits non-zero without its final line:

1. card      nvidia-smi name and power limit; build every CUDA kernel.
2. kernels   each kernel against its plain PyTorch version at the main
             path's shapes and at the edge cases (ragged capacity,
             causal window, wrapped ring; fp32 and bf16), with its time
             (CUDA events, median of 25 cold-L2 launches), the plain
             version's, one PyTorch library call's where one computes the
             same function, and the least time the card could take. The
             times are device time: the host's launch overhead is kept
             out of the timed span.
3. dense     GenerativePredictor(Transformer.big(), batch 64, src 128,
             prompt 64, capacity 1024).run for 32 new tokens: the dense
             decode kernel launches once per decoder layer per step, and
             one whole-model decode step with the kernels agrees with the
             same step on the plain versions.
4. serving   GenerativeServer over the paged stream (width 8, pages of
             128 tokens, 25-page pool, prefix cache of 8): 16 requests
             from 4 threads, some repeated; every future resolves through
             the paged kernel and the prefix cache hits.
5. summary   the kernels line, the card line, then the result line.
"""

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.float32: 67e12,      # fp32, no tensor cores
                  torch.bfloat16: 989e12}    # bf16 tensor cores, dense
REPS, WARMUP = 25, 3
HOLD_CYCLES = 2_000_000            # about 1 ms of SM clock
FP32_ATOL, BF16_ATOL = 2e-5, 2e-2
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


def reset_launches(A):
    A.decode_attention_kernel.launches = 0
    A.paged_attention_kernel.launches = 0


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
         libraries=sorted(libs))

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
    paged_rec = paged_case(A, dev, gen, flush)
    del flush

    dense_pred, dense_launches, feed = dense_path(T, A, inference, monitor,
                                                  dev)
    paged_launches = serving_path(T, A, inference, monitor, dev, dense_pred,
                                  feed)

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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
