"""Where a decode step of paddle_tpu_torch's Transformer-big spends its
time on the card.

    python3 tools/profile_decode.py

Needs one CUDA card. Drives the two serving paths of chip_smoke.py at
the same shapes (dense ring cache: batch 64, src 128, prompt 64,
capacity 1024; paged stream: width 8, pages of 128 tokens, 25-page
pool), times STEPS decode steps on the host clock (ending in a device
sync), traces as many with torch.profiler, and prints one JSON
line per path: wall ms per step, device-busy ms per step (the sum of
kernel times), the device's idle share, kernel launches per step, the
decode-attention kernel's share of device time, and the ten kernels
with the most device time. Device numbers are "not measured" where the
profiler returned no device events.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from paddle_tpu_torch import inference  # noqa: E402
from paddle_tpu_torch.models import transformer as T  # noqa: E402

STEPS = 20


def _device_kernels(prof):
    """{kernel name: (device us, calls)} from a finished profile."""
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


def _report(path, step_fn, steps, **meta):
    for _ in range(3):
        step_fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step_fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step_fn()
        torch.cuda.synchronize()
    kern = _device_kernels(prof)
    rec = dict(phase="profile", path=path, steps=steps,
               wall_ms_per_step=wall_ms, **meta)
    if not kern:
        rec.update(device_busy_ms_per_step="not measured",
                   idle_share="not measured")
    else:
        busy_us = sum(us for us, _ in kern.values())
        attn_us = sum(us for k, (us, _) in kern.items()
                      if "decode_attention_kernel" in k)
        rec.update(
            device_busy_ms_per_step=busy_us / steps / 1e3,
            idle_share=1.0 - busy_us / steps / 1e3 / wall_ms,
            kernel_launches_per_step=sum(n for _, n in kern.values())
            / steps,
            attention_share_of_busy=attn_us / busy_us,
            top=[dict(kernel=k[:96], ms_per_step=us / steps / 1e3,
                      calls_per_step=n / steps)
                 for k, (us, n) in sorted(kern.items(),
                                          key=lambda kv: -kv[1][0])[:10]])
    print(json.dumps(rec), flush=True)


def dense(model, steps):
    B, SRC, PROMPT, CAP = 64, 128, 64, 1024
    dev = torch.device("cuda")
    pred = inference.GenerativePredictor(
        model, batch_size=B, src_len=SRC, prompt_len=PROMPT,
        cache_capacity=CAP, device=dev)
    sess = pred._session
    rng = np.random.RandomState(0)
    src = torch.from_numpy(rng.randint(2, 32000, (B, SRC))).to(dev)
    prompt = torch.from_numpy(rng.randint(2, 32000, (B, PROMPT))).to(dev)
    L = len(model.dec_layers)
    with torch.no_grad():
        outs = model.prefill(src, prompt, sess._pos_src, sess._pos_tgt,
                             sess._causal,
                             torch.zeros(B, dtype=torch.int32, device=dev),
                             *sess._caches)
        caches = outs[1:1 + 2 * L]
        cross = outs[1 + 2 * L:1 + 4 * L]
        tok = outs[0][:, -1].argmax(-1).to(torch.int32)[:, None]
        fin = torch.zeros(B, 1, dtype=torch.bool, device=dev)
        start = torch.full((B,), PROMPT, dtype=torch.int32, device=dev)

        def step():
            # the same positions every step: lengths stay inside the
            # position table however many steps are traced
            model.decode_step(tok, fin, sess._end_ids, start, *cross,
                              *caches)

        _report("dense", step, steps, batch=B, cache_capacity=CAP)


def paged(model, steps):
    W, SRC, PROMPT, CAP = 8, 128, 64, 1024
    pred = inference.GenerativePredictor(
        model, batch_size=W, src_len=SRC, prompt_len=PROMPT,
        cache_capacity=CAP, paged=True, page_tokens=128, pool_pages=25,
        device="cuda")
    stream = pred.open_stream()
    rng = np.random.RandomState(1)
    for _ in range(W):
        stream.join(rng.randint(2, 32000, SRC), rng.randint(2, 32000, PROMPT),
                    max_new_tokens=model.max_len - PROMPT)

    def step():
        stream.step()
        stream._len[:] = PROMPT     # hold positions inside the table

    _report("paged", step, steps, width=W, page_tokens=128, pool_pages=25)


def main():
    if not torch.cuda.is_available():
        print("profile_decode: torch sees no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    model = T.Transformer.big(device="cuda", seed=0)
    dense(model, STEPS)
    paged(model, STEPS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
