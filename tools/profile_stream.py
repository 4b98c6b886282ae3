"""Host time of the dense continuous stream's step beside the dense
session's, before and after one torch.profiler trace in the process.

    python3 tools/profile_stream.py

Needs one CUDA card. Transformer-big (seed 0) at chip_smoke.py's stream
shapes (width 8, src 128, prompt 64, capacity 1024): the dense
session's step (a 41-token generate less a 1-token one, over 40) and
the median of STEPS steps of a full ContinuousDecodeSession (each ends
in the step's one sync), then the same after a profiler trace of one
generate. Prints one JSON line per reading, with the card's name and
power limit.
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

STEPS = 40
W, SRC, PROMPT, CAP = 8, 128, 64, 1024


def dense_step_ms(pred, feed):
    pred.run(feed, max_new_tokens=2)
    t0 = time.perf_counter()
    pred.run(feed, max_new_tokens=1)
    prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred.run(feed, max_new_tokens=STEPS + 1)
    return (time.perf_counter() - t0 - prefill) / STEPS * 1e3


def stream_step_ms(pred, src, prompt):
    stream = pred.open_stream()
    for b in range(W):
        stream.join(src[b], prompt[b], max_new_tokens=STEPS + 2)
    stream.step()
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        stream.step()
        times.append(time.perf_counter() - t0)
    while stream.active_count:
        stream.step()
    return float(np.median(times)) * 1e3


def main():
    if not torch.cuda.is_available():
        print("profile_stream: torch sees no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    rng = np.random.RandomState(3)
    src = rng.randint(2, 32000, (W, SRC)).astype(np.int64)
    prompt = rng.randint(2, 32000, (W, PROMPT)).astype(np.int64)
    feed = {"src": src, "prompt": prompt}
    pred = inference.GenerativePredictor(
        T.Transformer.big(device=dev, seed=0), batch_size=W, src_len=SRC,
        prompt_len=PROMPT, cache_capacity=CAP, slot_prefill=True,
        device=dev)
    for when in ("before_trace", "after_trace"):
        print(json.dumps(dict(
            card=card, when=when, width=W,
            dense_step_ms=dense_step_ms(pred, feed),
            stream_step_ms=stream_step_ms(pred, src, prompt))), flush=True)
        if when == "before_trace":
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                pred.run(feed, max_new_tokens=2)
                torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
