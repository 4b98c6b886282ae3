"""Where a DeepFM training step (BASELINE config 4) of paddle_tpu_torch
spends its time on the card, replayed from the executor's CUDA graph and
run eagerly.

    python3 tools/profile_deepfm.py [--batch 4096] [--dense] [--steps 10]
                                    [--phase]

Needs one CUDA card. Builds chip_smoke.py's deepfm program
(``models/deepfm.py::build_train_program(DeepFMConfig())``, Adam lr
1e-3; the sparse embedding engine's device tier unless ``--dense``) and
feeds it one synthetic batch made on the card. For each mode in turn
(``graphed``: the executor's default, whose second run captures the step
and later runs replay it; ``eager``: ``cuda_graphs=False``), in a fresh
scope: the startup program, two warm-up steps, ``--steps`` steps timed
on the host clock (ending in a device sync), as many traced with
torch.profiler; prints the card's name and power limit, then one JSON
line a mode: wall ms a step, examples/s, device-busy ms a step (the sum
of kernel times), the idle share, device kernels and the host's launch
calls a step (``chip_smoke.LAUNCH_APIS``), peak memory allocated,
device ms a step by kind of kernel (``KINDS``, by the profiler's names)
and the kernels with the most device time. ``--phase`` first runs
chip_smoke.py's ``deepfm`` phase alone (its checks and JSON lines).
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from chip_smoke import LAUNCH_APIS, kernel_times  # noqa: E402
from paddle_tpu_torch import fluid  # noqa: E402
from paddle_tpu_torch.models import deepfm  # noqa: E402

# device time by kind, first match wins (the profiler's kernel names)
KINDS = (
    ("sort", re.compile(r"sort|radix|cub::", re.I)),
    ("embedding_backward", re.compile(r"embedding|segment|krn_partial|"
                                      r"compute_grad_weight|sum_and_scatter",
                                      re.I)),
    ("scatter_gather", re.compile(r"index|scatter|gather", re.I)),
    ("gemm", re.compile(r"gemm|nvjet|cutlass|sm90", re.I)),
    ("scan", re.compile(r"scan|cumsum", re.I)),
    ("reduce", re.compile(r"reduce", re.I)),
    ("copy", re.compile(r"copy|memcpy|memset", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled", re.I)),
)


def kind_of(name):
    for kind, pattern in KINDS:
        if pattern.search(name):
            return kind
    return "other"


def profile_mode(prog, feed, args, mode):
    """The record of one mode (module docstring)."""
    main, startup, loss, _ = prog
    exe = fluid.Executor("cuda", cuda_graphs=mode == "graphed")
    scope = fluid.Scope()
    exe.run(startup, scope=scope)

    def steps(n):
        return chip_smoke.fetch_losses(exe, main, feed, [loss], scope, n)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(args.steps)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(chip_smoke.TRACE_PAD_S)
        steps(args.steps)
        torch.cuda.synchronize()
        time.sleep(chip_smoke.TRACE_PAD_S)
    kern = kernel_times(prof)
    api = {e.key: e.count / args.steps for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.key in LAUNCH_APIS}
    rec = dict(mode=mode, wall_ms_per_step=wall_ms,
               examples_per_s=args.batch / wall_ms * 1e3,
               host_launch_calls_per_step=api,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated()
               / 2 ** 30)
    if not kern:
        rec.update(device_busy_ms_per_step="not measured",
                   idle_share="not measured")
    else:
        busy_us = sum(us for us, _ in kern.values())
        by_kind = {}
        for name, (us, _) in kern.items():
            k = kind_of(name)
            by_kind[k] = by_kind.get(k, 0.0) + us / 1e3 / args.steps
        top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:12]
        rec.update(
            device_busy_ms_per_step=busy_us / args.steps / 1e3,
            idle_share=1.0 - busy_us / args.steps / 1e3 / wall_ms,
            device_kernels_per_step=sum(n for _, n in kern.values())
            / args.steps,
            device_ms_by_kind=dict(sorted(by_kind.items(),
                                          key=lambda kv: -kv[1])),
            top_kernels=[dict(name=n[:160], ms_per_step=us / 1e3 / args.steps,
                              calls_per_step=c / args.steps)
                         for n, (us, c) in top])
    exe.close()
    del scope
    torch.cuda.empty_cache()
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=chip_smoke.DEEPFM_BATCH)
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--phase", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_deepfm: torch sees no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    if args.phase:
        from paddle_tpu_torch import inference
        from paddle_tpu_torch.kernels import attention as A

        chip_smoke.deepfm_path(A, inference, dev)
    prog = chip_smoke.deepfm_program(fluid, deepfm, is_sparse=not args.dense)
    feed = chip_smoke.deepfm_feed(deepfm, args.batch, seed=0, dev=dev)
    for mode in ("graphed", "eager"):
        rec = profile_mode(prog, feed, args, mode)
        rec.update(batch=args.batch, sparse=not args.dense)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
