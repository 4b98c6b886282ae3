"""Where a ResNet training step of paddle_tpu_torch spends its time on the
card, replayed from the executor's CUDA graph and run eagerly.

    python3 tools/profile_resnet.py [--layout NCHW|NHWC] [--batch 256]
                                    [--size 224] [--depth 50] [--fp32]
                                    [--steps 4] [--conv-backward free]
                                    [--no-weight-decay]

Needs one CUDA card. Builds chip_smoke.py's resnet phase program
(``models/resnet.py::build_train_program``: Momentum(0.9) +
L2Decay(1e-4), bf16 AMP unless ``--fp32``) in ``--layout`` and feeds it
one synthetic batch made on the card. For each mode in turn
(``graphed``: the executor's default, whose second run captures the step
and later runs replay it; ``eager``: ``cuda_graphs=False``), in a fresh
scope: the startup program, two warm-up steps, ``--steps`` steps timed
on the host clock (ending in a device sync), as many traced with
torch.profiler; prints the card's name and power limit, then one JSON
line a mode: wall ms a step, device-busy ms a step (the sum of kernel
times), the idle share, device kernels and the host's launch calls a
step (``chip_smoke.LAUNCH_APIS``), peak memory allocated and reserved,
device ms a step by kind of kernel (``KINDS``, by the profiler's names)
and the kernels with the most device time.

``--conv-backward free`` runs the convolutions' backward with cuDNN's
own choice of algorithms instead of the deterministic ones the port
takes (``fluid/ops/nn.py``, ``_deterministic_cudnn``), to price that
choice; each mode then also reads whether two eager steps from one
state give the same loss and state (``eager_repeat_unequal``: the
persistables that differ). ``--no-weight-decay`` builds the program
without its L2Decay (no ``scale`` and ``elementwise_add`` a parameter),
to price the decay ops.
"""

import argparse
import contextlib
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
from paddle_tpu_torch.fluid.ops import nn as nn_ops  # noqa: E402
from paddle_tpu_torch.models import resnet  # noqa: E402

# device time by kind, first match wins (the profiler's kernel names;
# "gemm" holds cuBLAS's products and cuDNN's GEMM-form kernels)
KINDS = (
    ("layout_transpose", re.compile(r"nchwToNhwc|nhwcToNchw", re.I)),
    ("conv_wgrad", re.compile(r"wgrad|dgrad_.*filter|bwd_filter|"
                              r"convolve_wgrad", re.I)),
    ("conv_dgrad", re.compile(r"dgrad|bwd_data", re.I)),
    ("conv_fprop", re.compile(r"fprop|implicit|conv|xmma|cudnn", re.I)),
    ("batch_norm", re.compile(r"batch_norm|welford|bn_", re.I)),
    ("pool", re.compile(r"pool", re.I)),
    ("gemm", re.compile(r"gemm|nvjet|cutlass|sm90", re.I)),
    ("reduce", re.compile(r"reduce", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled", re.I)),
)


def kind_of(name):
    for kind, pattern in KINDS:
        if pattern.search(name):
            return kind
    return "other"


def steps(exe, main, feed, loss, scope, n):
    return [float(exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scope)[0].reshape(-1)[0]) for _ in range(n)]


def profile_mode(prog, feed, args, mode):
    """The record of one mode (module docstring)."""
    main, startup, loss, _ = prog
    exe = fluid.Executor("cuda", cuda_graphs=mode == "graphed")
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    rec = {"mode": mode}
    if mode == "eager":
        first = chip_smoke.clone_scope(fluid, scope)
        again = chip_smoke.clone_scope(fluid, scope)
        a = steps(exe, main, feed, loss, first, 2)
        b = steps(exe, main, feed, loss, again, 2)
        diff = chip_smoke.unequal(first, again)
        rec.update(eager_repeat_losses_equal=a == b,
                   eager_repeat_unequal_count=len(diff),
                   eager_repeat_unequal=diff[:8])
        del first, again
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps(exe, main, feed, loss, scope, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(exe, main, feed, loss, scope, args.steps)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(chip_smoke.TRACE_PAD_S)
        steps(exe, main, feed, loss, scope, args.steps)
        torch.cuda.synchronize()
        time.sleep(chip_smoke.TRACE_PAD_S)
    kern = kernel_times(prof)
    api = {e.key: e.count / args.steps for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.key in LAUNCH_APIS}
    rec.update(wall_ms_per_step=wall_ms,
               images_per_s=args.batch / wall_ms * 1e3,
               host_launch_calls_per_step=api,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated()
               / 2 ** 30,
               memory_reserved_gb=torch.cuda.memory_reserved() / 2 ** 30)
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
    ap.add_argument("--layout", default="NCHW", choices=("NCHW", "NHWC"))
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--depth", type=int, default=50)
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--conv-backward", default="deterministic",
                    choices=("deterministic", "free"))
    ap.add_argument("--no-weight-decay", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_resnet: torch sees no CUDA device", file=sys.stderr)
        return 2
    if args.conv_backward == "free":
        nn_ops._deterministic_cudnn = contextlib.nullcontext
    if args.no_weight_decay:
        fluid.regularizer.L2Decay = lambda coeff: None
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    prog = chip_smoke.resnet_program(fluid, resnet, args.layout,
                                     depth=args.depth, size=args.size,
                                     use_amp=not args.fp32)
    feed = chip_smoke.resnet_feed(torch.device("cuda"), args.batch,
                                  args.size, seed=0)
    for mode in ("graphed", "eager"):
        rec = profile_mode(prog, feed, args, mode)
        rec.update(layout=args.layout, batch=args.batch, size=args.size,
                   depth=args.depth, amp=not args.fp32,
                   conv_backward=args.conv_backward,
                   weight_decay=not args.no_weight_decay,
                   train_flops_per_step=3 * chip_smoke.program_flops(
                       prog[0], args.batch))
        rec["mfu"] = rec["train_flops_per_step"] / (
            rec["wall_ms_per_step"] / 1e3) / chip_smoke.BF16_PEAK_OPS_PER_S
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
