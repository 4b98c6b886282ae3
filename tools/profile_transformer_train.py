"""Where a Transformer-big training step (BASELINE config 5) of
paddle_tpu_torch spends its time on the card: the traced program
replayed from the executor's CUDA graph, run by the eager executor, and
the eager dygraph step.

    python3 tools/profile_transformer_train.py [--batch 32] [--seq 64]
                                              [--steps 10] [--fp32]
                                              [--phase]

Needs one CUDA card. Builds chip_smoke.py's program as bench.py's
bench_transformer does: ``Transformer.big(32000, 32000)`` under
``dygraph.guard()`` (seed 0), recorded by ``dygraph.jit.trace`` in
training mode (dropout 0.1), the loss and ``mixed_precision.decorate(
Adam(1e-4))`` appended (plain Adam with ``--fp32``), fed one synthetic
batch on the card. For each mode in turn (``graphed``: the executor's
default, whose second run captures the step and later runs replay it;
``eager_executor``: ``cuda_graphs=False``; ``dygraph``: eager
``loss.backward()`` + ``Adam.minimize`` on the model itself, fp32), from
the same starting weights: two warm-up steps, ``--steps`` steps timed on
the host clock (ending in a device sync), as many traced with
torch.profiler; prints the card's name and power limit, then one JSON
line a mode: wall ms a step, tokens/s, MFU against 989 TFLOP/s
(``chip_smoke.transformer_train_flops_per_step``), device-busy ms a step
(the sum of kernel times), the idle share, device kernels and the host's
launch calls a step (``chip_smoke.LAUNCH_APIS``), peak memory allocated,
device ms a step by kind of kernel (``KINDS``, by the profiler's names)
and the kernels with the most device time. ``--phase`` first runs
chip_smoke.py's ``transformer_train`` phase alone (its checks and JSON
lines).
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
from paddle_tpu_torch.fluid import dygraph, optimizer  # noqa: E402
from paddle_tpu_torch.models import transformer as T  # noqa: E402

# device time by kind, first match wins (the profiler's kernel names)
KINDS = (
    ("gemm", re.compile(r"gemm|nvjet|cutlass|sm90|xmma", re.I)),
    ("softmax", re.compile(r"softmax", re.I)),
    ("layer_norm", re.compile(r"layer_norm|LayerNorm", re.I)),
    ("embedding", re.compile(r"embedding|index|gather|scatter", re.I)),
    ("reduce", re.compile(r"reduce", re.I)),
    ("copy", re.compile(r"copy|memcpy|memset|cat", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled", re.I)),
)


def kind_of(name):
    for kind, pattern in KINDS:
        if pattern.search(name):
            return kind
    return "other"


def timed(steps, n, args):
    """(wall ms a step, {kernel: (us, calls)}, launch calls a step) of
    ``steps(n)``: two warm-up steps, ``n`` timed, ``n`` traced."""
    steps(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(n)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(chip_smoke.TRACE_PAD_S)
        steps(n)
        torch.cuda.synchronize()
        time.sleep(chip_smoke.TRACE_PAD_S)
    api = {e.key: e.count / n for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.key in LAUNCH_APIS}
    return wall_ms, kernel_times(prof), api


def record(mode, wall_ms, kern, api, args):
    tokens = args.batch * args.seq
    flops = chip_smoke.transformer_train_flops_per_step(
        args.batch, args.seq, 1024, 4096, 6, chip_smoke.TFM_VOCAB)
    rec = dict(mode=mode, batch=args.batch, seq=args.seq,
               amp=not args.fp32 and mode != "dygraph",
               wall_ms_per_step=wall_ms,
               tokens_per_s=tokens / wall_ms * 1e3,
               mfu=flops / (wall_ms / 1e3) / chip_smoke.BF16_PEAK_OPS_PER_S,
               host_launch_calls_per_step=api,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated()
               / 2 ** 30)
    n = args.steps
    if not kern:
        rec.update(device_busy_ms_per_step="not measured",
                   idle_share="not measured")
        return rec
    busy_us = sum(us for us, _ in kern.values())
    by_kind = {}
    for name, (us, _) in kern.items():
        k = kind_of(name)
        by_kind[k] = by_kind.get(k, 0.0) + us / 1e3 / n
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:12]
    rec.update(
        device_busy_ms_per_step=busy_us / n / 1e3,
        idle_share=1.0 - busy_us / n / 1e3 / wall_ms,
        device_kernels_per_step=sum(c for _, c in kern.values()) / n,
        device_ms_by_kind=dict(sorted(by_kind.items(),
                                      key=lambda kv: -kv[1])),
        top_kernels=[dict(name=k[:160], ms_per_step=us / 1e3 / n,
                          calls_per_step=c / n) for k, (us, c) in top])
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=chip_smoke.TFM_BATCH)
    ap.add_argument("--seq", type=int, default=chip_smoke.TFM_SEQ)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--phase", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_transformer_train: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    if args.phase:
        from paddle_tpu_torch.kernels import attention as A

        chip_smoke.transformer_train_path(A, dev)
        torch.cuda.empty_cache()
    feeds, labels = chip_smoke.transformer_args(T, args.batch, args.seq)
    with fluid.unique_name.guard(), dygraph.guard(dev):
        model = T.Transformer.big(chip_smoke.TFM_VOCAB, chip_smoke.TFM_VOCAB,
                                  seed=0)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        _, traced = dygraph.jit.trace(
            model, [dygraph.to_variable(a) for a in feeds])
    with fluid.unique_name.guard():
        startup, loss = chip_smoke.transformer_static(
            fluid, traced, args.seq, amp=not args.fp32)
    traced._materialize_scope()
    feed = chip_smoke.transformer_feed(traced, feeds, labels, dev)
    for mode in ("graphed", "eager_executor"):
        model.set_dict(start)
        scope = chip_smoke.clone_scope(fluid, traced._scope) \
            if traced._scope.generator is not None else traced._scope
        exe = fluid.Executor(dev, cuda_graphs=mode == "graphed")
        exe.run(startup, scope=scope)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wall, kern, api = timed(lambda n: chip_smoke.fetch_losses(
            exe, traced.program, feed, [loss], scope, n), args.steps, args)
        print(json.dumps(record(mode, wall, kern, api, args)), flush=True)
        exe.close()
        del scope
        torch.cuda.empty_cache()
    del traced, feed
    model.set_dict(start)
    with dygraph.guard(dev):
        opt = optimizer.Adam(learning_rate=1e-4)
        xs = [dygraph.to_variable(a) for a in feeds]
        lab = dygraph.to_variable(labels)

        def steps(n):
            for _ in range(n):
                loss = T.loss_fn(model(*xs), lab)
                model.clear_gradients()
                opt.minimize(loss, parameter_list=model.parameters())
            return float(loss.numpy())

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wall, kern, api = timed(steps, args.steps, args)
        rec = record("dygraph", wall, kern, api, args)
        tracer = fluid.framework._dygraph_tracer()
        n0 = tracer.traced_ops
        steps(1)
        rec["ops_traced_per_step"] = tracer.traced_ops - n0
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
