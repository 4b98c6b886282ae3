"""Where a BERT-base pretraining step of paddle_tpu_torch spends its time
on the card.

    python3 tools/profile_bert.py [--seq 512] [--batch 32] [--amp]
                                  [--packed] [--steps 2]

Needs one CUDA card. Builds the program of chip_smoke.py's bert phase
(``build_pretrain_program(BertConfig.base(), seq_len=--seq)``, dropout
0.1, Adam; fp32, or bf16 mixed precision with ``--amp``, which the
bert_long phase runs at S 2048/4096/8192 with batch 8/4/2;
``BertConfig.max_seq`` is raised to ``--seq`` past 512; ``--packed``
sets ``use_fused_attention="packed"``, the bert_packed phase's layout,
which that phase runs at S 128, batch 128, with ``--amp``), runs its
startup program and two warm-up steps on one synthetic batch, times
``--steps`` steps on the host clock (ending in a device sync), traces as
many with torch.profiler, and prints the card's name and power limit,
then one JSON line: wall ms per step, device-busy ms per step (the sum
of kernel times), the device's idle share, kernel launches per step, the
fused attention kernels' device ms and share, and the kernels with the
most device time. Device numbers are "not measured" where the profiler
returned no device events.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import kernel_times  # noqa: E402
from paddle_tpu_torch import fluid  # noqa: E402
from paddle_tpu_torch.models import bert  # noqa: E402

# the fused-attention kernels (csrc/fused_attention.cu): the SIMT
# forward and backward (fp32 at d 256), the fp32 3xTF32 and the bf16/fp16
# tensor-core forward and backward, and the kernels past d 256
ATTENTION_KERNELS = ("attn_fwd", "attn_bwd_dq", "attn_bwd_dkdv",
                     "attn_fwd_tf32x3", "attn_bwd_dq_tf32x3",
                     "attn_bwd_dkdv_tf32x3",
                     "attn_fwd_mma", "attn_bwd_dq_mma", "attn_bwd_dkdv_mma",
                     "attn_fwd_wide", "attn_bwd_dq_wide",
                     "attn_bwd_dkdv_wide")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--amp", action="store_true",
                    help="bf16 mixed precision (use_amp=True)")
    ap.add_argument("--packed", action="store_true",
                    help='use_fused_attention="packed"')
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_bert: torch sees no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cfg = bert.BertConfig.base()
    cfg.max_seq = max(cfg.max_seq, args.seq)
    if args.packed:
        cfg.use_fused_attention = "packed"
    with fluid.unique_name.guard():
        main_prog, startup, loss = bert.build_pretrain_program(
            cfg, seq_len=args.seq, use_amp=args.amp)
    feed = bert.synthetic_batch(cfg, args.batch, args.seq, seed=0)
    exe, scope = fluid.Executor("cuda"), fluid.Scope()
    exe.run(startup, scope=scope)

    def step():
        exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / args.steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
    kern = kernel_times(prof)
    rec = dict(phase="profile", path="bert", batch=args.batch,
               seq_len=args.seq, amp="bf16" if args.amp else None,
               attention="packed" if args.packed else "auto",
               steps=args.steps, wall_ms_per_step=wall_ms,
               tokens_per_s=args.batch * args.seq / wall_ms * 1e3)
    if not kern:
        rec.update(device_busy_ms_per_step="not measured",
                   idle_share="not measured")
    else:
        busy_us = sum(us for us, _ in kern.values())
        attn = {name: sum(us for k, (us, _) in kern.items() if name + "<" in k)
                / args.steps / 1e3 for name in ATTENTION_KERNELS}
        rec.update(
            device_busy_ms_per_step=busy_us / args.steps / 1e3,
            idle_share=1.0 - busy_us / args.steps / 1e3 / wall_ms,
            kernel_launches_per_step=sum(n for _, n in kern.values())
            / args.steps,
            attention_ms_per_step=attn,
            attention_share_of_busy=sum(attn.values()) * 1e3 * args.steps
            / busy_us,
            top=[dict(kernel=k[:96], ms_per_step=us / args.steps / 1e3,
                      calls_per_step=n / args.steps)
                 for k, (us, n) in sorted(kern.items(),
                                          key=lambda kv: -kv[1][0])[:15]])
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
