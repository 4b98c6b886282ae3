"""How far a torch.profiler trace of one CUDA-graph replay can be trusted
to count its kernels: one graphed BERT-base AMP step (chip_smoke.py's
``long_program``) traced over several replays, each in its own profiler
session as chip_smoke's ``traced_replay`` traces them.

    python3 tools/trace_replays.py [--seq 8192] [--batch 2] [--traces 8]

Needs one CUDA card. Builds the program at ``--seq``, runs its startup,
one eager step and the step that captures its graph, then traces
``--traces`` replays one at a time (``chip_smoke.host_launches``).
Prints the card's name and power limit, then one JSON line per trace:
its device events (kernels, copies and sets), the fused attention
kernels by wrapper (``chip_smoke.traced_launches``) and every event name
whose count differs from the most common trace's, with the difference.
A graph's replay runs the same work each time, so any difference
between traces is the trace's.
"""

import argparse
import collections
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--traces", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_replays: torch sees no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cfg, main, startup, loss, _ = smoke.long_program(fluid, bert, args.seq)
    feed = bert.synthetic_batch(cfg, args.batch, args.seq, seed=0)
    exe = fluid.Executor(torch.device("cuda"))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    for _ in range(2):      # eager, then the capture and its replay
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)

    def replay():
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)

    traces = []
    for _ in range(args.traces):
        kern = smoke.host_launches(replay)[1]
        traces.append({name: calls for name, (_, calls) in kern.items()})
    totals = [sum(t.values()) for t in traces]
    mode = collections.Counter(totals).most_common(1)[0][0]
    common = traces[totals.index(mode)]
    for i, t in enumerate(traces):
        diff = {name[:100]: t.get(name, 0) - common.get(name, 0)
                for name in set(t) | set(common)
                if t.get(name, 0) != common.get(name, 0)}
        kern = {name: (0.0, calls) for name, calls in t.items()}
        print(json.dumps(dict(trace=i, seq_len=args.seq, batch=args.batch,
                              device_events=totals[i],
                              fused=smoke.traced_launches(kern),
                              diff_from_common=diff)), flush=True)
    exe.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
