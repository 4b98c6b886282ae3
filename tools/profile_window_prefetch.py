"""Where the time of a py_reader-fed iters=k window goes on the card,
prefetched (``Executor.run(..., prefetch=True)``) and inline.

    python3 tools/profile_window_prefetch.py [--windows 8] [--iters 4]
                                              [--wait copy|stream]

Needs one CUDA card. Builds chip_smoke.py's checkpoint-phase program
(config 3: BERT-base, batch 128, S 128, bf16 AMP, packed, fed by its
py_reader) and runs ``--windows`` windows of ``--iters`` steps from one
startup state, inline, prefetched, prefetched, inline, each run in a
fresh executor and a clone of the state. Timers wrap the executor's
pieces on the host clock: the window's own steps (``_window``), the
host's wait for its fetch, and, on the prefetch thread, the pull of the
batches (``_pull_window``), their stacking (``_stack_window``) and the
copy to the card (``reader.copy_feed``), with the consuming run's wait
for the thread (``executor_window_stall_seconds``). Prints the card's
name and power limit, then one JSON line a window: its wall ms and each
piece's ms, the thread's pieces measured from the start of the window
they were started in. ``--wait``: how the host waits for a window's
fetch: ``copy`` (the copy to the host, as ``Executor.run`` returns
numpy) or ``stream`` (a sync of the current stream first, then the
copy).
"""

import argparse
import json
import os
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as S  # noqa: E402
from paddle_tpu_torch import fluid  # noqa: E402
from paddle_tpu_torch.fluid import executor as E  # noqa: E402
from paddle_tpu_torch.fluid import monitor, reader  # noqa: E402
from paddle_tpu_torch.models import bert  # noqa: E402

EVENTS = []
_LOCK = threading.Lock()


def timed(name, fn):
    """``fn`` recording (name, thread, start, end) on the host clock."""
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            with _LOCK:
                EVENTS.append((name, threading.current_thread().name, t0,
                               time.perf_counter()))
    return wrapped


def run(main, loss, init, windows, iters, prefetch, wait):
    sc, exe = S.clone_scope(fluid, init), fluid.Executor("cuda")
    stall = monitor.histogram("executor_window_stall_seconds")
    main.py_reader.start()
    out = []
    for w in range(windows):
        del EVENTS[:]
        c0 = (stall.count, stall.sum)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (v,) = exe.run(main, fetch_list=[loss], scope=sc, iters=iters,
                       prefetch=prefetch, return_numpy=False)
        t1 = time.perf_counter()
        if wait == "stream":
            torch.cuda.current_stream().synchronize()
        np.asarray(v.cpu())
        t2 = time.perf_counter()
        rec = dict(mode="prefetch" if prefetch else "inline", wait=wait,
                   window=w,
                   wall_ms=(t2 - t0) * 1e3, run_ms=(t1 - t0) * 1e3,
                   fetch_wait_ms=(t2 - t1) * 1e3,
                   stall_ms=(stall.sum - c0[1]) * 1e3
                   if stall.count > c0[0] else None)
        with _LOCK:
            for name, thread, a, b in EVENTS:
                key = name if thread == threading.main_thread().name \
                    else "thread_" + name
                rec[key + "_ms"] = (b - a) * 1e3
                rec[key + "_from_start_ms"] = (a - t0) * 1e3
        out.append(rec)
        print(json.dumps(rec), flush=True)
    exe.close()
    main.py_reader.reset()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=8)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--wait", choices=("copy", "stream"), default="copy")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_window_prefetch: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    print(S.card_line(), flush=True)
    E._pull_window = timed("pull", E._pull_window)
    E._stack_window = timed("stack", E._stack_window)
    E.Executor._window = timed("window", E.Executor._window)
    reader.copy_feed = timed("copy", reader.copy_feed)
    cfg, prog, startup, loss = S.reader_program(
        fluid, bert, n_batches=args.windows * args.iters)
    init = fluid.Scope()
    fluid.Executor("cuda", cuda_graphs=False).run(startup, scope=init)
    summary = {}
    for prefetch in (False, True, True, False):
        for rec in run(prog, loss, init, args.windows, args.iters,
                       prefetch, args.wait)[1:]:
            summary.setdefault(rec["mode"], []).append(rec["wall_ms"])
    print(json.dumps({"median_window_ms": {
        k: float(np.median(v)) for k, v in summary.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
