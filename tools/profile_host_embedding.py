"""Where a host-tier DeepFM step of paddle_tpu_torch spends its host
time: the embedding table's ``prepare`` (ids to cache slots, eviction
read-back, admission) and ``prefetch`` against the rest of the run.

    python3 tools/profile_host_embedding.py [--shape full|bench]
                                            [--steps 6] [--warm 5]
                                            [--device cuda]

``--shape full``: config 4's widths at batch 4096 with ``fm_emb`` on a
table of chip_smoke.HOST_FULL_ROWS rows behind HOST_FULL_BUDGET cache
rows (chip_smoke.py's ``host_embedding`` full-width check);
``--shape bench``: bench.py's embedding bench (chip_smoke.HOST_BENCH).
Fresh seeded ids every step. For each mode in turn (without and with
``embedding.prefetch(main, next_feed)`` after each step), in a fresh
scope: ``--warm`` steps, then ``--steps`` steps under cProfile. Prints
the card's name and power limit, then one JSON line a mode: the step's
wall ms, the ``run`` and ``prefetch`` calls' host ms, and host ms a step
by function (cProfile's own time, so a numpy fancy-index assignment is
counted in the function that makes it), the largest first. cProfile
adds its own cost to every Python call; the split, not the total, is
what this reads. ``--device cpu`` runs it here, at the same sizes.
"""

import argparse
import cProfile
import json
import os
import pstats
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from paddle_tpu_torch import embedding, fluid  # noqa: E402
from paddle_tpu_torch.models import deepfm  # noqa: E402

TOP = 14


def config(shape):
    """(cfg, budget, batch) of the shape."""
    if shape == "full":
        return (chip_smoke.host_cfg(deepfm, chip_smoke.HOST_FULL_ROWS),
                chip_smoke.HOST_FULL_BUDGET, chip_smoke.DEEPFM_BATCH)
    b = chip_smoke.HOST_BENCH
    return (chip_smoke.host_cfg(deepfm, b["vocab"], b["fields"], b["dense"],
                                b["dim"], b["fc"]), b["budget"], b["batch"])


def by_function(prof, steps):
    """[(function, host ms a step)] by cProfile's own time, largest
    first."""
    stats = pstats.Stats(prof)
    rows = []
    for (path, line, name), (_, _, tottime, _, _) in stats.stats.items():
        where = "%s:%d(%s)" % (os.path.basename(path), line, name) \
            if line else name
        rows.append((where, 1e3 * tottime / steps))
    return sorted(rows, key=lambda r: -r[1])[:TOP]


def profile_mode(shape, prefetch, steps, warm, dev):
    cfg, budget, batch = config(shape)
    table, main, startup, loss = chip_smoke.host_program(
        fluid, deepfm, embedding, cfg, budget)
    feeds = [deepfm.synthetic_batch(cfg, batch, seed=500 + i)
             for i in range(warm + steps + 1)]
    exe, scope = fluid.Executor(dev), fluid.Scope()
    exe.run(startup, scope=scope)
    run_s, prefetch_s = [], []

    def step(i):
        t0 = time.perf_counter()
        lv = exe.run(main, feed=feeds[i], fetch_list=[loss], scope=scope,
                     return_numpy=False)[0]
        t1 = time.perf_counter()
        if prefetch:
            embedding.prefetch(main, feeds[i + 1])
        run_s.append(t1 - t0)
        prefetch_s.append(time.perf_counter() - t1)
        return lv

    for i in range(warm):
        step(i)
    chip_smoke.sync(dev)
    del run_s[:], prefetch_s[:]
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for i in range(warm, warm + steps):
        lv = step(i)
    float(lv.reshape(-1)[0])
    prof.disable()
    wall = time.perf_counter() - t0
    table.close()
    exe.close()
    embedding.reset_tables()
    return dict(shape=shape, prefetch=prefetch, rows=cfg.sparse_feature_dim,
                budget=budget, batch=batch, steps=steps,
                step_ms=1e3 * wall / steps,
                run_call_ms=1e3 * float(np.median(run_s)),
                prefetch_call_ms=1e3 * float(np.median(prefetch_s)),
                host_ms_by_function=[dict(function=f, ms=ms)
                                     for f, ms in by_function(prof, steps)])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", choices=("full", "bench"), default="full")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--warm", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("profile_host_embedding: torch sees no CUDA device",
                  file=sys.stderr)
            return 2
        print(chip_smoke.card_line(), flush=True)
    for prefetch in (False, True):
        print(json.dumps(profile_mode(args.shape, prefetch, args.steps,
                                      args.warm, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
