"""Where a DeepFM training step on the card parts from the same step on
the CPU (BASELINE config 4, sparse, Adam lr 1e-3), element by element.

    python3 tools/deepfm_divergence.py [--batch 4096] [--steps 3]
                                       [--device cuda] [--out FILE]

From one startup state made on ``--device``, four runs take ``--steps``
steps on the fresh seeded batches of chip_smoke.py's card-vs-CPU check
(``deepfm_card_vs_cpu``): eager on the device, graphed on the device
(the executor's default), on the CPU in fp32 and on the CPU in float64
(``chip_smoke.float64_program``). Each step fetches the loss, every
relu's input and every parameter's gradient (a sparse table's
SelectedRows values summed per row, and the sum of their magnitudes
beside it). After each step, for every persistable: whether graphed
equals eager to the bit; the device against the CPU and the CPU against
float64 as the largest difference over the float64 tensor's largest
magnitude, as the count and share of elements past ``--rtol`` of that
magnitude, and as the L2 norm of the difference over the L2 norm of what
the float64 run moved the tensor since the start (``update_rel_l2``).
For each relu, the inputs whose sign differs between the device and the
CPU (a flip sends one example's gradient another way), their size
against the input's standard deviation, and how many of a table's rows
with parted elements a flipped example looks up. For each parameter
with parted elements, the worst ``--top`` of them: the three runs'
values, the step's gradient there in each run, its size against the
median nonzero one, the summed magnitudes of a table row's terms (a
near-cancelling sum reads small), and the CPU's Adam moments. Prints the
device's name and power limit, then one JSON line a step; ``--out``
writes the lines to a file too.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from paddle_tpu_torch import fluid  # noqa: E402
from paddle_tpu_torch.models import deepfm  # noqa: E402


def adam_slots(main):
    """{param: (Moment1, Moment2)} from the program's adam ops."""
    return {op.input("Param")[0]: (op.input("Moment1")[0],
                                   op.input("Moment2")[0])
            for op in main.global_block().ops if op.type == "adam"}


def dense_grads(fetched, names, sparse, vocab):
    """{param: (per-element gradient, per-element sum of |terms| or
    None)} in float64, a sparse table's per-position values summed into
    its rows."""
    out, i = {}, 0
    for n in names:
        if n in sparse:
            vals, rows = (np.asarray(fetched[i], np.float64),
                          np.asarray(fetched[i + 1]).astype(np.int64))
            i += 2
            vals = vals.reshape(rows.shape[0], -1)
            g = np.zeros((vocab, vals.shape[1]))
            mag = np.zeros_like(g)
            np.add.at(g, rows, vals)
            np.add.at(mag, rows, np.abs(vals))
            out[n] = (g, mag)
        else:
            out[n] = (np.asarray(fetched[i], np.float64), None)
            i += 1
    return out


def compare(a, b, truth, rtol):
    d = np.abs(a - b)
    scale = max(float(np.abs(truth).max()), 1e-30)
    past = d > rtol * scale
    return d, scale, dict(max_rel=float(d.max()) / scale,
                          past=int(past.sum()),
                          share=float(past.mean()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=chip_smoke.DEEPFM_BATCH)
    ap.add_argument("--steps", type=int, default=chip_smoke.CHECK_STEPS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rtol", type=float, default=chip_smoke.DEEPFM_CPU_RTOL)
    ap.add_argument("--top", type=int, default=6)
    ap.add_argument("--out")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("deepfm_divergence: torch sees no CUDA device",
                  file=sys.stderr)
            return 2
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip(),
              flush=True)
    main_p, startup, loss, _ = chip_smoke.deepfm_program(fluid, deepfm)
    m64 = chip_smoke.float64_program(main_p)
    vocab = deepfm.DeepFMConfig().sparse_feature_dim
    sparse = set(chip_smoke.sparse_tables(main_p))
    params = sorted(p.name for p in main_p.all_parameters())
    slots = adam_slots(main_p)
    relus = [op.input("X")[0] for op in main_p.global_block().ops
             if op.type == "relu"]
    fetch = [loss.name] + relus
    for n in params:
        fetch += [n + "@GRAD"] + ([n + "@GRAD@ROWS"] if n in sparse else [])
    start = fluid.Scope()
    fluid.Executor(dev, cuda_graphs=False).run(startup, scope=start)
    runs = {}
    for name, place, graphs, prog in (
            ("eager", dev, False, main_p), ("graphed", dev, True, main_p),
            ("cpu", "cpu", False, main_p), ("float64", "cpu", False, m64)):
        sc = fluid.Scope()
        for n in start.local_var_names():
            t = start.find_var(n).to(place, copy=True)
            sc.set_var(n, t.double() if name == "float64" and
                       t.dtype == torch.float32 else t)
        runs[name] = (fluid.Executor(place, cuda_graphs=graphs), sc, prog)
    begin = {n: start.find_var(n).detach().cpu().double().numpy()
             for n in start.local_var_names()}
    flipped_rows = set()
    lines = []
    for step in range(args.steps):
        f = chip_smoke.deepfm_feed(deepfm, args.batch, seed=11 + step)
        got = {}
        for name, (exe, sc, prog) in runs.items():
            feed = dict(f, dense_x=f["dense_x"].astype(np.float64)) \
                if name == "float64" else f
            out = exe.run(prog, feed=feed, fetch_list=fetch, scope=sc)
            k = 1 + len(relus)
            got[name] = (float(np.asarray(out[0]).reshape(-1)[0]),
                         dense_grads(out[k:], params, sparse, vocab),
                         [np.asarray(x, np.float64) for x in out[1:k]])
        state = {name: {n: sc.find_var(n).detach().cpu().double().numpy()
                        for n in sc.local_var_names()}
                 for name, (_, sc, _) in runs.items()}
        rec = dict(step=step + 1, batch=args.batch, rtol=args.rtol,
                   losses={k: v[0] for k, v in got.items()},
                   graphed_unequal=[
                       n for n in sorted(state["eager"])
                       if not np.array_equal(state["eager"][n],
                                             state["graphed"][n])],
                   vars={}, worst={}, relu_flips={}, parted_rows={})
        for r, (xe, xc, xf) in zip(relus, zip(*(got[k][2] for k in (
                "eager", "cpu", "float64")))):
            flip = (xe > 0) != (xc > 0)
            at = np.nonzero(flip)
            flipped_rows.update(f["sparse_ids"].reshape(
                f["sparse_ids"].shape[0], -1)[sorted(set(at[0]))]
                .reshape(-1).tolist())
            rec["relu_flips"][r] = dict(
                device_vs_cpu=int(flip.sum()),
                cpu_vs_float64=int(((xc > 0) != (xf > 0)).sum()),
                examples=sorted(set(int(b) for b in at[0])),
                units=sorted(set(int(u) for u in at[1])),
                size_over_std=float(np.abs(xc[flip]).max() / xc.std())
                if flip.any() else None)
        for n in sorted(state["cpu"]):
            dev_s, cpu_s, f64_s = (state["eager"][n], state["cpu"][n],
                                   state["float64"][n])
            d, _, vs_cpu = compare(dev_s, cpu_s, f64_s, args.rtol)
            _, _, noise = compare(cpu_s, f64_s, f64_s, args.rtol)
            moved = max(float(np.linalg.norm(f64_s - begin[n])), 1e-30)
            rec["vars"][n] = dict(
                device_vs_cpu=vs_cpu, cpu_vs_float64=noise,
                update_rel_l2=[float(np.linalg.norm(dev_s - cpu_s)) / moved,
                               float(np.linalg.norm(cpu_s - f64_s)) / moved])
            if n in sparse and vs_cpu["past"]:
                parted = np.nonzero((d > args.rtol * np.abs(f64_s).max())
                                    .any(axis=1))[0]
                rec["parted_rows"][n] = dict(
                    rows=int(parted.size),
                    of_flipped_examples=int(sum(int(i) in flipped_rows
                                                for i in parted)))
            if n not in params or not vs_cpu["past"]:
                continue
            g = {k: got[k][1][n] for k in ("eager", "cpu", "float64")}
            gc, mag = g["cpu"]
            nz = np.abs(gc[gc != 0])
            med = float(np.median(nz)) if nz.size else 0.0
            flat = np.argsort(d, axis=None)[::-1][:args.top]
            rows = []
            for k in flat:
                at = np.unravel_index(k, d.shape)
                e = dict(at=[int(x) for x in at],
                         value={"device": float(dev_s[at]),
                                "cpu": float(cpu_s[at]),
                                "float64": float(f64_s[at])},
                         diff_over_lr=float(d[at]) / 1e-3,
                         grad={r: float(g[r][0][at]) for r in g},
                         grad_over_median=float(abs(gc[at])) / med
                         if med else None)
                if mag is not None:
                    e["grad_over_term_sum"] = float(abs(gc[at]) / mag[at]) \
                        if mag[at] else None
                if n in slots:
                    e["cpu_moments"] = [float(state["cpu"][s][at])
                                        for s in slots[n]]
                rows.append(e)
            flips = (np.sign(g["eager"][0]) != np.sign(gc)) & (gc != 0)
            rec["worst"][n] = dict(median_abs_grad=med,
                                   grad_sign_flips=int(flips.sum()),
                                   elements=rows)
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    for exe, _, _ in runs.values():
        exe.close()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
