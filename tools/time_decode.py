"""Time the decode-attention kernels of a tree of the port at the main
paths' shapes, so that two trees can be compared in one run on one card.

    python3 tools/time_decode.py [--tree DIR] [--sweep]

Needs one CUDA card. Imports ``paddle_tpu_torch`` from DIR (default:
this checkout; e.g. an unpacked parent commit) and times its
``decode_attention_kernel`` and ``paged_attention_kernel`` with this
checkout's ``chip_smoke.time_ms`` (CUDA events, median of 25 launches
after an L2-evicting write of 128 MiB, and again after a read of it,
which leaves no dirty lines in the L2) at the shapes and lengths of
chip_smoke's decode cases named in TIMED (``decode_case_list``): the
dense path, its speculative verify rows (Q 4, causal window), the
serving path's mix, the serving phase's own steps and one long slot.
Inputs are drawn from fixed seeds, the same for every tree; a tree
whose wrappers take ``longest`` gets the cases' longest length, as the
decode sessions pass it. Prints the card's name and power limit, then
one JSON line per case with the tree, its time and max |kernel -
plain|; ``--sweep`` adds the times at the case's forced counts of
key-axis pieces (its ``sweep``).
"""

import argparse
import inspect
import json
import math
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the cases of chip_smoke.decode_case_list that are timed
TIMED = ("path_f32", "causal_f32", "paged_path", "paged_step", "paged_long")


def time_cases(A, smoke, dev, flush, sweep=False):
    """One record per TIMED case: the kernel's time (and with ``sweep``
    its times at the case's forced piece counts) and max |kernel -
    plain|."""
    hint = "longest" in inspect.signature(
        A.decode_attention_kernel).parameters
    recs = []
    for name, fn, args, kw in smoke.decode_case_list():
        if name not in TIMED:
            continue
        if fn is smoke.dense_case:
            _, B, H, Q, C, d, lens, dtype = args
            causal = kw.get("causal", False)
            q, k, v, cache_len = smoke.dense_inputs(
                dev, torch.Generator(device=dev).manual_seed(1), B, H, Q, C,
                d, lens, dtype)
            scale, cap = 1.0 / math.sqrt(d), C

            def run(_q=q, _k=k, _v=v, _n=cache_len, _c=causal, _s=scale,
                    **extra):
                return A.decode_attention_kernel(_q, _k, _v, _n, _s, _c,
                                                 **extra)
            want = A._ref_attention_cache(q, k, v, cache_len, scale, causal)
        else:
            _, B, npages, pool_pages, lens = args
            q, k_pool, v_pool, table, cache_len = smoke.paged_inputs(
                dev, torch.Generator(device=dev).manual_seed(2), B, npages,
                pool_pages, lens)
            scale, cap = 1.0 / math.sqrt(q.shape[-1]), npages * 128

            def run(_q=q, _k=k_pool, _v=v_pool, _t=table, _n=cache_len,
                    _s=scale, **extra):
                return A.paged_attention_kernel(_q, _k, _v, _t, _n, _s,
                                                **extra)
            want = A._ref_attention_cache(
                q, A.gather_paged_cache(k_pool, table),
                A.gather_paged_cache(v_pool, table), cache_len, scale)
        extra = dict(longest=max(lens)) if hint else {}
        rec = dict(case=name,
                   kernel_ms=smoke.time_ms(lambda: run(**extra), flush),
                   kernel_ms_clean_l2=smoke.time_ms(lambda: run(**extra),
                                                    flush, True),
                   max_abs_err=(run(**extra).float() - want.float()).abs()
                   .max().item())
        if sweep and kw.get("sweep"):
            rec.update(smoke.split_sweeps(A, lambda s: run(_splits=s), flush,
                                          cap, kw["sweep"]))
        recs.append(rec)
    return recs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--sweep", action="store_true",
                    help="also time each case's forced piece counts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_decode: torch sees no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, HERE)
    import chip_smoke as smoke
    sys.path.insert(0, tree)
    from paddle_tpu_torch.kernels import attention as A
    if not os.path.dirname(os.path.abspath(A.__file__)).startswith(tree):
        raise RuntimeError("imported %s, not the tree's" % A.__file__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    for rec in time_cases(A, smoke, dev, flush, args.sweep):
        print(json.dumps(dict(tree=args.tree, **rec)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
