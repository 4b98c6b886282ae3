"""The smoke run's one-step checks of the fused attention (chip_smoke.py's
bert_long and bert_packed ``step_vs_plain``) at each data seed, and
their verdict.

    python3 tools/step_check_spread.py [--seeds 6]

Needs one CUDA card. For data seeds 0 .. --seeds - 1 (chip_smoke checks
STEP_SEEDS, 0-5), runs chip_smoke's ``long_step_check`` (BERT-base AMP,
S 2048, batch 1) and ``packed_step_check`` (S 128, batch 2, packed),
each one step with the kernels and one with the plain attention from one
cloned scope and generator, through ``step_check_seeds``, and prints the
card's name and power limit, one JSON line per (phase, seed): the loss's
signed relative difference (kernel - plain) and each watched first
moment's difference as a share of its largest magnitude; then one line
per phase with chip_smoke's ``step_verdict`` on them (the same function
the smoke run judges by). Both routes round the attention output to
bf16, so a reading is set by which outputs land on either side of a
rounding boundary: the spread over seeds is what the limits have to
clear.
"""

import argparse
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
    ap.add_argument("--seeds", type=int, default=len(smoke.STEP_SEEDS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("step_check_spread: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.kernels import attention as A
    from paddle_tpu_torch.models import bert

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    exe = fluid.Executor(torch.device("cuda"))
    for phase, check, prog, grad_rtol in (
            ("bert_long", smoke.long_step_check,
             smoke.long_program(fluid, bert, smoke.LONG_CHECK_SEQ),
             smoke.LONG_GRAD_RTOL),
            ("bert_packed", smoke.packed_step_check,
             smoke.packed_program(fluid, bert, bert.BertConfig.base(),
                                  "packed"),
             smoke.PACKED_GRAD_RTOL)):
        recs = smoke.step_check_seeds(A, exe, fluid, bert, prog, check,
                                      seeds=range(args.seeds))
        for rec in recs:
            print(json.dumps(dict(phase=phase, **rec)), flush=True)
        print(json.dumps(dict(summary=phase, **smoke.step_verdict(
            recs, grad_rtol, smoke.STEP_LOSS_MEAN[phase]))), flush=True)
        del prog
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
