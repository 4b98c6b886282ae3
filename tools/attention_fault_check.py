"""How far the long-sequence and packed-layout attention checks of
chip_smoke.py stand from the sound kernels and from planted faults.

    python3 tools/attention_fault_check.py

Needs one CUDA card and nvcc. For each fault the port and chip_smoke.py
are copied into a temporary directory and the fault is planted in the
copy's ``csrc/fused_attention.cu`` (the checkout is never edited); all
copies are built at once, then each runs, one after another, every
kernel case of chip_smoke's ``long_case_list`` and ``packed_case_list``
(untimed; the sound copy runs each packed case at SOUND_SALTS seeds of
data and dropout mask, for the spread of the readings the limits must
clear), the bert_long phase's one-step kernel-vs-plain check and the
bert_packed phase's. Faults:

  sound         no fault: the readings the limits must clear;
  skip_tile     each kernel skips its second tile (keys 64-127 in the
                forward and dq kernels, query rows 64-127 in dk/dv; in
                the tensor-core kernels the double-buffered copy of the
                tile after it is skipped too);
  no_mask       the bias (the padding mask) is ignored;
  pair_by_head  the dropout mask is keyed on the head alone, not on
                b * H + h, so every batch row draws the first row's mask;
  row_stride_d  tiles are loaded with a row stride of d elements (the
                SIMT loads and the tensor-core kernels' cp.async copies),
                as if every operand were contiguous [B, H, S, d]: right
                there, wrong in the packed layout, whose rows are H * d
                apart (and right at H = 1);
  k_not_transposed  the tensor-core dq kernel reads K for dq += dS . K
                with ldmatrix without .trans, so each 8 x 8 block of K
                enters the product transposed.

Every fault but k_not_transposed is planted in both the SIMT kernels
(the forward in every type, the fp32 backward) and the tensor-core
backward; tests/test_torch_attention_plants.py checks that it reaches
each.

Prints one JSON line per (fault, case): each output's max |kernel -
plain| over the plain output's largest magnitude, the limit chip_smoke
holds it to, and the outputs over their limits; then one per fault for
the step check. Exits 0 when the sound copy passes every limit and each
planted fault is caught by at least one.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join("paddle_tpu_torch", "kernels", "csrc",
                      "fused_attention.cu")
SOUND_SALTS = 5
_K_LOOP = "  for (int k0 = 0; k0 < S; k0 += kB) {\n"
_Q_LOOP = "  for (int q0 = 0; q0 < S; q0 += kB) {\n"
# fault: [(text of the sound source, its replacement, occurrences)]
FAULTS = {
    "sound": [],
    "skip_tile": [
        (_K_LOOP, _K_LOOP + "    if (k0 == kB) continue;\n", 3),
        (_Q_LOOP, _Q_LOOP + "    if (q0 == kB) continue;\n", 2)],
    "no_mask": [("  return s * scale + (brow ? brow[col] : 0.f);",
                 "  return s * scale;", 1),
                ("  return brow ? brow[col] : 0.f;", "  return 0.f;", 1)],
    "pair_by_head": [(", bh, p_drop, keep);", ", h, p_drop, keep);", 5)],
    "row_stride_d": [("const long long stride = rs;",
                      "const long long stride = D;", 2)],
    "k_not_transposed": [("ldsm_t(kb, Kt + c * LDS + bt_off + n);",
                          "ldsm(kb, Kt + c * LDS + bt_off + n);", 1)],
}


def plant(copy, fault):
    path = os.path.join(copy, SOURCE)
    with open(path) as f:
        text = f.read()
    for old, new, count in FAULTS[fault]:
        if text.count(old) != count:
            raise RuntimeError("%s: %r occurs %d times in %s, expected %d"
                               % (fault, old, text.count(old), SOURCE, count))
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)


def run_copy(copy, fault):
    """In a child process: every long and packed case and the two step
    checks on the copy at ``copy``, one JSON line each. Returns whether
    any limit failed (the child exits 10 then, 0 if none did)."""
    sys.path.insert(0, copy)
    import torch
    import chip_smoke as smoke
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.kernels import attention as A
    from paddle_tpu_torch.models import bert

    dev = torch.device("cuda")
    failed = False
    checks = [(smoke.long_check, case, {})
              for case in smoke.long_case_list()]
    checks += [(smoke.packed_check, case[:-1], {"salt": salt})
               for case in smoke.packed_case_list()
               for salt in range(SOUND_SALTS if fault == "sound" else 1)]
    for check, case, kwargs in checks:
        rec, inputs = check(A, dev, *case, **kwargs)
        del inputs
        over = sorted(k for k, r in rec["rel_err"].items()
                      if not r <= rec["rtol"][k])
        failed |= bool(over)
        print(json.dumps(dict(fault=fault, case=rec["name"], **kwargs,
                              rel_err=rec["rel_err"], rtol=rec["rtol"],
                              max_abs_err=rec["max_abs_err"],
                              over=over)), flush=True)
        torch.cuda.empty_cache()
    exe = fluid.Executor(dev)
    for name, step_check, prog, loss_rtol, grad_rtol in (
            ("bert_long", smoke.long_step_check,
             smoke.long_program(fluid, bert, smoke.LONG_CHECK_SEQ),
             smoke.LONG_LOSS_RTOL, smoke.LONG_GRAD_RTOL),
            ("bert_packed", smoke.packed_step_check,
             smoke.packed_program(fluid, bert, bert.BertConfig.base(),
                                  "packed"),
             smoke.PACKED_LOSS_RTOL, smoke.PACKED_GRAD_RTOL)):
        rec = step_check(A, exe, fluid, bert, prog)
        del prog
        over = sorted(n for n, r in rec["grad_rel"].items()
                      if not r <= grad_rtol[n])
        if not rec["loss_rel"] <= loss_rtol:
            over.append("loss")
        failed |= bool(over)
        print(json.dumps(dict(fault=fault, check="step_vs_plain",
                              phase=name, over=over, **rec)), flush=True)
        torch.cuda.empty_cache()
    return failed


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--copy", help=argparse.SUPPRESS)
    ap.add_argument("--fault", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.copy:
        return 10 if run_copy(args.copy, args.fault) else 0

    import torch
    if not torch.cuda.is_available():
        print("attention_fault_check: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    tmp = tempfile.mkdtemp(prefix="attention_faults_")
    try:
        copies = {}
        for fault in FAULTS:
            copies[fault] = os.path.join(tmp, fault)
            shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"),
                            os.path.join(copies[fault], "paddle_tpu_torch"),
                            ignore=shutil.ignore_patterns("_build",
                                                          "__pycache__"))
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), copies[fault])
            plant(copies[fault], fault)
        build = ("import sys; sys.path.insert(0, sys.argv[1]); "
                 "from paddle_tpu_torch.kernels import _build; "
                 "_build.build_all()")
        procs = [subprocess.Popen([sys.executable, "-c", build, c])
                 for c in copies.values()]
        if any([p.wait() for p in procs]):
            raise RuntimeError("a copy failed to build")
        caught = {}
        for fault, copy in copies.items():
            rc = subprocess.call([sys.executable, os.path.abspath(__file__),
                                  "--copy", copy, "--fault", fault])
            if rc not in (0, 10):
                raise RuntimeError("%s: the check exited %d" % (fault, rc))
            caught[fault] = rc == 10
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ok = all(caught[f] == (f != "sound") for f in caught)
    print(json.dumps(dict(summary="faults", failed_a_limit=caught, ok=ok)),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
