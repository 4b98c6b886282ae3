"""Whether the decode-attention checks of chip_smoke.py catch faults planted
in the kernels that split the key axis, and pass the sound kernels.

    python3 tools/decode_fault_check.py [--variants] [--only NAME ...]

Needs one CUDA card and nvcc. For each fault the port and chip_smoke.py
are copied into a temporary directory and the fault is planted in the
copy's ``csrc/decode_attention.cu`` (the checkout is never edited; the
copies leave out ``csrc/fused_attention.cu``, which no decode case
runs). All copies are built at once; then each runs, in a process of its
own, every decode kernel case of chip_smoke's ``decode_case_list``
untimed: the dense cases (path, ragged, causal, wrapped ring; fp32 and
bf16) against the plain version, the row-width checks (dense, paged and
padded), and the paged cases against the plain version and the dense
kernel on the gathered cache. Faults:

  sound           no fault: every case must pass;
  drop_split      the combine skips the last piece of each row;
  no_rescale      the combine adds the partials without exp(m_i - M);
  split_boundary  each piece after the first skips its first column.

Variants (with --variants; each must pass every case, and each copy,
the sound one too, is first timed at tools/time_decode.py's path shapes
and forced piece counts): designs that could have shipped,

  no_pdl          the combine launched after the split kernel's end, not
                  as a programmatic dependent launch;
  stages2, stages4
                  a ring of 2 or 4 tiles, not 3;
  tile16          tiles of at most 8 KB (16 keys at fp32 d 64), not 16;
  tile16_stages4  both: 16-key tiles in a ring of 4.

Prints the card's name and power limit, then one JSON line per (copy,
case) with its verdict and, where it failed, the check's message; then a
summary. Exits 0 when the sound copy and every variant pass every case
and each planted fault fails at least one. tools/decode_rehearsal.py
plants the same faults in the CPU emulation.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join("paddle_tpu_torch", "kernels", "csrc")
SOURCE = os.path.join(CSRC, "decode_attention.cu")
# name: [(text of the sound source, its replacement, occurrences)]
FAULTS = {
    "sound": [],
    "drop_split": [("    for (int s = 0; s < splits; ++s) {\n"
                    "      const float m = ml[2 * s];",
                    "    for (int s = 0; s < splits - 1; ++s) {\n"
                    "      const float m = ml[2 * s];", 1)],
    "no_rescale": [("      const float w = expf(m - M);",
                    "      const float w = 1.f;", 1)],
    "split_boundary": [("  const int c_begin = split * a.piece;",
                        "  const int c_begin = split * a.piece + "
                        "(split > 0);", 1)],
}
# designs that could have shipped (with --variants; timed, not judged)
VARIANTS = {
    "no_pdl": [("attr[0].val.programmaticStreamSerializationAllowed = 1;",
                "attr[0].val.programmaticStreamSerializationAllowed = 0;",
                1)],
    "stages2": [("constexpr int kStages = 3;", "constexpr int kStages = 2;",
                 1)],
    "stages4": [("constexpr int kStages = 3;", "constexpr int kStages = 4;",
                 1)],
    "tile16": [("constexpr int kStageBytes = 16384;",
                "constexpr int kStageBytes = 8192;", 1)],
    "tile16_stages4": [("constexpr int kStages = 3;",
                        "constexpr int kStages = 4;", 1),
                       ("constexpr int kStageBytes = 16384;",
                        "constexpr int kStageBytes = 8192;", 1)],
}
PLANTS = dict(FAULTS, **VARIANTS)


def plant(copy, name):
    path = os.path.join(copy, SOURCE)
    with open(path) as f:
        text = f.read()
    for old, new, count in PLANTS[name]:
        if text.count(old) != count:
            raise RuntimeError("%s: %r occurs %d times in %s, expected %d"
                               % (name, old, text.count(old), SOURCE, count))
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)


def run_copy(copy, name, timed):
    """In a child process: every decode case of chip_smoke on the copy at
    ``copy``, untimed, one JSON line each; with ``timed`` first the copy's
    times at the path shapes and forced piece counts
    (``time_decode.time_cases``). Returns whether any case failed."""
    sys.path.insert(0, copy)
    sys.path.insert(1, os.path.join(ROOT, "tools"))
    import torch
    import chip_smoke as smoke
    import time_decode
    from paddle_tpu_torch.kernels import attention as A

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    if timed:
        flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
        for rec in time_decode.time_cases(A, smoke, dev, flush, sweep=True):
            print(json.dumps(dict(copy=name, **rec)), flush=True)
        del flush
    failed = False
    for case, fn, args, kw in smoke.decode_case_list():
        kw = {k: v for k, v in kw.items() if k != "sweep"}
        try:
            if fn is smoke.decode_width_check:
                fn(A, dev, gen, *args)
            else:
                fn(A, dev, gen, None, *args, timed=False, **kw)
            verdict = dict(passed=True)
        except AssertionError as e:
            failed = True
            verdict = dict(passed=False, message=str(e)[:300])
        print(json.dumps(dict(copy=name, case=case, **verdict)), flush=True)
    return failed


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", action="store_true",
                    help="also run the VARIANTS copies; time every copy")
    ap.add_argument("--only", nargs="+", help="run these copies alone")
    ap.add_argument("--copy", help=argparse.SUPPRESS)
    ap.add_argument("--name", help=argparse.SUPPRESS)
    ap.add_argument("--timed", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.copy:
        return 10 if run_copy(args.copy, args.name, args.timed) else 0

    import torch
    if not torch.cuda.is_available():
        print("decode_fault_check: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    names = list(FAULTS) + (list(VARIANTS) if args.variants else [])
    if args.only:
        names = [n for n in PLANTS if n in args.only]
    tmp = tempfile.mkdtemp(prefix="decode_faults_")
    try:
        copies = {}
        for name in names:
            copies[name] = os.path.join(tmp, name)
            shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"),
                            os.path.join(copies[name], "paddle_tpu_torch"),
                            ignore=shutil.ignore_patterns(
                                "_build", "__pycache__",
                                "fused_attention.cu"))
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), copies[name])
            plant(copies[name], name)
        build = ("import sys; sys.path.insert(0, sys.argv[1]); "
                 "from paddle_tpu_torch.kernels import _build; "
                 "_build.build_all()")
        procs = [subprocess.Popen([sys.executable, "-c", build, c])
                 for c in copies.values()]
        if any([p.wait() for p in procs]):
            raise RuntimeError("a copy failed to build")
        failed = {}
        for name, copy in copies.items():
            rc = subprocess.call([sys.executable, os.path.abspath(__file__),
                                  "--copy", copy, "--name", name] +
                                 (["--timed"] if args.variants else []))
            if rc not in (0, 10):
                raise RuntimeError("%s: the check exited %d" % (name, rc))
            failed[name] = rc == 10
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # a variant is a sound design: it must pass every case too
    ok = all(failed[n] == (n in FAULTS and n != "sound") for n in failed)
    print(json.dumps(dict(summary="decode faults", failed_a_check=failed,
                          ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
