"""How far the long-sequence and packed-layout attention checks of
chip_smoke.py stand from the sound kernels and from planted faults.

    python3 tools/attention_fault_check.py [--forward simt] [--variants]
        [--fp32] [--only NAME ...]

Needs one CUDA card and nvcc. For each fault the port and chip_smoke.py
are copied into a temporary directory and the fault is planted in the
copy's ``csrc/fused_attention.cu`` (the checkout is never edited); all
copies are built at once, then each runs, one after another, every
kernel case of chip_smoke's ``long_case_list`` and ``packed_case_list``
(untimed; the sound copy runs each packed case at SOUND_SALTS seeds of
data and dropout mask, for the spread of the readings the limits must
clear), the bert_long and bert_packed phases' one-step
kernel-vs-plain checks at every data seed of chip_smoke's STEP_SEEDS,
judged by chip_smoke's ``step_verdict``, and the bert phase's fp32 step
check (``bert_step_check``: BERT_LOSS_RTOL, BERT_GRAD_RTOL). ``--fp32``
runs the fp32 cases and the fp32 step check alone. Faults:

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
                enters the product transposed;
  v_not_transposed  the tensor-core forward reads V for P . V likewise;
  tf32x1        the fp32 kernels on the tensor cores multiply the TF32
                high parts alone (hi.hi: TF32, not 3xTF32).

The first four are planted in the SIMT kernels (fp32 and every type at
d 256, and past it), the 3xTF32 kernels (fp32 up to d 128), the 16-bit
tensor-core forward and the 16-bit tensor-core backward;
tests/test_torch_attention_plants.py checks that each reaches them.

Variants (with --variants; reported, not judged: each is a forward
that could have shipped):

  forward_simt     the bf16 and fp16 forward on the SIMT kernel, as it
                   ran before the tensor-core forward;
  pieces_1, pieces_3
                   the tensor-core forward with P in one or three pieces
                   of the input type, not two;
  single_chain     its P . V as one mma chain over every key (O rescaled,
                   then accumulated into), not a zero accumulator a tile;
  fp32_simt        fp32 on the SIMT kernels, as it ran before the 3xTF32
                   kernels;
  lo_rounded       the 3xTF32 kernels' lo parts rounded to TF32 by cvt,
                   not passed as fp32 bits that the tensor cores truncate;
  q_split_each_tile  the 3xTF32 forward splits Q's fragments each tile at
                   d 64 (holds them in registers only up to d 32);
  dkdv_cols_64     the 3xTF32 dk/dv kernel holds S^T and dP^T over all 64
                   query columns of a tile at once (not 32).

--forward simt plants forward_simt into every copy, faults included:
the readings the multi-seed limits were set from. Each copy that runs
with --variants also times the forward at chip_smoke's long, flash and
resident shapes (bf16, p 0), or with --fp32 the fp32 forward and
backward at the bert path's shape (p 0.1 and 0) and at d 128.

Prints the card's name and power limit, then one JSON line per (copy,
case): each output's max |kernel - plain| over the plain output's
largest magnitude, the limit chip_smoke holds it to, and the outputs
over their limits; one per (copy, phase, data seed) of the step check
and one per (copy, phase) with its verdict; then a summary. Exits 0
when the sound copy passes every limit and each planted fault is caught
by at least one.
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
# the fp32 backward's loops, over tiles of kBwdRows<D> rows
_K_LOOP_TB = "  for (int k0 = 0; k0 < S; k0 += TB) {\n"
_Q_LOOP_TB = "  for (int q0 = 0; q0 < S; q0 += TB) {\n"
_SKIP_K = "    if (k0 == kB) continue;\n"
_SKIP_Q = "    if (q0 == kB) continue;\n"
# name: [(text of the sound source, its replacement, occurrences)]
FAULTS = {
    "sound": [],
    "skip_tile": [(_K_LOOP, _K_LOOP + _SKIP_K, 7),
                  (_K_LOOP_TB, _K_LOOP_TB + _SKIP_K, 1),
                  (_Q_LOOP, _Q_LOOP + _SKIP_Q, 3),
                  (_Q_LOOP_TB, _Q_LOOP_TB + _SKIP_Q, 1)],
    "no_mask": [("  return s * scale + (brow ? brow[col] : 0.f);",
                 "  return s * scale;", 1),
                ("  return brow ? brow[col] : 0.f;", "  return 0.f;", 1)],
    "pair_by_head": [(", bh, p_drop, keep);", ", h, p_drop, keep);", 12)],
    "row_stride_d": [("const long long stride = rs;",
                      "const long long stride = D;", 2)],
    "k_not_transposed": [("ldsm_t(kb, Kt + c * LDS + bt_off + n);",
                          "ldsm(kb, Kt + c * LDS + bt_off + n);", 1)],
    "v_not_transposed": [("ldsm_t(vb, Vt + c * LDS + bt_off + n);",
                          "ldsm(vb, Vt + c * LDS + bt_off + n);", 1)],
    "tf32x1": [("  mma_tf32(c, al, bh[0], bh[1]);\n"
                "  mma_tf32(c, ah, bl[0], bl[1]);\n", "", 1)],
}
_PIECES = "constexpr int kPPieces = 2;"
VARIANTS = {
    "forward_simt": [("constexpr int kMmaFwdMaxD = 128;",
                      "constexpr int kMmaFwdMaxD = 0;", 1)],
    "pieces_1": [(_PIECES, _PIECES.replace("2", "1"), 1)],
    "pieces_3": [(_PIECES, _PIECES.replace("2", "3"), 1)],
    "single_chain": [
        ("    float pv[D / 8][4] = {};\n",
         "    for (int j = 0; j < D / 8; ++j)\n"
         "      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];\n"
         "    float (&pv)[D / 8][4] = acc;\n", 1),
        ("        acc[j][e] = fmaf(acc[j][e], corr[e >> 1], pv[j][e]);\n",
         "        (void)pv[j][e];\n", 1)],
    "fp32_simt": [("constexpr int kTf32MaxD = 128, kTf32BwdMaxD = 64;",
                   "constexpr int kTf32MaxD = 0, kTf32BwdMaxD = 0;", 1)],
    "lo_rounded": [("  lo = __float_as_uint(x - __uint_as_float(hi));",
                    "  lo = to_tf32(x - __uint_as_float(hi));", 1)],
    "q_split_each_tile": [("constexpr bool kHoldQ = D <= 64;",
                           "constexpr bool kHoldQ = D <= 32;", 1)],
    "dkdv_cols_64": [("constexpr int kTf32DkdvCols = D >= 32 ? 32 : 64;",
                      "constexpr int kTf32DkdvCols = 64;", 1)],
}
PLANTS = dict(FAULTS, **VARIANTS)
# the forward's timed shapes (chip_smoke's long_case_list and
# packed_case_list): (name, B, H, S, d, packed)
TIMED = (("long_S2048", 1, 12, 2048, 64, False),
         ("flash_S8192", 1, 12, 8192, 64, False),
         ("resident_config3", 128, 12, 128, 64, True))


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


def time_forward(A, smoke, dev, flush):
    """{shape: ms} of the forward kernel at TIMED, bf16, p 0, padding
    mask (chip_smoke's time_ms)."""
    import torch
    out = {}
    for name, B, H, S, d, packed in TIMED:
        gen = torch.Generator(device=dev).manual_seed(S)
        if packed:
            q, k, v = (A._split_heads(torch.randn(
                B, S, H * d, device=dev, generator=gen).bfloat16(), H)
                for _ in range(3))
        else:
            q, k, v = (torch.randn(B, H, S, d, device=dev,
                                   generator=gen).bfloat16()
                       for _ in range(3))
        bias = torch.zeros(B, 1, 1, S, device=dev)
        bias_f, strides = A._bias_operand(bias, B, H, S)
        out[name] = smoke.time_ms(lambda: A.fused_attention_fwd_kernel(
            q, k, v, bias_f, strides, None, d ** -0.5, 0.0), flush)
        del q, k, v
    return out


# the fp32 timed shapes: (name, B, H, S, d, p), padding mask
FP32_TIMED = (("path_p0.1", 32, 12, 512, 64, 0.1),
              ("path_p0", 32, 12, 512, 64, 0.0),
              ("d128_p0.1", 8, 8, 512, 128, 0.1))


def time_fp32(A, smoke, dev, flush):
    """{shape: {fwd, bwd: ms}} of the fp32 forward kernel and the dq and
    dk/dv kernels together at FP32_TIMED (chip_smoke's time_ms)."""
    import torch
    out = {}
    for name, B, H, S, d, p in FP32_TIMED:
        gen = torch.Generator(device=dev).manual_seed(S + d)
        q, k, v, do = (torch.randn(B, H, S, d, device=dev, generator=gen)
                       for _ in range(4))
        lens = torch.randint(S // 2, S + 1, (B, 1), device=dev, generator=gen)
        bias = torch.where(torch.arange(S, device=dev)[None] < lens, 0.0,
                           -1e4).view(B, 1, 1, S)
        bias_f, strides = A._bias_operand(bias, B, H, S)
        seed = torch.tensor([S], dtype=torch.int64, device=dev)
        o, lse = A.fused_attention_fwd_kernel(q, k, v, bias_f, strides, seed,
                                              d ** -0.5, p)
        out[name] = dict(
            fwd=smoke.time_ms(lambda: A.fused_attention_fwd_kernel(
                q, k, v, bias_f, strides, seed, d ** -0.5, p), flush),
            bwd=smoke.time_ms(lambda: A.fused_attention_backward(
                q, k, v, bias_f, strides, seed, o, lse, do, d ** -0.5, p,
                bias_grad=True), flush))
        del q, k, v, do, o, lse
    return out


def run_copy(copy, name, timed, fp32):
    """In a child process: every long and packed case, the two bf16 step
    checks at every data seed and the fp32 step check on the copy at
    ``copy`` (with ``fp32``, the fp32 cases and step check alone), one
    JSON line each. Returns whether any limit failed (the child exits 10
    then, 0 if none did)."""
    sys.path.insert(0, copy)
    import torch
    import chip_smoke as smoke
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.kernels import attention as A
    from paddle_tpu_torch.models import bert

    dev = torch.device("cuda")
    failed = False
    if timed:
        flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
        if fp32:
            print(json.dumps(dict(copy=name, fp32_ms=time_fp32(
                A, smoke, dev, flush))), flush=True)
        else:
            print(json.dumps(dict(copy=name, fwd_ms=time_forward(
                A, smoke, dev, flush))), flush=True)
        del flush
    checks = [(smoke.long_check, case, {})
              for case in smoke.long_case_list()]
    checks += [(smoke.packed_check, case[:-1], {"salt": salt})
               for case in smoke.packed_case_list()
               for salt in range(SOUND_SALTS if name == "sound" else 1)]
    if fp32:   # the cases' dtype: long_check's 7th argument, packed's 8th
        checks = [c for c in checks
                  if c[1][6 if c[0] is smoke.long_check else 7]
                  == torch.float32]
    for check, case, kwargs in checks:
        rec, inputs = check(A, dev, *case, **kwargs)
        del inputs
        over = sorted(k for k, r in rec["rel_err"].items()
                      if not r <= rec["rtol"][k])
        failed |= bool(over)
        print(json.dumps(dict(copy=name, case=rec["name"], **kwargs,
                              rel_err=rec["rel_err"], rtol=rec["rtol"],
                              max_abs_err=rec["max_abs_err"],
                              over=over)), flush=True)
        torch.cuda.empty_cache()
    exe = fluid.Executor(dev)
    prog = smoke.bert_program(fluid, bert)
    feed = bert.synthetic_batch(prog[0], smoke.BERT_BATCH, smoke.BERT_SEQ,
                                seed=0)
    scope = fluid.Scope()
    exe.run(prog[2], scope=scope)
    rec = smoke.bert_step_check(A, exe, fluid, prog, feed, scope)
    del prog, scope
    failed |= not rec["passes"]
    print(json.dumps(dict(copy=name, check="bert_step_vs_plain", **rec)),
          flush=True)
    torch.cuda.empty_cache()
    for phase, step_check, prog, grad_rtol in () if fp32 else (
            ("bert_long", smoke.long_step_check,
             smoke.long_program(fluid, bert, smoke.LONG_CHECK_SEQ),
             smoke.LONG_GRAD_RTOL),
            ("bert_packed", smoke.packed_step_check,
             smoke.packed_program(fluid, bert, bert.BertConfig.base(),
                                  "packed"),
             smoke.PACKED_GRAD_RTOL)):
        recs = smoke.step_check_seeds(A, exe, fluid, bert, prog, step_check)
        del prog
        for rec in recs:
            print(json.dumps(dict(copy=name, check="step_vs_plain",
                                  phase=phase, **rec)), flush=True)
        verdict = smoke.step_verdict(recs, grad_rtol,
                                     smoke.STEP_LOSS_MEAN[phase])
        failed |= not verdict["passes"]
        print(json.dumps(dict(copy=name, check="step_verdict", phase=phase,
                              **verdict)), flush=True)
        torch.cuda.empty_cache()
    return failed


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--forward", choices=("simt",),
                    help="plant forward_simt into every copy")
    ap.add_argument("--variants", action="store_true",
                    help="also run the VARIANTS copies, timed")
    ap.add_argument("--fp32", action="store_true",
                    help="the fp32 cases and the fp32 step check alone")
    ap.add_argument("--only", nargs="+", help="run these copies alone")
    ap.add_argument("--copy", help=argparse.SUPPRESS)
    ap.add_argument("--name", help=argparse.SUPPRESS)
    ap.add_argument("--timed", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.copy:
        return 10 if run_copy(args.copy, args.name, args.timed,
                              args.fp32) else 0

    import torch
    if not torch.cuda.is_available():
        print("attention_fault_check: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    names = list(FAULTS) + (list(VARIANTS) if args.variants else [])
    if args.only:
        names = [n for n in PLANTS if n in args.only]
    tmp = tempfile.mkdtemp(prefix="attention_faults_")
    try:
        copies = {}
        for name in names:
            copies[name] = os.path.join(tmp, name)
            shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"),
                            os.path.join(copies[name], "paddle_tpu_torch"),
                            ignore=shutil.ignore_patterns("_build",
                                                          "__pycache__"))
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), copies[name])
            if args.forward == "simt":
                plant(copies[name], "forward_simt")
            if name != "forward_simt" or args.forward != "simt":
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
            cmd = [sys.executable, os.path.abspath(__file__), "--copy", copy,
                   "--name", name]
            rc = subprocess.call(cmd + (["--timed"] if args.variants
                                        else []) +
                                 (["--fp32"] if args.fp32 else []))
            if rc not in (0, 10):
                raise RuntimeError("%s: the check exited %d" % (name, rc))
            failed[name] = rc == 10
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ok = all(failed[n] == (n != "sound") for n in failed if n in FAULTS)
    print(json.dumps(dict(summary="faults", forward=args.forward or "as built",
                          failed_a_limit=failed, ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
