"""Cold start of one served BERT-base encoder process on the card: from
nothing against from ``__prelowered__/``.

    python3 tools/profile_cold_start.py [--repeat N]

Exports chip_smoke.py's encoder_serving model (BertConfig.base, packed,
S 128, fp32) twice: plain, and with ``save_inference_model(prelower=True)``
at the serving ladder's batch sizes (1-32). Then starts chip_smoke.py's
cold-start child (``--cold-start-child``) on each, in fresh processes with
an empty ``PADDLE_COMPILE_CACHE_DIR`` and no ``_build/`` in reach
(``PADDLE_KERNEL_BUILD_DIR`` empty), alternating ``from_nothing`` and
``prelowered`` N times:

- ``from_nothing``: the plain export; the warm-up builds each ladder
  step's plan live and the attention library with ``nvcc``;
- ``prelowered``: the prelowered export; 0 ``nvcc`` runs.

Each run prints one JSON line: its seconds from spawn to first answer and
by part (import, load, warm-up, answer, and the ``nvcc`` seconds inside
the warm-up), its ``nvcc`` runs, live compiles and disk hits, and its
answer's max |err| against this process's ``Predictor.run`` of the same
rows. The exports need the kernels in this process: it builds them first
(``_build.build_all()``) when they are not built yet.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as S  # noqa: E402
from paddle_tpu_torch import fluid, inference  # noqa: E402
from paddle_tpu_torch.fluid import compile_cache  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.models import bert  # noqa: E402


def export(dirname, dev, prelower, ladder):
    cfg = bert.BertConfig.base()
    cfg.use_fused_attention = "packed"
    feeds, reqs = S.encoder_requests(bert, cfg)
    with fluid.unique_name.guard():
        main, startup, enc = bert.build_encoder_program(cfg,
                                                        seq_len=S.SERVE_SEQ)
    exe, scope = fluid.Executor(dev), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup, scope=scope)
        t0 = time.perf_counter()
        fluid.io.save_inference_model(
            dirname, feeds, [enc], exe, main_program=main, prelower=prelower,
            prelower_batch_sizes=ladder)
        return reqs, time.perf_counter() - t0


def child(tmp, model_dir, req_path, tag, i):
    run = os.path.join(tmp, "%s_%d" % (tag, i))
    cache, no_build = os.path.join(run, "cache"), os.path.join(run, "build")
    os.makedirs(cache)
    os.makedirs(no_build)
    env = dict(os.environ, PYTHONPATH=ROOT,
               **{compile_cache.ENV_DIR: cache,
                  _build.ENV_BUILD_DIR: no_build})
    out = os.path.join(run, "out.npy")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--cold-start-child", model_dir, req_path, out, repr(time.time())],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=1200)
    got = [json.loads(line) for line in r.stdout.splitlines()
           if line.startswith("{")]
    if r.returncode != 0 or not got:
        raise SystemExit("%s run %d failed (exit %d):\n%s"
                         % (tag, i, r.returncode, r.stderr[-3000:]))
    return got[-1], np.load(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_cold_start: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    print(S.card_line(), flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build_all()
    print(json.dumps({"parent_build_s": time.perf_counter() - t0}),
          flush=True)
    ladder = inference.ServeConfig(max_batch_size=32).ladder()
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {"from_nothing": os.path.join(tmp, "plain"),
                "prelowered": os.path.join(tmp, "pre")}
        for tag, d in dirs.items():
            reqs, export_s = export(d, dev, tag == "prelowered", ladder)
            print(json.dumps({"export": tag, "export_s": export_s,
                              "bytes": S.dir_bytes(d)}), flush=True)
        req_path = os.path.join(tmp, "req.npz")
        np.savez(req_path, **reqs[0])
        direct = inference.create_predictor(inference.Config(
            dirs["from_nothing"]))
        direct._exe.cuda_graphs = False
        want = direct.run(reqs[0])[0]
        del direct
        torch.cuda.empty_cache()
        for i in range(args.repeat):
            for tag in ("from_nothing", "prelowered"):
                rec, out = child(tmp, dirs[tag], req_path, tag, i)
                rec.update(run=tag, repeat=i, vs_direct_max_abs_err=float(
                    np.abs(out - want).max()))
                print(json.dumps(rec), flush=True)
                if not rec["vs_direct_max_abs_err"] <= S.SERVE_ATOL:
                    raise SystemExit("%s: answer off by %g"
                                     % (tag, rec["vs_direct_max_abs_err"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
