"""Whether the checks of the executor's CUDA graphs catch faults planted
in the executor and in chip_smoke.py's step checks, and pass the sound
code.

    python3 tools/graph_fault_check.py [--only NAME ...]

Needs one CUDA card and nvcc. The kernels are built once in the
checkout; for each fault the port, chip_smoke.py and
tests/test_torch_cuda.py are copied (built libraries included) into a
temporary directory and the fault is planted in the copy (the checkout
is never edited). Each copy then runs, in processes of its own:

- the card tests of the graphs (``tests/test_torch_cuda.py -k graph``:
  BERT-tiny packed AMP graphed against eager, dynamic loss scaling,
  masks between replays, a replaced weight, async handles, iters=k,
  skip_step, two scopes, the Predictor);
- chip_smoke's ``packed_step_check`` (BERT-base AMP, batch 2, S 128,
  data seed 0): the kernel route against the plain route, each route's
  launches held to its own.

Faults:

  sound                 no fault: every check must pass;
  no_write_back         a persistable an op writes out of place (AMP's
                        loss-scaling state) is not copied back into the
                        storage the next replay reads;
  generator_unregistered  the scope's generator is not registered with
                        the capture;
  handle_aliases_output  an async FetchHandle holds the graph's static
                        output, not a copy;
  key_without_scope     the cache key leaves out the scope and its
                        generator;
  plain_route_replays   a step check's plain route runs on the kernel
                        route's scope through the graphed executor, so
                        it replays the kernel route's graph.

Prints the card's name and power limit, one JSON line per (copy, check)
with its verdict and the failures' names or message, then a summary.
Exits 0 when the sound copy passes every check and each fault fails at
least one.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXECUTOR = os.path.join("paddle_tpu_torch", "fluid", "executor.py")
SMOKE = "chip_smoke.py"
CARD_TESTS = os.path.join("tests", "test_torch_cuda.py")
# name: [(file, text of the sound source, its replacement, occurrences)]
FAULTS = {
    "sound": [],
    "no_write_back": [(
        EXECUTOR,
        "        if value.data_ptr() != stored.data_ptr() or \\\n"
        "                value.stride() != stored.stride():\n"
        "            stored.copy_(value.detach())\n",
        "        return\n", 1)],
    "generator_unregistered": [(
        EXECUTOR, "        graph.register_generator_state(gen)\n", "", 1)],
    "handle_aliases_output": [(
        EXECUTOR,
        '        if static and (fetch_mode == "async" or not return_numpy):',
        "        if static and not return_numpy:", 1)],
    "key_without_scope": [(
        EXECUTOR, "            key += (scope._uid, id(gen), tuple(",
        "            key += (tuple(", 1)],
    "plain_route_replays": [(
        SMOKE,
        "    sc = clone_scope(fluid, scope)\n"
        "    eager = fluid.Executor(exe.place, cuda_graphs=False)\n"
        "    return eager.run(main, feed=feed, fetch_list=[loss], "
        "scope=sc)[0], sc\n",
        "    from paddle_tpu_torch.kernels import attention as A\n"
        "    sc = _ROUTE_SCOPES.get(id(scope))\n"
        "    if sc is None:      # the kernel route: warm, capture\n"
        "        sc = _ROUTE_SCOPES[id(scope)] = clone_scope(fluid, scope)\n"
        "        for _ in range(2):\n"
        "            exe.run(main, feed=feed, fetch_list=[loss], scope=sc)\n"
        "        reset_launches(A)\n"
        "    start = clone_scope(fluid, scope)\n"
        "    for n in start.local_var_names():\n"
        "        sc.find_var(n).copy_(start.find_var(n))\n"
        "    sc.generator.set_state(start.generator.get_state())\n"
        "    return exe.run(main, feed=feed, fetch_list=[loss], "
        "scope=sc)[0], sc\n\n\n_ROUTE_SCOPES = {}\n", 1)],
}


def plant(copy, name):
    for rel, old, new, count in FAULTS[name]:
        path = os.path.join(copy, rel)
        with open(path) as f:
            text = f.read()
        if text.count(old) != count:
            raise RuntimeError("%s: %r occurs %d times in %s, expected %d"
                               % (name, old, text.count(old), rel, count))
        with open(path, "w") as f:
            f.write(text.replace(old, new))


STEP_CHECK = """
import json, sys, torch
import chip_smoke as smoke
from paddle_tpu_torch import fluid
from paddle_tpu_torch.kernels import attention as A
from paddle_tpu_torch.models import bert
prog = smoke.packed_program(fluid, bert, bert.BertConfig.base(), "packed")
try:
    rec = smoke.packed_step_check(A, fluid.Executor("cuda"), fluid, bert,
                                  prog, data_seed=0)
    over = [n for n, v in rec["grad_rel"].items()
            if not v <= smoke.PACKED_GRAD_RTOL[n]]
    if abs(rec["loss_signed_rel"]) > smoke.STEP_LOSS_MAX:
        over.append("loss")
    out = dict(passed=not over, over=over,
               loss_signed_rel=rec["loss_signed_rel"])
except AssertionError as e:
    out = dict(passed=False, message=str(e)[:300])
print("STEP_CHECK " + json.dumps(out))
"""


def run_checks(copy, name):
    """Both checks in ``copy``; yields one record each."""
    env = dict(os.environ, PYTHONPATH=copy)
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-rf",
         "-p", "no:cacheprovider", CARD_TESTS, "-k", "graph"],
        cwd=copy, env=env, capture_output=True, text=True)
    failed = re.findall(r"^FAILED \S+::(\S+)", proc.stdout, re.M)
    summary = (proc.stdout.strip().splitlines() or [""])[-1]
    yield dict(copy=name, check="card_tests_graph",
               passed=proc.returncode == 0, failed=failed, summary=summary)
    proc = subprocess.run([sys.executable, "-c", STEP_CHECK], cwd=copy,
                          env=env, capture_output=True, text=True)
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("STEP_CHECK ")]
    rec = json.loads(line[-1][len("STEP_CHECK "):]) if line else dict(
        passed=False, message=proc.stderr.strip()[-300:])
    yield dict(copy=name, check="packed_step_check", **rec)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="+", help="run these copies alone")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("graph_fault_check: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    sys.path.insert(0, ROOT)
    from paddle_tpu_torch.kernels import _build
    _build.build_all()
    names = [n for n in FAULTS if not args.only or n in args.only]
    tmp = tempfile.mkdtemp(prefix="graph_faults_")
    failed = {}
    try:
        for name in names:
            copy = os.path.join(tmp, name)
            shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"),
                            os.path.join(copy, "paddle_tpu_torch"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            os.makedirs(os.path.join(copy, "tests"))
            for rel in (SMOKE, CARD_TESTS):
                shutil.copy(os.path.join(ROOT, rel), os.path.join(copy, rel))
            plant(copy, name)
            failed[name] = False
            for rec in run_checks(copy, name):
                print(json.dumps(rec), flush=True)
                failed[name] |= not rec["passed"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ok = all(failed[n] == (n != "sound") for n in failed)
    print(json.dumps(dict(summary="graph faults", failed_a_check=failed,
                          ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
