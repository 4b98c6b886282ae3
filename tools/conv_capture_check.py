"""Whether capturing VGG16-BN's training step into a CUDA graph keeps the
eager step's cuDNN convolution kernels, with the card's free memory set
before the step:

    python3 tools/conv_capture_check.py [MODE ...]

Each MODE runs in a fresh process (empty cuDNN plan caches): ``free``
(nothing held), ``held:G`` (a live tensor leaves G GiB of the card
free), ``cached:G`` (the same bytes allocated and freed again: reserved
by the caching allocator's ordinary pool, which a graph's private pool
cannot use). In each, one executor runs the step eagerly (traced), then
captures it, then replays it (the most complete of three traces); then a
second, eager-only executor runs it again (traced). Prints one JSON line
per mode: the convolution kernels of each run by name, the allocator's
``num_ooms`` across the eager run and across the capture, and the
card's free GiB before each. With no MODE it runs
``free held:3 held:1.5 cached:3 cached:1.5``.
"""

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_MODES = ["free", "held:3", "held:1.5", "cached:3", "cached:1.5"]


def free_gib():
    return torch.cuda.mem_get_info()[0] / 2 ** 30


def ooms():
    return torch.cuda.memory_stats().get("num_ooms", 0)


def occupy(mode):
    """The tensor that holds the card's memory for ``mode`` (None when
    nothing stays allocated)."""
    if mode == "free":
        return None
    kind, gib = mode.split(":")
    nbytes = int((free_gib() - float(gib)) * 2 ** 30)
    block = torch.empty(max(nbytes, 0), dtype=torch.uint8, device="cuda")
    if kind == "held":
        return block
    del block                      # cached by the allocator, not released
    return None


def child(mode):
    sys.path.insert(0, ROOT)
    import chip_smoke as S
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import vgg

    dev = torch.device("cuda")
    with fluid.unique_name.guard():
        main, startup, loss, acc = vgg.build_train_program()
    g = torch.Generator(device=dev).manual_seed(0)
    feed = {"vgg_img": torch.rand(S.VGG_BATCH, 3, 32, 32, generator=g,
                                  device=dev),
            "vgg_label": torch.randint(0, 10, (S.VGG_BATCH, 1),
                                       generator=g, device=dev)}
    scope = fluid.Scope()
    fluid.Executor(dev, cuda_graphs=False).run(startup, scope=scope)
    hold = occupy(mode)

    def step(exe):
        return lambda: exe.run(main, feed=feed, fetch_list=[loss, acc],
                               scope=scope)

    rec = dict(mode=mode, free_gib_before_eager=free_gib())
    exe = fluid.Executor(dev)
    o = ooms()
    _, eager_kern = S.host_launches(step(exe))            # run 1: eager
    rec["ooms_eager"] = ooms() - o
    rec["free_gib_before_capture"] = free_gib()
    o = ooms()
    step(exe)()                                           # run 2: capture
    torch.cuda.synchronize()
    rec["ooms_capture"] = ooms() - o
    _, replay_kern, _, _ = S.complete_trace(step(exe))
    exe.close()
    again = fluid.Executor(dev, cuda_graphs=False)
    _, again_kern, _, _ = S.complete_trace(step(again))
    eager, replay, later = (S.conv_kernels(k) for k in (
        eager_kern, replay_kern, again_kern))
    rec.update(replay_equals_eager=replay == eager,
               replay_only=sorted(set(replay) - set(eager)),
               eager_only=sorted(set(eager) - set(replay)),
               later_eager_equals_replay=later == replay,
               later_eager_only=sorted(set(later) - set(replay)),
               replay_conv_calls=S.kernels_matching(replay_kern,
                                                    S.CONV_KERNEL))
    del hold
    print(json.dumps(rec), flush=True)
    return 0


def main(args):
    if args[:1] == ["--child"]:
        return child(args[1])
    if not torch.cuda.is_available():
        print("conv_capture_check: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    rc = 0
    for mode in args or DEFAULT_MODES:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", mode], timeout=600)
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
