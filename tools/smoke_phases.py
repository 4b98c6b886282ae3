"""Run chosen phases of chip_smoke.py alone on the card, after building
the kernels:

    python3 tools/smoke_phases.py checkpoint recompute fleet

Phases: ``checkpoint`` (py_reader windows, checkpoints, rollback, drain
and resume at config 3), ``recompute`` (BERT-base with and without
recompute at S 512 and S 8192), ``fleet`` (the smoke's cold_start
and fleet phases: the BERT-base encoder exported with prelower=True,
three cold child processes, a fleet of two replica processes),
``seq2seq`` (the GRU seq2seq trained and beam-decoded at the book's
widths), ``book`` (word2vec with a schedule and a clip, VGG16-BN),
``sentiment`` (the book's convolution and stacked-LSTM sentiment nets on
LoD reviews), ``tagger`` (the GRU + CRF tagger on LoD sentences) and
``recommender`` (the MovieLens towers scored by cos_sim) and
``control_flow`` (the PTB LM trained through StaticRNN and decoded
through While and a bounded while_loop; cond, switch_case, IfElse and
DynamicRNN against the CPU). ``--no-build`` skips the kernel build: the
seq2seq, book, sentiment, tagger, recommender and control_flow phases
launch none of the port's kernels. Each
prints the smoke's JSON lines and its wall seconds; a failed check
raises, as in the smoke.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as S  # noqa: E402
from paddle_tpu_torch import inference  # noqa: E402
from paddle_tpu_torch.fluid import monitor  # noqa: E402
from paddle_tpu_torch.kernels import _build, attention as A  # noqa: E402

PHASES = {"checkpoint": lambda dev: S.checkpoint_path(A, monitor, dev),
          "recompute": lambda dev: S.recompute_path(A, dev),
          "fleet": lambda dev: S.served_fleet(A, inference, monitor, dev),
          "seq2seq": lambda dev: S.seq2seq_path(A, inference, dev),
          "book": lambda dev: S.book_path(A, monitor, dev),
          "sentiment": lambda dev: S.sentiment_path(A, monitor, dev),
          "tagger": lambda dev: S.tagger_path(A, dev),
          "recommender": lambda dev: S.recommender_path(A, dev),
          "control_flow": lambda dev: S.control_flow_path(A, dev)}


def main(names):
    build = "--no-build" not in names
    names = [n for n in names if n != "--no-build"]
    if not torch.cuda.is_available():
        print("smoke_phases: torch sees no CUDA device", file=sys.stderr)
        return 2
    unknown = [n for n in names if n not in PHASES]
    if unknown or not names:
        print("usage: smoke_phases.py %s ..." % "|".join(PHASES),
              file=sys.stderr)
        return 2
    if build:
        t0 = time.perf_counter()
        _build.build_all()
        print("build_s", time.perf_counter() - t0, flush=True)
    print(S.card_line(), flush=True)
    dev = torch.device("cuda")
    for name in names:
        t0 = time.perf_counter()
        PHASES[name](dev)
        print(name, "phase_s", time.perf_counter() - t0, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
