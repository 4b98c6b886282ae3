"""The port's sentiment nets (paddle_tpu_torch/models/sentiment.py, the
book's chapter 6) held to the JAX package on the CPU: both nets' program
descs equal inside ``unique_name.guard()``; from the reference's startup
state (``copy_scope``), 10 Adam steps on the reference's
``synthetic_reviews`` batches, padded to the dataset's row bound, give
the reference's losses at rtol 1e-4. Also the smoke's review feed
(``chip_smoke.snt_feed``) at small sizes."""

import os
import sys

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import sentiment as JS
import paddle_tpu_torch.fluid as pfluid
from paddle_tpu_torch.models import sentiment as PS

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

TRAJ_RTOL = 1e-4
STEPS, BATCH, ROWS = 10, 6, 64


def _padded(fluid, feed):
    """``feed``'s reviews as a LoDTensor of ROWS rows (zero padding past
    the tokens), so every step has one shape."""
    t = feed["snt_words"]
    data = np.zeros((ROWS, 1), np.int64)
    data[:t.data().shape[0]] = t.data()
    return {"snt_words": fluid.create_lod_tensor(
        data, t.recursive_sequence_lengths()),
        "snt_label": feed["snt_label"]}


@pytest.mark.parametrize("net", ["conv", "lstm"])
def test_sentiment_desc_and_trajectory_match_reference(net):
    with jfluid.unique_name.guard():
        jm, js, jloss, jacc = JS.build_train_program(net)
    with pfluid.unique_name.guard():
        pm, ps, ploss, pacc = PS.build_train_program(net)
    assert pm.to_desc() == jm.to_desc()
    assert pm.global_block().var("snt_words").lod_level == 1
    jscope, pscope = jfluid.Scope(), pfluid.Scope()
    jexe, pexe = jfluid.Executor(), pfluid.Executor("cpu")
    jexe.run(js, scope=jscope)
    pexe.run(ps, scope=pscope)
    names = [v.name for v in jm.list_vars()
             if v.persistable and jscope.find_var(v.name) is not None]
    pfluid.copy_scope(jscope, pscope, names, device="cpu")
    want, got = [], []
    for step in range(STEPS):
        feed = JS.synthetic_reviews(np.random.RandomState(step), BATCH)
        want.append(float(np.asarray(jexe.run(
            jm, feed=_padded(jfluid, feed), fetch_list=[jloss],
            scope=jscope)[0])))
        got.append(float(np.asarray(pexe.run(
            pm, feed=_padded(pfluid, feed), fetch_list=[ploss],
            scope=pscope)[0])))
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)


def test_smoke_review_feed():
    """The smoke's reviews: lengths in SNT_LEN (the first set by
    ``long``), words in the label's half of the dictionary, rows the
    dataset's power-of-two bound, and the time bound the executor keys
    the step by."""
    feed, tokens, bound = chip_smoke.snt_feed(pfluid, 0, 16, long=450)
    words = feed["snt_words"]
    lens = words.recursive_sequence_lengths()[0]
    assert lens[0] == 450 and sum(lens) == tokens
    assert all(chip_smoke.SNT_LEN[0] <= n <= chip_smoke.SNT_LEN[1]
               for n in lens[1:])
    assert words.shape[0] == pfluid.dataset.DatasetBase._lod_bound(tokens)
    assert not words.data()[tokens:].any()
    assert bound == 512
    half = chip_smoke.SNT["vocab"] // 2
    at = 0
    for n, y in zip(lens, feed["snt_label"][:, 0]):
        w = words.data()[at:at + n, 0]
        assert ((w >= half) == bool(y)).all()
        at += n
