"""The port's MovieLens recommender (paddle_tpu_torch/models/
recommender.py, the book's recommender chapter) held to the JAX package
on the CPU: the program desc equal inside ``unique_name.guard()``; from
the reference's startup state (``copy_scope``), 10 SGD steps on the
reference's ``synthetic_batch`` feeds, the ragged fields padded to one
row count, give the reference's losses at rtol 1e-4. Also the smoke's
feed (``chip_smoke.rec_feed``) at a small size."""

import os
import sys

import numpy as np

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import recommender as JR
import paddle_tpu_torch.fluid as pfluid
from paddle_tpu_torch.models import recommender as PR

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

TRAJ_RTOL = 1e-4
STEPS, BATCH = 10, 16
ROWS = {"category_id": 64, "movie_title": 64}


def _padded(fluid, feed):
    out = dict(feed)
    for name, rows in ROWS.items():
        t = feed[name]
        data = np.zeros((rows, 1), np.int64)
        data[:t.data().shape[0]] = t.data()
        out[name] = fluid.create_lod_tensor(
            data, t.recursive_sequence_lengths())
    return out


def test_recommender_desc_and_trajectory_match_reference():
    with jfluid.unique_name.guard():
        jm, js, jloss, jfeeds = JR.build_train_program()
    with pfluid.unique_name.guard():
        pm, ps, ploss, pfeeds = PR.build_train_program()
    assert pm.to_desc() == jm.to_desc() and pfeeds == jfeeds
    for name in ("category_id", "movie_title"):
        assert pm.global_block().var(name).lod_level == 1
    jscope, pscope = jfluid.Scope(), pfluid.Scope()
    jexe, pexe = jfluid.Executor(), pfluid.Executor("cpu")
    jexe.run(js, scope=jscope)
    pexe.run(ps, scope=pscope)
    names = [v.name for v in jm.list_vars()
             if v.persistable and jscope.find_var(v.name) is not None]
    pfluid.copy_scope(jscope, pscope, names, device="cpu")
    want, got = [], []
    for step in range(STEPS):
        feed = JR.synthetic_batch(BATCH, np.random.RandomState(step))
        want.append(float(np.asarray(jexe.run(
            jm, feed=_padded(jfluid, feed), fetch_list=[jloss],
            scope=jscope)[0])))
        got.append(float(np.asarray(pexe.run(
            pm, feed=_padded(pfluid, feed), fetch_list=[ploss],
            scope=pscope)[0])))
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)


def test_smoke_recommender_feed():
    """The smoke's batch: the model's vocabularies, 1-6 categories and
    1-15 title words a film, the ragged fields padded to the dataset's
    power-of-two row bound."""
    feed, counts = chip_smoke.rec_feed(pfluid, PR, 0, 32)
    for name, (low, high) in (("category_id", chip_smoke.REC_CATS),
                              ("movie_title", chip_smoke.REC_TITLE)):
        t = feed[name]
        lens = t.recursive_sequence_lengths()[0]
        assert len(lens) == 32 and all(low <= n <= high for n in lens)
        assert t.shape[0] == pfluid.dataset.DatasetBase._lod_bound(sum(lens))
        assert counts[name] == sum(lens)
        assert not t.data()[sum(lens):].any()
    assert feed["category_id"].data().max() < PR.CAT_VOCAB
    assert feed["movie_title"].data().max() < PR.TITLE_VOCAB
    assert feed["user_id"].shape == (32, 1)
    assert set(np.unique(feed["score"])) <= {1.0, 2.0, 3.0, 4.0, 5.0}
