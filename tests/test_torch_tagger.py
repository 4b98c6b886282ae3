"""The port's CRF tagger (paddle_tpu_torch/models/tagger.py, the book's
semantic-role labelling chapter) held to the JAX package on the CPU: the
training and decode programs' descs equal inside ``unique_name.guard()``;
from the reference's startup state (``copy_scope``), 10 Adam steps on the
reference's ``synthetic_tagging`` batches, padded to one row count,
give the reference's losses at rtol 1e-4; then the decode program on each
trained scope gives the reference's Viterbi paths exactly. Also the
smoke's sentence feed (``chip_smoke.tagger_feed``) at a small size."""

import os
import sys

import numpy as np

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import tagger as JT
import paddle_tpu_torch.fluid as pfluid
from paddle_tpu_torch.models import tagger as PT

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

TRAJ_RTOL = 1e-4
STEPS, BATCH, ROWS = 10, 4, 32


def _padded(fluid, feed):
    """``feed``'s sentences as LoDTensors of ROWS rows (zero padding past
    the tokens), so every step has one shape."""
    out = {}
    for name, t in feed.items():
        data = np.zeros((ROWS, 1), np.int64)
        data[:t.data().shape[0]] = t.data()
        out[name] = fluid.create_lod_tensor(
            data, t.recursive_sequence_lengths())
    return out


def test_tagger_desc_trajectory_and_paths_match_reference():
    with jfluid.unique_name.guard():
        jm, js, jloss = JT.build_train_program()
        jd, _, jpath = JT.build_decode_program()
    with pfluid.unique_name.guard():
        pm, ps, ploss = PT.build_train_program()
        pd, _, ppath = PT.build_decode_program()
    assert pm.to_desc() == jm.to_desc()
    assert pd.to_desc() == jd.to_desc()
    jscope, pscope = jfluid.Scope(), pfluid.Scope()
    jexe, pexe = jfluid.Executor(), pfluid.Executor("cpu")
    jexe.run(js, scope=jscope)
    pexe.run(ps, scope=pscope)
    names = [v.name for v in jm.list_vars()
             if v.persistable and jscope.find_var(v.name) is not None]
    pfluid.copy_scope(jscope, pscope, names, device="cpu")
    want, got = [], []
    for step in range(STEPS):
        feed, _ = JT.synthetic_tagging(np.random.RandomState(step), BATCH)
        want.append(float(np.asarray(jexe.run(
            jm, feed=_padded(jfluid, feed), fetch_list=[jloss],
            scope=jscope)[0])))
        got.append(float(np.asarray(pexe.run(
            pm, feed=_padded(pfluid, feed), fetch_list=[ploss],
            scope=pscope)[0])))
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
    feed, lens = JT.synthetic_tagging(np.random.RandomState(99), BATCH)
    words = _padded(jfluid, feed)["tg_words"]
    a = np.asarray(jexe.run(jd, feed={"tg_words": words},
                            fetch_list=[jpath], scope=jscope)[0])
    b = np.asarray(pexe.run(pd, feed={"tg_words": pfluid.create_lod_tensor(
        words.data(), [lens])}, fetch_list=[ppath], scope=pscope)[0])
    assert b.dtype == np.int64 and b.shape == (ROWS, 1)
    np.testing.assert_array_equal(b, a)
    assert not b[sum(lens):].any()


def test_smoke_sentence_feed():
    """The smoke's sentences: lengths in TAG_LEN, ids in the dictionary,
    tags in the label set, rows the dataset's power-of-two bound and the
    time bound the executor keys the step by."""
    feed, tokens, bound = chip_smoke.tagger_feed(pfluid, 0, 10)
    words, tags = feed["tg_words"], feed["tg_tags"]
    lens = words.recursive_sequence_lengths()[0]
    assert tags.recursive_sequence_lengths()[0] == lens
    assert sum(lens) == tokens and len(lens) == 10
    assert all(chip_smoke.TAG_LEN[0] <= n <= chip_smoke.TAG_LEN[1]
               for n in lens)
    assert words.shape[0] == pfluid.dataset.DatasetBase._lod_bound(tokens)
    assert not words.data()[tokens:].any()
    assert words.data().max() < chip_smoke.TAG["vocab"]
    assert tags.data().max() < chip_smoke.TAG["num_tags"]
    assert bound == pfluid.lod.length_bound(max(lens), words.shape[0])
